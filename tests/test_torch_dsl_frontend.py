"""The port's frontend and analysis against the reference's: the mirror of
``tests/test_dsl_frontend.py``.

Each definition is written once, with the port's types; the reference reads
its twin (``torch_mirror.reference_twin``).  Where the port parses, its
Definition IR equals the reference's, as dataclasses and through ``ir_json``;
where the reference rejects, the port rejects with the same error class and
message; extents and stage counts are the reference's.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

import corpus_gen
from repro.core import analysis as r_analysis
from repro.core import frontend as r_frontend
from repro.core import gtscript as r_gtscript
from repro_torch.core import analysis, frontend, gtscript, ir, ir_json
from repro_torch.core.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    Field,
    GTScriptSemanticError,
    GTScriptSyntaxError,
    computation,
    interval,
)
from torch_mirror import reference_twin


def _parse(fn, externals=None):
    """The port's Definition IR, held equal to the reference's."""
    d = frontend.parse_stencil_definition(fn, externals=dict(externals or {}), name=fn.__name__)
    r = r_frontend.parse_stencil_definition(reference_twin(fn), externals=dict(externals or {}), name=fn.__name__)
    assert repr(d) == repr(r)
    assert ir_json.definition_to_json(d) == corpus_gen.definition_to_json(r)
    return d


def _analyze(fn, externals=None):
    """The port's Implementation IR, held equal to the reference's."""
    impl = analysis.analyze(_parse(fn, externals))
    r_impl = r_analysis.analyze(
        r_frontend.parse_stencil_definition(reference_twin(fn), externals=dict(externals or {}), name=fn.__name__))
    assert repr(impl) == repr(r_impl)
    return impl


def _rejects(fn, error, r_error, match, analyze=True, externals=None):
    """Both packages reject ``fn`` with the same error class and message."""
    t_step = (lambda d: analysis.analyze(d)) if analyze else (lambda d: d)
    r_step = (lambda d: r_analysis.analyze(d)) if analyze else (lambda d: d)
    with pytest.raises(error, match=match) as t_err:
        t_step(frontend.parse_stencil_definition(fn, externals=dict(externals or {}), name=fn.__name__))
    with pytest.raises(r_error, match=match) as r_err:
        r_step(r_frontend.parse_stencil_definition(reference_twin(fn), externals=dict(externals or {}),
                                                   name=fn.__name__))
    assert str(t_err.value) == str(r_err.value)


# ---------------------------------------------------------------------------
# parsing basics
# ---------------------------------------------------------------------------


def test_signature_classification():
    def st(a: Field[np.float64], b: Field[np.float32], *, s: np.float64, t: np.int32):
        with computation(PARALLEL), interval(...):
            a = b + s + t

    d = _parse(st)
    api = {f.name: f for f in d.api_fields if f.is_api}
    assert set(api) == {"a", "b"}
    assert api["a"].dtype == "float64"
    assert api["b"].dtype == "float32"
    scalars = {s.name: s.dtype for s in d.scalars}
    assert scalars == {"s": "float64", "t": "int32"}


def test_offsets_compose_through_function_inlining():
    @gtscript.function
    def dx(phi):
        return phi[1, 0, 0] - phi[0, 0, 0]

    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = dx(a[-1, 2, 0])

    d = _parse(st)
    stmt = d.computations[0].intervals[0].body[0]
    reads = {e.offset for e in ir.walk_exprs(stmt.value) if isinstance(e, ir.FieldAccess)}
    assert reads == {(0, 2, 0), (-1, 2, 0)}


def test_nested_function_inlining_with_locals():
    @gtscript.function
    def lap(phi):
        return -4.0 * phi[0, 0, 0] + phi[1, 0, 0] + phi[-1, 0, 0] + phi[0, 1, 0] + phi[0, -1, 0]

    @gtscript.function
    def bilap(phi):
        l1 = lap(phi)
        return lap(l1)

    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = bilap(a)

    impl = _analyze(st)
    ext = impl.extent_of("a")
    assert ext.i == (-2, 2) and ext.j == (-2, 2)


def test_externals_resolved_and_required():
    def st(a: Field[np.float64], o: Field[np.float64]):
        from __externals__ import C

        with computation(PARALLEL), interval(...):
            o = a * C

    d = _parse(st, externals={"C": 2.5})
    stmt = d.computations[0].intervals[0].body[0]
    lits = [e for e in ir.walk_exprs(stmt.value) if isinstance(e, ir.Literal)]
    assert any(lit.value == 2.5 for lit in lits)

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "external", analyze=False, externals={})


def test_compile_time_if_pruning_on_externals():
    def st(a: Field[np.float64], o: Field[np.float64]):
        from __externals__ import FLAG

        with computation(PARALLEL), interval(...):
            if FLAG:
                o = a * 2.0
            else:
                o = a * 3.0

    d = _parse(st, externals={"FLAG": True})
    body = d.computations[0].intervals[0].body
    assert len(body) == 1 and isinstance(body[0], ir.Assign)


def test_interval_bounds():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 2):
                o = a
            with interval(2, -1):
                o = a * 2.0
            with interval(-1, None):
                o = a * 3.0

    d = _parse(st)
    ivs = d.computations[0].intervals
    assert ivs[0].interval.end == ir.AxisBound(ir.LevelMarker.START, 2)
    assert ivs[1].interval.end == ir.AxisBound(ir.LevelMarker.END, -1)
    assert ivs[2].interval.start == ir.AxisBound(ir.LevelMarker.END, -1)


def test_tuple_assignment_and_swap_semantics():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            x = a * 1.0
            y = a * 2.0
            x, y = y, x
            o = x - y

    impl = _analyze(st)
    # numerically a swap: tests/test_torch_dsl_backends.py; here the staging temps
    names = {t.name for t in impl.temporaries}
    assert any(n.startswith("gt__unpack") for n in names)


# ---------------------------------------------------------------------------
# compile-time error checks (paper §2.2)
# ---------------------------------------------------------------------------


def test_parallel_self_offset_race_rejected():
    def st(a: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            a = a[1, 0, 0] + 1.0

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "PARALLEL")


def test_forward_lookahead_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD), interval(...):
            o = o[0, 0, 1] + a

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "ahead of a FORWARD")


def test_backward_lookbehind_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(BACKWARD), interval(...):
            o = o[0, 0, -1] + a

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "behind a BACKWARD")


def test_horizontal_self_offset_in_sequential_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD), interval(...):
            o = o[1, 0, 0] + a

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "horizontal")


def test_temporary_use_before_definition_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = tmp + a
            tmp = a * 2.0

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "before definition")


def test_overlapping_intervals_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 3):
                o = a
            with interval(2, None):
                o = a * 2.0

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "overlap")


def test_vertical_read_below_domain_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD), interval(0, None):
            o = a[0, 0, -1]

    _rejects(st, GTScriptSemanticError, r_gtscript.GTScriptSemanticError, "below the vertical domain")


def test_unknown_symbol_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = a + undefined_thing  # noqa: F821

    _rejects(st, GTScriptSyntaxError, r_gtscript.GTScriptSyntaxError, "unknown symbol", analyze=False)


def test_write_offset_rejected():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o[1, 0, 0] = a

    _rejects(st, GTScriptSyntaxError, r_gtscript.GTScriptSyntaxError, "offset must be zero", analyze=False)


def test_reserved_name_rejected():
    def st(nk: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = nk

    _rejects(st, GTScriptSyntaxError, r_gtscript.GTScriptSyntaxError, "reserved", analyze=False)


# ---------------------------------------------------------------------------
# analysis results
# ---------------------------------------------------------------------------


def test_hdiff_extents_and_fusion():
    from repro_torch.stencils.hdiff import hdiff_defs

    impl = _analyze(hdiff_defs, externals={"LIM": 0.01})
    assert impl.extent_of("in_phi").i == (-3, 3)
    assert impl.extent_of("in_phi").j == (-3, 3)
    assert impl.extent_of("out_phi").i == (0, 0)
    # a single fused PARALLEL multi-stage
    assert len(impl.multi_stages) == 1
    assert impl.multi_stages[0].order == ir.IterationOrder.PARALLEL


def test_dead_temporary_pruned():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            unused = a * 3.0  # noqa: F841
            o = a * 2.0

    impl = _analyze(st)
    assert all(t.name != "unused" for t in impl.temporaries)
    # and the stage feeding it is gone
    total_stages = sum(len(i.stages) for ms in impl.multi_stages for i in ms.intervals)
    assert total_stages == 1


def test_min_k_levels():
    def st(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 2):
                o = a
            with interval(2, None):
                o = a + o[0, 0, -1]

    impl = _analyze(st)
    assert impl.min_k_levels >= 3
