"""The port's pass pipeline against the reference's: the mirror of
``tests/test_passes.py``.

Every pass decision, the optimized IR and the pass report (without its
timings) equal the reference's on the same definition; each assertion the
reference makes about its own pipeline holds for the port's.  The
differential runs (``torch_mirror.run_differential``) hold the port's
``debug``, ``numpy`` (opt 0 and default), ``torch`` (opt 0 and default) and
``cuda`` (opt 0 and default, ``block=(4, 4)``, its plain module on CPU
tensors) against the reference's ``debug`` oracle at ``opt_level=0``, within
the reference's 1e-13.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import os

import numpy as np

import torch_stencil_cases as cases
from repro.core import analysis as r_analysis
from repro.core import frontend as r_frontend
from repro.core import ir as r_ir
from repro.core import passes as r_passes
from repro_torch.core import analysis, frontend, gtscript, ir, passes, storage
from repro_torch.core.gtscript import FORWARD, PARALLEL, Field, computation, interval
from repro_torch.stencils.hdiff import hdiff_defs, hdiff_smag_defs
from repro_torch.stencils.vadv import vadv_boundary_defs, vadv_defs, vadv_system_defs
from repro_torch.stencils.vintg import vintg_defs
from torch_mirror import decisions, definitions, reference_twin, run_case

# the reference's CI pass matrix reruns its file with these knobs set; the
# assertions about the default pipeline do not apply there, in either package
skip_under_env_knobs = pytest.mark.skipif(
    bool(os.environ.get("REPRO_OPT_LEVEL") or os.environ.get("REPRO_DISABLE_PASSES")),
    reason="pass-pipeline env knobs active (CI pass matrix)",
)

NI, NJ, NK = cases.DOMAIN


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _impls(defs, externals=None, name=None):
    """(reference, port) unoptimized Implementation IR, held equal."""
    r_defn, t_defn = definitions(defs, externals, name)
    r_impl, t_impl = r_analysis.analyze(r_defn), analysis.analyze(t_defn)
    assert repr(t_impl) == repr(r_impl)
    return r_impl, t_impl


def _run(r_impl, t_impl, **opts):
    """Both pipelines on one IR: (reference IR, port IR, port report), with
    the port's IR and decisions held equal to the reference's."""
    r_opt, r_rep = r_passes.run_pipeline(r_impl, **opts)
    t_opt, t_rep = passes.run_pipeline(t_impl, **opts)
    assert repr(t_opt) == repr(r_opt)
    assert repr(decisions(t_rep)) == repr(decisions(r_rep))
    return r_opt, t_opt, t_rep


def _pipeline(defs, externals=None, name=None, **opts):
    """The port's (unoptimized IR, optimized IR, report), each held to the reference's."""
    r_impl, t_impl = _impls(defs, externals, name)
    _r_opt, t_opt, t_rep = _run(r_impl, t_impl, **opts)
    return t_impl, t_opt, t_rep


def _analyze(defs, externals=None, name=None):
    return _impls(defs, externals, name)[1]


# ---------------------------------------------------------------------------
# library operators, each wrapped in a minimal stencil
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("defs", cases.ONE_FIELD, ids=lambda d: d.__name__)
def test_library_operator_differential(defs):
    run_case(cases.BY_NAME[defs.__name__[:-5]])


@pytest.mark.parametrize("defs", cases.TWO_FIELDS, ids=lambda d: d.__name__)
def test_library_operator_two_fields_differential(defs):
    run_case(cases.BY_NAME[defs.__name__[:-5]])


# ---------------------------------------------------------------------------
# the paper's two motifs + system assembly
# ---------------------------------------------------------------------------


def test_hdiff_differential():
    run_case(cases.BY_NAME["hdiff"])


def test_vadv_differential():
    run_case(cases.BY_NAME["vadv"])


def test_vadv_system_differential():
    run_case(cases.BY_NAME["vadv_system"])


def test_conditionally_overwritten_local_differential():
    run_case(cases.BY_NAME["overwritten_local"])
    # t's first write is unconditional → it demotes despite the masked update
    _impl, opt, _rep = _pipeline(cases.overwritten_local_defs)
    assert [f.name for f in opt.local_decls] == ["t"]


def test_zero_init_temp_not_demoted_and_correct():
    run_case(cases.BY_NAME["zero_init_temp"])
    _impl, opt, _rep = _pipeline(cases.zero_init_temp_defs)
    assert not opt.local_decls  # a conditional first write must stay a field


# ---------------------------------------------------------------------------
# the pipeline demonstrably does work (acceptance assertions)
# ---------------------------------------------------------------------------


def test_hdiff_optimized_ir_is_smaller():
    impl0, opt, report = _pipeline(hdiff_defs, externals={"LIM": 0.01}, name="hdiff")
    assert len(opt.temporaries) < len(impl0.temporaries)
    assert {f.name for f in opt.local_decls} == {"flux_x", "flux_y", "grad_x", "grad_y"}
    assert any(r["pass"] == "temp_demotion" and r["changed"] for r in report)


def test_vadv_optimized_ir_is_smaller():
    impl0, opt, _rep = _pipeline(vadv_defs, name="vadv")
    assert len(opt.temporaries) < len(impl0.temporaries)
    assert {f.name for f in opt.local_decls} == {"denom"}


def test_vadv_system_fuses_multistages():
    impl0, opt, report = _pipeline(vadv_system_defs, name="vadv_system")
    assert len(impl0.multi_stages) == 3
    assert len(opt.multi_stages) == 1
    assert any(r["pass"] == "multistage_fusion" and r["changed"] for r in report)


@skip_under_env_knobs
def test_pass_timings_in_exec_info():
    from repro_torch.stencils.hdiff import build_hdiff

    hd = build_hdiff("numpy")
    H = 3
    i = storage.from_array(_rand((NI + 2 * H, NJ + 2 * H, NK)), backend="numpy", default_origin=(H, H, 0))
    o = storage.zeros((NI + 2 * H, NJ + 2 * H, NK), backend="numpy", default_origin=(H, H, 0))
    info = {}
    hd(i, o, alpha=np.float64(0.1), exec_info=info)
    report = info["pass_report"]
    assert report, "pass_report missing from exec_info"
    names = {r["pass"] for r in report}
    assert {"multistage_fusion", "temp_demotion", "dead_temp_pruning"} <= names
    assert all(r["seconds"] >= 0.0 and "before" in r and "after" in r for r in report)
    # the same passes, in the same order, as the reference's hdiff
    from repro.stencils.hdiff import build_hdiff as r_build_hdiff

    assert [r["pass"] for r in report] == [r["pass"] for r in r_build_hdiff("numpy").pass_report]


# ---------------------------------------------------------------------------
# individual passes
# ---------------------------------------------------------------------------


def test_interval_merging_merges_identical_bodies():
    impl0, opt, report = _pipeline(cases.merge_forward_defs)
    assert sum(len(ms.intervals) for ms in impl0.multi_stages) == 2
    assert sum(len(ms.intervals) for ms in opt.multi_stages) == 1
    assert opt.multi_stages[0].intervals[0].interval == ir.VerticalInterval.full()
    assert any(r["pass"] == "interval_merging" and r["changed"] for r in report)
    run_case(cases.BY_NAME["merge_forward"])


def test_interval_merging_backward():
    _impl, opt, _rep = _pipeline(cases.merge_backward_defs)
    assert sum(len(ms.intervals) for ms in opt.multi_stages) == 1
    run_case(cases.BY_NAME["merge_backward"])


def test_interval_merging_keeps_different_bodies():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 2):
                o = a * 2.0
            with interval(2, None):
                o = a * 3.0

    _impl, opt, _rep = _pipeline(defs)
    assert sum(len(ms.intervals) for ms in opt.multi_stages) == 2


def test_constant_folding_folds_literal_arithmetic():
    _impl, opt, report = _pipeline(cases.fold_literals_defs)
    (stmt,) = opt.multi_stages[0].intervals[0].stages[0].stmts
    # reassociation canonicalizes commutative operands literal-first
    assert stmt.value == ir.BinOp("*", ir.Literal(7.0, "float"), ir.FieldAccess("a", (0, 0, 0)))
    assert any(r["pass"] == "constant_folding" and r["changed"] for r in report)
    run_case(cases.BY_NAME["fold_literals"])


def test_constant_folding_prunes_dead_branch_and_temp():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            t = a * 2.0
            if 1.0 > 2.0:
                o = t
            else:
                o = a

    _impl, opt, _rep = _pipeline(defs)
    # the dead branch was the only consumer of t → t and its stage are gone
    assert not opt.temporaries and not opt.local_decls
    assert sum(len(itv.stages) for ms in opt.multi_stages for itv in ms.intervals) == 1


def test_constant_folding_empty_then_branch():
    # the then-branch folds away entirely; the else must still apply
    case = cases.BY_NAME["fold_empty_then"]
    results = run_case(case)
    x = case.arrays()["a"][0]
    np.testing.assert_allclose(results["debug"]["o"], np.where(x > 0.0, x, -x))


def test_constant_folding_mod_uses_floored_semantics():
    # np.mod(-7, 3) == 2 (floored); math.fmod would give -1: the fold and every
    # backend, the oracle included, agree on the floored value
    case = cases.BY_NAME["fold_mod"]
    results = run_case(case)
    np.testing.assert_allclose(results["debug"]["o"], case.arrays()["a"][0] + 2.0)
    _impl, opt, _rep = _pipeline(cases.fold_mod_defs)
    (stmt,) = opt.multi_stages[0].intervals[0].stages[0].stmts
    assert stmt.value == ir.BinOp("+", ir.Literal(2.0, "float"), ir.FieldAccess("a", (0, 0, 0)))


def test_constant_folding_keeps_out_of_range_int_cast():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = a + int(5000000000)  # wraps at runtime in int32 — must not fold

    _impl, opt, _rep = _pipeline(defs)
    (stmt,) = opt.multi_stages[0].intervals[0].stages[0].stmts
    assert stmt.value.right == ir.Cast("int32", ir.Literal(5000000000, "int"))

    # optimized against unoptimized on one backend (the runtime cast wraps;
    # the debug oracle's scalar int() does not, as in the reference)
    x = _rand((NI, NJ, NK), seed=14)
    outs = {}
    for backend in ("numpy", "torch", "cuda"):
        for lvl in (0, 3):
            st = gtscript.stencil(backend=backend, opt_level=lvl)(defs)
            dev = None if backend == "numpy" else "cpu"
            a = storage.from_array(x.copy(), backend=backend, device=dev)
            o = storage.zeros(x.shape, backend=backend, device=dev)
            st(a, o, domain=(NI, NJ, NK))
            outs[backend, lvl] = o.to_numpy()
        np.testing.assert_array_equal(outs[backend, 0], outs[backend, 3])
    np.testing.assert_array_equal(outs["torch", 3], outs["numpy", 3])


def test_constant_folding_preserves_negative_zero():
    # x + 0.0 flips -0.0 to +0.0, so it must NOT fold away (commuting it to
    # 0.0 + x is fine: IEEE addition is commutative bit for bit)
    _impl, opt, _rep = _pipeline(cases.negative_zero_defs)
    (stmt,) = opt.multi_stages[0].intervals[0].stages[0].stmts
    assert stmt.value == ir.BinOp("+", ir.Literal(0.0, "float"), ir.FieldAccess("a", (0, 0, 0)))
    results = run_case(cases.BY_NAME["negative_zero"])
    for key in ("numpy@default", "torch@default", "cuda@default"):
        assert not np.signbit(results[key]["o"]).any(), key


def test_dead_temp_pruning_shrinks_extents():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            wide = a[2, 0, 0] + a[-2, 0, 0]
            if False:
                o = wide
            else:
                o = a

    _impl, opt, _rep = _pipeline(defs)
    assert opt.extent_of("a").i == (0, 0)  # the ±2 halo demand died with `wide`


# ---------------------------------------------------------------------------
# cross-stage CSE
# ---------------------------------------------------------------------------


def _cse_detail(report):
    for r in report:
        if r["pass"] == "cross_stage_cse":
            return r.get("detail", {})
    return {}


def test_cse_hoists_shift_equivalent_neighbor_sums():
    _impl, opt, report = _pipeline(cases.cse_neighbor_sums_defs)
    assert _cse_detail(report) == {"hoisted": 1, "eliminated": 1}
    assert [f.name for f in opt.temporaries if f.name.startswith("_cse")] == ["_cse0"]
    # the two occurrences read the shared temporary at shifts (1,0,0) and
    # (0,0,0), and the halo stays what the original reads demanded
    assert opt.extent_of("a").i == (-1, 1)
    run_case(cases.BY_NAME["cse_neighbor_sums"])


def test_cse_vadv_system_eliminates_gcv_chain():
    _impl, opt, report = _pipeline(vadv_system_defs, name="vadv_system")
    detail = _cse_detail(report)
    # the 0.25*(w_k + w_k±1)*dt/dz chain and the phi-difference chain each
    # repeat (k-shifted) in the interior interval
    assert detail["hoisted"] == 2 and detail["eliminated"] == 2
    # the k-shifted hoists evaluate in their own vertical interval
    cse_intervals = [
        itv for ms in opt.multi_stages for itv in ms.intervals
        if any(st.writes[0].startswith("_cse") for st in itv.stages if st.writes)
    ]
    assert cse_intervals, "expected dedicated defining intervals for k-shifted hoists"


def test_cse_hdiff_smag_eliminates_stretch_and_shear():
    _impl, opt, report = _pipeline(hdiff_smag_defs, externals={"CS": 0.15}, name="hdiff_smag")
    detail = _cse_detail(report)
    assert detail["hoisted"] == 2 and detail["eliminated"] == 2
    assert opt.extent_of("u").i == (-1, 1)  # CSE must not grow the halo
    run_case(cases.BY_NAME["hdiff_smag"])


def test_cse_respects_intervening_writes():
    _impl, opt, report = _pipeline(cases.cse_intervening_writes_defs)
    # `a * a` repeats with no interference and hoists; `a * a + b` repeats
    # too, but b is rewritten between the occurrences: it must NOT merge
    detail = _cse_detail(report)
    assert detail["hoisted"] == 1 and detail["eliminated"] == 1
    # zero-offset single-interval hoists demote to stage-locals downstream
    (cse,) = [f for f in tuple(opt.temporaries) + tuple(opt.local_decls) if f.name.startswith("_cse")]
    for ms in opt.multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    if stmt.target.name == cse.name:
                        assert stmt.value == ir.BinOp(
                            "*", ir.FieldAccess("a", (0, 0, 0)), ir.FieldAccess("a", (0, 0, 0))
                        )
    run_case(cases.BY_NAME["cse_intervening_writes"])


def test_cse_skips_sequential_sweeps():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 1):
                o = a * a + a
            with interval(1, None):
                o = a * a + o[0, 0, -1]

    _impl, _opt, report = _pipeline(defs)
    assert _cse_detail(report) == {"hoisted": 0, "eliminated": 0}


def test_cse_disable_toggle():
    _impl, opt, report = _pipeline(vadv_system_defs, name="vadv_system", disable=("cross_stage_cse",))
    assert not any(r["pass"] == "cross_stage_cse" for r in report)
    assert not any(f.name.startswith("_cse") for f in opt.temporaries)


# ---------------------------------------------------------------------------
# configuration / plumbing
# ---------------------------------------------------------------------------


def test_opt_level_0_runs_no_passes():
    impl0, out, report = _pipeline(hdiff_defs, externals={"LIM": 0.01}, name="hdiff", opt_level=0)
    assert out == impl0 and report == []


def test_disable_and_enable_passes():
    r_impl, t_impl = _impls(hdiff_defs, externals={"LIM": 0.01}, name="hdiff")
    _r, no_demote, _rep = _run(r_impl, t_impl, disable=("temp_demotion",))
    assert not no_demote.local_decls

    _impl, fused_only, report = _pipeline(vadv_system_defs, name="vadv_system", opt_level=0,
                                          enable=("multistage_fusion",))
    assert len(fused_only.multi_stages) == 1
    assert [r["pass"] for r in report] == ["multistage_fusion"]

    with pytest.raises(ValueError, match="unknown pass") as t_err:
        passes.run_pipeline(t_impl, disable=("no_such_pass",))
    with pytest.raises(ValueError, match="unknown pass") as r_err:
        r_passes.run_pipeline(r_impl, disable=("no_such_pass",))
    assert str(t_err.value) == str(r_err.value)


@skip_under_env_knobs
def test_fingerprint_keyed_on_pass_config():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = a * 2.0

    for backend in ("numpy", "torch", "cuda"):
        st0 = gtscript.stencil(backend=backend, opt_level=0)(defs)
        st3 = gtscript.stencil(backend=backend)(defs)
        st_no_fold = gtscript.stencil(backend=backend, disable_passes=("constant_folding",))(defs)
        assert st0.fingerprint != st3.fingerprint
        assert st_no_fold.fingerprint not in (st0.fingerprint, st3.fingerprint)


# ---------------------------------------------------------------------------
# interval splitting (boundary specialization)
# ---------------------------------------------------------------------------


def _split_detail(report):
    for r in report:
        if r["pass"] == "interval_splitting":
            return r.get("detail", {})
    return {}


def test_interval_splitting_peels_vadv_boundary():
    r_impl, t_impl = _impls(vadv_boundary_defs, name="vadv_boundary")
    _r, opt, report = _run(r_impl, t_impl)
    assert _split_detail(report)["intervals_split"] == 2
    assert [ms.order.name for ms in opt.multi_stages] == ["PARALLEL", "FORWARD", "PARALLEL", "BACKWARD"]
    # the payoff: the interior sweeps stop carrying the boundary-only flux
    # outputs, half the carried planes of the verbatim lowering
    _r0, opt0, _rep0 = _run(r_impl, t_impl, opt_level=0)
    nk = 16

    def planes(im):
        return sum(p.carried_planes(nk) for p in analysis.sequential_carry_plan(im).values())

    assert planes(opt) == planes(opt0) // 2
    run_case(cases.BY_NAME["vadv_boundary"])


def test_interval_splitting_converts_carry_free_sweep():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 1):
                o = a * 2.0
            with interval(1, None):
                o = a * 3.0

    _impl, opt, report = _pipeline(defs)
    assert _split_detail(report)["parallelized_sweeps"] == 1
    assert all(ms.order == ir.IterationOrder.PARALLEL for ms in opt.multi_stages)


def test_interval_splitting_carry_guard_protects_vintg_windows():
    _impl, opt, report = _pipeline(vintg_defs, name="vintg")
    detail = _split_detail(report)
    # peeling vintg's boundary inits would reclassify the depth-1 window
    # accumulators as full cross-multi-stage carries: the guard refuses
    assert detail["intervals_split"] == 0
    assert detail["rejected_by_carry_guard"] == 2
    assert all(len(p.window) == 1 for p in analysis.sequential_carry_plan(opt).values())


def test_interval_splitting_keeps_interior_recurrence():
    _impl, opt, report = _pipeline(vadv_defs, name="vadv")
    assert _split_detail(report)["intervals_split"] == 2
    assert [ms.order.name for ms in opt.multi_stages] == ["PARALLEL", "FORWARD", "PARALLEL", "BACKWARD"]


def test_interval_splitting_retype_roundtrip_float32():
    """Splitting decisions are dtype-independent: the float32 variant of the
    boundary stencil (``ir.retype_definition``) splits identically, as in the
    reference, and its optimized output is bit-identical to its own
    verbatim lowering on the port's numpy and torch backends."""
    from repro_torch.stencils.vadv import build_vadv_boundary

    defn32 = ir.retype_definition(
        frontend.parse_stencil_definition(vadv_boundary_defs, externals={}, name="vadv_boundary"),
        {"float64": "float32"},
    )
    r_defn32 = r_ir.retype_definition(
        r_frontend.parse_stencil_definition(reference_twin(vadv_boundary_defs), externals={}, name="vadv_boundary"),
        {"float64": "float32"},
    )
    assert repr(defn32) == repr(r_defn32)
    _r, _t, rep32 = _run(r_analysis.analyze(r_defn32), analysis.analyze(defn32))
    _impl64, _opt64, rep64 = _pipeline(vadv_boundary_defs, name="vadv_boundary")
    assert _split_detail(rep64) == _split_detail(rep32)

    H = 1
    rng = np.random.default_rng(31)
    shape = (NI + 2 * H, NJ + 2 * H, NK)
    data = {
        "wcon": rng.normal(size=shape), "phi": rng.normal(size=shape),
        "flux_bot": np.zeros(shape), "flux_top": np.zeros(shape),
        "acc": np.zeros(shape), "res": np.zeros(shape),
    }
    for backend in ("numpy", "torch"):
        outs = {}
        for lvl in (0, 3):
            st = build_vadv_boundary(backend, dtype="float32", opt_level=lvl)
            dev = None if backend == "numpy" else "cpu"
            fs = {n: storage.from_array(v.astype("float32"), backend=backend, default_origin=(H, H, 0), device=dev)
                  for n, v in data.items()}
            st(**fs, weight=np.float32(0.4), domain=(NI, NJ, NK))
            outs[lvl] = {n: f.to_numpy() for n, f in fs.items()}
        for n in outs[0]:
            np.testing.assert_array_equal(outs[0][n], outs[3][n], err_msg=f"{backend}/{n}")


# ---------------------------------------------------------------------------
# algebraic reassociation
# ---------------------------------------------------------------------------


def test_reassociation_commutes_for_cse():
    r_impl, t_impl = _impls(cases.reassociation_defs)
    _r, _opt, report = _run(r_impl, t_impl)
    # u*v and v*u share one canonical spelling → CSE hoists the product
    assert _cse_detail(report) == {"hoisted": 1, "eliminated": 1}
    _r, _opt, report_off = _run(r_impl, t_impl, disable=("algebraic_reassociation",))
    assert _cse_detail(report_off) == {"hoisted": 0, "eliminated": 0}
    run_case(cases.BY_NAME["reassociation"])


def test_reassociation_exact_mode_only_commutes():
    def defs2(a: Field[np.float64], o: Field[np.float64], *, s: np.float64):
        with computation(PARALLEL), interval(...):
            o = a + (s + a[1, 0, 0])

    r_impl, t_impl = _impls(defs2)
    _r, opt_exact, _rep = _run(r_impl, t_impl)
    _r, opt_loose, rep_loose = _run(r_impl, t_impl, exact=False)
    (stmt_e,) = opt_exact.multi_stages[0].intervals[0].stages[0].stmts
    (stmt_l,) = opt_loose.multi_stages[0].intervals[0].stages[0].stmts
    # exact: association untouched (a + (s + a[1,0,0]) keeps its tree)
    assert isinstance(stmt_e.value.right, ir.BinOp)
    # exact=False: the chain flattens left-associated with sorted terms
    assert stmt_l.value == ir.BinOp(
        "+",
        ir.BinOp("+", ir.ScalarRef("s"), ir.FieldAccess("a", (0, 0, 0))),
        ir.FieldAccess("a", (1, 0, 0)),
    )
    detail = next(r["detail"] for r in rep_loose if r["pass"] == "algebraic_reassociation")
    assert detail["reassociated"] >= 1 and detail["exact"] is False


def test_exact_flag_in_fingerprint():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = a + (a[1, 0, 0] + a[-1, 0, 0])

    for backend in ("numpy", "torch", "cuda"):
        st_exact = gtscript.stencil(backend=backend)(defs)
        st_loose = gtscript.stencil(backend=backend, exact=False)(defs)
        assert st_exact.fingerprint != st_loose.fingerprint


# ---------------------------------------------------------------------------
# numpy stage tiling
# ---------------------------------------------------------------------------


def test_numpy_tiling_bit_identical_on_odd_domains():
    H = 3
    ni, nj, nk = 13, 11, 4  # deliberately not tile-divisible
    data = _rand((ni + 2 * H, nj + 2 * H, nk), seed=34)
    outs = {}
    for label, opts in (("untiled", {"tile": None}), ("tiled", {"tile": (5, 4)})):
        st = gtscript.stencil(backend="numpy", externals={"LIM": 0.01}, **opts)(hdiff_defs)
        i = storage.from_array(data.copy(), backend="numpy", default_origin=(H, H, 0))
        o = storage.zeros(data.shape, backend="numpy", default_origin=(H, H, 0))
        st(i, o, alpha=np.float64(0.07), domain=(ni, nj, nk))
        outs[label] = o.to_numpy()
    np.testing.assert_array_equal(outs["tiled"], outs["untiled"])
    # and the reference's tiled numpy backend gives the same bits
    from repro.core import gtscript as r_gtscript
    from repro.core import storage as r_storage

    st = r_gtscript.stencil(backend="numpy", externals={"LIM": 0.01}, tile=(5, 4))(reference_twin(hdiff_defs))
    i = r_storage.from_array(data.copy(), default_origin=(H, H, 0))
    o = r_storage.zeros(data.shape, default_origin=(H, H, 0))
    st(i, o, alpha=np.float64(0.07), domain=(ni, nj, nk))
    np.testing.assert_array_equal(outs["tiled"], o.to_numpy())


def test_numpy_tiling_skips_antidependent_multistage():
    from repro.core.codegen_array import tiling_plan as r_tiling_plan
    from repro_torch.core.codegen_array import tiling_plan

    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            t = a[1, 0, 0] + a[-1, 0, 0]
            o = o + t  # reads its own write target → overlap recompute double-applies

    r_impl, t_impl = _impls(defs)
    r_opt, opt, _rep = _run(r_impl, t_impl)
    plan = tiling_plan(opt)
    assert plan == r_tiling_plan(r_opt)
    assert plan["tiled_multistages"] == 0 and plan["untileable_multistages"] == 1

    # ... and the emitted module must therefore match untiled bit for bit
    x = _rand((NI + 2, NJ + 2, NK), seed=35)
    outs = {}
    for label, opts in (("untiled", {"tile": None}), ("tiled", {"tile": (3, 2)})):
        st = gtscript.stencil(backend="numpy", **opts)(defs)
        a = storage.from_array(x.copy(), backend="numpy", default_origin=(1, 1, 0))
        o = storage.from_array(_rand((NI + 2, NJ + 2, NK), seed=36), backend="numpy", default_origin=(1, 1, 0))
        st(a, o, domain=(NI, NJ, NK))
        outs[label] = o.to_numpy()
    np.testing.assert_array_equal(outs["tiled"], outs["untiled"])


@skip_under_env_knobs
def test_numpy_tiling_reports_and_fingerprints():
    st = gtscript.stencil(backend="numpy", externals={"LIM": 0.01})(hdiff_defs)
    rec = next(r for r in st.pass_report if r["pass"] == "numpy_stage_tiling")
    assert rec["changed"] and rec["detail"]["tiled_multistages"] >= 1
    st_off = gtscript.stencil(
        backend="numpy", externals={"LIM": 0.01}, disable_passes=("numpy_stage_tiling",)
    )(hdiff_defs)
    rec_off = next(r for r in st_off.pass_report if r["pass"] == "numpy_stage_tiling")
    assert not rec_off["changed"] and rec_off["detail"]["enabled"] is False
    st_pin = gtscript.stencil(backend="numpy", externals={"LIM": 0.01}, tile=(16, 32))(hdiff_defs)
    assert len({st.fingerprint, st_off.fingerprint, st_pin.fingerprint}) == 3


# ---------------------------------------------------------------------------
# pass invariants: idempotence + pipeline fixpoint
# ---------------------------------------------------------------------------


def _invariant_impls():
    return [
        _impls(hdiff_defs, externals={"LIM": 0.01}, name="hdiff"),
        _impls(vadv_defs, name="vadv"),
        _impls(vadv_system_defs, name="vadv_system"),
        _impls(vadv_boundary_defs, name="vadv_boundary"),
        _impls(vintg_defs, name="vintg"),
    ]


@pytest.mark.parametrize("name", [p.name for p in passes.PIPELINE])
def test_each_pass_is_idempotent(name):
    assert [p.name for p in passes.PIPELINE] == [p.name for p in r_passes.PIPELINE]
    pass_obj = next(p for p in passes.PIPELINE if p.name == name)
    r_pass = next(p for p in r_passes.PIPELINE if p.name == name)
    for r_impl, impl in _invariant_impls():
        ctx, r_ctx = passes.PassContext(), r_passes.PassContext()
        once, r_once = pass_obj(impl, ctx), r_pass(r_impl, r_ctx)
        assert repr(once) == repr(r_once), f"{name} differs from the reference's on {impl.name}"
        twice = pass_obj(once, ctx)
        assert twice == once, f"{name} is not idempotent on {impl.name}"


def test_full_pipeline_converges():
    """Re-running the whole pipeline reaches a fixpoint after at most one
    extra iteration (cross_stage_cse runs after reassociation), as in the
    reference."""
    for r_impl, impl in _invariant_impls():
        r_opt, opt, _rep = _run(r_impl, impl)
        r_opt2, opt2, _rep = _run(r_opt, opt)
        _r3, opt3, report3 = _run(r_opt2, opt2)
        assert opt3 == opt2, f"pipeline does not converge on {impl.name}"
        assert not any(r["changed"] for r in report3)


def test_fingerprint_stable_iff_config_and_ir_stable():
    """Same definition and pass configuration → same fingerprint; any
    pass-configuration change → a new one, even where the optimized IR does
    not change."""
    from repro_torch.stencils.vadv import vadv_boundary_defs as defs

    for backend in ("numpy", "torch", "cuda"):
        a = gtscript.stencil(backend=backend)(defs)
        b = gtscript.stencil(backend=backend)(defs)
        assert a.fingerprint == b.fingerprint
        c = gtscript.stencil(backend=backend, disable_passes=("constant_folding",))(defs)
        assert c.fingerprint != a.fingerprint
    # constant_folding never fires on this stencil: the optimized IR is the
    # same with it disabled, in both packages
    r_impl, impl = _impls(defs, name="vadv_boundary")
    _r, with_fold, _rep = _run(r_impl, impl)
    _r, without_fold, _rep = _run(r_impl, impl, disable=("constant_folding",))
    assert with_fold == without_fold


# ---------------------------------------------------------------------------
# fuzzer-found regressions
# ---------------------------------------------------------------------------


def test_parallel_interval_merging_respects_vertical_deps():
    """Two PARALLEL intervals with identical bodies where a stage reads
    another stage's write one level up: merging them would let the reader
    observe planes the interval-by-interval order had not yet written.  The
    ``cuda`` backend builds it (each interval runs as two k-sweeps) and holds
    the oracle."""
    _impl, opt, _rep = _pipeline(cases.interval_merging_vertical_defs)
    assert sum(len(ms.intervals) for ms in opt.multi_stages) == 2
    run_case(cases.BY_NAME["interval_merging_vertical"])
    for lvl in (0, 3):
        st = gtscript.stencil("cuda", opt_level=lvl, block=cases.BLOCK)(cases.interval_merging_vertical_defs)
        assert st.kernel.module.SCHEDULE["parallel_sweeps"] == {0: [2, 2]}


def test_min_k_levels_accounts_for_boundary_interval_disjointness():
    """interval(0, 1) + interval(-1, None) are only disjoint for nk >= 2:
    at nk == 1 both would execute the same level."""

    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD):
            with interval(0, 1):
                o = a * 2.0
            with interval(-1, None):
                o = a * 3.0

    impl = _analyze(defs)
    assert impl.min_k_levels == 2
    x = _rand((NI, NJ, 1), seed=38)
    for backend in ("numpy", "torch", "cuda"):
        st = gtscript.stencil(backend=backend)(defs)
        dev = None if backend == "numpy" else "cpu"
        a = storage.from_array(x, backend=backend, device=dev)
        o = storage.zeros(x.shape, backend=backend, device=dev)
        with pytest.raises(ValueError, match="vertical levels"):
            st(a, o, domain=(NI, NJ, 1))



# ---------------------------------------------------------------------------
# every stencil the card runs, against the reference's oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.BY_NAME))
def test_every_card_case_matches_the_reference_oracle(name):
    """Each case of ``torch_stencil_cases`` (the stencils that ``chip_smoke.py``
    path M2 and ``test_torch_dsl_gpu.py`` launch on the card against the port's
    ``debug`` backend) through every port variant, held against the
    reference's ``debug`` oracle: so the card's oracle is the reference's on
    these inputs, the vertical-dependency cases included."""
    run_case(cases.BY_NAME[name])
