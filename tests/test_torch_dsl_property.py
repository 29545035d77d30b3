"""The port's backends on the stencil corpus, against the reference's oracle:
the mirror of ``tests/test_dsl_property.py``.

Every corpus program (``tests/corpus/prog_*.json``, read by the port's own
``ir_json``) runs through the port's matrix: ``debug``; ``numpy`` at opt
levels 0-3, with each pass of ``passes.ALL_PASS_NAMES`` disabled in turn and
at ``tile=(3, 2)``; ``torch`` at levels 0, 3 and 2 or 1; ``cuda`` (its plain
module on CPU tensors) at levels 0, 3 and 1 or 2 with ``block=(4, 4)``,
where the reference's Pallas leg runs; ``numpy`` with ``exact=False``.  Each
is held against the reference's ``debug`` backend at ``opt_level=0`` on the
same inputs, random initial outputs included: ``debug`` and ``numpy`` bit
for bit, ``torch`` and ``cuda`` within 1e-12, ``exact=False`` within 1e-12.

Beside the corpus: programs seeded here with a temporary written and read
one plane up and down inside one PARALLEL interval (alone and with a
horizontal offset), which the ``cuda`` backend runs as consecutive k-sweeps;
the hypothesis fuzzer over the port's backends; the two IR-level property
tests; and the halo-extent invariant.
"""

import json

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

import corpus_gen
import torch_stencil_cases as cases
from corpus_gen import Leaf, _assign, _definition, _interval, gen_expr
from repro.core import ir as r_ir
from repro.core import storage as r_storage
from repro.core.stencil import build_from_definition as r_build
from repro_torch.core import ir, ir_json, passes, storage
from repro_torch.core.stencil import build_from_definition

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - the suite collects without hypothesis
    HAVE_HYPOTHESIS = False

NI, NJ, NK = 8, 7, 5
HALO = 6  # offsets up to ±2 chained through two temporaries

CORPUS = sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))


# ---------------------------------------------------------------------------
# the backend-differential corpus runner
# ---------------------------------------------------------------------------


def _corpus_data(defn, seed: int):
    """Random inputs and random initial outputs (which catch clobbered
    unwritten planes), as the reference's ``_corpus_data``."""
    cn, cj, ck = corpus_gen.NI, corpus_gen.NJ, corpus_gen.NK
    shape = (cn + 2 * corpus_gen.HALO, cj + 2 * corpus_gen.HALO, ck)
    rng = np.random.default_rng(seed)
    data = {f.name: rng.normal(size=shape) for f in defn.api_fields if f.is_api}
    return data, float(rng.normal())


def _fields(data, backend, package_storage):
    halo = corpus_gen.HALO
    dev = {"device": "cpu"} if backend in ("torch", "cuda") else {}
    return {n: package_storage.from_array(a.copy(), backend=backend, default_origin=(halo, halo, 0), **dev)
            for n, a in data.items()}


def _oracle(r_defn, data, scalar):
    """The reference's debug backend at opt_level 0: the written outputs."""
    st_obj = r_build(r_defn, "debug", backend_opts={"opt_level": 0})
    fields = _fields(data, "debug", r_storage)
    st_obj(**fields, s=np.float64(scalar), domain=(corpus_gen.NI, corpus_gen.NJ, corpus_gen.NK))
    written = set(st_obj.implementation_ir.written_api_fields())
    return {n: f.to_numpy() for n, f in fields.items() if n in written}


def _run_config(defn, backend, opts, data, scalar):
    """One port configuration: the written outputs."""
    st_obj = build_from_definition(defn, backend, backend_opts=dict(opts))
    fields = _fields(data, backend, storage)
    st_obj(**fields, s=np.float64(scalar), domain=(corpus_gen.NI, corpus_gen.NJ, corpus_gen.NK))
    assert st_obj.launches == 0  # CPU tensors run the plain module
    written = set(st_obj.implementation_ir.written_api_fields())
    return {n: f.to_numpy() for n, f in fields.items() if n in written}


def _differential_configs(index: int, with_cuda: bool, thorough: bool = True):
    """The reference's per-program matrix on the port's backends: jax →
    torch, pallas → cuda (at the Pallas leg's block and levels)."""
    cfgs = [("debug@default", "debug", {})]
    for lvl in (0, 1, 2, 3):
        cfgs.append((f"numpy@{lvl}", "numpy", {"opt_level": lvl}))
    if thorough:
        for p in passes.ALL_PASS_NAMES:
            cfgs.append((f"numpy@3-no-{p}", "numpy", {"disable_passes": (p,)}))
        # the corpus domain fits inside the default tile: a small pinned tile
        # puts tile boundaries inside it
        cfgs.append(("numpy@3-tile(3,2)", "numpy", {"tile": (3, 2)}))
    torch_levels = (0, 3, 2 if index % 2 == 0 else 1) if thorough else (0, 3)
    for lvl in torch_levels:
        cfgs.append((f"torch@{lvl}", "torch", {"opt_level": lvl}))
    if with_cuda:
        for lvl in cases.corpus_levels(index) if thorough else (3,):
            cfgs.append((f"cuda@{lvl}", "cuda", {"opt_level": lvl, "block": cases.BLOCK}))
    return cfgs


def _assert_matches_oracle(name, key, backend, got, oracle):
    """debug and numpy run the oracle's IEEE operations: bit for bit.  torch
    and cuda within 1e-12, as the reference holds its XLA legs."""
    assert got.keys() == oracle.keys(), f"{name}/{key}: written-output set differs"
    for n in oracle:
        if backend in ("debug", "numpy"):
            np.testing.assert_array_equal(got[n], oracle[n], err_msg=f"{name}: {key} is not bit-identical on {n!r}")
        else:
            np.testing.assert_allclose(got[n], oracle[n], rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}: {key} disagrees with the oracle on {n!r}")


def _as_reference(defn):
    return corpus_gen.definition_from_json(ir_json.definition_to_json(defn))


def _assert_differential(defn, seed: int, index: int, thorough: bool = True):
    """``defn``, the port's Definition IR, through the matrix."""
    data, scalar = _corpus_data(defn, seed)
    oracle = _oracle(_as_reference(defn), data, scalar)
    assert oracle, f"{defn.name}: no written outputs"
    for key, backend, opts in _differential_configs(index, ir_json.pallas_compatible(defn), thorough):
        got = _run_config(defn, backend, opts, data, scalar)
        _assert_matches_oracle(defn.name, key, backend, got, oracle)
    # exact=False allows reassociation: allclose, not bit-identity
    got = _run_config(defn, "numpy", {"exact": False}, data, scalar)
    for n in oracle:
        np.testing.assert_allclose(got[n], oracle[n], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{defn.name}: exact=False drifted beyond reassociation on {n!r}")


def test_corpus_is_committed_and_deterministic():
    """The port reads every committed program as the reference's generator
    made it, and writes it back byte for byte."""
    assert len(CORPUS) >= corpus_gen.N_PROGRAMS
    generated = corpus_gen.make_corpus()
    for path in CORPUS:
        defn = ir_json.load_program(path)
        assert repr(defn) == repr(generated[path.stem]), f"{path.name} drifted from its seed"
        assert ir_json.definition_to_json(defn) == json.loads(path.read_text())


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_corpus_backend_differential(path):
    index = int(path.stem.split("_")[1])
    _assert_differential(ir_json.load_program(path), seed=index, index=index)


# ---------------------------------------------------------------------------
# a temporary written and read one plane up and down inside one PARALLEL interval
# ---------------------------------------------------------------------------

START, END = r_ir.LevelMarker.START, r_ir.LevelMarker.END


def _vertical_program(seed: int, horizontal: bool, interior: bool):
    """``t1`` from the inputs; ``t2`` reads ``t1`` one plane up; ``out1``
    reads ``t2`` one plane down: one PARALLEL interval (the whole column, or
    its interior), random expressions drawn from ``seed``.  ``horizontal``
    adds offsets of one point to the vertical reads."""
    rng = np.random.default_rng(seed)
    h = 1 if horizontal else 0
    up = r_ir.FieldAccess("t1", (h, 0, 1))
    down = r_ir.FieldAccess("t2", (0, -h, -1))
    body = [
        _assign("t1", gen_expr(rng, [Leaf("in1"), Leaf("in2")], 2)),
        _assign("t2", r_ir.BinOp("*", up, gen_expr(rng, [Leaf("t1", h=h, dk=(-1, 0, 1)), Leaf("in1")], 1))),
        _assign("out1", r_ir.BinOp("+", down, gen_expr(rng, [Leaf("t2", h=h, dk=(-1, 0, 1)), Leaf("in2")], 1))),
    ]
    lo, hi = (r_ir.AxisBound(START, 1), r_ir.AxisBound(END, -1)) if interior else (
        r_ir.AxisBound(START), r_ir.AxisBound(END))
    comp = r_ir.ComputationBlock(r_ir.IterationOrder.PARALLEL, (_interval(lo, hi, body),))
    defn = _definition(f"vertical_{seed}", [comp])
    return ir_json.definition_from_json(corpus_gen.definition_to_json(defn))


VERTICAL = [(seed, seed % 2 == 1, seed >= 2) for seed in range(4)]


@pytest.mark.parametrize("seed,horizontal,interior", VERTICAL)
def test_vertical_dependency_in_one_parallel_interval(seed, horizontal, interior):
    defn = _vertical_program(seed, horizontal, interior)
    _assert_differential(defn, seed=100 + seed, index=seed)
    # the cuda kernel runs the interval as consecutive k-sweeps, t2's after
    # t1's, and t1 crosses them in full per-block scratch
    for lvl in cases.corpus_levels(seed):
        st_obj = build_from_definition(defn, "cuda", backend_opts={"opt_level": lvl, "block": cases.BLOCK})
        sched = st_obj.kernel.module.SCHEDULE
        ((sweeps,),) = sched["parallel_sweeps"].values()
        assert sweeps >= 2 and sched["temporaries"]["t1"] == "full", sched


# ---------------------------------------------------------------------------
# the hypothesis fuzzer (optional dependency; the corpus above is the floor)
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:

    @settings(max_examples=10, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.integers(0, len(corpus_gen.TEMPLATES) - 1))
    def test_fuzz_random_programs_backend_differential(seed, template):
        rng = np.random.default_rng(seed)
        r_defn = corpus_gen.make_program(rng, f"fuzz_t{template}", template=template)
        defn = ir_json.definition_from_json(corpus_gen.definition_to_json(r_defn))
        # the reference's lighter matrix per example, on the port's backends
        data, scalar = _corpus_data(defn, seed)
        oracle = _oracle(r_defn, data, scalar)
        configs = [
            ("numpy@0", "numpy", {"opt_level": 0}),
            ("numpy@3", "numpy", {}),
            ("numpy@3-no-interval_splitting", "numpy", {"disable_passes": ("interval_splitting",)}),
            ("numpy@3-no-algebraic_reassociation", "numpy", {"disable_passes": ("algebraic_reassociation",)}),
            ("numpy@3-no-numpy_stage_tiling", "numpy", {"disable_passes": ("numpy_stage_tiling",)}),
            ("torch@3", "torch", {}),
        ]
        if ir_json.pallas_compatible(defn):
            configs.append(("cuda@3", "cuda", {"block": cases.BLOCK}))
        for key, backend, opts in configs:
            got = _run_config(defn, backend, opts, data, scalar)
            _assert_matches_oracle(f"{defn.name}(seed={seed})", key, backend, got, oracle)


# ---------------------------------------------------------------------------
# IR-level property strategies
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    _offsets = st.tuples(st.integers(-2, 2), st.integers(-2, 2), st.just(0))

    def _exprs(depth: int, names):
        """Expression trees over ``names`` (field reads), in the port's IR."""
        leaf = st.one_of(
            st.builds(ir.FieldAccess, st.sampled_from(names), _offsets),
            st.builds(ir.Literal, st.floats(-2.0, 2.0, allow_nan=False), st.just("float")),
            st.just(ir.ScalarRef("s")),
        )
        if depth == 0:
            return leaf
        sub = _exprs(depth - 1, names)
        return st.one_of(
            leaf,
            st.builds(ir.BinOp, st.sampled_from(["+", "-", "*"]), sub, sub),
            st.builds(lambda a, b: ir.NativeCall("min", (a, b)), sub, sub),
            st.builds(lambda a, b: ir.NativeCall("max", (a, b)), sub, sub),
            st.builds(lambda a: ir.UnaryOp("-", a), sub),
            st.builds(lambda a: ir.NativeCall("abs", (a,)), sub),
            st.builds(lambda c, a, b: ir.TernaryOp(ir.BinOp(">", c, ir.Literal(0.0, "float")), a, b), sub, sub, sub),
        )

    @st.composite
    def parallel_stencils(draw):
        """A random PARALLEL stencil: t1 = f(in1, in2); t2 = g(in1, t1); out = h(t1, t2, in2)."""
        body = (
            ir.Assign(ir.FieldAccess("t1", (0, 0, 0)), draw(_exprs(2, ["in1", "in2"]))),
            ir.Assign(ir.FieldAccess("t2", (0, 0, 0)), draw(_exprs(2, ["in1", "t1"]))),
            ir.Assign(ir.FieldAccess("out", (0, 0, 0)), draw(_exprs(1, ["t1", "t2", "in2"]))),
        )
        comp = ir.ComputationBlock(order=ir.IterationOrder.PARALLEL,
                                   intervals=(ir.IntervalBlock(ir.VerticalInterval.full(), body),))
        return ir.StencilDefinition(
            name="prop_stencil",
            api_fields=(ir.FieldDecl("in1", "float64"), ir.FieldDecl("in2", "float64"), ir.FieldDecl("out", "float64"),
                        ir.FieldDecl("t1", "float64", is_api=False), ir.FieldDecl("t2", "float64", is_api=False)),
            scalars=(ir.ScalarDecl("s", "float64"),),
            computations=(comp,),
        )

    def _ir_property_run(defn, arrays, scalar):
        """The reference's debug oracle and the port's debug, numpy, torch
        and cuda backends on ``arrays``: the interior of each output."""
        r_defn = _as_reference(defn)
        results = {}
        for backend in ("oracle", "debug", "numpy", "torch", "cuda"):
            if backend == "oracle":
                st_obj, pkg, be = r_build(r_defn, "debug"), r_storage, "debug"
            else:
                opts = {"block": cases.BLOCK} if backend == "cuda" else {}
                st_obj, pkg, be = build_from_definition(defn, backend, backend_opts=opts), storage, backend
            dev = {"device": "cpu"} if be in ("torch", "cuda") else {}
            fields = {n: pkg.from_array(a.copy(), backend=be, default_origin=(HALO, HALO, 0), **dev)
                      for n, a in arrays.items()}
            st_obj(**fields, s=np.float64(scalar), domain=(NI, NJ, NK))
            results[backend] = {n: f.to_numpy()[HALO:HALO + NI, HALO:HALO + NJ, :] for n, f in fields.items()}
        return results

    @settings(max_examples=40, deadline=None)
    @given(parallel_stencils(), st.integers(0, 2**31 - 1))
    def test_random_parallel_stencils_backends_agree(defn, seed):
        rng = np.random.default_rng(seed)
        shape = (NI + 2 * HALO, NJ + 2 * HALO, NK)
        arrays = {"in1": rng.normal(size=shape), "in2": rng.normal(size=shape), "out": np.zeros(shape)}
        results = _ir_property_run(defn, arrays, float(rng.normal()))
        for backend in ("debug", "numpy", "torch", "cuda"):
            np.testing.assert_allclose(results[backend]["out"], results["oracle"]["out"], rtol=1e-12, atol=1e-12,
                                       err_msg=backend)

    @st.composite
    def sequential_stencils(draw):
        """Random FORWARD accumulation: acc = f(in1) + w·acc[k−1] on interval [1, None)."""
        e_init = draw(_exprs(1, ["in1"]))
        e_step = draw(_exprs(1, ["in1"]))
        w = draw(st.floats(-0.9, 0.9, allow_nan=False))
        body0 = (ir.Assign(ir.FieldAccess("acc", (0, 0, 0)), e_init),)
        body1 = (ir.Assign(ir.FieldAccess("acc", (0, 0, 0)),
                           ir.BinOp("+", e_step, ir.BinOp("*", ir.Literal(w, "float"),
                                                          ir.FieldAccess("acc", (0, 0, -1))))),)
        comp = ir.ComputationBlock(
            order=ir.IterationOrder.FORWARD,
            intervals=(
                ir.IntervalBlock(ir.VerticalInterval(ir.AxisBound(ir.LevelMarker.START, 0),
                                                     ir.AxisBound(ir.LevelMarker.START, 1)), body0),
                ir.IntervalBlock(ir.VerticalInterval(ir.AxisBound(ir.LevelMarker.START, 1),
                                                     ir.AxisBound(ir.LevelMarker.END, 0)), body1),
            ),
        )
        return ir.StencilDefinition(
            name="prop_seq",
            api_fields=(ir.FieldDecl("in1", "float64"), ir.FieldDecl("acc", "float64")),
            scalars=(ir.ScalarDecl("s", "float64"),),
            computations=(comp,),
        )

    @settings(max_examples=25, deadline=None)
    @given(sequential_stencils(), st.integers(0, 2**31 - 1))
    def test_random_sequential_stencils_backends_agree(defn, seed):
        rng = np.random.default_rng(seed)
        shape = (NI + 2 * HALO, NJ + 2 * HALO, NK)
        results = _ir_property_run(defn, {"in1": rng.normal(size=shape), "acc": np.zeros(shape)}, 0.0)
        for backend in ("debug", "numpy", "torch", "cuda"):
            np.testing.assert_allclose(results[backend]["acc"], results["oracle"]["acc"], rtol=1e-12, atol=1e-12,
                                       err_msg=backend)


def test_extent_invariant_outputs_independent_of_extra_halo():
    """Enlarging the storage halo beyond the required extent never changes
    the interior result, on the port's numpy, torch and cuda backends, and
    the result is the reference's."""
    from repro.stencils.hdiff import build_hdiff as r_build_hdiff
    from repro_torch.stencils.hdiff import build_hdiff

    rng = np.random.default_rng(0)
    ni, nj, nk = 10, 9, 3
    core = rng.normal(size=(ni + 12, nj + 12, nk))  # big enough for halo 6
    ref = None
    for backend in ("numpy", "torch", "cuda"):
        st_obj = build_hdiff(backend)
        dev = {"device": "cpu"} if backend != "numpy" else {}
        outs = []
        for halo in (3, 5, 6):
            lo = 6 - halo
            data = core[lo:lo + ni + 2 * halo, lo:lo + nj + 2 * halo, :]
            i = storage.from_array(data.copy(), backend=backend, default_origin=(halo, halo, 0), **dev)
            o = storage.zeros(data.shape, backend=backend, default_origin=(halo, halo, 0), **dev)
            st_obj(i, o, alpha=np.float64(0.05), domain=(ni, nj, nk))
            outs.append(o.to_numpy()[halo:halo + ni, halo:halo + nj, :])
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-13)
        np.testing.assert_allclose(outs[0], outs[2], rtol=1e-13)
        if ref is None:
            i = r_storage.from_array(core[3:3 + ni + 6, 3:3 + nj + 6, :].copy(), default_origin=(3, 3, 0))
            o = r_storage.zeros(i.shape, default_origin=(3, 3, 0))
            r_build_hdiff("numpy")(i, o, alpha=np.float64(0.05), domain=(ni, nj, nk))
            ref = o.to_numpy()[3:3 + ni, 3:3 + nj, :]
        np.testing.assert_allclose(outs[0], ref, rtol=1e-12, atol=1e-12, err_msg=backend)
