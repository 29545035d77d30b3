"""The port's kernel entry points and its CUDA code generator, on the CPU.

``ops.hdiff``/``ops.vadv`` on CPU tensors run the plain torch module of the
generated stencil; they are held against the reference's Pallas kernels, run
as ``tests/test_kernels.py`` runs them (interpret mode, small blocks).  The
generated CUDA source cannot compile here, so it is checked as text and
through its schedule metadata; ``test_torch_gpu.py`` launches it on a card.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import json
import re

import jax.numpy as jnp
import numpy as np
import torch

import corpus_gen
import torch_stencil_cases as stencil_cases
from repro.core.stencil import build_from_definition as r_build
from repro.kernels.hdiff.ops import hdiff as r_hdiff_op
from repro.kernels.hdiff.ref import hdiff_ref as r_hdiff_ref
from repro.kernels.vadv.ops import vadv as r_vadv_op
from repro.kernels.vadv.ref import vadv_ref as r_vadv_ref
from repro_torch.core import analysis, codegen_cuda, gtscript, ir, ir_json, passes
from repro_torch.core.gtscript import (BACKWARD, FORWARD, IJ, K, PARALLEL, Field, GTScriptSemanticError,
                                      computation, interval)
from repro_torch.core.stencil import build_from_definition as t_build
from repro_torch.kernels.hdiff.ops import hdiff
from repro_torch.kernels.hdiff.ref import hdiff_ref
from repro_torch.kernels.vadv.ops import vadv
from repro_torch.kernels.vadv.ref import vadv_ref
from repro_torch.stencils import forecast, hdiff as t_hdiff, vadv as t_vadv, vintg as t_vintg
from torch_mirror import run_case


def _tridiagonal(shape, seed, off=0.1, diag=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * off, diag + rng.random(shape), rng.normal(size=shape) * off,
            rng.normal(size=shape))


@pytest.mark.parametrize("shape", [(12, 12, 4), (17, 23, 7)])
def test_hdiff_op_matches_reference_kernel(shape):
    ni, nj, nk = shape
    x = np.random.default_rng(11).normal(size=(ni + 6, nj + 6, nk))
    ref = np.asarray(r_hdiff_op(jnp.asarray(x), 0.05, block=(4, 8)))
    got = hdiff(torch.from_numpy(x), 0.05)
    assert got.shape == x.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)
    np.testing.assert_allclose(hdiff_ref(torch.from_numpy(x), 0.05).numpy(),
                               np.asarray(r_hdiff_ref(jnp.asarray(x), 0.05)), atol=1e-12)


@pytest.mark.parametrize("shape", [(6, 6, 8), (5, 9, 17)])
def test_vadv_op_matches_reference_kernel(shape):
    a, b, c, d = _tridiagonal(shape, 0)
    ref = np.asarray(r_vadv_op(*(jnp.asarray(v) for v in (a, b, c, d)), block=(4, 4)))
    got = vadv(*(torch.from_numpy(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    np.testing.assert_allclose(vadv_ref(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy(),
                               np.asarray(r_vadv_ref(*(jnp.asarray(v) for v in (a, b, c, d)))), atol=1e-10)


@pytest.mark.parametrize("nk", [2, 3, 7, 12])
def test_vadv_op_solves_the_system(nk):
    a, b, c, d = _tridiagonal((3, 4, nk), nk, off=0.2, diag=3.0)
    x = vadv(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy()
    resid = b * x - d
    resid[..., 1:] += a[..., 1:] * x[..., :-1]
    resid[..., :-1] += c[..., :-1] * x[..., 1:]
    assert np.max(np.abs(resid)) < 1e-8


# ---------------------------------------------------------------------------
# the generated CUDA source
# ---------------------------------------------------------------------------

SOURCES = {
    "hdiff": lambda: t_hdiff.build_hdiff("cuda"),
    "hdiff_smag": lambda: t_hdiff.build_hdiff_smag("cuda"),
    "vadv": lambda: t_vadv.build_vadv("cuda"),
    "vadv_system": lambda: t_vadv.build_vadv_system("cuda"),
    "vadv_boundary": lambda: t_vadv.build_vadv_boundary("cuda"),
    "vintg": lambda: t_vintg.build_vintg("cuda"),
    "advect": lambda: gtscript.stencil("cuda")(forecast.advect_defs),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_one_kernel_per_stencil_with_a_c_entry(name):
    st = SOURCES[name]()
    src = st.generated_source
    assert src.count("__global__") == 1
    assert st.kernel.module.KERNEL in src and 'extern "C" int launch_' in src
    assert "return (int)cudaGetLastError();" in src
    assert "repro/core/codegen_pallas.py" in src  # says which TPU kernel it replaces
    bi, bj = st.kernel.module.BLOCK
    assert st.kernel.module._smem_bytes(bi, bj) == st.kernel.module.SMEM_BYTES
    assert st.kernel.module._smem_bytes(2 * bi, bj) >= st.kernel.module.SMEM_BYTES
    assert st.kernel.module.SMEM_BYTES <= codegen_cuda.SMEM_DEFAULT_LIMIT


def test_windowed_and_full_carries_have_their_storage():
    sched = t_vintg.build_vintg("cuda").kernel.module.SCHEDULE
    assert set(sched["temporaries"].values()) == {"window"}
    sched = t_vadv.build_vadv("cuda").kernel.module.SCHEDULE
    assert sched["temporaries"]["cp"] == sched["temporaries"]["dp"] == "full"
    sched = t_hdiff.build_hdiff("cuda").kernel.module.SCHEDULE
    assert sched["staged_inputs"] == ["in_phi[k+0]"]


def _schedule_cases():
    cases = [(n, None) for n in ("hdiff", "vadv", "vintg", "vadv_boundary", "vadv_system")]
    cases += [(p.stem, p) for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))
              if corpus_gen.pallas_compatible(corpus_gen.load_program(p))]
    return cases


@pytest.mark.parametrize("name,path", _schedule_cases(), ids=[c[0] for c in _schedule_cases()])
def test_schedule_matches_reference_pallas_module(name, path):
    if path is None:
        from repro.stencils import hdiff as rh, vadv as rv, vintg as ri

        ref = {"hdiff": lambda: rh.build_hdiff("pallas"), "vadv": lambda: rv.build_vadv("pallas"),
               "vintg": lambda: ri.build_vintg("pallas"), "vadv_boundary": lambda: rv.build_vadv_boundary("pallas"),
               "vadv_system": lambda: rv.build_vadv_system("pallas")}[name]()
        st = SOURCES[name]()
    else:
        ref = r_build(corpus_gen.load_program(path), "pallas")
        st = t_build(ir_json.load_program(path), "cuda")
    for key in ("halo", "dma_inputs", "dma_first_use_ms", "sweeps", "full_carry_fields",
                "window_fields", "window_planes"):
        assert st.kernel.module.SCHEDULE[key] == ref._module.SCHEDULE[key], key


def test_written_api_field_read_at_offset_is_rejected():
    path = corpus_gen.CORPUS_DIR / "prog_07.json"  # the api-feedback template
    assert not corpus_gen.pallas_compatible(corpus_gen.load_program(path))
    with pytest.raises(GTScriptSemanticError, match="horizontal offset"):
        t_build(ir_json.load_program(path), "cuda")
    t_build(ir_json.load_program(path), "torch")  # the plain backends take it


_REJECTED = [p for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))
             if not corpus_gen.pallas_compatible(corpus_gen.load_program(p))]


@pytest.mark.parametrize("path", _REJECTED, ids=[p.stem for p in _REJECTED])
def test_cuda_rejects_the_corpus_programs_pallas_rejects(path):
    """The schedule test builds every Pallas-compatible program for cuda; the
    rest are rejected by the same limit, and the port's copy of the criterion
    agrees with the reference's."""
    assert not ir_json.pallas_compatible(ir_json.load_program(path))
    with pytest.raises(GTScriptSemanticError, match="horizontal offset"):
        t_build(ir_json.load_program(path), "cuda", backend_opts={"opt_level": 3})


def test_pallas_compatible_copy_agrees_with_the_reference():
    for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json")):
        assert ir_json.pallas_compatible(ir_json.load_program(p)) == \
            corpus_gen.pallas_compatible(corpus_gen.load_program(p)), p.stem


def test_module_launch_counts_are_read_from_the_live_kernels():
    st = t_vintg.build_vintg("cuda")
    key = st.kernel.key
    before = codegen_cuda.launch_counts().get(key, 0)
    st.launches = 3  # what three launches on a card would leave
    assert codegen_cuda.launch_counts()[key] == before + 3
    codegen_cuda.reset_launch_counts()
    assert st.launches == 0 and codegen_cuda.launch_counts()[key] == 0


def k_out_defs(a: Field[np.float64], out: Field[np.float64, K]):
    with computation(PARALLEL), interval(...):
        out = a[0, 0, 0]


def test_k_axis_output_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="K-field output"):
        gtscript.stencil("cuda")(k_out_defs)


def test_vertical_read_of_a_field_written_in_the_same_parallel_interval_builds():
    """``t`` is written and read one plane up inside one PARALLEL interval:
    the kernel runs the interval as two k-sweeps, ``t`` crosses them in full
    per-block scratch, and the plain module holds the reference's oracle."""
    for lvl in (0, 3):
        st = gtscript.stencil("cuda", opt_level=lvl)(stencil_cases.temp_vertical_defs)
        module = st.kernel.module
        assert module.SCHEDULE["parallel_sweeps"] == {0: [2]}
        assert module.SCHEDULE["temporaries"] == {"t": "full"}
        assert [name for name, *_ in module.SCRATCH] == ["t"]
    run_case(stencil_cases.BY_NAME["temp_vertical"])


@pytest.mark.parametrize("case, zeroed", [
    ("interval_merging_vertical", {"t": True}),  # read a plane up before the later interval writes it
    ("temp_above_and_below", {"t": False}),  # the first sweep writes every plane
    ("temp_vertical", {"t": True}),  # the top plane is never written
    ("vertical_flux_divergence", {"flux": True}),  # flux leaves plane 0; the k-walk keeps wf in registers
])
def test_full_temporaries_are_zeroed_where_a_plane_is_read_before_written(case, zeroed):
    """The kernel zeroes a full temporary's scratch where its order may read
    a plane of the domain no stage has written yet (the reference's
    temporary reads 0 there), and only there."""
    st = gtscript.stencil("cuda", block=stencil_cases.BLOCK)(stencil_cases.BY_NAME[case].defs)
    plan = codegen_cuda._Plan(st.implementation_ir, stencil_cases.BLOCK)
    assert {n: t.zero_all for n, t in plan.temps.items() if t.kind == "full"} == zeroed


def _reads_an_unwritten_plane(impl, name, nk):
    """The reference's interval-by-interval order run level by level at
    ``nk``: whether a read of ``name`` finds a plane of the domain that no
    stage has written yet."""
    written = set()
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            k0, k1 = itv.interval.resolve(nk)
            levels = range(k1 - 1, k0 - 1, -1) if ms.order == ir.IterationOrder.BACKWARD else range(k0, k1)
            for k in levels:
                for st in itv.stages:
                    for stmt in st.stmts:
                        if any(n == name and 0 <= k + off[2] < nk and k + off[2] not in written
                               for n, off in ir.stmt_reads(stmt)):
                            return True
                        if name in ir.stmt_writes(stmt):
                            written.add(k)
    return False


def _vertical_program(rng, name, orders=3, init=0.5):
    """A random definition (the reference's IR): one to three PARALLEL,
    FORWARD or BACKWARD computations (the first ``orders`` of these), each
    split at the column's ends, whose statements read the temporaries one
    plane up and down; a share ``init`` of them start by writing both
    temporaries over the whole column."""
    from repro.core import ir as r_ir

    s, e = r_ir.LevelMarker.START, r_ir.LevelMarker.END
    splits = [[(s, 0, e, 0)], [(s, 0, s, 1), (s, 1, e, 0)], [(s, 0, e, -1), (e, -1, e, 0)],
              [(s, 0, s, 1), (s, 1, e, -1), (e, -1, e, 0)], [(s, 1, e, 0)], [(s, 0, e, -1)]]
    orders = (r_ir.IterationOrder.PARALLEL, r_ir.IterationOrder.FORWARD, r_ir.IterationOrder.BACKWARD)[:orders]
    leaves = [corpus_gen.Leaf("in1", h=1, dk=(-1, 0, 1)), corpus_gen.Leaf("t1", h=1, dk=(-1, 0, 1)),
              corpus_gen.Leaf("t2", h=0, dk=(-1, 0, 1))]
    comps = []
    for _ in range(rng.integers(1, 4)):
        order = orders[rng.integers(len(orders))]
        ivs = splits[rng.integers(len(splits))]
        blocks = [corpus_gen._interval(r_ir.AxisBound(a, ao), r_ir.AxisBound(b, bo),
                                       [corpus_gen._assign(("t1", "t2", "out1")[rng.integers(3)],
                                                           corpus_gen.gen_expr(rng, leaves, 2))
                                        for _ in range(rng.integers(1, 4))])
                  for a, ao, b, bo in (ivs[::-1] if order == r_ir.IterationOrder.BACKWARD else ivs)]
        comps.append(r_ir.ComputationBlock(order, tuple(blocks)))
    if rng.random() < init:
        init = [corpus_gen._assign(t, corpus_gen.gen_expr(rng, leaves[:1], 1)) for t in ("t1", "t2")]
        comps.insert(0, r_ir.ComputationBlock(r_ir.IterationOrder.PARALLEL, (
            corpus_gen._interval(r_ir.AxisBound(s, 0), r_ir.AxisBound(e, 0), init),)))
    return corpus_gen._definition(name, comps)


def test_full_temporaries_are_zeroed_wherever_the_kernel_order_reads_an_unwritten_plane():
    """The zeroing rule against the reference's order run level by level at
    every ``nk`` up to 12, over the cases and random programs that read
    temporaries one plane up and down in every iteration order: no full
    temporary that the order reads before writing goes unzeroed, and no
    temporary a k-walk keeps on chip (which nothing zeroes) is read there
    before it is written.  The kernel's reads see the reference's writes
    (``test_k_walk_reads_see_the_reference_writes_*``)."""
    impls = [gtscript.stencil("cuda", externals=dict(c.externals), opt_level=lvl)(c.defs).implementation_ir
             for c in stencil_cases.CASES for lvl in (0, 3)]
    rng = np.random.default_rng(22)
    for seed in range(3000):
        d = _vertical_program(rng, f"v{seed}")
        try:
            impl = analysis.analyze(ir_json.definition_from_json(json.loads(json.dumps(
                corpus_gen.definition_to_json(d)))))
        except GTScriptSemanticError:
            continue  # a temporary read before its definition, or ahead of its sweep
        impls += [passes.run_pipeline(impl, opt_level=lvl)[0] for lvl in (0, 3)]
    read_unwritten = checked = 0
    for impl in impls:
        try:
            plan = codegen_cuda._Plan(impl, stencil_cases.BLOCK)
        except GTScriptSemanticError:
            continue
        for n, t in plan.temps.items():
            if t.kind in ("full", "ring", "plane_ring"):
                truth = any(_reads_an_unwritten_plane(plan.impl, n, nk)
                            for nk in range(max(2, plan.impl.min_k_levels), 13))
                assert (t.kind == "full" and t.zero_all) or not truth, (impl.name, n)
                read_unwritten += truth
                checked += 1
    assert read_unwritten >= 10 and checked >= 100


class _Order:
    """One order of a stencil's accesses at ``nk``, level by level: the write
    each read sees (``seen``, None where no stage has written the level),
    the last write of each level (``last``) and, for the kernel's order, the
    loop and step of each access (``when``).  A non-IJK field is one level."""

    def __init__(self, impl):
        self.flat = {f.name for f in impl.api_fields if f.axes != ir.AXES_IJK}
        self.label = {id(st): (mi, ii, si) for mi, ms in enumerate(impl.multi_stages)
                      for ii, itv in enumerate(ms.intervals) for si, st in enumerate(itv.stages)}
        self.seen, self.last, self.when, self.name = {}, {}, {}, {}

    def _touch(self, st, j, a, n, write, off, k, where):
        ev = (self.label[id(st)], j, a, k)
        lv = None if n in self.flat else k + off[2]
        if write:
            self.last[(n, lv)] = ev
        else:
            self.seen[ev] = self.last.get((n, lv))
        self.name[ev] = (n, off)
        if where is not None:
            self.when[ev] = where

    @staticmethod
    def _accesses(st):
        for j, stmt in enumerate(st.stmts):
            found = []
            codegen_cuda._stmt_accesses(stmt, False, found)
            yield j, found

    def stage(self, st, levels, where=None):
        """A stage over ``levels``: one level after the other (``where`` is
        the kernel's loop and step), or each access over all of them at once
        (the reference's PARALLEL stage, when ``levels`` is a range)."""
        for j, found in self._accesses(st):
            for a, (n, write, off, _masked) in enumerate(found):
                for k in levels:
                    self._touch(st, j, a, n, write, off, k, where)


def _reference_order(impl, nk):
    o = _Order(impl)
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            k0, k1 = itv.interval.resolve(nk)
            if ms.order == ir.IterationOrder.PARALLEL:
                for st in itv.stages:
                    o.stage(st, range(k0, k1))
                continue
            for k in (range(k1 - 1, k0 - 1, -1) if ms.order == ir.IterationOrder.BACKWARD else range(k0, k1)):
                for st in itv.stages:
                    o.stage(st, (k,))
    return o


def _kernel_order(plan, impl, nk):
    """The plan's loops run as the kernel runs them: a walk's step ``t``
    runs each unit at level ``t + shift`` where its interval holds it."""
    o = _Order(impl)
    for li, loop in enumerate(plan.loops):
        itvs = [plan.impl.multi_stages[u.mi].intervals[u.ii] for u in loop.units]
        spans = [itv.interval.resolve(nk) for itv in itvs]
        if plan.impl.multi_stages[loop.units[0].mi].order == ir.IterationOrder.BACKWARD:
            assert not loop.walk
            steps = range(spans[0][1] - 1, spans[0][0] - 1, -1)
        else:
            steps = range(min(lo - u.shift for u, (lo, _) in zip(loop.units, spans)),
                          max(hi - u.shift for u, (_, hi) in zip(loop.units, spans)))
        for t in steps:
            for u, itv, (lo, hi) in zip(loop.units, itvs, spans):
                if lo <= t + u.shift < hi:
                    for st in itv.stages:
                        o.stage(st, (t + u.shift,), where=(li, t))
    return o


def _hold_walks(impl):
    """The kernel's order against the reference's at every ``nk`` up to 12:
    every read sees the same (stage, level) write, every API level ends
    with the same write, every read a walk's register ring serves sees a
    write of that walk exactly its slot's steps before, and every read of a
    temporary a walk keeps in shared-memory planes a write of its walk at
    most ``depth`` steps before.  Returns the walks and the fields whose
    reads they keep on chip."""
    plan = codegen_cuda._Plan(impl, stencil_cases.BLOCK)
    api = {f.name for f in impl.api_fields}
    planes = {n: t for n, t in plan.temps.items() if t.kind == "plane_ring"}
    assert all(t.kind != "ring" or any(n in loop.rings for loop in plan.loops) for n, t in plan.temps.items())
    assert sorted({(u.mi, u.ii) for loop in plan.loops for u in loop.units}) == sorted(
        (mi, ii) for mi, ms in enumerate(plan.impl.multi_stages) for ii in range(len(ms.intervals)))
    for nk in range(max(1, impl.min_k_levels), 13):
        ref, ker = _reference_order(impl, nk), _kernel_order(plan, impl, nk)
        assert ker.seen == ref.seen, (impl.name, nk)
        assert {k: v for k, v in ker.last.items() if k[0] in api} == \
            {k: v for k, v in ref.last.items() if k[0] in api}, (impl.name, nk)
        for ev, src in ker.seen.items():
            (n, off), (lr, sr) = ker.name[ev], ker.when[ev]
            ring = plan.loops[lr].rings.get(n)
            lag = ring.served.get(ev[0] + (off[2],)) if ring is not None and off[:2] == (0, 0) else None
            if lag is not None:
                assert src is not None and ker.when[src] == (lr, sr - lag), (impl.name, nk, n, ev, src)
            if n in planes:
                (lw, sw) = ker.when[src]
                assert lr == lw and 0 <= sr - sw <= planes[n].depth, (impl.name, nk, n, ev, src)
    return sum(loop.walk for loop in plan.loops), len(planes) + sum(len(loop.rings) for loop in plan.loops)


_WALK_CASES = [(c.name, lvl) for c in stencil_cases.CASES for lvl in (0, 3)]


@pytest.mark.parametrize("name,lvl", _WALK_CASES, ids=[f"{n}@{lvl}" for n, lvl in _WALK_CASES])
def test_k_walk_reads_see_the_reference_writes_on_the_cases(name, lvl):
    c = stencil_cases.BY_NAME[name]
    _hold_walks(gtscript.stencil("cuda", externals=dict(c.externals), opt_level=lvl)(c.defs).implementation_ir)


@pytest.mark.parametrize("chunk", range(8))
def test_k_walk_reads_see_the_reference_writes_on_random_programs(chunk):
    """Random definitions that read temporaries one plane up and down in
    every iteration order, at opt levels 0 and 3: walks form and keep
    temporaries on chip, and each holds the reference's order."""
    rng = np.random.default_rng(2600 + chunk)
    walks = onchip = 0
    for seed in range(1500):
        d = _vertical_program(rng, f"w{chunk}_{seed}", orders=2, init=1.0)
        try:
            impl = analysis.analyze(ir_json.definition_from_json(json.loads(json.dumps(
                corpus_gen.definition_to_json(d)))))
        except GTScriptSemanticError:
            continue  # a temporary read before its definition, or ahead of its sweep
        for lvl in (0, 3):
            try:
                w, n = _hold_walks(passes.run_pipeline(impl, opt_level=lvl)[0])
            except GTScriptSemanticError:
                continue
            walks += w
            onchip += n
    assert walks >= 5 and onchip >= 5, (walks, onchip)


def walk_reads_above_defs(a: Field[np.float64], x: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(0, -1):
        o = x[0, 0, 1] + a  # the old x: the next multi-stage writes it
    with computation(PARALLEL), interval(...):
        x = a * 2.0
        t = x + 1.0
    with computation(PARALLEL), interval(1, None):
        o = t[0, 0, -1] + o


def walk_flat_output_defs(a: Field[np.float64], s: Field[np.float64, IJ], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        s = a * 2.0
    with computation(PARALLEL), interval(1, None):
        o = a + s  # every level sees the top level's s: no walk


def walk_gapped_forward_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(FORWARD):
        with interval(0, 1):
            o = t
        with interval(2, None):
            o = t + o[0, 0, -2]


def walk_backward_between_defs(a: Field[np.float64], o: Field[np.float64], p: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(BACKWARD):
        with interval(-1, None):
            o = t
        with interval(0, -1):
            o = t + o[0, 0, 1]
    with computation(PARALLEL), interval(...):
        p = o + t


def walk_reads_the_top_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(PARALLEL), interval(...):
        o = t[0, 0, 1] - t  # the plane above the top reads 0


@pytest.mark.parametrize("defs, walks, kinds", [
    # a later multi-stage writes the plane an earlier one reads above: one
    # walk, x read before it is written at each level; t kept one level
    (walk_reads_above_defs, [[0, 0, 0]], {"t": "ring"}),
    (walk_flat_output_defs, [], {}),  # refused: the 2-D output aliases every level
    (walk_gapped_forward_defs, [], {"t": "full"}),  # refused: the FORWARD intervals leave a gap
    (walk_backward_between_defs, [], {"t": "full"}),  # refused: BACKWARD runs down the column
    # t's top read finds no write, so t stays in memory and the walk would keep
    # nothing out of it: the loops stay
    (walk_reads_the_top_defs, [], {"t": "full"}),
], ids=["reads_above", "flat_output", "gapped_forward", "backward_between", "reads_the_top"])
def test_k_walk_refusals_and_kept_loops(defs, walks, kinds):
    """Where the plan walks and where it keeps the loops, and what it keeps
    on chip; each case holds the reference's order."""
    for lvl in (0, 3):
        st = gtscript.stencil("cuda", opt_level=lvl, disable_passes=("interval_splitting",))(defs)
        sched = st.kernel.module.SCHEDULE
        assert [[s for _mi, _iv, s in w["units"]] for w in sched["k_walks"]] == walks
        assert {n: sched["temporaries"][n] for n in kinds} == kinds
        _hold_walks(st.implementation_ir)


_FLOAT_LITERAL = re.compile(r"(?<![\w.])(\d+\.\d*|\d*\.\d+|\d+[eE][-+]?\d+)([eE][-+]?\d+)?(?![\w.])")


@pytest.mark.parametrize("name", ["hdiff", "hdiff_smag", "vadv", "vadv_system", "vintg"])
def test_float32_source_has_no_bare_double_literal(name):
    build_fns = {"hdiff": t_hdiff.build_hdiff, "hdiff_smag": t_hdiff.build_hdiff_smag, "vadv": t_vadv.build_vadv,
                "vadv_system": t_vadv.build_vadv_system, "vintg": t_vintg.build_vintg}
    src = build_fns[name]("cuda", dtype="float32").generated_source
    assert "typedef float real_t;" in src and "double" not in src
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    bare = _FLOAT_LITERAL.findall(re.sub(r"real_t\([^()]*\)", "real_t(_)", code))
    assert bare == []
    if name not in ("vadv", "vintg"):  # those two have no float literal
        assert re.search(r"real_t\(\d+\.\d*(e-?\d+)?\)", code)  # the literals are there, typed


def test_module_launch_counts_keep_a_freed_kernels_launches():
    """A driver's stencils die when it returns (an example's ``main``): the
    launches their kernels made still count until the next reset."""
    codegen_cuda.reset_launch_counts()
    st = t_vintg.build_vintg("cuda")
    key = st.kernel.key
    st.launches = 2
    del st
    assert codegen_cuda.launch_counts().get(key, 0) == 2
    codegen_cuda.reset_launch_counts()
    assert codegen_cuda.launch_counts().get(key, 0) == 0


def test_reset_launch_counts_clears_the_scratch_counts():
    """A launch adds its launcher's scratch bytes to ``scratch_counts()`` by
    key; ``reset_launch_counts()`` clears them with the launches."""

    class StandIn(codegen_cuda.CountedKernel):
        key = "k_stand_in"

    k = StandIn()
    codegen_cuda.register_kernel(k)
    codegen_cuda.reset_launch_counts()
    k.count_launch(1024)
    k.count_launch(1024)
    k.count_launch()  # a launch with no full scratch
    assert codegen_cuda.scratch_counts()["k_stand_in"] == 2048
    assert codegen_cuda.launch_counts()["k_stand_in"] == 3 == k.launches
    codegen_cuda.reset_launch_counts()
    assert codegen_cuda.scratch_counts()["k_stand_in"] == 0 and k.launches == 0
