"""The ``cuda`` backend's schedule against the reference's Pallas schedule:
the mirror of ``tests/test_pallas_schedule.py``.

The carry plans of ``analysis.sequential_carry_plan``, and every key of the
generated module's ``SCHEDULE`` that the reference's Pallas module exports,
equal the reference's.  Where the reference asserts its Pallas source
(rolling ``_wh_`` planes, DMA waits at first use), this asserts the CUDA
source's counterpart: ``W_`` window planes and no per-block scratch, and
where each staged input is first copied and waited on relative to each
multi-stage's marker.  The source is generated here; only ``nvcc`` is
missing, so ``tests/test_torch_dsl_gpu.py`` runs the same stencils on the
card.  Correctness is held differentially (``torch_mirror``).
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

import torch_stencil_cases as cases
from repro.core import analysis as r_analysis
from repro.core import gtscript as r_gtscript
from repro.core import passes as r_passes
from repro_torch.core import analysis, gtscript, ir, passes, storage
from repro_torch.core.gtscript import FORWARD, Field, computation, interval
from repro_torch.stencils.vadv import vadv_defs
from repro_torch.stencils.vintg import vintg_defs
from torch_mirror import definitions, reference_twin, run_case

NI, NJ, NK = cases.DOMAIN
PALLAS_KEYS = ("halo", "dma_inputs", "dma_first_use_ms", "sweeps", "full_carry_fields", "window_fields",
               "window_planes")


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _impl(defs, externals=None, name=None):
    """The port's optimized IR, held equal to the reference's."""
    r_defn, t_defn = definitions(defs, externals, name)
    r_opt, _ = r_passes.run_pipeline(r_analysis.analyze(r_defn))
    opt, _ = passes.run_pipeline(analysis.analyze(t_defn))
    assert repr(opt) == repr(r_opt)
    return opt


def _plans(impl):
    """The port's carry plans (the reference's, since the IR is)."""
    return analysis.sequential_carry_plan(impl)


def _cuda_and_pallas(defs, **opts):
    """The cuda stencil and the reference's Pallas stencil of one
    definition, built alike, with the Pallas module's SCHEDULE keys equal."""
    st = gtscript.stencil(backend="cuda", **opts)(defs)
    ref = r_gtscript.stencil(backend="pallas", **opts)(reference_twin(defs))
    for key in PALLAS_KEYS:
        assert st.kernel.module.SCHEDULE[key] == ref._module.SCHEDULE[key], key
    return st, ref


# ---------------------------------------------------------------------------
# carry-plan analysis
# ---------------------------------------------------------------------------


def test_vintg_carry_plan_windows_accumulators():
    plans = _plans(_impl(vintg_defs))
    assert len(plans) == 2
    fwd, bwd = plans[0], plans[1]
    assert fwd.full == ("out_dn",) and fwd.window == (("acc_dn", 1),)
    assert bwd.full == ("out_up",) and bwd.window == (("acc_up", 1),)
    # the k-blocking payoff: 1 full field + 1 plane instead of 2 full fields
    assert fwd.carried_planes(NK) == NK + 1
    assert fwd.baseline_planes(NK) == 2 * NK


def test_vadv_carry_plan_keeps_cross_sweep_temps_full():
    impl = _impl(vadv_defs, name="vadv")
    # interval_splitting peels both boundary intervals into PARALLEL
    # multi-stages around the two interior sweeps
    assert [ms.order for ms in impl.multi_stages] == [
        ir.IterationOrder.PARALLEL, ir.IterationOrder.FORWARD, ir.IterationOrder.PARALLEL, ir.IterationOrder.BACKWARD,
    ]
    plans = _plans(impl)
    fwd, bwd = plans[1], plans[3]
    # cp/dp are read by the BACKWARD substitution sweep: full 3-D, and in the
    # cuda kernel, full per-block scratch
    assert set(fwd.full) == {"cp", "dp"} and fwd.window == ()
    assert bwd.full == ("out",) and bwd.window == ()
    st, _ref = _cuda_and_pallas(vadv_defs)
    temps = st.kernel.module.SCHEDULE["temporaries"]
    assert temps["cp"] == temps["dp"] == "full"
    assert sorted(name for name, *_ in st.kernel.module.SCRATCH) == ["cp", "dp"]


def test_sweep_local_temp_written_in_two_sweeps_stays_full():
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(FORWARD), interval(...):
            t = a * 2.0
            o = t
        with computation(FORWARD), interval(...):
            t = a * 3.0
            o = o[0, 0, 0] + t

    plans = _plans(_impl(defs))
    # t is written by two multi-stages: the rolling window may not be split
    assert all("t" not in dict(p.window) for p in plans.values())
    st, _ref = _cuda_and_pallas(defs)
    assert st.kernel.module.SCHEDULE["window_fields"] == 0


# ---------------------------------------------------------------------------
# windowed sweep codegen
# ---------------------------------------------------------------------------


def test_vintg_differential_all_backends():
    run_case(cases.BY_NAME["vintg"])


def test_vintg_generated_code_carries_planes_not_arrays():
    st, _ref = _cuda_and_pallas(vintg_defs)
    src = st.generated_source
    # each accumulator is a rolling window of shared-memory planes (depth 1:
    # two slots), read through gt_slot ...
    for name in ("acc_dn", "acc_up"):
        assert f"#define W_{name}(di, dj, dk) sp_{name}[gt_slot(k + (dk), 2)" in src
        assert f"// temporary {name}: window (depth 1)" in src
        # ... and never an (ni, nj, nk) array: no per-block scratch for it
        assert f"sc_{name}" not in src and f"F_{name}" not in src
    assert st.kernel.module.SCRATCH == []


def test_window_depth_two_recurrence():
    plans = _plans(_impl(cases.window_depth_two_defs))
    assert plans[0].window == (("acc", 2),)
    run_case(cases.BY_NAME["window_depth_two"])
    st, _ref = _cuda_and_pallas(cases.window_depth_two_defs)
    assert "// temporary acc: window (depth 2)" in st.generated_source
    assert "gt_slot(k + (dk), 3)" in st.generated_source


def test_windowed_temp_with_horizontal_halo():
    impl = _impl(cases.window_halo_defs)
    plans = _plans(impl)
    # s carries one trailing plane (read horizontally off-center a level
    # behind); acc never crosses an iteration → a depth-0 window, no carry
    assert dict(plans[0].window) == {"s": 1, "acc": 0}
    assert impl.extent_of("s").i == (-1, 1)  # plane windows keep their halo
    run_case(cases.BY_NAME["window_halo"])
    st, _ref = _cuda_and_pallas(cases.window_halo_defs)
    bi, bj = st.kernel.module.BLOCK
    # s's planes hold the tile and its halo of one point in I: (bi + 2) rows
    # of bj, two of them (depth 1)
    assert st.kernel.module.SCHEDULE["temporaries"]["s"] == "window"
    assert (2, 0, 2, 8) in st.kernel.module._SMEM_TERMS
    assert f"* {bj}" in st.generated_source.split("#define W_s(di, dj, dk)")[1].splitlines()[0]


# ---------------------------------------------------------------------------
# staging schedule (the Pallas kernel's DMA schedule)
# ---------------------------------------------------------------------------


def test_dma_waits_deferred_to_first_use():
    # interval_splitting would peel the carry-free [0, 1) init off the sweep
    # and fuse it into multi-stage 0; pin the two-multi-stage shape
    st, ref = _cuda_and_pallas(cases.two_ms_defs, block=cases.BLOCK, disable_passes=("interval_splitting",))
    # the reference's first-use schedule, key for key
    assert st.kernel.module.SCHEDULE["dma_first_use_ms"] == {"a": 0, "b": 1, "o1": 0, "o2": 1}
    src = st.generated_source
    i_ms0 = src.index("// ---- multi-stage 0")
    i_ms1 = src.index("// ---- multi-stage 1")
    # a, read at horizontal offsets by multi-stage 0, is staged plane by
    # plane there: its first copy is started and first waited on inside
    # multi-stage 0, each plane's copy overlapping the plane before
    i_stage_a = src.index("// stage a[k+0] plane")
    assert i_ms0 < i_stage_a < src.index("gt_cp_async_wait_all();", i_ms0) < i_ms1
    assert src.index("gt_cp_async<8>(&S_a_p0(0, 0)", i_ms0) < i_ms1
    # b is first touched by multi-stage 1 and read at its own column: no
    # copy, read in place where it is first used
    assert "S_b" not in src and "ss_b" not in src
    assert i_ms1 < src.index("A_b(0, 0, 0)", src.index("__global__"))
    assert st.kernel.module.SCHEDULE["staged_inputs"] == ["a[k+0]"]


def test_dma_deferred_schedule_differential():
    run_case(cases.BY_NAME["two_ms"])


def test_partially_written_outputs_preserve_caller_values():
    """An API output written only on some k-intervals, or only under a mask,
    keeps the caller's values on the unwritten planes and false lanes; the
    cuda kernel writes outputs in place."""
    run_case(cases.BY_NAME["partial_outputs"])
    st, _ref = _cuda_and_pallas(cases.partial_outputs_defs, block=cases.BLOCK)
    # ob is partially written: an input of the kernel too, as in the reference
    assert "ob" in st.kernel.module.SCHEDULE["dma_inputs"]
    assert ("ob", ("I", "J", "K"), "float64", True, (0, 0, 0, 0)) in st.kernel.module.FIELDS


def test_schedule_surfaces_in_exec_info():
    st = gtscript.stencil(backend="cuda", block=cases.BLOCK)(vintg_defs)
    fs = {
        n: storage.from_array(v, backend="cuda", device="cpu")
        for n, v in {
            "rho": _rand((NI, NJ, NK), seed=7) + 2.0,
            "w": _rand((NI, NJ, NK), seed=8) + 2.0,
            "out_dn": np.zeros((NI, NJ, NK)),
            "out_up": np.zeros((NI, NJ, NK)),
        }.items()
    }
    info = {}
    st(**fs, decay=np.float64(0.9), domain=(NI, NJ, NK), exec_info=info)
    sched = info["schedule"]
    assert sched["dma_inputs"] == ["rho", "w"]
    assert sched["window_fields"] == 2 and sched["window_planes"] == 2
    assert sched["full_carry_fields"] == 2
    ref = r_gtscript.stencil(backend="pallas", block=cases.BLOCK)(reference_twin(vintg_defs))
    assert {k: sched[k] for k in PALLAS_KEYS} == {k: ref._module.SCHEDULE[k] for k in PALLAS_KEYS}
