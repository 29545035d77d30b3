"""Tile autotuner of the port (repro_torch.core.autotune), on the CPU.

The reference's tests (tests/test_autotune.py, Pallas in interpret mode) run
here on the port's tiled numpy backend, which the same tuner serves:
persistence, a second build's pure cache hit, distinct records for distinct
opt levels and for batched shapes, and a pinned tile winning.  The card's
candidate filter is held against a ``cuda`` module's ``_smem_bytes`` (its
Python part loads without nvcc); a ``cuda`` stencil on CPU tensors does not
tune; and the block variants, the program groups and the ensemble's batched
groups resolve their blocks through the tuner with the right geometry (the
search itself, which times kernels on the card, is stubbed here and run for
real in tests/test_torch_serving_gpu.py).

The tuning store is isolated per test via REPRO_TORCH_GT_CACHE.
"""

import glob
import json
import os

import numpy as np
import pytest

from repro_torch.core import autotune, caching, codegen_cuda, gtscript, storage
from repro_torch.ensemble import Ensemble, batch
from repro_torch.stencils import forecast
from repro_torch.stencils.vintg import vintg_defs

NI, NJ, NK = 12, 10, 6
CANDS = ((4, 4), (8, 8))


@pytest.fixture()
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GT_CACHE", str(tmp_path))
    saved = dict(autotune._memory)
    autotune._memory.clear()
    yield tmp_path
    autotune._memory.clear()
    autotune._memory.update(saved)


def _fields(backend="numpy"):
    rng = np.random.default_rng(0)
    kw = {"device": "cpu"} if backend in ("torch", "cuda") else {}
    return {
        n: storage.from_array(v, backend=backend, **kw)
        for n, v in {
            "rho": rng.random((NI, NJ, NK)) + 0.5,
            "w": rng.random((NI, NJ, NK)) + 0.5,
            "out_dn": np.zeros((NI, NJ, NK)),
            "out_up": np.zeros((NI, NJ, NK)),
        }.items()
    }


def _call(st, exec_info=None, backend="numpy"):
    fs = _fields(backend)
    st(**fs, decay=np.float64(0.9), domain=(NI, NJ, NK), exec_info=exec_info)
    return fs


def _build(backend="numpy", **opts):
    return gtscript.stencil(
        backend=backend, autotune=True, autotune_candidates=CANDS,
        autotune_iters=1, autotune_warmup=1, rebuild=True, **opts,
    )(vintg_defs)


def test_autotuner_times_candidates_and_persists(isolated_cache):
    st = _build()
    info = {}
    _call(st, info)
    rec = info["autotune"]
    assert rec["cache_hit"] is False
    timed = {tuple(t["block"]) for t in rec["timings"]}
    # the clamped default tile (64, 128) -> (12, 10) is timed alongside the candidates
    assert timed == {(4, 4), (8, 8), (12, 10)}
    assert tuple(rec["block"]) in timed
    assert all(t["us"] > 0 for t in rec["timings"])
    assert info["numpy_tile"]["block"] == tuple(rec["block"])

    path = caching.tuning_path(st.name, st.fingerprint)
    assert path.name == f"rt_{st.name}_{st.fingerprint}.tune.json"
    store = json.loads(path.read_text())
    (entry,) = store["domains"].values()
    assert entry["block"] == rec["block"]


def test_second_build_identical_ir_is_pure_cache_hit(isolated_cache):
    st1 = _build()
    info1 = {}
    _call(st1, info1)
    assert info1["autotune"]["cache_hit"] is False

    # a fresh StencilObject for the identical IR + opts shares the
    # fingerprint, so its first call reuses the persisted tile untimed
    st2 = _build()
    assert st2 is not st1 and st2.fingerprint == st1.fingerprint
    info2 = {}
    _call(st2, info2)
    assert info2["autotune"]["cache_hit"] is True
    assert info2["autotune"]["block"] == info1["autotune"]["block"]

    # ... including across a cold in-memory cache (disk only)
    autotune._memory.clear()
    st3 = _build()
    info3 = {}
    _call(st3, info3)
    assert info3["autotune"]["cache_hit"] is True


def test_distinct_opt_levels_key_distinct_tiles(isolated_cache):
    st_lo = _build(opt_level=1)
    st_hi = _build(opt_level=3)
    assert st_lo.fingerprint != st_hi.fingerprint
    for st in (st_lo, st_hi):
        info = {}
        _call(st, info)
        assert info["autotune"]["cache_hit"] is False  # tuned independently
    stores = glob.glob(os.path.join(str(isolated_cache), "*.tune.json"))
    assert len(stores) == 2


def test_pinned_block_wins_over_autotuner(isolated_cache):
    st = _build(tile=(4, 8))
    info = {}
    _call(st, info)
    assert "autotune" not in info  # no search ran
    assert info["numpy_tile"]["block"] == (4, 8)
    assert glob.glob(os.path.join(str(isolated_cache), "*.tune.json")) == []


def test_card_filter_drops_blocks_the_card_cannot_run(isolated_cache, monkeypatch):
    """The card's counterpart of the reference's VMEM filter: at most 1024
    threads, BJ in whole warps, shared memory within SMEM_MAX (checked with
    the module's own ``_smem_bytes``)."""
    st = gtscript.stencil(backend="cuda", rebuild=True)(forecast.diffuse_defs)
    module = st._module
    domain = (256, 256, 80)
    cands = ((8, 32), (8, 48), (4, 64), (32, 64), (2, 128))
    blocks = autotune.candidate_blocks(module, domain, candidates=cands)
    assert (8, 32) in blocks and (4, 64) in blocks and (2, 128) in blocks
    assert (32, 64) not in blocks  # 2048 threads
    assert (8, 48) not in blocks  # BJ not a multiple of 32
    # the shared-memory clause, with a limit between two candidates' needs
    small, large = module._smem_bytes(4, 64), module._smem_bytes(8, 64)
    assert small < large
    monkeypatch.setattr(codegen_cuda, "SMEM_MAX", (small + large) // 2)
    blocks = autotune.candidate_blocks(module, domain, candidates=((4, 64), (8, 64)))
    assert (4, 64) in blocks and (8, 64) not in blocks
    # every kept block obeys all three rules; the module's own block is always a candidate
    for bi, bj in autotune.candidate_blocks(module, domain):
        assert bi * bj <= 1024 and bj % 32 == 0 and module._smem_bytes(bi, bj) <= codegen_cuda.SMEM_MAX
    assert tuple(module.BLOCK) in autotune.candidate_blocks(module, domain)
    # BJ clamps to the domain in whole warps
    assert autotune.candidate_blocks(module, (6, 40, 4), candidates=((8, 128),)) == [(6, 32), (6, 64)]


def test_batched_operand_shapes_key_distinct_tiles(isolated_cache):
    """A member-batched run has the same (ni, nj, nk) domain as the unbatched
    one but different operand shapes — it must tune its own record, never
    reuse the stale unbatched (BI, BJ)."""
    st = _build()
    info = {}
    _call(st, info)
    assert info["autotune"]["cache_hit"] is False

    batched_shapes = [
        (n, (5, NI, NJ, NK)) for n in ("rho", "w", "out_dn", "out_up")
    ]
    _block, rec = st._resolve_block((NI, NJ, NK), batched_shapes)
    assert rec["cache_hit"] is False  # same domain, new geometry: fresh search
    assert rec["batch"] == 5  # timed with the member axis

    # both records persist independently under one fingerprint
    path = caching.tuning_path(st.name, st.fingerprint)
    store = json.loads(path.read_text())
    assert len(store["domains"]) == 2

    # each geometry is a pure cache hit for a fresh build of the same IR
    st2 = _build()
    _block, rec2 = st2._resolve_block((NI, NJ, NK), batched_shapes)
    assert rec2["cache_hit"] is True
    assert rec2["block"] == rec["block"]
    info3 = {}
    _call(st2, info3)
    assert info3["autotune"]["cache_hit"] is True


def test_cuda_stencil_on_cpu_tensors_does_not_tune(isolated_cache):
    """No kernel runs on CPU tensors (the plain torch module does), so there
    is no block to tune: the call says so and writes no record."""
    st = _build("cuda")
    assert st.tunes
    info = {}
    got = _call(st, info, backend="cuda")
    assert info["autotune"]["tuned"] is False and "CPU tensors" in info["autotune"]["reason"]
    assert glob.glob(os.path.join(str(isolated_cache), "*.tune.json")) == []
    want = _call(gtscript.stencil(backend="torch")(vintg_defs), backend="torch")
    for n in ("out_dn", "out_up"):
        assert np.array_equal(got[n].to_numpy(), want[n].to_numpy())
    # the autotune keys stay out of the fingerprint: same IR + options, same record
    assert st.fingerprint == gtscript.stencil(backend="cuda", rebuild=True)(vintg_defs).fingerprint


def test_block_variants_are_their_own_modules(isolated_cache):
    """Each block is its own generated source: a module name that carries the
    block, its own fingerprint, BI/BJ defined in the source; the member-batched
    variant of a block keys on both."""
    st = _build("cuda")
    assert st.block_kernel(None) is st.kernel and st.block_kernel(tuple(st._module.BLOCK)) is st.kernel
    k = st.block_kernel((4, 64))
    assert k is st.block_kernel((4, 64))  # cached
    fp = caching.block_fingerprint(st.fingerprint, (4, 64))
    assert k.key == caching.module_key(f"{st.name}_b4x64", fp)
    assert tuple(k.module.BLOCK) == (4, 64)
    assert "#define BI 4" in k.module.CUDA_SOURCE and "#define BJ 64" in k.module.CUDA_SOURCE
    km = st.block_kernel((4, 64), ("decay",))
    assert km.member_scalars == ("decay",) and km.key != k.key
    assert km.key == caching.module_key(f"{st.name}_b4x64", caching.member_fingerprint(fp, ("decay",)))
    assert st.block_kernel(None, ()).key == caching.module_key(st.name, caching.member_fingerprint(st.fingerprint, ()))
    assert len({k.key, km.key, st.kernel.key, st.block_kernel(None, ()).key}) == 4
    assert {p.name for p in isolated_cache.glob("*.py")} >= {f"{k.key}.py", f"{km.key}.py"}


def _stub_select(monkeypatch, block):
    calls = []

    def select(module, name, fingerprint, domain, **kw):
        calls.append({"name": name, "fingerprint": fingerprint, "domain": domain, **kw})
        return tuple(block), {"block": list(block), "cache_hit": False, "batch": None}

    monkeypatch.setattr(autotune, "select_block", select)
    return calls


def test_ensemble_groups_resolve_their_block_for_batched_shapes(isolated_cache, monkeypatch):
    """A member-batched group never reuses a block tuned for one member: it
    asks the tuner with the BATCHED operand shapes (member axis in front of
    each batched field, shared fields without it) and launches the kernel of
    that block's member-batched variant; the one-member program group asks
    with its domain alone."""
    dom = (8, 6, 4)
    step = forecast.build_forecast_step("cuda", dom, name="tune_step", autotune=True)
    fields, scalars = forecast.make_forecast_fields("cuda", dom, device="cpu")
    members = 3
    ens = Ensemble(step, members)
    ef = {n: (batch.broadcast(f, members) if n not in ("u", "v") else f) for n, f in fields.items()}
    ce = ens.compiled(ef, scalars)
    calls = _stub_select(monkeypatch, (4, 32))
    runs = ce.batched_runs({"dt": True})
    assert all(r.launches is None for r in runs)  # nothing is tuned before the card runs it
    shape = tuple(fields["phi"].shape)
    for r, obj in zip(runs, ce.cp.group_objects):
        shapes = dict(r.operand_shapes)
        for n in obj.field_info:
            assert shapes[n] == (shape if n in ("u", "v") else (members,) + shape)
        kernel = r.kernel  # resolves
        assert kernel.key.startswith(f"rt_{obj.name}_b4x32_") and kernel.member_scalars is not None
        assert tuple(kernel.module.BLOCK) == (4, 32)
    assert [c["name"] for c in calls] == [o.name for o in ce.cp.group_objects]
    assert all(autotune.batch_count(ce.cp.group_objects[0]._module, c["operand_shapes"]) == members
               for c in calls[:1])
    assert all(callable(c["kernels"]) for c in calls)
    # the one-member program group: its domain, no operand shapes, the one-member kernel
    calls.clear()
    cp = step.compiled(fields, scalars)
    (kernel,) = [k for k in cp.group_kernels][:1]
    assert calls[0]["domain"] == dom and calls[0].get("operand_shapes") is None
    assert kernel.member_scalars is None and tuple(kernel.module.BLOCK) == (4, 32)
