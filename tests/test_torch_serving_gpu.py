"""Forecast serving and the tile autotuner on a CUDA card.

* a 4-request engine on the card gives each request the bits of its run
  alone (``ProgramObject.iterate``);
* the dispatch wall the engine records covers the card's time of the
  dispatch's group launches (the executor job waits for the stream);
* ``autotune=True`` times its candidates on the card, persists the record,
  a rebuild is a pure cache hit, and the tuned kernel matches the plain
  module within 1e-12;
* a member-batched group re-resolves its block under its own key;
* ``python -m repro_torch.launch.serve --load 4`` runs on the card by default.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package and needs no aiohttp:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serving_gpu.py
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.core import autotune, caching, codegen_cuda, gtscript, storage  # noqa: E402
from repro_torch.ensemble import Ensemble, batch  # noqa: E402
from repro_torch.serving import RequestSpec, ServingEngine, drive_engine  # noqa: E402
from repro_torch.stencils import forecast  # noqa: E402
from repro_torch.stencils.vintg import vintg_defs  # noqa: E402

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parent.parent
DOM = (40, 70, 8)  # ragged against every candidate block
CANDS = ((4, 32), (8, 32), (8, 64))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture()
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GT_CACHE", str(tmp_path))
    saved = dict(autotune._memory)
    autotune._memory.clear()
    yield tmp_path
    autotune._memory.clear()
    autotune._memory.update(saved)


def _drive(engine, specs):
    async def go():
        async with engine:
            return await drive_engine(engine, specs)

    return asyncio.run(go())


def _alone(step, templates, scalars, phi0, steps):
    """One request alone through the one-member program on the card."""
    f = {n: storage.Storage(s.data.clone(), "cuda", s.default_origin, s.axes) for n, s in templates.items()}
    f["phi"].data.copy_(torch.from_numpy(phi0))
    step.iterate(steps, **f, **scalars)
    return f["phi"].to_numpy()


def test_engine_on_the_card_is_bit_identical_to_lone_runs(card):
    step = forecast.build_forecast_step("cuda", DOM, name="gpu_serve_step")
    templates, scalars = forecast.make_forecast_fields("cuda", DOM)  # the card by default
    assert all(f.device.type == "cuda" and storage.is_card_layout(f.data) for f in templates.values())
    eng = ServingEngine(window_ms=25.0)
    entry = eng.register(step, fields=templates, scalars=scalars, request_fields=("phi",),
                         member_counts=(1, 2, 4), warm=True, warm_chunk=3)
    phis = [forecast.request_state(DOM, seed=i + 1) for i in range(4)]
    codegen_cuda.reset_launch_counts()
    rep = _drive(eng, [RequestSpec(entry.name, {"phi": p}, steps=6, stream_every=3) for p in phis])
    stats = eng.stats()
    assert stats["errors"] == 0 and stats["retries"] == 0 and stats["bisects"] == 0
    assert all(r.ok and r.steps_seen == [3, 6] and r.members == 4 for r in rep.results)
    launched = {k: n for k, n in codegen_cuda.launch_counts().items() if n}
    assert launched and set(launched.values()) == {6}  # one launch a group and step, all 4 members
    for p, r in zip(phis, rep.results):
        for t in (3, 6):
            assert np.array_equal(r.step_fields[t]["phi"], _alone(step, templates, scalars, p, t))


def test_dispatch_seconds_cover_the_card_time_of_the_launches(card):
    """The executor job waits for the stream: the dispatch wall the engine
    records is at least the CUDA-event time from before the dispatch's first
    launch to after its last (without the wait it would be the time to queue
    the launches, far less at this size)."""
    dom = (256, 256, 80)
    step = forecast.build_forecast_step("cuda", dom, name="gpu_wall_step")
    templates, scalars = forecast.make_forecast_fields("cuda", dom)
    eng = ServingEngine(window_ms=2.0)
    entry = eng.register(step, fields=templates, scalars=scalars, request_fields=("phi",),
                         member_counts=(1,), warm=True, warm_chunk=50)
    ens = entry.ensembles[1]
    inner, events = ens.iterate, []

    def timed_iterate(n, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(n, *args, **kw)
        end.record()
        events.append((start, end))
        return out

    ens.iterate = timed_iterate
    rep = _drive(eng, [RequestSpec(entry.name, {"phi": forecast.request_state(dom, seed=1)}, steps=200,
                                   stream_every=200)])
    assert rep.results[0].ok
    ((start, end),) = events
    end.synchronize()
    card_s = start.elapsed_time(end) / 1e3
    hist = entry.hist["dispatch"]
    assert hist.count == 1
    assert hist.sum >= card_s > 0


def _vintg_call(st, exec_info=None):
    rng = np.random.default_rng(0)
    shape = (DOM[0], DOM[1], DOM[2])
    fs = {n: storage.from_array(v) for n, v in {
        "rho": rng.random(shape) + 0.5, "w": rng.random(shape) + 0.5,
        "out_dn": np.zeros(shape), "out_up": np.zeros(shape)}.items()}
    st(**fs, decay=np.float64(0.9), exec_info=exec_info)
    return fs


def test_autotune_on_the_card_persists_hits_and_matches_plain(card, isolated_cache):
    def build():
        return gtscript.stencil(backend="cuda", autotune=True, autotune_candidates=CANDS, autotune_iters=2,
                                rebuild=True)(vintg_defs)

    st = build()
    info = {}
    got = _vintg_call(st, info)
    rec = info["autotune"]
    assert rec["cache_hit"] is False and rec["batch"] is None
    assert {tuple(t["block"]) for t in rec["timings"]} == set(CANDS) | {tuple(st._module.BLOCK)}
    assert all(t["us"] > 0 for t in rec["timings"])
    path = caching.tuning_path(st.name, st.fingerprint)
    (entry,) = json.loads(path.read_text())["domains"].values()
    assert entry["block"] == rec["block"]
    tuned = st.block_kernel(tuple(rec["block"]))
    before = tuned.launches
    _vintg_call(st)
    assert tuned.launches == before + 1
    want = _vintg_call(gtscript.stencil(backend="torch")(vintg_defs))
    for n in ("out_dn", "out_up"):
        torch.testing.assert_close(got[n].data, want[n].data, rtol=1e-12, atol=1e-12)
    autotune._memory.clear()
    info2 = {}
    _vintg_call(build(), info2)
    assert info2["autotune"]["cache_hit"] is True and info2["autotune"]["block"] == rec["block"]


def test_member_batched_group_resolves_its_own_key(card, isolated_cache):
    step = forecast.build_forecast_step("cuda", DOM, name="gpu_tune_step", autotune=True,
                                        autotune_candidates=CANDS, autotune_iters=2)
    templates, scalars = forecast.make_forecast_fields("cuda", DOM)
    members = 3
    ef = {n: (f if n in ("u", "v") else batch.broadcast(f, members)) for n, f in templates.items()}
    ef["phi"].data.add_(1e-3 * torch.randn(ef["phi"].data.shape, dtype=torch.float64, device=card))
    init = ef["phi"].data.clone()
    ens = Ensemble(step, members)
    ens.iterate(4, **ef, **scalars)
    (ce,) = ens._cache.values()
    (runs,) = ce._batched_runs.values()
    for r, obj in zip(runs, ce.cp.group_objects):
        assert r.autotune["batch"] == members
        store = json.loads(caching.tuning_path(obj.name, obj.fingerprint).read_text())["domains"]
        assert any(f":{members}x" in k for k in store)  # a batched operand shape in the key
        assert tuple(r.kernel.module.BLOCK) == tuple(r.autotune["block"])
    for m in range(members):  # each member alone through the one-member program (its own tuned blocks)
        one = {n: storage.Storage(s.data.clone(), "cuda", s.default_origin, s.axes) for n, s in templates.items()}
        one["phi"].data.copy_(init[m])
        step.iterate(4, **one, **scalars)
        assert torch.equal(one["phi"].data, ef["phi"].data[m])
    codegen_cuda.reset_launch_counts()  # the searches launched every candidate: count the path alone
    ens.iterate(1, **ef, **scalars)
    assert [r.kernel.launches for r in runs] == [1] * len(runs)
    cp = step.compiled(templates, scalars)
    for r, obj in zip(cp._group_runs, cp.group_objects):
        assert r.autotune["batch"] is None  # the one-member record is another key
        store = json.loads(caching.tuning_path(obj.name, obj.fingerprint).read_text())["domains"]
        assert len([k for k in store if not k.startswith("serving|")]) == 2


def test_serve_cli_load_runs_on_the_card_by_default(card):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--load", "4", "--steps", "4", "--stream-every", "2",
         "--domain", "48", "48", "16", "--no-slo"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert "4 concurrent requests x 4 steps" in out.stdout and "device cuda" in out.stdout
    assert "in order: True" in out.stdout
