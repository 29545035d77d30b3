"""Deadline-aware batching scheduler tests (repro.serving.scheduler + the
engine's backlog/window rewrite, PR 10).

What is locked here:

* **determinism** — the same backlog yields the same windows, twice, for
  every policy (each sort key ends in the admission sequence);
* **EDF beats FIFO where it must** — under a blend of tight- and
  loose-deadline requests at equal load, EDF dispatches the tight ones first
  and strictly reduces the deadline-expired count (here: 3 → 0);
* **the pickup bugfix** — a request that is already dead at window pickup is
  504'd WITHOUT burning a dispatch (zero batches, zero dispatches);
* **the window-cap bugfix** — collection is capped by the programs actually
  present in the backlog, never the largest *registered* program (and an
  empty backlog caps at 0 instead of crashing);
* **the feedback loop** — served batch shapes land in the autotune store as
  ``serving|batch=N`` records and registration reads them back;
* priority admission validation (422s) and the SLO batch-window wiring
  (latency breaches recover within batching-window timescales where the
  5-minute SRE defaults would still page).
"""

import asyncio
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import autotune, caching
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import slo as obs_slo
from repro_torch.serving import RequestSpec, ServingEngine, ServingError, drive_engine
from repro_torch.serving.engine import tuned_member_counts
from repro_torch.serving.protocol import parse_forecast
from repro_torch.serving.scheduler import (
    BatchingScheduler,
    EdfScheduler,
    FifoScheduler,
    make_scheduler,
)
from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields, request_state

DOM = (10, 8, 4)


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="sched_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


def make_engine(step, templates, **kw):
    fields, scalars = templates
    kw.setdefault("window_ms", 25.0)
    member_counts = kw.pop("member_counts", (1, 2, 4))
    eng = ServingEngine(**kw)
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=member_counts,
        max_steps=100,
    )
    return eng


def drive(engine, specs, **kw):
    async def go():
        async with engine:
            return await drive_engine(engine, specs, **kw)

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# scheduler unit layer: policy order, windows, caps — no engine, no clock
# ---------------------------------------------------------------------------

_ENTRIES = {}


def fake_req(seq, program="p", max_batch=4, priority=1, deadline_at=None):
    entry = _ENTRIES.setdefault((program, max_batch), SimpleNamespace(name=program, max_batch=max_batch))
    return SimpleNamespace(seq=seq, entry=entry, priority=priority, deadline_at=deadline_at)


def window_ids(windows):
    return [(entry.name, [r.seq for r in chunk]) for entry, chunk in windows]


def test_make_scheduler_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_SCHEDULER", raising=False)
    assert isinstance(make_scheduler(None), EdfScheduler)  # the default
    assert isinstance(make_scheduler("fifo"), FifoScheduler)
    assert isinstance(make_scheduler("EDF"), EdfScheduler)
    inst = FifoScheduler()
    assert make_scheduler(inst) is inst  # instance passthrough
    monkeypatch.setenv("REPRO_SCHEDULER", "fifo")
    assert isinstance(make_scheduler(None), FifoScheduler)
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("lifo")


def test_same_backlog_same_windows_twice():
    """Determinism: identical pushes yield identical windows, per policy."""
    reqs = [
        fake_req(3, priority=0, deadline_at=9.0),
        fake_req(0),
        fake_req(2, priority=0, deadline_at=1.0),
        fake_req(1, deadline_at=0.5),
        fake_req(4, max_batch=2, program="q"),
    ]
    for cls in (FifoScheduler, EdfScheduler):
        rounds = []
        for _ in range(2):
            sched = cls()
            for r in reqs:
                sched.push(r)
            rounds.append(window_ids(sched.take(0.0)))
        assert rounds[0] == rounds[1]


def test_fifo_is_arrival_order_and_edf_degenerates_to_it():
    """With no deadlines and one priority class, EDF *is* FIFO."""
    for cls in (FifoScheduler, EdfScheduler):
        sched = cls()
        for seq in (2, 0, 1, 3):
            sched.push(fake_req(seq))
        assert window_ids(sched.take(0.0)) == [("p", [0, 1, 2, 3])]
        assert sched.backlog() == 0


def test_edf_orders_by_priority_then_deadline_then_seq():
    sched = EdfScheduler()
    sched.push(fake_req(0, priority=1))  # no deadline: last in class 1
    sched.push(fake_req(1, priority=0, deadline_at=5.0))
    sched.push(fake_req(2, priority=0, deadline_at=2.0))
    sched.push(fake_req(3, priority=1, deadline_at=1.0))
    assert window_ids(sched.take(0.0)) == [("p", [2, 1, 3, 0])]
    # seq breaks exact ties
    sched.push(fake_req(7, priority=0, deadline_at=3.0))
    sched.push(fake_req(5, priority=0, deadline_at=3.0))
    assert window_ids(sched.take(0.0)) == [("p", [5, 7])]
    assert sched.sort_key(fake_req(9))[1] == math.inf


def test_window_cap_counts_only_present_programs():
    """The over-collection bugfix: the cap is the sum of max_batch over the
    programs IN the backlog — 0 when empty, never max() over the registry."""
    sched = FifoScheduler()
    assert sched.window_cap() == 0  # empty backlog, no ValueError
    for seq in range(5):
        sched.push(fake_req(seq, program="small", max_batch=2))
    assert sched.window_cap() == 2
    sched.push(fake_req(9, program="big", max_batch=8))
    assert sched.window_cap() == 10


def test_take_caps_per_program_and_surplus_recompetes():
    sched = EdfScheduler()
    for seq in range(5):
        sched.push(fake_req(seq, program="a", max_batch=2))
    sched.push(fake_req(5, program="b", max_batch=1, priority=0))
    # one window per program, each at most max_batch; surplus stays pooled
    assert window_ids(sched.take(0.0)) == [("b", [5]), ("a", [0, 1])]
    assert sched.backlog() == 3
    # a late tight-deadline arrival overtakes the queued surplus next round
    sched.push(fake_req(6, program="a", max_batch=2, priority=0, deadline_at=1.0))
    assert window_ids(sched.take(0.0)) == [("a", [6, 2])]
    assert window_ids(sched.take(0.0)) == [("a", [3, 4])]
    assert sched.take(0.0) == []


def test_sweep_and_flush_empty_the_backlog():
    sched = FifoScheduler()
    for seq in range(4):
        sched.push(fake_req(seq))
    dead = sched.sweep(lambda r: r.seq % 2 == 0)
    assert [r.seq for r in dead] == [0, 2] and sched.backlog() == 2
    assert [r.seq for r in sched.flush()] == [1, 3]
    assert sched.backlog() == 0 and sched.flush() == []


# ---------------------------------------------------------------------------
# the tentpole property: EDF strictly reduces deadline expiries vs FIFO
# ---------------------------------------------------------------------------

SERVICE_S = 0.06  # fake per-window service time; 7 loose windows ≥ 0.42 s


def _run_deadline_mix(step, templates, policy):
    """Equal load, two policies: 7 loose requests submitted BEFORE 3 tight
    ones (priority 0, 400 ms deadline), member_counts=(1,) so every window
    serializes.  The fake runner sleeps a fixed service time per window —
    asyncio.sleep never undershoots, so under FIFO the first tight pickup
    happens at ≥ 7×0.06 = 0.42 s > 0.40 s: all three MUST expire.  Under EDF
    the tights ride the first three windows (~0.18 s nominal, wide margin)."""
    eng = make_engine(step, templates, scheduler=policy, window_ms=2.0, member_counts=(1,))
    dispatched = []

    async def fake_run_batch(entry, requests):
        dispatched.append([r.request_id for r in requests])
        await asyncio.sleep(SERVICE_S)
        for r in requests:
            r.post({"type": "done", "request_id": r.request_id, "steps": r.steps})

    eng._run_batch = fake_run_batch
    phi = request_state(DOM, seed=1)

    async def go():
        outcomes = {}

        async def wait_terminal(req):
            while True:
                ev = await req.events.get()
                if ev["type"] in ("done", "error"):
                    outcomes[req.request_id] = ev
                    return

        async with eng:
            reqs = [
                eng.submit("sched_step", {"phi": phi}, steps=1, request_id=f"loose-{i}")
                for i in range(7)
            ]
            reqs += [
                eng.submit(
                    "sched_step", {"phi": phi}, steps=1, request_id=f"tight-{i}",
                    deadline_ms=400.0, priority=0,
                )
                for i in range(3)
            ]
            await asyncio.wait_for(asyncio.gather(*(wait_terminal(r) for r in reqs)), timeout=30.0)
        return outcomes

    outcomes = asyncio.run(go())
    return outcomes, dispatched, eng.stats()


def test_edf_strictly_reduces_deadline_expiries_vs_fifo(step, templates):
    fifo_out, fifo_disp, fifo_stats = _run_deadline_mix(step, templates, "fifo")
    edf_out, edf_disp, edf_stats = _run_deadline_mix(step, templates, "edf")

    # FIFO: every tight request dies in the queue — 504 at pickup, and the
    # expiry never burned a dispatch slot (the dispatch log has no tight id)
    tights = [f"tight-{i}" for i in range(3)]
    assert fifo_stats["deadline_expired"] == 3
    for rid in tights:
        assert fifo_out[rid]["type"] == "error" and fifo_out[rid]["code"] == 504
        assert "not dispatched" in fifo_out[rid]["reason"]
    assert not {rid for w in fifo_disp for rid in w} & set(tights)
    assert fifo_stats["scheduler"]["decisions"]["expired_at_pickup"] == 3

    # EDF at the SAME load: the tights ride the first three windows and all
    # ten requests finish — strictly fewer expiries (3 → 0)
    assert edf_stats["deadline_expired"] == 0
    assert [w[0] for w in edf_disp[:3]] == tights
    assert all(ev["type"] == "done" for ev in edf_out.values())
    assert edf_stats["deadline_expired"] < fifo_stats["deadline_expired"]
    assert edf_stats["scheduler"]["policy"] == "edf"
    assert edf_stats["scheduler"]["decisions"]["reordered"] >= 1


def test_same_load_same_windows_twice(step, templates):
    """Engine-level determinism: the identical submission schedule produces
    the identical dispatch order, run twice (the seq tiebreaker at work)."""
    runs = [_run_deadline_mix(step, templates, "edf")[1] for _ in range(2)]
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the pickup bugfix: dead-on-arrival requests never reach a dispatch
# ---------------------------------------------------------------------------


def test_expired_while_queued_is_504_with_zero_dispatches(step, templates):
    """A request whose budget is gone before the worker picks it up gets its
    504 at window pickup — no scatter, no batch, no dispatch burned."""
    eng = make_engine(step, templates, window_ms=1.0)

    async def go():
        async with eng:
            req = eng.submit(
                "sched_step", {"phi": request_state(DOM, seed=1)}, steps=5,
                deadline_ms=1e-4,  # ~100 ns of budget: dead by pickup, always
            )
            while True:
                ev = await asyncio.wait_for(req.events.get(), timeout=10.0)
                if ev["type"] in ("done", "error"):
                    return ev

    ev = asyncio.run(go())
    assert ev["type"] == "error" and ev["code"] == 504
    assert "not dispatched" in ev["reason"]
    s = eng.stats()
    assert s["deadline_expired"] == 1
    assert s["batches"] == 0 and s["dispatches"] == 0  # the regression
    assert s["scheduler"]["decisions"]["expired_at_pickup"] == 1


def test_live_deadline_still_enforced_at_segment_boundary(step, templates):
    """The pickup check must not replace the mid-horizon check: a request
    alive at pickup but out of budget between segments still 504s there."""
    eng = make_engine(step, templates, window_ms=1.0)
    spec = RequestSpec(
        "sched_step", {"phi": request_state(DOM, seed=2)}, steps=50,
        stream_every=1, deadline_ms=50.0,
    )
    rep = drive(eng, [spec])
    res = rep.results[0]
    if not res.ok:  # jit warmth decides which boundary; expiry code is fixed
        assert res.error_code == 504
        assert eng.stats()["dispatches"] >= 1  # it DID run before expiring


# ---------------------------------------------------------------------------
# the window-cap bugfix at engine level: no over-collection for small programs
# ---------------------------------------------------------------------------


def test_windows_capped_by_present_program_not_registry(step, templates):
    """With a big-cap program registered but idle, a burst for the small-cap
    program must chunk at ITS max_batch — the old cap used the registry-wide
    max and over-collected."""
    fields, scalars = templates
    eng = ServingEngine(window_ms=25.0)
    eng.register(
        step, fields=fields, scalars=scalars, request_fields=("phi",),
        member_counts=(1, 2), max_steps=100,
    )
    big = build_forecast_step("torch", DOM, name="big_step")
    eng.register(
        big, fields=fields, scalars=scalars, request_fields=("phi",),
        member_counts=(1, 2, 4, 8), max_steps=100,
    )
    specs = [
        RequestSpec("sched_step", {"phi": request_state(DOM, seed=i + 1)}, steps=1)
        for i in range(5)
    ]
    rep = drive(eng, specs)
    assert all(res.ok and res.members <= 2 for res in rep.results)
    assert eng.stats()["batches"] == 3  # 2 + 2 + 1, no registry-wide fill


# ---------------------------------------------------------------------------
# the feedback loop: observed batch shapes land in the tune store
# ---------------------------------------------------------------------------


def _tune_paths(entry):
    return [caching.tuning_path(o.name, o.fingerprint) for o in entry.cp.group_objects]


def test_served_batches_feed_the_tune_store(step, templates):
    eng = make_engine(step, templates)
    entry = eng._programs["sched_step"]
    paths = _tune_paths(entry)
    assert paths, "forecast program should expose group objects"
    for p in paths:
        p.unlink(missing_ok=True)
    try:
        specs = [
            RequestSpec("sched_step", {"phi": request_state(DOM, seed=i + 1)}, steps=2)
            for i in range(2)
        ]
        rep = drive(eng, specs)
        assert all(r.ok for r in rep.results)
        store = json.loads(paths[0].read_text())
        batch_recs = {
            k: v for k, v in store["domains"].items() if k.startswith("serving|batch=")
        }
        assert batch_recs, f"no serving batch records in {store['domains'].keys()}"
        rec = next(iter(batch_recs.values()))
        assert rec["source"] == "serving" and rec["count"] >= 1
        assert rec["us_per_step"] > 0
        # registration reads the observation back as a padding target
        assert rec["batch"] in tuned_member_counts(entry.cp)
        # stats surface the loop: per-priority p99 + decision counters exist
        s = eng.stats()["scheduler"]
        assert s["decisions"]["window"] >= 1
        assert "1" in s["priority_latency_p99_s"]  # default priority class
    finally:
        for p in paths:
            p.unlink(missing_ok=True)


def test_record_batch_observation_merges_best_and_count(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GT_CACHE", str(tmp_path))
    autotune.record_batch_observation("grp", "fp0", 4, 120.0)
    autotune.record_batch_observation("grp", "fp0", 4, 90.0)   # better: wins
    autotune.record_batch_observation("grp", "fp0", 4, 200.0)  # worse: count only
    path = caching.tuning_path("grp", "fp0")
    store = json.loads(path.read_text())
    rec = store["domains"]["serving|batch=4"]
    assert rec == {"batch": 4, "us_per_step": 90.0, "count": 3, "source": "serving"}
    # a second engine observing concurrently merges instead of clobbering
    autotune.record_batch_observation("grp", "fp0", 8, 70.0)
    store = json.loads(path.read_text())
    assert set(store["domains"]) == {"serving|batch=4", "serving|batch=8"}


# ---------------------------------------------------------------------------
# priority admission + protocol plumbing
# ---------------------------------------------------------------------------


def test_priority_validation_and_defaults(step, templates):
    eng = make_engine(step, templates)  # priority_classes defaults to 3
    phi = request_state(DOM, seed=1)
    assert eng.admit("sched_step", {"phi": phi}).priority == 1  # "normal"
    assert eng.admit("sched_step", {"phi": phi}, priority=0).priority == 0
    assert eng.admit("sched_step", {"phi": phi}, priority=np.int64(2)).priority == 2
    for bad in (True, "high", 1.5, 3, -1):
        with pytest.raises(ServingError) as ei:
            eng.admit("sched_step", {"phi": phi}, priority=bad)
        assert ei.value.code == 422
    solo = make_engine(step, templates, priority_classes=1)
    assert solo.admit("sched_step", {"phi": phi}).priority == 0
    assert solo.priority_classes == 1  # floor at one class


def test_priority_rides_the_wire_protocol():
    frame = {
        "type": "forecast", "program": "p",
        "fields": {}, "priority": 2, "deadline_ms": 100.0,
    }
    kw = parse_forecast(frame)
    assert kw["priority"] == 2 and kw["deadline_ms"] == 100.0
    assert parse_forecast({"type": "forecast", "program": "p", "fields": {}})["priority"] is None
    assert RequestSpec("p", {}, priority=0).priority == 0


# ---------------------------------------------------------------------------
# SLO coupling: latency burn windows scale with the batching window
# ---------------------------------------------------------------------------


def test_wire_batch_window_scales_latency_rules_only(step, templates):
    reg = obs_metrics.MetricsRegistry()
    lat = obs_slo.Objective("l", "p", obs_slo.LATENCY_P99, 0.1)
    avail = obs_slo.Objective("a", "p", obs_slo.AVAILABILITY, 0.999)
    slo = obs_slo.SloEngine(reg, [lat, avail])
    assert slo.rules_for(lat) == slo.rules  # unwired: defaults everywhere
    slo.wire_batch_window(0.002)
    fast, slow = slo.rules_for(lat)
    assert (fast.name, slow.name) == ("batch_fast", "batch_slow")
    assert fast.short_s == 0.25  # floored: 2 ms × 64 ≪ min_short_s
    assert slo.rules_for(avail) == slo.rules  # availability keeps SRE defaults
    wide = obs_slo.SloEngine(reg).wire_batch_window(1.0)
    assert wide._latency_rules[0].short_s == 64.0  # unfloored scaling
    # the engine wires its own window at construction
    eng = make_engine(step, templates, window_ms=4.0)
    (efast, _) = eng.slo.rules_for(lat)
    assert efast.short_s == pytest.approx(max(eng.window_s * 64.0, 0.25))


def test_wired_rules_recover_where_default_rules_still_page():
    """The point of the coupling: after traffic goes good, the batch-scaled
    short windows age the bad samples out within seconds — the 5-minute SRE
    defaults would still be paging at the same instant."""
    reg = obs_metrics.MetricsRegistry()
    req = reg.counter("serving_requests_total", "", program="p")
    hist = reg.histogram("serving_request_latency_seconds", "", program="p")

    def build(wired):
        slo = obs_slo.SloEngine(reg, [obs_slo.Objective("lat", "p", obs_slo.LATENCY_P99, 0.1)])
        return slo.wire_batch_window(0.004) if wired else slo

    wired, default = build(True), build(False)
    for s in (wired, default):
        s.sample(now=0.0)
    req.inc(10)
    hist.observe(0.5)  # p99 ≫ target: those 10 requests are bad
    assert wired.evaluate(now=0.1)["breaching"]
    assert default.evaluate(now=0.1)["breaching"]
    # recovery: p99 back under target, a little good traffic
    for _ in range(600):
        hist.observe(0.01)
    req.inc(20)
    for s in (wired, default):
        s.sample(now=0.2)
    # a few seconds later every wired short window excludes the bad burst...
    later = 0.2 + wired._latency_rules[1].short_s * 4.0
    assert not wired.evaluate(now=later)["breaching"]
    # ...while the 300 s/1800 s defaults still see burn 10/30/budget ≈ 33
    assert default.evaluate(now=later)["breaching"]
