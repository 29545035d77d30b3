"""Chaos tests for the serving resilience layer (repro.serving.faults + the
engine's failure handling) — no websocket dependency.

THE invariant, asserted with faults injected at every site: **every accepted
request terminates** — a ``done`` event, an ``error`` event, or an admission
rejection; never a hang.  And the requests that *do* survive retries and
bisection finish **bit-identical** (float64, 0 ULP) to their unfaulted
sequential runs — resilience must not cost reproducibility.

These tests double as the CI chaos matrix: the fault-matrix test also honors
``REPRO_FAULT_SITES``-style env arming, so a CI leg can re-run the suite with
the injector armed per site."""

import asyncio
import time

import numpy as np
import torch
import pytest

from repro_torch.serving import (
    DEADLINE_EXCEEDED,
    DEGRADED,
    DRAINING,
    OVERLOADED,
    SERVING,
    FaultInjector,
    InjectedFault,
    RequestSpec,
    ServingEngine,
    ServingError,
    drive_engine,
)
from repro_torch.serving.faults import SITES
from repro_torch.stencils.forecast import FIELD_NAMES, build_forecast_step, make_forecast_fields, request_state
from repro_torch.core.storage import Storage

DOM = (10, 8, 4)


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="chaos_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


def make_engine(step, templates, *, faults=None, **kw):
    fields, scalars = templates
    kw.setdefault("window_ms", 25.0)
    kw.setdefault("retry_backoff_ms", 1.0)
    eng = ServingEngine(faults=faults if faults is not None else FaultInjector(), **kw)
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2, 4),
        max_steps=100,
    )
    return eng


def sequential(step, templates, phi0, steps):
    fields, scalars = templates
    f = {
        n: Storage(s.data.clone(), backend="torch", default_origin=s.default_origin, axes=s.axes)
        for n, s in fields.items()
    }
    f["phi"].data = torch.from_numpy(np.array(phi0, copy=True))
    for _ in range(steps):
        step(*[f[n] for n in FIELD_NAMES], **scalars)
    return f["phi"].to_numpy()


def drive(engine, specs, **kw):
    async def go():
        async with engine:
            return await drive_engine(engine, specs, **kw)

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# the injector itself: deterministic, seeded, site-addressed
# ---------------------------------------------------------------------------


def test_injector_disabled_by_default():
    inj = FaultInjector()
    assert not inj.enabled
    for site in SITES:
        inj.check(site)  # never raises
    assert inj.stats()["injected"] == {}


def test_injector_validates_config():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(sites=("warp_core",), rate=0.5)
    with pytest.raises(ValueError, match="rate"):
        FaultInjector(sites=("dispatch",), rate=1.5)


def test_injector_is_deterministic_per_seed():
    def decisions(seed):
        inj = FaultInjector(sites=("dispatch",), rate=0.3, seed=seed)
        out = []
        for _ in range(64):
            try:
                inj.check("dispatch")
                out.append(False)
            except InjectedFault:
                out.append(True)
        return out

    a, b = decisions(7), decisions(7)
    assert a == b  # same seed, same schedule
    assert any(a) and not all(a)  # rate 0.3 fires sometimes, not always
    assert decisions(8) != a  # another seed, another schedule


def test_injector_rate_extremes_and_poison():
    always = FaultInjector(sites=("gather",), rate=1.0, seed=0)
    with pytest.raises(InjectedFault):
        always.check("gather")
    never = FaultInjector(sites=("gather",), rate=0.0, seed=0, poison=("bad",))
    for _ in range(32):
        never.check("gather", keys=("good",))
    with pytest.raises(InjectedFault, match="poison"):
        never.check("gather", keys=("good", "bad"))
    assert never.stats()["injected"]["gather"] == 1


def test_injector_from_env():
    assert not FaultInjector.from_env(env={}).enabled
    inj = FaultInjector.from_env(
        env={
            "REPRO_FAULT_SITES": "dispatch,gather",
            "REPRO_FAULT_RATE": "0.25",
            "REPRO_FAULT_SEED": "3",
            "REPRO_FAULT_POISON": "req-x",
        }
    )
    assert inj.enabled and inj.armed("dispatch") and inj.armed("gather")
    assert not inj.armed("scatter")
    assert inj.rate == 0.25 and inj.seed == 3 and "req-x" in inj.poison


# ---------------------------------------------------------------------------
# the chaos invariant: faults at every site, every request terminates,
# survivors bit-identical
# ---------------------------------------------------------------------------


def chaos_injector(sites, rate, seed):
    """The CI chaos matrix arms the injector from the environment
    (REPRO_FAULT_SITES=...); when it does, that configuration wins so the
    whole invariant suite runs under the armed site.  Unarmed (the normal
    tier-1 run), each test supplies its own deterministic schedule."""
    env_inj = FaultInjector.from_env()
    return env_inj if env_inj.enabled else FaultInjector(sites=sites, rate=rate, seed=seed)


@pytest.mark.parametrize("site", SITES)
def test_chaos_matrix_every_request_terminates(step, templates, site):
    """With the injector armed at any one site, all 6 requests reach a
    terminal state and every survivor matches its sequential oracle exactly."""
    inj = chaos_injector((site,), rate=0.3, seed=13)
    eng = make_engine(step, templates, faults=inj)
    n, steps = 6, 4
    specs = [
        RequestSpec("chaos_step", {"phi": request_state(DOM, seed=i + 1)}, steps=steps, stream_every=2)
        for i in range(n)
    ]
    rep = drive(eng, specs)  # drive() bounds the run via asyncio.run + aclose
    assert rep.requests == n
    for spec, res in zip(specs, rep.results):
        # terminal: either completed with every streamed step, or errored
        if res.ok:
            assert res.steps_seen == [2, 4]
            ref = sequential(step, templates, spec.fields["phi"], steps)
            assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
        else:
            assert res.error_code in (500, OVERLOADED, DEADLINE_EXCEEDED)
    # the engine survived: a fresh request on the same engine still works
    rep2 = drive(eng, [RequestSpec("chaos_step", {"phi": request_state(DOM, seed=99)}, steps=2)])
    assert rep2.results[0].ok or rep2.results[0].error_code == 500


@pytest.mark.parametrize("site", ["dispatch", "scatter", "gather"])
def test_chaos_under_edf_reordering(step, templates, site):
    """The PR-10 leg: the chaos invariant must survive the deadline-aware
    scheduler REORDERING the backlog.  Mixed priorities and (loose) deadlines
    push requests through different windows than arrival order — every
    accepted request still terminates, and every survivor is still bit-exact
    against its sequential oracle: reordering is free because batched
    execution is bit-identical per request."""
    inj = chaos_injector((site,), rate=0.3, seed=29)
    eng = make_engine(step, templates, faults=inj, scheduler="edf")
    n, steps = 8, 4
    specs = [
        RequestSpec(
            "chaos_step",
            {"phi": request_state(DOM, seed=i + 1)},
            steps=steps,
            stream_every=2,
            priority=i % 3,
            deadline_ms=None if i % 2 else 60_000.0,  # loose: never expires
        )
        for i in range(n)
    ]
    rep = drive(eng, specs)
    assert rep.requests == n  # nobody hung
    for spec, res in zip(specs, rep.results):
        if res.ok:
            assert res.steps_seen == [2, 4]
            ref = sequential(step, templates, spec.fields["phi"], steps)
            assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
        else:
            assert res.error_code in (500, OVERLOADED)
    assert eng.stats()["deadline_expired"] == 0  # reordering, not expiry
    assert eng.stats()["scheduler"]["policy"] == "edf"


def test_chaos_all_sites_at_once(step, templates):
    """Everything armed simultaneously — the worst day in production."""
    inj = chaos_injector(SITES, rate=0.15, seed=5)
    eng = make_engine(step, templates, faults=inj)
    specs = [RequestSpec("chaos_step", {"phi": request_state(DOM, seed=i + 1)}, steps=3) for i in range(8)]
    rep = drive(eng, specs)
    assert rep.requests == 8  # nobody hung
    for spec, res in zip(specs, rep.results):
        if res.ok:
            ref = sequential(step, templates, spec.fields["phi"], 3)
            assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    if set(inj.sites) & {"dispatch", "scatter", "gather"}:
        assert eng.faults.stats()["injected"]  # the injector actually fired


# ---------------------------------------------------------------------------
# retry-with-bisect: the poison request is isolated, neighbors unharmed
# ---------------------------------------------------------------------------


def test_poison_dispatch_bisects_and_isolates(step, templates):
    inj = FaultInjector(sites=("dispatch",), rate=0.0, poison=("poison-1",))
    eng = make_engine(step, templates, faults=inj, retry_attempts=2)
    steps = 4
    specs = [
        RequestSpec(
            "chaos_step",
            {"phi": request_state(DOM, seed=i + 1)},
            steps=steps,
            stream_every=2,
            request_id="poison-1" if i == 1 else f"ok-{i}",
        )
        for i in range(4)
    ]
    rep = drive(eng, specs)
    by_id = {r.request_id: r for r in rep.results}
    assert not by_id["poison-1"].ok and by_id["poison-1"].error_code == 500
    for i in (0, 2, 3):
        res = by_id[f"ok-{i}"]
        assert res.ok, res.error_reason
        ref = sequential(step, templates, specs[i].fields["phi"], steps)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    st = eng.stats()
    assert st["bisects"] >= 1 and st["retries"] >= 1


def test_transient_dispatch_fault_retries_to_success(step, templates):
    """rate < 1 means a retry advances the schedule and eventually passes:
    with enough attempts every request completes, bit-identically."""
    inj = FaultInjector(sites=("dispatch",), rate=0.4, seed=21)
    eng = make_engine(step, templates, faults=inj, retry_attempts=8)
    specs = [RequestSpec("chaos_step", {"phi": request_state(DOM, seed=i + 1)}, steps=3) for i in range(3)]
    rep = drive(eng, specs)
    for spec, res in zip(specs, rep.results):
        assert res.ok, res.error_reason
        ref = sequential(step, templates, spec.fields["phi"], 3)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    assert eng.stats()["retries"] >= 1


def test_poison_gather_errors_only_that_request(step, templates):
    inj = FaultInjector(sites=("gather",), rate=0.0, poison=("poison-g",))
    eng = make_engine(step, templates, faults=inj, retry_attempts=2)
    specs = [
        RequestSpec(
            "chaos_step",
            {"phi": request_state(DOM, seed=i + 1)},
            steps=2,
            request_id="poison-g" if i == 0 else f"ok-{i}",
        )
        for i in range(3)
    ]
    rep = drive(eng, specs)
    by_id = {r.request_id: r for r in rep.results}
    assert not by_id["poison-g"].ok
    for i in (1, 2):
        res = by_id[f"ok-{i}"]
        assert res.ok, res.error_reason
        ref = sequential(step, templates, specs[i].fields["phi"], 2)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0


def test_tune_read_fault_falls_back_to_defaults(step, templates):
    """A poisoned tuning store must never block registration — the engine
    degrades to the default member counts."""
    fields, scalars = templates
    eng = ServingEngine(faults=FaultInjector(sites=("tune_read",), rate=1.0, seed=0))
    entry = eng.register(step, fields=fields, scalars=scalars, request_fields=("phi",), max_steps=100)
    from repro_torch.serving import DEFAULT_MEMBER_COUNTS

    assert entry.member_counts == tuple(sorted(DEFAULT_MEMBER_COUNTS))


# ---------------------------------------------------------------------------
# backpressure: bounded queue, 503 + retry_after_ms, health states
# ---------------------------------------------------------------------------


def test_queue_full_rejects_503_with_retry_after(step, templates):
    eng = make_engine(step, templates, max_queue=2, degraded_watermark=0.5)
    gate = asyncio.Event()
    real_run_batch = eng._run_batch

    async def gated(entry, requests):
        await gate.wait()
        await real_run_batch(entry, requests)

    eng._run_batch = gated

    async def go():
        async with eng:
            phi = request_state(DOM, seed=1)
            reqs = [eng.submit("chaos_step", {"phi": phi}, steps=1)]
            await asyncio.sleep(0.06)  # worker picks up req 0, holds at the gate
            reqs += [eng.submit("chaos_step", {"phi": phi}, steps=1) for _ in range(2)]
            assert eng.state == DEGRADED  # queue at/above the watermark
            with pytest.raises(ServingError) as ei:
                eng.submit("chaos_step", {"phi": phi}, steps=1)
            assert ei.value.code == OVERLOADED
            assert ei.value.retry_after_ms is not None and ei.value.retry_after_ms > 0
            assert eng.stats()["rejected_overloaded"] == 1
            gate.set()
            for r in reqs:
                evs = [ev async for ev in eng.stream(r)]
                assert evs[-1]["type"] == "done"
            assert eng.state == SERVING

    asyncio.run(go())


def test_drive_engine_retries_503(step, templates):
    """The in-process driver backs off retry_after_ms and resubmits: with a
    briefly-full queue every request still completes."""
    eng = make_engine(step, templates, max_queue=1, window_ms=1.0)
    eng._programs["chaos_step"].warm(1)  # no compile stalls while retries tick
    specs = [RequestSpec("chaos_step", {"phi": request_state(DOM, seed=i + 1)}, steps=2) for i in range(6)]
    rep = drive(eng, specs, retry_503=25)
    assert all(r.ok for r in rep.results), [r.error_reason for r in rep.results]
    for spec, res in zip(specs, rep.results):
        ref = sequential(step, templates, spec.fields["phi"], 2)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0


def test_deadline_expired_gets_504(step, templates):
    eng = make_engine(step, templates)

    async def go():
        async with eng:
            phi = request_state(DOM, seed=1)
            # an already-expired deadline: rejected at the first boundary check
            dead = eng.submit("chaos_step", {"phi": phi}, steps=5, deadline_ms=0.001)
            ok = eng.submit("chaos_step", {"phi": phi}, steps=5, deadline_ms=60_000.0)
            dead_evs = [ev async for ev in eng.stream(dead)]
            ok_evs = [ev async for ev in eng.stream(ok)]
            assert dead_evs[-1]["type"] == "error"
            assert dead_evs[-1]["code"] == DEADLINE_EXCEEDED
            assert ok_evs[-1]["type"] == "done"
            assert eng.stats()["deadline_expired"] == 1

    asyncio.run(go())


def test_deadline_validation():
    eng = ServingEngine()
    with pytest.raises(ServingError) as ei:
        eng.admit("whatever", {}, deadline_ms=-1)
    assert ei.value.code == 404  # unknown program wins first; now a real one:


def test_deadline_rejects_nonpositive(step, templates):
    eng = make_engine(step, templates)
    phi = request_state(DOM, seed=1)
    for bad in (0, -5, "soon"):
        with pytest.raises(ServingError) as ei:
            eng.admit("chaos_step", {"phi": phi}, deadline_ms=bad)
        assert ei.value.code == 422


def test_drain_finishes_queued_then_rejects(step, templates):
    eng = make_engine(step, templates)

    async def go():
        phi = request_state(DOM, seed=1)
        reqs = [eng.submit("chaos_step", {"phi": phi}, steps=2) for _ in range(3)]
        assert await eng.drain(timeout_s=30.0)
        assert eng.state == DRAINING
        for r in reqs:
            evs = [ev async for ev in eng.stream(r)]
            assert evs[-1]["type"] == "done"
        with pytest.raises(ServingError) as ei:
            eng.submit("chaos_step", {"phi": phi}, steps=1)
        assert ei.value.code == OVERLOADED and "drain" in ei.value.reason

    asyncio.run(go())


# ---------------------------------------------------------------------------
# the orphaned-request regression: worker failures must never strand requests
# ---------------------------------------------------------------------------


def test_worker_failure_outside_batch_fails_requests_not_liveness(step, templates):
    """Regression: an exception outside the per-chunk try (here: window
    formation in the scheduler) used to kill the worker silently, hanging
    every queued request forever.  Now the pooled requests get error events
    and the very next request still works."""
    eng = make_engine(step, templates)
    real_take = eng.scheduler.take
    eng.scheduler.take = lambda now: (_ for _ in ()).throw(RuntimeError("grouping exploded"))

    async def go():
        async with eng:
            phi = request_state(DOM, seed=1)
            req = eng.submit("chaos_step", {"phi": phi}, steps=1)
            evs = await asyncio.wait_for(_collect(eng, req), timeout=10.0)
            assert evs[-1]["type"] == "error" and evs[-1]["code"] == 500
            assert "grouping exploded" in evs[-1]["reason"]
            assert eng.stats()["worker_failures"] == 1
            # heal the scheduler; the worker survived and serves again
            eng.scheduler.take = real_take
            req2 = eng.submit("chaos_step", {"phi": phi}, steps=1)
            evs2 = await asyncio.wait_for(_collect(eng, req2), timeout=30.0)
            assert evs2[-1]["type"] == "done"

    asyncio.run(go())


async def _collect(eng, req):
    return [ev async for ev in eng.stream(req)]


def test_dead_worker_task_fails_queued_requests(step, templates):
    """Belt-and-braces: if the worker task itself dies, its done-callback
    fails everything still queued and the next submit respawns it."""
    eng = make_engine(step, templates)

    async def suicidal():
        raise RuntimeError("worker died at birth")

    async def go():
        phi = request_state(DOM, seed=1)
        # install a worker that dies immediately, then submit
        eng._worker = asyncio.get_running_loop().create_task(suicidal())
        eng._worker.add_done_callback(eng._worker_died)
        await asyncio.sleep(0.01)
        assert eng._worker is None  # the callback cleared it
        req = eng.submit("chaos_step", {"phi": phi}, steps=1)  # respawns
        evs = await asyncio.wait_for(_collect(eng, req), timeout=30.0)
        assert evs[-1]["type"] == "done"
        await eng.aclose()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# DEGRADED sheds per-step statistics
# ---------------------------------------------------------------------------


def test_degraded_sheds_stats_emission(step, templates):
    eng = make_engine(step, templates, max_queue=4, degraded_watermark=0.25)
    gate = asyncio.Event()
    real_run_batch = eng._run_batch

    async def gated(entry, requests):
        await gate.wait()
        await real_run_batch(entry, requests)

    eng._run_batch = gated

    async def go():
        async with eng:
            phi = request_state(DOM, seed=1)
            first = eng.submit("chaos_step", {"phi": phi}, steps=1, stats=True)
            await asyncio.sleep(0.06)
            queued = [eng.submit("chaos_step", {"phi": phi}, steps=1, stats=True) for _ in range(2)]
            assert eng.state == DEGRADED
            gate.set()
            evs = await asyncio.wait_for(_collect(eng, first), timeout=30.0)
            steps = [e for e in evs if e["type"] == "step"]
            # the first batch ran while DEGRADED: its stats were shed
            assert steps and all("stats" not in e for e in steps)
            for r in queued:
                await asyncio.wait_for(_collect(eng, r), timeout=30.0)

    asyncio.run(go())


# ---------------------------------------------------------------------------
# determinism of the chaos run itself (same seed → same casualty list)
# ---------------------------------------------------------------------------


def test_chaos_run_is_reproducible(step, templates):
    def casualties(seed):
        inj = chaos_injector(("dispatch",), rate=0.5, seed=seed)
        eng = make_engine(step, templates, faults=inj, retry_attempts=2)
        specs = [
            RequestSpec(
                "chaos_step",
                {"phi": request_state(DOM, seed=i + 1)},
                steps=2,
                request_id=f"r{i}",
            )
            for i in range(4)
        ]
        rep = drive(eng, specs)
        return sorted(r.request_id for r in rep.results if not r.ok)

    assert casualties(11) == casualties(11)
