"""SLO engine + autoscaler contract tests.

The load-bearing assertions:

* burn-rate math follows the multi-window recipe: burn = (bad/total in the
  window) / error budget, a rule fires only when BOTH its windows exceed the
  threshold, and evaluation is clock-injectable so timelines replay;
* breach *transitions* (not steady states) flip the ``serving_slo_breach``
  gauge, emit the ``slo.breach``/``slo.recovered`` trace instants, and invoke
  ``on_breach`` exactly once per edge;
* latency objectives accrue "bad" traffic from request deltas while the
  windowed p99 sits above target;
* the autoscaler's desired-replica rule is the documented one — queue term,
  capped latency term, breach term — immediate on the way up, damped on the
  way down;
* the acceptance chain: seeded chaos → deterministic error counts → the SAME
  breach timeline and the SAME ``/autoscale`` recommendation on two
  identical runs, with the breach dumping a flight bundle.
"""

import asyncio

import pytest

from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import trace as otrace
from repro_torch.obs.slo import (
    AVAILABILITY,
    ERROR_RATE,
    LATENCY_P99,
    Autoscaler,
    BurnRule,
    Objective,
    SloEngine,
)
from repro_torch.serving import FaultInjector, RequestSpec, ServingEngine, drive_engine
from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields, request_state

DOM = (10, 8, 4)


# ---------------------------------------------------------------------------
# objectives: kinds, budgets
# ---------------------------------------------------------------------------


def test_objective_kinds_and_error_budgets():
    avail = Objective("a", "p", AVAILABILITY, 0.999)
    assert avail.error_budget() == pytest.approx(0.001)
    err = Objective("e", "p", ERROR_RATE, 0.002)
    assert err.error_budget() == pytest.approx(0.002)
    lat = Objective("l", "p", LATENCY_P99, 0.5)
    assert lat.error_budget() == obs_slo.LATENCY_BUDGET
    assert Objective("l2", "p", LATENCY_P99, 0.5, budget=0.05).error_budget() == 0.05
    with pytest.raises(ValueError, match="unknown objective kind"):
        Objective("x", "p", "p50_latency", 0.5)


def test_default_objectives_helper():
    objs = obs_slo.default_objectives("fc", availability=0.99, p99_s=0.25)
    assert [o.kind for o in objs] == [AVAILABILITY, LATENCY_P99]
    assert all(o.program == "fc" for o in objs)
    assert objs[0].target == 0.99 and objs[1].target == 0.25


# ---------------------------------------------------------------------------
# burn-rate math over the sample rings
# ---------------------------------------------------------------------------


def _availability_fixture(rules):
    reg = obs_metrics.MetricsRegistry()
    req = reg.counter("serving_requests_total", "", program="p")
    err = reg.counter("serving_errors_total", "", program="p", code="500")
    slo = SloEngine(reg, [Objective("avail", "p", AVAILABILITY, 0.999)], rules=rules)
    return reg, req, err, slo


def test_burn_rate_is_windowed_bad_fraction_over_budget():
    _, req, err, slo = _availability_fixture((BurnRule("fast", 10.0, 60.0, 14.4),))
    req.inc(100)
    slo.sample(now=0.0)
    req.inc(100)
    err.inc(2)  # 2% bad over the last window against a 0.1% budget → burn 20
    out = aggregate = slo.evaluate(now=10.0)
    (rule,) = aggregate["objectives"][0]["rules"]
    assert rule["short_burn"] == pytest.approx(20.0)
    assert rule["long_burn"] == pytest.approx(20.0)  # window > history → all of it
    assert rule["breaching"] and out["breaching"]


def test_rule_fires_only_when_both_windows_exceed():
    """A short spike over a long quiet stretch must NOT page (the long window
    vetoes); that is the whole point of pairing windows."""
    _, req, err, slo = _availability_fixture((BurnRule("fast", 10.0, 60.0, 14.4),))
    req.inc(100)
    slo.sample(now=0.0)
    req.inc(500)
    slo.sample(now=60.0)  # a long, clean stretch
    req.inc(10)
    err.inc(2)  # then a 20%-bad spike in the last 10 s
    out = slo.evaluate(now=70.0)
    (rule,) = out["objectives"][0]["rules"]
    assert rule["short_burn"] > 14.4
    assert rule["long_burn"] < 14.4
    assert not rule["breaching"] and not out["breaching"]


def test_no_traffic_burns_nothing():
    _, _, _, slo = _availability_fixture(obs_slo.DEFAULT_RULES)
    out = slo.evaluate(now=0.0)
    assert not out["breaching"]
    assert all(
        r["short_burn"] == 0.0 for o in out["objectives"] for r in o["rules"]
    )


def test_latency_objective_accrues_bad_while_p99_above_target():
    reg = obs_metrics.MetricsRegistry()
    req = reg.counter("serving_requests_total", "", program="p")
    hist = reg.histogram("serving_request_latency_seconds", "", program="p")
    slo = SloEngine(
        reg,
        [Objective("lat", "p", LATENCY_P99, 0.1)],
        rules=(BurnRule("fast", 10.0, 60.0, 14.4),),
    )
    slo.sample(now=0.0)
    req.inc(10)
    hist.observe(0.5)  # p99 = 0.5 ≫ 0.1 target: the 10 new requests are "bad"
    out = slo.evaluate(now=10.0)
    (rule,) = out["objectives"][0]["rules"]
    assert rule["short_burn"] == pytest.approx(10 / 10 / obs_slo.LATENCY_BUDGET)
    assert out["breaching"]
    assert slo.latency_pressure() == pytest.approx(5.0)
    # p99 back under target: new traffic stops accruing bad
    for _ in range(600):
        hist.observe(0.01)
    req.inc(1000)
    out = slo.evaluate(now=20.0)
    (rule,) = out["objectives"][0]["rules"]
    assert rule["short_burn"] < 14.4
    assert not out["breaching"]


# ---------------------------------------------------------------------------
# breach transitions: gauges, trace instants, on_breach
# ---------------------------------------------------------------------------


def test_breach_transitions_fire_once_per_edge():
    tracer = otrace.Tracer(enabled=True)
    reg = obs_metrics.MetricsRegistry()
    req = reg.counter("serving_requests_total", "", program="p")
    err = reg.counter("serving_errors_total", "", program="p", code="500")
    breaches = []
    slo = SloEngine(
        reg,
        [Objective("avail", "p", AVAILABILITY, 0.999)],
        rules=(BurnRule("fast", 10.0, 60.0, 14.4),),
        tracer=lambda: tracer,
        on_breach=breaches.append,
    )
    req.inc(100)
    slo.sample(now=0.0)
    req.inc(10)
    err.inc(5)
    slo.evaluate(now=10.0)  # edge: healthy → breaching
    slo.evaluate(now=11.0)  # steady breach — no second alert
    assert len(breaches) == 1 and breaches[0]["objective"] == "avail"
    gauge = reg.gauge("serving_slo_breach", objective="avail", program="p")
    assert gauge.value == 1.0
    burn = reg.gauge(
        "serving_slo_burn_rate", objective="avail", program="p", window="fast_short"
    )
    assert burn.value > 14.4
    # recovery edge
    req.inc(100_000)
    slo.evaluate(now=21.0)
    assert gauge.value == 0.0
    names = [s["name"] for s in tracer.snapshot()]
    assert names.count("slo.breach") == 1 and names.count("slo.recovered") == 1
    assert slo.status()["breaching"] is False


def test_on_breach_failure_does_not_break_evaluation():
    reg = obs_metrics.MetricsRegistry()
    req = reg.counter("serving_requests_total", "", program="p")
    err = reg.counter("serving_errors_total", "", program="p", code="500")

    def explode(_status):
        raise RuntimeError("pager down")

    slo = SloEngine(
        reg,
        [Objective("avail", "p", AVAILABILITY, 0.999)],
        rules=(BurnRule("fast", 10.0, 60.0, 1.0),),
        on_breach=explode,
    )
    slo.sample(now=0.0)
    req.inc(10)
    err.inc(10)
    out = slo.evaluate(now=10.0)  # alerting must never take serving down
    assert out["breaching"]


def test_add_objectives_after_construction():
    reg = obs_metrics.MetricsRegistry()
    slo = SloEngine(reg)
    assert slo.evaluate(now=0.0)["objectives"] == []
    slo.add(*obs_slo.default_objectives("fc"))
    out = slo.evaluate(now=1.0)
    assert [o["objective"] for o in out["objectives"]] == ["fc-availability", "fc-latency"]
    # re-adding by name replaces instead of duplicating
    slo.add(Objective("fc-latency", "fc", LATENCY_P99, 1.0))
    assert len(slo.objectives) == 2


# ---------------------------------------------------------------------------
# the autoscaler rule
# ---------------------------------------------------------------------------


def test_autoscaler_queue_term_scales_up_immediately():
    a = Autoscaler(replicas=1, max_replicas=8, target_utilization=0.75)
    # 24 member-slots of backlog against one replica of capacity 8:
    # utilization 3.0 → queue term 1 * 3 / 0.75 = 4 → desired 4, immediately
    rec = a.recommend(queue_depth=20, inflight=4, max_batch=8)
    assert rec["desired_replicas"] == 4
    assert rec["reason"] == "scale_up:queue"
    assert rec["inputs"]["utilization"] == pytest.approx(3.0)


def test_autoscaler_latency_term_is_capped():
    a = Autoscaler(replicas=2, max_replicas=16, latency_ratio_cap=4.0)
    rec = a.recommend(queue_depth=0, inflight=0, max_batch=8, latency_ratio=100.0)
    # one outlier cannot demand the moon: term = 2 * min(100, 4) = 8
    assert rec["desired_replicas"] == 8
    assert rec["reason"] == "scale_up:latency"
    # pressure ≤ 1 contributes no term at all
    rec = a.recommend(queue_depth=0, inflight=0, max_batch=8, latency_ratio=0.9)
    assert "latency" not in rec["terms"]


def test_autoscaler_breach_term_asks_for_one_more():
    a = Autoscaler(replicas=3, max_replicas=8)
    rec = a.recommend(queue_depth=0, inflight=0, max_batch=8, breaching=True)
    assert rec["desired_replicas"] == 4
    assert rec["reason"] == "scale_up:slo_breach"


def test_autoscaler_scale_down_is_damped_and_stepwise():
    a = Autoscaler(replicas=4, down_stable_evals=3)
    idle = dict(queue_depth=0, inflight=0, max_batch=8)
    assert a.recommend(**idle)["reason"] == "hold:damping(1/3)"
    assert a.recommend(**idle)["reason"] == "hold:damping(2/3)"
    rec = a.recommend(**idle)
    # three consecutive agreements, then exactly ONE step down
    assert rec["reason"] == "scale_down:stable"
    assert rec["desired_replicas"] == 3
    # any scale-up signal resets the streak
    a.recommend(**idle)
    a.recommend(queue_depth=50, inflight=0, max_batch=8)
    assert a.recommend(**idle)["reason"] == "hold:damping(1/3)"


def test_autoscaler_clamps_and_observe_replicas():
    a = Autoscaler(replicas=1, min_replicas=2, max_replicas=4)
    rec = a.recommend(queue_depth=1000, inflight=0, max_batch=1)
    assert rec["desired_replicas"] == 4  # clamped to max
    a.observe_replicas(4)
    assert a.replicas == 4
    rec = a.recommend(queue_depth=0, inflight=0, max_batch=1)
    assert rec["desired_replicas"] == 4  # damped hold, not a jump to min
    assert rec["replicas"] == 4


# ---------------------------------------------------------------------------
# the acceptance chain: seeded chaos → breach → alert → /autoscale, twice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="slo_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


def _chain_once(step, templates, flight_dir):
    """One full run: poison-seeded faults produce a deterministic error
    count; the SLO engine is evaluated on an injected clock; the autoscale
    recommendation is read at the end.  Everything returned must be
    bit-identical across runs."""
    fields, scalars = templates
    tracer = otrace.Tracer(enabled=True, sample_rate=0.5)
    inj = FaultInjector(sites=("dispatch",), rate=0.0, seed=7, poison=("poison-1",))
    eng = ServingEngine(
        window_ms=25.0,
        retry_backoff_ms=1.0,
        faults=inj,
        tracer=tracer,
        slos=[Objective("avail", "slo_step", AVAILABILITY, 0.999)],
        flight=obs_flight.FlightRecorder(flight_dir),
    )
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2, 4),
        max_steps=100,
    )
    eng.slo.sample(now=0.0)
    specs = [
        RequestSpec(
            program="slo_step",
            fields={"phi": request_state(DOM, seed=i + 1)},
            steps=4,
            stream_every=2,
            request_id="poison-1" if i == 1 else f"ok-{i}",
        )
        for i in range(4)
    ]

    async def go():
        async with eng:
            return await drive_engine(eng, specs, keep_fields="none")

    report = asyncio.run(go())
    assert sum(not r.ok for r in report.results) == 1  # exactly the poison

    timeline = []
    for t in (10.0, 20.0):
        status = eng.slo.evaluate(now=t)
        timeline.append(
            (
                t,
                status["breaching"],
                [
                    (r["rule"], round(r["short_burn"], 6), round(r["long_burn"], 6),
                     r["breaching"])
                    for o in status["objectives"]
                    for r in o["rules"]
                ],
            )
        )
    rec = eng.autoscale_signal(now=30.0)
    breach_events = [s["name"] for s in tracer.snapshot() if s["name"] == "slo.breach"]
    return {
        "timeline": timeline,
        "desired": rec["desired_replicas"],
        "reason": rec["reason"],
        "breaching": rec["slo"]["breaching"],
        "breach_events": breach_events,
        "errors": eng.stats()["errors"],
        "last_bundle": eng.flight.last_bundle,
    }


def test_breach_to_autoscale_chain_is_deterministic(step, templates, tmp_path):
    a = _chain_once(step, templates, tmp_path / "a")
    b = _chain_once(step, templates, tmp_path / "b")

    # one poisoned request out of four burns 25% of traffic against a 0.1%
    # budget — far past every default rule — so the chain must fire...
    assert a["errors"] == 1
    assert a["timeline"][0][1] is True  # breaching at the first evaluation
    assert a["breaching"] is True
    assert a["reason"] == "scale_up:slo_breach"
    assert a["desired"] == 2
    assert a["breach_events"] == ["slo.breach"]  # one edge, one alert

    # ...and the breach dumped a flight bundle naming the objective
    assert a["last_bundle"] is not None
    bundle = obs_flight.load_bundle(a["last_bundle"])
    assert bundle["reason"] == "slo_breach:avail"
    assert bundle["extra"]["breach"]["objective"] == "avail"

    # the determinism contract: same breach timeline, same recommendation
    for key in ("timeline", "desired", "reason", "breaching", "breach_events", "errors"):
        assert a[key] == b[key], key


def test_engine_stats_and_autoscale_surface_slo(step, templates):
    fields, scalars = templates
    eng = ServingEngine(
        window_ms=25.0,
        slos=obs_slo.default_objectives("slo_step"),
    )
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2),
        max_steps=100,
    )
    st = eng.stats()
    assert st["slo"]["breaching"] is False
    assert {o["objective"] for o in st["slo"]["objectives"]} == {
        "slo_step-availability", "slo_step-latency",
    }
    rec = eng.autoscale_signal(now=0.0)
    assert rec["desired_replicas"] == 1
    assert rec["reason"].startswith("hold")
    assert rec["slo"]["breaching"] is False
    text = eng.metrics.to_prometheus()
    assert "# TYPE serving_slo_burn_rate gauge" in text
    assert 'serving_slo_breach{objective="slo_step-availability",program="slo_step"} 0.0' in text
