"""Telemetry contract tests: tracer, metrics registry, exporters, and the
request-correlated serving instrumentation.

The load-bearing assertions:

* the disabled tracing path is a shared no-op singleton with a bounded cost
  (serving/stencil hot paths call ``span()`` unconditionally);
* trace IDs propagate through a bisected poison batch — one batch span links
  every co-batched request, and the bisect/retry events carry the affected
  request ids — so one request's whole story is recoverable from a dump;
* the Chrome-trace/Perfetto export validates against its own schema checker
  (the same one the CI trace-capture step runs);
* the Prometheus text exposition carries the engine's counters, gauges, and
  latency summaries;
* ``retry_after_ms`` stays sane before the watchdog has any samples (the
  empty-median regression).
"""

import asyncio
import json
import math
import time

import numpy as np
import pytest

from repro_torch.obs import export as obs_export
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sampling as obs_sampling
from repro_torch.obs import trace as otrace
from repro_torch.runtime.supervise import StragglerWatchdog
from repro_torch.serving import FaultInjector, RequestSpec, ServingEngine, drive_engine
from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields, request_state

DOM = (10, 8, 4)


# ---------------------------------------------------------------------------
# tracer: spans, nesting, ring buffer
# ---------------------------------------------------------------------------


def test_span_nesting_attrs_events_and_links():
    tr = otrace.Tracer(enabled=True)
    with tr.span("outer", category="t", a=1) as outer:
        outer.event("mark", note="hi")
        with tr.span("inner", trace_id="req-1") as inner:
            inner.set("b", 2)
            inner.link("req-2")
            inner.link("req-2")  # idempotent
    spans = tr.snapshot()
    assert [s["name"] for s in spans] == ["inner", "outer"]  # finish order
    inner_d, outer_d = spans
    assert inner_d["parent"] == outer_d["id"]
    assert inner_d["trace_ids"] == ["req-1", "req-2"]
    assert inner_d["attrs"]["b"] == 2
    assert outer_d["attrs"]["a"] == 1
    assert outer_d["events"][0]["name"] == "mark"
    assert outer_d["end_s"] >= outer_d["start_s"]


def test_span_records_error_attribute():
    tr = otrace.Tracer(enabled=True)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("kaput")
    (sp,) = tr.snapshot()
    assert sp["attrs"]["error"] == "ValueError: kaput"


def test_ring_buffer_retention_is_bounded():
    tr = otrace.Tracer(enabled=True, capacity=8)
    for i in range(50):
        with tr.span(f"s{i}"):
            pass
    spans = tr.snapshot()
    assert len(spans) == 8
    assert [s["name"] for s in spans] == [f"s{i}" for i in range(42, 50)]
    tr.clear()
    assert len(tr) == 0


def test_standalone_event_becomes_instant_record():
    tr = otrace.Tracer(enabled=True)
    tr.event("lonely", trace_ids=("r1",), why="no span open")
    (ev,) = tr.snapshot()
    assert ev["instant"] and ev["trace_ids"] == ["r1"] and ev["start_s"] == ev["end_s"]


def test_event_inside_span_attaches_and_carries_trace_ids():
    tr = otrace.Tracer(enabled=True)
    with tr.span("host"):
        tr.event("hit", trace_ids=("r9",), site="dispatch")
    (sp,) = tr.snapshot()
    assert sp["trace_ids"] == ["r9"]  # linked onto the span
    assert sp["events"][0]["attrs"]["trace_ids"] == ["r9"]  # and kept on the event


# ---------------------------------------------------------------------------
# the disabled fast path
# ---------------------------------------------------------------------------


def test_disabled_span_is_the_noop_singleton():
    tr = otrace.Tracer(enabled=False)
    assert tr.span("anything") is otrace.NOOP_SPAN
    assert tr.span("other", trace_id="x", heavy=list(range(100))) is otrace.NOOP_SPAN
    tr.event("dropped")
    tr.add_span("dropped", 0.0, 1.0)
    assert len(tr) == 0


def test_disabled_path_overhead_is_bounded():
    """100k disabled span() round-trips must stay well under a second — the
    serving hot path calls this unconditionally per dispatch/gather."""
    tr = otrace.Tracer(enabled=False)
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("hot", category="serving"):
            pass
    dt = time.perf_counter() - t0
    assert len(tr) == 0
    assert dt < 1.0, f"{n} disabled spans took {dt:.3f}s"


# ---------------------------------------------------------------------------
# head-based sampling
# ---------------------------------------------------------------------------


def _id_with(rate, sampled, prefix="req", seed=0):
    """A deterministic request id whose head hash lands in (or out of) the
    keep region — so tests choose their sampled/dropped ids explicitly."""
    for i in range(10_000):
        rid = f"{prefix}-{i}"
        if (obs_sampling.sample_unit(rid, seed) < rate) == sampled:
            return rid
    raise AssertionError("no id found")  # pragma: no cover


def test_sample_unit_is_deterministic_and_roughly_uniform():
    ids = [f"req-{i}" for i in range(2000)]
    draws = [obs_sampling.sample_unit(t) for t in ids]
    assert draws == [obs_sampling.sample_unit(t) for t in ids]  # pure function
    assert all(0.0 <= d < 1.0 for d in draws)
    frac = sum(d < 0.25 for d in draws) / len(draws)
    assert 0.18 < frac < 0.32  # a hash, not a statistician — loose bounds
    # the seed reshuffles the draw (different tracers can sample independently)
    assert obs_sampling.sample_unit("req-0", 0) != obs_sampling.sample_unit("req-0", 1)


def test_head_sampled_rate_extremes():
    assert obs_sampling.head_sampled("anything", 1.0)
    assert not obs_sampling.head_sampled("anything", 0.0)


def test_rate_from_env_parses_and_clamps(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_SAMPLE", raising=False)
    assert obs_sampling.rate_from_env() == 1.0
    monkeypatch.setenv("REPRO_TRACE_SAMPLE", "0.25")
    assert obs_sampling.rate_from_env() == 0.25
    monkeypatch.setenv("REPRO_TRACE_SAMPLE", "7")
    assert obs_sampling.rate_from_env() == 1.0  # clamped
    monkeypatch.setenv("REPRO_TRACE_SAMPLE", "-1")
    assert obs_sampling.rate_from_env() == 0.0
    monkeypatch.setenv("REPRO_TRACE_SAMPLE", "banana")
    assert obs_sampling.rate_from_env() == 1.0  # a typo must not disable tracing


def test_sampling_policy_forced_ids_win_and_are_bounded():
    pol = obs_sampling.SamplingPolicy(0.0, forced_capacity=4)
    assert not pol.decide("req-1")
    pol.force("req-1")
    assert pol.decide("req-1") and pol.is_forced("req-1")
    assert pol.sampled(["req-0", "req-1"])  # any forced id keeps the span
    # FIFO eviction past capacity — errors are rare, the set stays bounded
    pol.force("a", "b", "c", "d")
    assert not pol.is_forced("req-1")
    assert pol.is_forced("d")
    # no ids → always kept (sampling is a per-request budget)
    assert pol.sampled([])


def test_tracer_drops_sampled_out_spans_keeps_idfree():
    tr = otrace.Tracer(enabled=True, sample_rate=0.0)
    assert tr.span("serving.queue", trace_id="req-7") is otrace.NOOP_SPAN
    tr.event("serving.done", trace_ids=("req-7",))
    tr.add_span("serving.admit", 0.0, 1.0, trace_ids=("req-7",))
    assert len(tr) == 0
    # spans with NO request correlation (compiles, windows) are always kept
    with tr.span("program.compile"):
        pass
    assert [s["name"] for s in tr.snapshot()] == ["program.compile"]


def test_batch_span_kept_iff_any_member_sampled():
    rate = 0.5
    kept = _id_with(rate, True, "kept")
    dropped = _id_with(rate, False, "drop")
    tr = otrace.Tracer(enabled=True, sample_rate=rate)
    with tr.span("serving.batch", trace_ids=(dropped, kept)):
        pass
    with tr.span("serving.batch", trace_ids=(dropped,)):
        pass
    spans = tr.snapshot()
    # the co-batched span a sampled request rode is retained; the all-dropped
    # batch is not
    assert len(spans) == 1 and kept in spans[0]["trace_ids"]


def test_forced_event_bypasses_gate_and_pins_ids():
    tr = otrace.Tracer(enabled=True, sample_rate=0.0)
    # the error/bisect/deadline paths force: recorded despite rate 0...
    tr.event("serving.retry", trace_ids=("req-9",), force=True, site="dispatch")
    assert len(tr) == 1
    # ...and everything that happens to req-9 afterwards is retained too
    with tr.span("serving.dispatch", trace_id="req-9"):
        pass
    tr.add_span("serving.queue", 0.0, 1.0, trace_ids=("req-9",))
    assert [s["name"] for s in tr.snapshot()] == [
        "serving.retry", "serving.dispatch", "serving.queue"
    ]


def test_sampled_out_overhead_is_bounded():
    """A sampled-out request costs one hash check per span attempt — the
    same generous wall bound the fully-disabled path gets."""
    tr = otrace.Tracer(enabled=True, sample_rate=1e-12)
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("hot", category="serving", trace_id="req-sampled-out"):
            pass
    dt = time.perf_counter() - t0
    assert len(tr) == 0
    assert dt < 1.0, f"{n} sampled-out spans took {dt:.3f}s"


def test_configure_sample_rate_and_capture_default():
    tr = otrace.configure(sample_rate=0.5)
    try:
        assert tr.sample_rate == 0.5
        # capacity rebuild must not silently reset the rate to 1.0
        tr = otrace.configure(capacity=tr.capacity + 1)
        assert tr.sample_rate == 0.5
    finally:
        otrace.configure(sample_rate=1.0)
    # a deliberate capture() keeps everything regardless of the env knob
    with otrace.capture() as cap:
        pass
    assert cap.sample_rate == 1.0


def test_capture_routes_module_level_spans_locally():
    before = len(otrace.get_tracer())
    with otrace.capture() as cap:
        with otrace.span("captured", category="test"):
            pass
        assert otrace.enabled()
    assert [s["name"] for s in cap.snapshot()] == ["captured"]
    assert len(otrace.get_tracer()) == before  # default tracer untouched


# ---------------------------------------------------------------------------
# metrics registry + Prometheus exposition
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("t_total", "things")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("t_level", "level")
    g.set(5)
    g.dec(2)
    assert g.value == 3
    live = reg.gauge("t_live", "callback-backed", fn=lambda: 42.0)
    assert live.value == 42.0
    broken = reg.gauge("t_broken", "bad callback", fn=lambda: 1 / 0)
    assert math.isnan(broken.value)  # a scrape must survive a bad callback
    h = reg.histogram("t_seconds", "walls")
    for v in [1.0, 2.0, 3.0, 4.0, 5.0]:
        h.observe(v)
    assert h.count == 5 and h.sum == 15.0
    assert h.quantile(0.5) == 3.0
    assert h.quantile(0.99) == 5.0
    assert math.isnan(reg.histogram("t_empty", "no samples").quantile(0.5))


def test_registry_rejects_kind_conflicts_and_bad_names():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("dual", "x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("dual", "x")
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad-name", "x")
    with pytest.raises(ValueError, match="invalid label name"):
        reg.counter("ok", "x", **{"bad-label": "v"})


def test_prometheus_text_exposition_contract():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("req_total", "requests", code="200").inc(7)
    reg.counter("req_total", "requests", code="503").inc(1)
    reg.gauge("depth", "queue depth").set(4)
    h = reg.histogram("lat_seconds", "latency")
    h.observe(0.25)
    text = reg.to_prometheus()
    lines = text.splitlines()
    assert "# HELP req_total requests" in lines
    assert "# TYPE req_total counter" in lines
    assert 'req_total{code="200"} 7.0' in lines
    assert 'req_total{code="503"} 1.0' in lines
    assert "# TYPE depth gauge" in lines
    assert "depth 4.0" in lines
    assert "# TYPE lat_seconds summary" in lines
    assert 'lat_seconds{quantile="0.5"} 0.25' in lines
    assert "lat_seconds_sum 0.25" in lines
    assert "lat_seconds_count 1.0" in lines
    # every non-comment line is "name{labels} value" with a float-parseable value
    for ln in lines:
        if ln.startswith("#") or not ln:
            continue
        float(ln.rsplit(" ", 1)[1])


def test_never_observed_histogram_renders_empty_summary():
    """A histogram with zero observations must export the Prometheus-idiomatic
    empty summary — ``_count 0``/``_sum 0`` and NO quantile lines (NaN samples
    poison scrapers) — and omit the quantile keys from the JSON summary."""
    reg = obs_metrics.MetricsRegistry()
    reg.histogram("dispatch_seconds", "walls", program="cold")
    text = reg.to_prometheus()
    assert "# TYPE dispatch_seconds summary" in text
    assert 'dispatch_seconds_count{program="cold"} 0' in text
    assert 'dispatch_seconds_sum{program="cold"} 0.0' in text
    assert "quantile" not in text
    assert "NaN" not in text
    summary = reg.histogram("dispatch_seconds", program="cold").summary()
    assert summary == {"count": 0.0, "sum": 0.0}
    # first observation brings the quantile samples back
    reg.histogram("dispatch_seconds", program="cold").observe(0.25)
    text = reg.to_prometheus()
    assert 'dispatch_seconds{program="cold",quantile="0.5"} 0.25' in text
    assert "p99" in reg.histogram("dispatch_seconds", program="cold").summary()


def test_registry_read_sum_and_quantile_helpers():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("errs_total", "", program="a", code="500").inc(2)
    reg.counter("errs_total", "", program="a", code="504").inc(3)
    reg.counter("errs_total", "", program="b", code="500").inc(7)
    # subset label match rolls extra dimensions up
    assert reg.sum_value("errs_total", program="a") == 5
    assert reg.sum_value("errs_total") == 12
    assert reg.sum_value("nonexistent_total") == 0.0
    assert reg.quantile("lat_seconds", 0.99) is None
    reg.histogram("lat_seconds", "", program="a").observe(0.1)
    reg.histogram("lat_seconds", "", program="b").observe(0.4)
    # worst-case (max) across matching children
    assert reg.quantile("lat_seconds", 0.99) == 0.4
    assert reg.quantile("lat_seconds", 0.99, program="a") == 0.1


def test_collect_is_json_friendly():
    import json

    reg = obs_metrics.MetricsRegistry()
    reg.counter("a_total", "a").inc(2)
    reg.histogram("b_seconds", "b").observe(1.5)
    out = reg.collect()
    assert out["a_total"] == 2
    assert out["b_seconds"]["count"] == 1 and out["b_seconds"]["p50"] == 1.5
    json.dumps(out)  # /stats embeds this verbatim


# ---------------------------------------------------------------------------
# chrome-trace export + validation
# ---------------------------------------------------------------------------


def test_chrome_trace_schema_roundtrip(tmp_path):
    tr = otrace.Tracer(enabled=True)
    with tr.span("parent", category="c", trace_id="r1", k="v") as sp:
        sp.event("ping", n=1)
        with tr.span("child"):
            pass
    tr.event("orphan", trace_ids=("r2",))
    path = tmp_path / "trace.json"
    data = obs_export.write_chrome_trace(path, tracer=tr, metadata={"run": "test"})
    events = obs_export.validate_chrome_trace(data)
    names = [e["name"] for e in events]
    assert names[0] == "process_name" and events[0]["ph"] == "M"
    assert "parent" in names and "child" in names and "ping" in names and "orphan" in names
    parent = next(e for e in events if e["name"] == "parent")
    child = next(e for e in events if e["name"] == "child")
    assert parent["ph"] == "X" and parent["args"]["trace_ids"] == ["r1"]
    assert child["args"]["parent_span_id"] == parent["args"]["span_id"]
    assert data["otherData"]["run"] == "test"
    # the CLI validator agrees
    assert obs_export.main([str(path)]) == 0


@pytest.mark.parametrize(
    "bad",
    [
        [],
        {"traceEvents": "nope"},
        {"traceEvents": [{"ph": "X"}]},  # missing name/pid/tid
        {"traceEvents": [{"name": "a", "ph": "Z", "pid": 1, "tid": 1, "ts": 0}]},
        {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},  # no dur
    ],
)
def test_chrome_trace_validator_rejects(bad):
    with pytest.raises(ValueError):
        obs_export.validate_chrome_trace(bad)


def test_request_events_filters_by_trace_id():
    tr = otrace.Tracer(enabled=True)
    with tr.span("batch", trace_ids=("r1", "r2")):
        pass
    with tr.span("other", trace_id="r3"):
        pass
    data = obs_export.chrome_trace(tr.snapshot())
    mine = obs_export.request_events(data, "r1")
    assert [e["name"] for e in mine] == ["batch"]


def test_export_cli_exit_codes(tmp_path, capsys):
    """The ``python -m repro.obs.export`` contract: 0 only for a valid trace,
    1 + one-line stderr reason for unreadable/invalid input IN EVERY MODE
    (census mode used to be reachable without the validation gate), 2 usage."""
    tr = otrace.Tracer(enabled=True)
    with tr.span("a", trace_id="r1"):
        pass
    good = tmp_path / "good.json"
    obs_export.write_chrome_trace(good, tr.snapshot())

    assert obs_export.main([str(good)]) == 0
    assert "OK" in capsys.readouterr().out

    assert obs_export.main(["--census-json", str(good)]) == 0
    census = json.loads(capsys.readouterr().out)
    assert census["events"] == 1 and census["names"] == {"a": 1}

    missing = tmp_path / "nope.json"
    for mode in ([], ["--census-json"]):
        assert obs_export.main([*mode, str(missing)]) == 1
        err = capsys.readouterr().err
        assert err.count("\n") == 1 and "INVALID" in err

    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert obs_export.main(["--census-json", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err

    notrace = tmp_path / "notrace.json"
    notrace.write_text('{"spans": []}')
    assert obs_export.main([str(notrace)]) == 1
    assert "traceEvents" in capsys.readouterr().err

    assert obs_export.main([]) == 2
    assert obs_export.main(["--census-json"]) == 2
    assert obs_export.main(["--bogus-flag", str(good)]) == 2


class _Boom(RuntimeError):
    pass


def _profiler_case(case, tracer, monkeypatch):
    if case == "never_raises":
        with tracer.span("unit-test"):
            x = 1 + 1
        assert x == 2
    elif case == "propagates_body_exception":
        # the wrapped block's exception must surface with its original
        # type/message: retry-with-bisect keys off it
        with pytest.raises(_Boom, match="original dispatch failure"):
            with tracer.span("unit-test"):
                raise _Boom("original dispatch failure")
    elif case == "survives_broken_annotation":
        # a record_function that blows up on entry must neither fail the
        # work nor swallow the body's own exception
        def _broken_record_function(name):
            raise OSError("profiler backend unavailable")

        monkeypatch.setattr(otrace, "_record_function", _broken_record_function)
        with tracer.span("unit-test"):
            x = 1 + 1
        assert x == 2
        with pytest.raises(ValueError, match="body failure"):
            with tracer.span("unit-test"):
                raise ValueError("body failure")
    else:  # labels_a_profile: the span is a record_function range the profile carries by name
        import torch

        with tracer.span("serving.dispatch", profile_name="serving.dispatch[unit]"):
            torch.ones(4).sum()
        assert all(s["name"] == "serving.dispatch" for s in tracer.snapshot())


@pytest.mark.parametrize(
    "case", ["never_raises", "propagates_body_exception", "survives_broken_annotation", "labels_a_profile"]
)
def test_profiler_bridge(case, monkeypatch):
    """While a torch.profiler session records, every span, of an enabled
    tracer or a disabled one, is also a record_function range of its name;
    the range never fails the work, and only the enabled tracer keeps the
    span."""
    import torch

    for enabled in (False, True):
        tr = otrace.Tracer(enabled=enabled)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _profiler_case(case, tr, monkeypatch)
        names = {e.name for e in prof.events()}
        if case == "labels_a_profile":
            assert "serving.dispatch[unit]" in names
        elif case != "survives_broken_annotation":
            assert "unit-test" in names
        assert (len(tr) >= 1) if enabled else (len(tr) == 0)
        monkeypatch.undo()


def test_disabled_span_opens_no_profiler_range(monkeypatch):
    """With no profiler recording, a disabled tracer's span is NOOP_SPAN and
    opens no record_function, within the disabled path's 100k-span bound."""
    opened = []
    monkeypatch.setattr(otrace, "_record_function", lambda name: opened.append(name))
    tr = otrace.Tracer(enabled=False)
    assert otrace.span("program.iterate") is otrace.NOOP_SPAN
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("launch k_hot"):
            pass
    dt = time.perf_counter() - t0
    assert tr.span("launch k_hot") is otrace.NOOP_SPAN
    assert opened == [] and len(tr) == 0
    assert dt < 1.0, f"{n} disabled spans took {dt:.3f}s"


def test_profiled_spans_are_user_annotations(tmp_path):
    """Under torch.profiler on the CPU, a disabled tracer's spans land in the
    exported trace as user_annotation events, and the buffer keeps nothing."""
    import torch

    from repro_torch.core import storage
    from repro_torch.stencils import climate

    from repro_torch.ensemble import Ensemble

    dom = (6, 5, 4)
    prog = climate.build_program("torch", dom)

    def fields(members=None):
        return {n: storage.storage_for_domain(dom, (3, 3, 0), backend="torch", device="cpu",
                                              members=None if n in ("u", "v", "w") else members)
                for n in climate.FIELD_NAMES}

    tr = otrace.get_tracer()
    assert not tr.enabled
    before = len(tr)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prog.iterate(2, **fields(), **climate.DEFAULT_SCALARS)
        Ensemble(prog, 2).iterate(2, **fields(2), **climate.DEFAULT_SCALARS)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"program.iterate", "ensemble.iterate"} <= annotations
    assert len(tr) == before


# ---------------------------------------------------------------------------
# per-call stencil trace opt-in (exec_info={"trace": True})
# ---------------------------------------------------------------------------


def test_stencil_exec_info_trace_opt_in():
    from repro_torch.core import gtscript, storage
    from repro_torch.core.gtscript import PARALLEL, Field, computation, interval

    def defs(a: Field[np.float64], b: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            b = a + 1.0  # noqa: F841

    st = gtscript.stencil(backend="numpy")(defs)
    a = storage.from_array(np.zeros((4, 4, 3)), backend="numpy")
    b = storage.from_array(np.zeros((4, 4, 3)), backend="numpy")
    info = {"trace": True}
    st(a, b, domain=(4, 4, 3), exec_info=info)
    events = obs_export.validate_chrome_trace(info["trace"])
    assert any(e["name"] == "stencil.run" for e in events)
    # the opt-in never leaks into the process tracer or later calls
    info2 = {}
    st(a, b, domain=(4, 4, 3), exec_info=info2)
    assert "trace" not in info2


# ---------------------------------------------------------------------------
# serving: trace-id propagation through a bisected poison batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="obs_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


def _drive(engine, specs, **kw):
    async def go():
        async with engine:
            return await drive_engine(engine, specs, **kw)

    return asyncio.run(go())


def _specs(n, steps=4, poison=None):
    out = []
    for i in range(n):
        rid = poison if (poison and i == 1) else f"ok-{i}"
        out.append(
            RequestSpec(
                program="obs_step",
                fields={"phi": request_state(DOM, seed=i + 1)},
                steps=steps,
                stream_every=2,
                request_id=rid,
            )
        )
    return out


def _make_engine(step, templates, *, faults=None, tracer=None):
    fields, scalars = templates
    eng = ServingEngine(
        window_ms=25.0,
        retry_backoff_ms=1.0,
        faults=faults if faults is not None else FaultInjector(),
        tracer=tracer,
    )
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2, 4),
        max_steps=100,
    )
    return eng


def test_trace_ids_propagate_through_bisected_poison_batch(step, templates):
    tracer = otrace.Tracer(enabled=True)
    inj = FaultInjector(sites=("dispatch",), rate=0.0, poison=("poison-1",))
    eng = _make_engine(step, templates, faults=inj, tracer=tracer)
    report = _drive(eng, _specs(4, poison="poison-1"), keep_fields="none")
    by_id = {r.request_id: r for r in report.results}
    assert not by_id["poison-1"].ok and all(by_id[f"ok-{i}"].ok for i in (0, 2, 3))

    spans = tracer.snapshot()
    all_ids = {"poison-1", "ok-0", "ok-2", "ok-3"}
    batches = [s for s in spans if s["name"] == "serving.batch"]
    assert batches, "no batch span recorded"
    # ONE batch span links every co-batched request
    assert any(all_ids <= set(s["trace_ids"]) for s in batches)
    # the bisect event names the affected requests
    bisects = [ev for s in spans for ev in s["events"] if ev["name"] == "serving.bisect"]
    assert bisects and "poison-1" in bisects[0]["attrs"]["trace_ids"]
    # retries fired for the poison request before the bisect
    retries = [ev for s in spans for ev in s["events"] if ev["name"] == "serving.retry"]
    assert any("poison-1" in ev["attrs"]["trace_ids"] for ev in retries)

    # the per-request view of the Perfetto dump tells the whole story:
    # admission span + shared batch span + the bisect instant
    data = obs_export.chrome_trace(spans)
    obs_export.validate_chrome_trace(data)
    mine = {e["name"] for e in obs_export.request_events(data, "poison-1")}
    assert {"serving.admit", "serving.batch", "serving.bisect"} <= mine
    ok0 = {e["name"] for e in obs_export.request_events(data, "ok-0")}
    assert {"serving.admit", "serving.batch", "serving.dispatch", "serving.done"} <= ok0


def test_bisected_poison_story_survives_head_sampling(step, templates):
    """The acceptance contract for always-on sampled tracing: at 0 < rate < 1
    a poison request whose head hash said DROP still has its full bisect
    story in the dump (error paths force-sample), a head-sampled request
    keeps its normal story, and a head-dropped healthy request contributes
    no per-request spans — the dump is strictly smaller than unsampled."""
    rate = 0.4
    poison = _id_with(rate, False, "poison")  # head says drop; errors must win
    kept = _id_with(rate, True, "kept")
    shed = _id_with(rate, False, "shed")  # healthy + dropped: costs one hash
    tracer = otrace.Tracer(enabled=True, sample_rate=rate)
    inj = FaultInjector(sites=("dispatch",), rate=0.0, poison=(poison,))
    eng = _make_engine(step, templates, faults=inj, tracer=tracer)

    def spec(rid, seed):
        return RequestSpec(
            program="obs_step",
            fields={"phi": request_state(DOM, seed=seed)},
            steps=4,
            stream_every=2,
            request_id=rid,
        )

    # batch 1: poison + a sampled neighbor; batch 2: a healthy dropped request
    # (a retry force-samples every co-batched id — the whole batch lived
    # through the fault — so the truly-dropped path needs a healthy batch)
    async def go():
        async with eng:
            r1 = await drive_engine(eng, [spec(kept, 1), spec(poison, 2)], keep_fields="none")
            r2 = await drive_engine(eng, [spec(shed, 3)], keep_fields="none")
            return r1, r2

    report, report2 = asyncio.run(go())
    by_id = {r.request_id: r for r in report.results}
    assert not by_id[poison].ok and by_id[kept].ok
    assert report2.results[0].ok

    data = obs_export.chrome_trace(tracer.snapshot())
    obs_export.validate_chrome_trace(data)

    # the poison request's WHOLE story is recoverable despite its head hash:
    # the shared batch span (kept members ride it), the forced retry/bisect
    # instants, and its terminal request_failed
    mine = {e["name"] for e in obs_export.request_events(data, poison)}
    assert {"serving.batch", "serving.retry", "serving.bisect",
            "serving.request_failed"} <= mine
    assert tracer.sampling.is_forced(poison)

    # a head-sampled healthy request keeps its normal story
    kept_names = {e["name"] for e in obs_export.request_events(data, kept)}
    assert {"serving.admit", "serving.batch", "serving.done"} <= kept_names

    # a head-dropped healthy request leaves no per-request spans of its own
    shed_names = {e["name"] for e in obs_export.request_events(data, shed)}
    assert "serving.admit" not in shed_names and "serving.queue" not in shed_names
    assert "serving.done" not in shed_names
    assert not tracer.sampling.is_forced(shed)

    # strictly fewer admit spans than requests: sampling really dropped work
    admits = [e for e in data["traceEvents"] if e["name"] == "serving.admit"]
    assert len(admits) < 3


# ---------------------------------------------------------------------------
# flight recorder: bundles, validation, the CLI
# ---------------------------------------------------------------------------


def test_flight_recorder_bundle_roundtrip(tmp_path):
    tr = otrace.Tracer(enabled=True)
    with tr.span("serving.batch", trace_ids=("req-1", "req-2")):
        pass
    tr.event("serving.request_failed", trace_ids=("req-1",), force=True, error="boom")
    reg = obs_metrics.MetricsRegistry()
    reg.counter("serving_requests_total", "", program="p").inc(2)
    rec = obs_flight.FlightRecorder(
        tmp_path,
        tracer=tr,
        metrics=reg,
        stats=lambda: {"requests": 2, "weird": np.float64(1.5)},
        config={"window_ms": 2.0},
    )
    path = rec.dump("worker_death", extra={"error": "ValueError: boom"})
    assert path is not None and path.exists()
    bundle = obs_flight.load_bundle(path)  # validates
    assert bundle["reason"] == "worker_death"
    assert bundle["config"]["window_ms"] == 2.0
    assert bundle["stats"]["weird"] == 1.5  # numpy scalar made JSON-safe
    assert bundle["metrics"]["serving_requests_total"] == {"program=p": 2}
    assert obs_flight.span_census(bundle) == {
        "serving.batch": 1, "serving.request_failed": 1,
    }
    # the per-request story view works straight off a bundle
    story = obs_flight.request_story(bundle, "req-1")
    assert {e["name"] for e in story} == {"serving.batch", "serving.request_failed"}

    # a second dump + pruning keeps the directory bounded
    rec.max_bundles = 1
    p2 = rec.dump("sigusr2")
    assert p2 is not None and not path.exists()


def test_flight_bundle_records_torch_cuda_and_the_card(tmp_path):
    """The port's bundles name the software and the card they were written
    under: the torch version, the CUDA version it was built for, and the
    first card's name (None on a host without one)."""
    import torch

    path = obs_flight.FlightRecorder(tmp_path).dump("sigusr2")
    versions = obs_flight.load_bundle(path)["versions"]
    assert versions["torch"] == torch.__version__
    assert versions["cuda"] == torch.version.cuda
    assert versions["device"] == (torch.cuda.get_device_name(0) if torch.cuda.is_available() else None)
    assert "jax" not in versions and obs_flight.SCHEMA == "repro_torch.obs.flight/1"


def test_flight_recorder_never_raises(tmp_path):
    """Every section is individually guarded: a failing stats source becomes
    an error note, an unwritable directory returns None — the recorder must
    never be the second failure."""

    def bad_stats():
        raise RuntimeError("stats exploded")

    rec = obs_flight.FlightRecorder(tmp_path, stats=bad_stats)
    path = rec.dump("slo_breach:x")
    bundle = obs_flight.load_bundle(path)
    assert bundle["stats"] == {"error": "RuntimeError: stats exploded"}

    gone = obs_flight.FlightRecorder(tmp_path / "file.json" / "not-a-dir")
    (tmp_path / "file.json").write_text("{}")
    assert gone.dump("anything") is None


def test_flight_bundle_validator_rejects():
    with pytest.raises(ValueError, match="JSON object"):
        obs_flight.validate_flight_bundle([])
    with pytest.raises(ValueError, match="schema"):
        obs_flight.validate_flight_bundle({"schema": "bogus/9"})
    shell = {k: {} for k in ("versions", "metrics", "stats")}
    shell.update(schema=obs_flight.SCHEMA, reason="r", wall_time="t",
                 monotonic_s=0.0, pid=1, spans=[])
    assert obs_flight.validate_flight_bundle(dict(shell)) is not None
    broken = dict(shell)
    del broken["spans"]
    with pytest.raises(ValueError, match="spans"):
        obs_flight.validate_flight_bundle(broken)


def test_flight_cli_exit_codes(tmp_path, capsys):
    rec = obs_flight.FlightRecorder(tmp_path, stats=lambda: {"requests": 1})
    a = rec.dump("first")
    b = rec.dump("second")

    assert obs_flight.main([str(a)]) == 0
    assert "first" in capsys.readouterr().out
    assert obs_flight.main([str(a), "--diff", str(b)]) == 0
    diff = json.loads(capsys.readouterr().out)
    assert set(diff) == {"metrics", "stats", "spans"}
    assert obs_flight.main([str(a), "--request", "req-1"]) == 0
    capsys.readouterr()

    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert obs_flight.main([str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err
    assert obs_flight.main([str(tmp_path / "missing.json")]) == 1
    capsys.readouterr()
    assert obs_flight.main([]) == 2
    assert obs_flight.main([str(a), "--diff"]) == 2
    assert obs_flight.main([str(a), str(b)]) == 2


def test_engine_metrics_registry_backs_stats_and_prometheus(step, templates):
    eng = _make_engine(step, templates)
    report = _drive(eng, _specs(3), keep_fields="none")
    assert report.recovered_rate == 1.0
    st = eng.stats()
    assert st["requests"] == 3 and st["batches"] >= 1
    text = eng.metrics.to_prometheus()
    assert "# TYPE serving_requests_total counter" in text
    # every engine counter carries the program label now
    assert 'serving_requests_total{program="obs_step"} 3' in text
    assert "# TYPE serving_queue_depth gauge" in text
    assert 'serving_state{state="SERVING"} 1.0' in text
    assert "# TYPE serving_dispatch_seconds summary" in text
    assert 'serving_dispatch_seconds{program="obs_step",quantile="0.5"}' in text
    assert 'serving_request_latency_seconds_count{program="obs_step"} 3' in text
    assert 'serving_queue_wait_seconds_count{program="obs_step"} 3' in text
    collected = eng.metrics.collect()
    assert collected["serving_requests_total"] == {"program=obs_step": 3}
    # the registry and the stats() view never disagree
    assert collected["serving_batches_total"]["program=obs_step"] == st["batches"]
    # ...and the flat stats() keys stay the cross-program sums clients read
    assert st["per_program"]["obs_step"]["requests"] == 3


def test_ensemble_spans_land_in_engine_tracer(step, templates):
    """``loop.run_in_executor`` does not propagate contextvars, so the engine
    pins its resolved tracer into the context the executor thread runs under:
    the ensemble.iterate span recorded inside the dispatch must land in the
    per-engine tracer, nested under its serving.dispatch span — not vanish
    into the (disabled) process default."""
    tracer = otrace.Tracer(enabled=True)
    eng = _make_engine(step, templates, tracer=tracer)
    report = _drive(eng, _specs(2), keep_fields="none")
    assert report.recovered_rate == 1.0
    spans = tracer.snapshot()
    dispatch_ids = {s["id"] for s in spans if s["name"] == "serving.dispatch"}
    assert dispatch_ids
    ens_spans = [s for s in spans if s["name"] == "ensemble.iterate"]
    assert ens_spans, "ensemble spans routed away from the engine tracer"
    assert all(s["parent"] in dispatch_ids for s in ens_spans)


def test_engine_disabled_tracing_records_nothing(step, templates):
    tracer = otrace.Tracer(enabled=False)
    eng = _make_engine(step, templates, tracer=tracer)
    report = _drive(eng, _specs(2), keep_fields="none")
    assert report.recovered_rate == 1.0
    assert len(tracer) == 0


# ---------------------------------------------------------------------------
# retry_after_ms: the empty-median regression
# ---------------------------------------------------------------------------


def test_watchdog_median_available_before_straggler_warmup():
    wd = StragglerWatchdog()
    wd.record(0, 0.05)
    # the very first sample already yields an estimate (was 0.0 until then)
    assert wd.stats.median_s == pytest.approx(0.05)
    wd.record(1, 0.07)
    assert wd.stats.median_s == pytest.approx(0.06)  # window includes dt
    assert wd.stats.stragglers == 0  # flagging still warms up at 8 samples


def test_retry_after_ms_sane_with_no_samples(step, templates):
    eng = _make_engine(step, templates)
    assert eng.watchdog.stats.median_s == 0.0
    ra = eng._retry_after_ms()
    assert math.isfinite(ra) and ra > 0
    # a NaN-poisoned median must not leak into client backoff either
    eng.watchdog.stats.median_s = float("nan")
    ra = eng._retry_after_ms()
    assert math.isfinite(ra) and ra > 0
    # with real samples the estimate follows the measured dispatch wall
    eng.watchdog.stats.median_s = 0.25
    assert eng._retry_after_ms() >= 250.0


# ---------------------------------------------------------------------------
# package surface
# ---------------------------------------------------------------------------


def test_obs_package_reexports():
    import repro_torch.obs as obs
    from repro_torch.obs import slo as obs_slo

    assert obs.monotonic is otrace.monotonic
    assert obs.Tracer is otrace.Tracer
    assert obs.MetricsRegistry is obs_metrics.MetricsRegistry
    assert obs.validate_chrome_trace is obs_export.validate_chrome_trace
    assert obs.SamplingPolicy is obs_sampling.SamplingPolicy
    assert obs.head_sampled is obs_sampling.head_sampled
    assert obs.Objective is obs_slo.Objective
    assert obs.SloEngine is obs_slo.SloEngine
    assert obs.Autoscaler is obs_slo.Autoscaler
    assert obs.FlightRecorder is obs_flight.FlightRecorder
    assert obs.validate_flight_bundle is obs_flight.validate_flight_bundle
