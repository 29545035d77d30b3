"""Websocket transport contract tests (repro.serving.server / .client).

Skipped entirely when aiohttp is absent — the transport is an optional
extra (``pip install repro[serving]``); the engine-level contract lives in
tests/test_serving.py with no such dependency.  Everything here crosses a
real socket: base64 array frames must round-trip float64 bit-exactly, events
must arrive per-request in order, and admission errors must come back as
typed ``error`` frames, not closed connections."""

import asyncio

import numpy as np
import torch
import pytest

aiohttp = pytest.importorskip("aiohttp")

from repro_torch.core.storage import Storage  # noqa: E402
from repro_torch.serving import RequestSpec, ServingEngine, protocol  # noqa: E402
from repro_torch.serving.client import drive_server  # noqa: E402
from repro_torch.serving.server import ForecastServer  # noqa: E402
from repro_torch.stencils.forecast import (  # noqa: E402
    FIELD_NAMES,
    build_forecast_step,
    make_forecast_fields,
    request_state,
)

DOM = (12, 10, 5)


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="ws_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


def serve(step, templates, coro_fn):
    """Run ``coro_fn(server)`` against a live server on an ephemeral port."""
    fields, scalars = templates

    async def go():
        engine = ServingEngine(window_ms=25.0)
        engine.register(
            step,
            fields=fields,
            scalars=scalars,
            request_fields=("phi",),
            member_counts=(1, 2, 4),
        )
        async with ForecastServer(engine) as srv:
            return await coro_fn(srv)

    return asyncio.run(go())


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


# ---------------------------------------------------------------------------
# protocol: arrays must survive the wire bit-exactly
# ---------------------------------------------------------------------------


def test_array_codec_is_bit_exact():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(7, 5, 3))  # float64, full precision
    back = protocol.decode_array(protocol.encode_array(arr))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert np.abs(back - arr).max() == 0.0
    assert back.tobytes() == arr.tobytes()


def test_array_codec_rejects_garbage():
    for bad in ("nope", {"shape": [2]}, {"shape": [4], "dtype": "float64", "data": "AAAA"}):
        with pytest.raises(protocol.ServingError) as ei:
            protocol.decode_array(bad)
        assert ei.value.code == 400


# ---------------------------------------------------------------------------
# the websocket contract: accepted → ordered steps → done
# ---------------------------------------------------------------------------


def test_forecast_over_websocket_bit_identical(step, templates):
    phi0 = request_state(DOM, seed=3)

    async def scenario(srv):
        async with aiohttp.ClientSession() as s, s.ws_connect(srv.ws_url) as ws:
            await ws.send_str(
                protocol.dumps(
                    {
                        "type": "forecast",
                        "request_id": "r1",
                        "program": "ws_step",
                        "steps": 3,
                        "stream_every": 1,
                        "stats": True,
                        "fields": {"phi": protocol.encode_array(phi0)},
                    }
                )
            )
            frames = []
            while True:
                frames.append(protocol.loads((await ws.receive()).data))
                if frames[-1]["type"] in ("done", "error"):
                    return frames

    frames = serve(step, templates, scenario)
    assert [f["type"] for f in frames] == ["accepted", "step", "step", "step", "done"]
    assert all(f["request_id"] == "r1" for f in frames)
    assert frames[0]["fingerprint"] and frames[0]["steps"] == 3
    steps = [f for f in frames if f["type"] == "step"]
    assert [f["step"] for f in steps] == [1, 2, 3]
    for f in steps:
        got = protocol.decode_array(f["fields"]["phi"])
        ref = sequential(step, templates, phi0, f["step"])
        assert np.abs(got - ref).max() == 0.0  # bit-identical across the wire
        assert set(f["stats"]["phi"]) == {"min", "max", "mean"}
        assert set(f["batch"]) == {"id", "members", "requests", "occupancy"}
    assert frames[-1]["latency_s"] > 0


def test_catalog_and_admission_errors_over_websocket(step, templates):
    async def scenario(srv):
        out = {}
        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(srv.ws_url) as ws:
                await ws.send_str(protocol.dumps({"type": "programs"}))
                out["catalog"] = protocol.loads((await ws.receive()).data)
                await ws.send_str("this is not json")
                out["not_json"] = protocol.loads((await ws.receive()).data)
                await ws.send_str(protocol.dumps({"type": "wat"}))
                out["bad_type"] = protocol.loads((await ws.receive()).data)
                await ws.send_str(
                    protocol.dumps(
                        {
                            "type": "forecast",
                            "request_id": "nope-1",
                            "program": "no_such_program",
                            "fields": {"phi": protocol.encode_array(np.zeros((2, 2, 2)))},
                        }
                    )
                )
                out["unknown"] = protocol.loads((await ws.receive()).data)
            async with s.get(f"http://{srv.host}:{srv.port}/healthz") as r:
                out["healthz"] = await r.json()
            async with s.get(f"http://{srv.host}:{srv.port}/stats") as r:
                out["stats"] = await r.json()
        return out

    out = serve(step, templates, scenario)
    cat = out["catalog"]
    assert cat["type"] == "catalog"
    (entry,) = cat["programs"]
    assert entry["program"] == "ws_step" and entry["member_counts"] == [1, 2, 4]
    assert entry["request_fields"]["phi"]["dtype"] == "float64"
    assert out["not_json"]["type"] == "error" and out["not_json"]["code"] == 400
    assert out["bad_type"]["code"] == 400
    assert out["unknown"]["code"] == 404 and out["unknown"]["request_id"] == "nope-1"
    assert out["healthz"] == {"ok": True, "state": "SERVING"}
    assert out["stats"]["requests"] == 0  # nothing was admitted


def test_metrics_endpoint_serves_prometheus_text(step, templates):
    """GET /metrics speaks the Prometheus text exposition (version 0.0.4) and
    carries the engine's request/retry/bisect/queue-depth series; /stats is
    enriched with the registry's quantile summaries under "metrics"."""
    specs = [
        RequestSpec("ws_step", {"phi": request_state(DOM, seed=i + 1)}, steps=2, stream_every=1)
        for i in range(3)
    ]

    async def scenario(srv):
        rep = await drive_server(srv.ws_url, specs)
        out = {"report": rep}
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://{srv.host}:{srv.port}/metrics") as r:
                out["status"] = r.status
                out["content_type"] = r.headers["Content-Type"]
                out["text"] = await r.text()
            async with s.get(f"http://{srv.host}:{srv.port}/stats") as r:
                out["stats"] = await r.json()
        return out

    out = serve(step, templates, scenario)
    assert out["report"].recovered_rate == 1.0
    assert out["status"] == 200
    assert out["content_type"] == "text/plain; version=0.0.4; charset=utf-8"
    text = out["text"]
    for family, kind in [
        ("serving_requests_total", "counter"),
        ("serving_retries_total", "counter"),
        ("serving_bisects_total", "counter"),
        ("serving_queue_depth", "gauge"),
        ("serving_request_latency_seconds", "summary"),
    ]:
        assert f"# TYPE {family} {kind}" in text, family
    assert 'serving_requests_total{program="ws_step"} 3' in text
    assert 'serving_state{state="SERVING"} 1.0' in text
    assert 'serving_request_latency_seconds{program="ws_step",quantile="0.99"}' in text
    assert 'serving_request_latency_seconds_count{program="ws_step"} 3' in text
    # /stats keeps its legacy flat keys (cross-program sums), gains the
    # per-program breakdown and the registry dump
    st = out["stats"]
    assert st["requests"] == 3
    assert st["per_program"]["ws_step"]["requests"] == 3
    assert st["metrics"]["serving_requests_total"] == {"program=ws_step": 3}
    assert st["metrics"]["serving_request_latency_seconds"]["program=ws_step"]["count"] == 3


def test_concurrent_metrics_scrapes_during_live_load(step, templates):
    """Prometheus scrapes race live serving: a scraper hammering /metrics
    while requests stream must always get a complete, well-formed exposition
    — every line parseable, no NaN, counters monotonic across scrapes."""
    specs = [
        RequestSpec("ws_step", {"phi": request_state(DOM, seed=i + 1)}, steps=4, stream_every=2)
        for i in range(6)
    ]

    async def scenario(srv):
        url = f"http://{srv.host}:{srv.port}/metrics"
        stop = asyncio.Event()
        scrapes = []

        async def scraper():
            async with aiohttp.ClientSession() as s:
                while not stop.is_set():
                    async with s.get(url) as r:
                        assert r.status == 200
                        scrapes.append(await r.text())
                    await asyncio.sleep(0.002)

        scrapers = [asyncio.ensure_future(scraper()) for _ in range(4)]
        try:
            rep = await drive_server(srv.ws_url, specs)
        finally:
            stop.set()
            await asyncio.gather(*scrapers)
        return rep, scrapes

    rep, scrapes = serve(step, templates, scenario)
    assert rep.recovered_rate == 1.0
    assert len(scrapes) >= 8  # the scrapers really ran during the load
    seen_requests = []
    for text in scrapes:
        assert "NaN" not in text
        for line in text.splitlines():
            assert line.startswith("#") or " " in line, f"malformed line: {line!r}"
        for line in text.splitlines():
            if line.startswith('serving_requests_total{program="ws_step"}'):
                seen_requests.append(float(line.rsplit(" ", 1)[1]))
    # counters never go backwards, and the final scrape saw all six requests
    assert seen_requests == sorted(seen_requests)
    assert seen_requests[-1] == 6.0


def test_slo_and_autoscale_endpoints(step, templates):
    """GET /slo serves the burn-rate evaluation and GET /autoscale the
    desired-replica recommendation, both as JSON."""
    from repro_torch.obs import slo as obs_slo

    fields, scalars = templates

    async def go():
        engine = ServingEngine(window_ms=25.0, slos=obs_slo.default_objectives("ws_step"))
        engine.register(
            step, fields=fields, scalars=scalars, request_fields=("phi",), member_counts=(1, 2, 4)
        )
        async with ForecastServer(engine) as srv:
            specs = [
                RequestSpec("ws_step", {"phi": request_state(DOM, seed=i + 1)}, steps=2)
                for i in range(2)
            ]
            rep = await drive_server(srv.ws_url, specs)
            out = {"report": rep}
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://{srv.host}:{srv.port}/slo") as r:
                    out["slo"] = (r.status, await r.json())
                async with s.get(f"http://{srv.host}:{srv.port}/autoscale") as r:
                    out["autoscale"] = (r.status, await r.json())
                async with s.get(f"http://{srv.host}:{srv.port}/stats") as r:
                    out["stats"] = await r.json()
            return out

    out = asyncio.run(go())
    assert out["report"].recovered_rate == 1.0
    status, slo = out["slo"]
    assert status == 200 and slo["breaching"] is False
    assert {o["objective"] for o in slo["objectives"]} == {
        "ws_step-availability",
        "ws_step-latency",
    }
    for obj in slo["objectives"]:
        for rule in obj["rules"]:
            assert {"rule", "short_burn", "long_burn", "max_burn", "breaching"} <= set(rule)
    status, auto = out["autoscale"]
    assert status == 200
    assert auto["desired_replicas"] >= 1 and isinstance(auto["reason"], str)
    assert {"queue_depth", "inflight", "max_batch", "utilization"} <= set(auto["inputs"])
    assert auto["slo"]["breaching"] is False
    # /stats carries the same SLO view for humans
    assert out["stats"]["slo"]["breaching"] is False


def test_load_generator_over_websocket(step, templates):
    """The deterministic load-generator smoke: N concurrent ws clients,
    streamed steps in order, final states bit-identical to sequential."""
    n = 5
    specs = [
        RequestSpec("ws_step", {"phi": request_state(DOM, seed=i + 1)}, steps=4, stream_every=2)
        for i in range(n)
    ]

    async def scenario(srv):
        return await drive_server(srv.ws_url, specs)

    rep = serve(step, templates, scenario)
    assert rep.requests == n and rep.all_in_order
    assert [r.steps_seen for r in rep.results] == [[2, 4]] * n
    assert rep.p99_ms >= rep.p50_ms > 0 and rep.mean_occupancy > 0
    for spec, res in zip(specs, rep.results):
        ref = sequential(step, templates, spec.fields["phi"], 4)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0


# ---------------------------------------------------------------------------
# disconnect mid-stream: the engine must not leak the slot or poison the batch
# ---------------------------------------------------------------------------


def test_client_disconnect_mid_stream_does_not_poison_engine(step, templates):
    """A client that vanishes right after ``accepted`` must not hang the
    engine or corrupt co-batched work: its request is abandoned, and a later
    well-behaved request on a fresh connection completes bit-identically."""

    async def scenario(srv):
        phi_gone = request_state(DOM, seed=41)
        async with aiohttp.ClientSession() as s:
            ws = await s.ws_connect(srv.ws_url)
            await ws.send_str(
                protocol.dumps(
                    {
                        "type": "forecast",
                        "request_id": "ghost",
                        "program": "ws_step",
                        "steps": 50,
                        "stream_every": 1,
                        "fields": {"phi": protocol.encode_array(phi_gone)},
                    }
                )
            )
            first = protocol.loads((await ws.receive()).data)
            assert first["type"] == "accepted"
            await ws.close()  # vanish mid-stream

            # a fresh, patient client right behind the ghost
            phi_ok = request_state(DOM, seed=42)
            rep = await drive_server(
                srv.ws_url,
                [RequestSpec("ws_step", {"phi": phi_ok}, steps=3, request_id="alive")],
                read_timeout_s=30.0,
            )
            # give the engine a beat to finish the ghost's (abandoned) batch
            deadline = asyncio.get_running_loop().time() + 30.0
            while srv.engine.stats()["abandoned"] < 1:
                assert asyncio.get_running_loop().time() < deadline, "ghost never abandoned"
                await asyncio.sleep(0.02)
            return rep, srv.engine.stats(), phi_ok

    rep, stats, phi_ok = serve(step, templates, scenario)
    (res,) = rep.results
    assert res.ok and res.steps_seen == [1, 2, 3]
    ref = sequential(step, templates, phi_ok, 3)
    assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    assert stats["abandoned"] >= 1


def test_healthz_degrades_to_503_while_draining(step, templates):
    async def scenario(srv):
        out = {}
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://{srv.host}:{srv.port}/healthz") as r:
                out["before"] = (r.status, await r.json())
            await srv.engine.drain(timeout_s=10.0)
            async with s.get(f"http://{srv.host}:{srv.port}/healthz") as r:
                out["after"] = (r.status, await r.json())
        return out

    out = serve(step, templates, scenario)
    assert out["before"][0] == 200 and out["before"][1]["state"] == "SERVING"
    assert out["after"][0] == 503 and out["after"][1] == {"ok": False, "state": "DRAINING"}


def test_503_error_frame_carries_retry_after(step, templates):
    """A full admission queue answers the ws client with a 503 error frame
    including retry_after_ms (here: without client-side auto-retry)."""
    fields, scalars = templates

    async def go():
        engine = ServingEngine(window_ms=25.0, max_queue=1)
        engine.register(
            step, fields=fields, scalars=scalars, request_fields=("phi",), member_counts=(1, 2, 4)
        )
        gate = asyncio.Event()
        real_run_batch = engine._run_batch

        async def gated(entry, requests):
            await gate.wait()
            await real_run_batch(entry, requests)

        engine._run_batch = gated
        phi = protocol.encode_array(request_state(DOM, seed=7))
        async with ForecastServer(engine) as srv:
            async with aiohttp.ClientSession() as s, s.ws_connect(srv.ws_url) as ws:

                async def forecast(rid):
                    await ws.send_str(
                        protocol.dumps(
                            {
                                "type": "forecast",
                                "request_id": rid,
                                "program": "ws_step",
                                "steps": 1,
                                "fields": {"phi": phi},
                            }
                        )
                    )

                await forecast("r0")  # worker takes it, holds at the gate
                await asyncio.sleep(0.08)
                await forecast("r1")  # sits in the queue (now full)
                frames = [protocol.loads((await ws.receive()).data) for _ in range(2)]
                await forecast("r2")  # over capacity → 503
                rejected = protocol.loads((await ws.receive()).data)
                gate.set()
                # r0 and r1 still complete; drain their remaining frames
                done = set()
                while done < {"r0", "r1"}:
                    ev = protocol.loads((await ws.receive()).data)
                    if ev["type"] == "done":
                        done.add(ev["request_id"])
                return frames, rejected

    frames, rejected = asyncio.run(go())
    assert {f["type"] for f in frames} == {"accepted"}
    assert rejected["type"] == "error" and rejected["code"] == 503
    assert rejected["request_id"] == "r2" and rejected["retry_after_ms"] > 0


# ---------------------------------------------------------------------------
# ws_send fault injection: a failing socket write abandons only that request
# ---------------------------------------------------------------------------


def test_ws_send_fault_abandons_request_not_connection(step, templates):
    from repro_torch.serving import FaultInjector

    fields, scalars = templates

    async def go():
        engine = ServingEngine(
            window_ms=25.0,
            faults=FaultInjector(sites=("ws_send",), rate=0.0, poison=("doomed",)),
        )
        engine.register(
            step, fields=fields, scalars=scalars, request_fields=("phi",), member_counts=(1, 2, 4)
        )
        async with ForecastServer(engine) as srv:
            specs = [
                RequestSpec(
                    "ws_step",
                    {"phi": request_state(DOM, seed=i + 1)},
                    steps=3,
                    request_id="doomed" if i == 0 else f"fine-{i}",
                )
                for i in range(3)
            ]
            rep = await drive_server(srv.ws_url, specs, read_timeout_s=5.0)
            return rep, engine.stats()

    rep, stats = asyncio.run(go())
    by_id = {r.request_id: r for r in rep.results}
    # the doomed stream dies client-side (read timeout); the others complete
    assert not by_id["doomed"].ok
    for i in (1, 2):
        res = by_id[f"fine-{i}"]
        assert res.ok, res.error_reason
        ref = sequential(step, templates, request_state(DOM, seed=i + 1), 3)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    assert stats["abandoned"] >= 1


# ---------------------------------------------------------------------------
# end-to-end supervision: kill the server process, serving comes back
# ---------------------------------------------------------------------------


def test_supervisor_restores_serving_after_server_crash(step, templates):
    """The acceptance path: a supervised real server process is force-killed;
    the supervisor respawns it and /healthz-ready serving resumes — verified
    by completing a real websocket forecast against the restarted process."""
    import functools
    import socket
    import threading
    import time as _time

    from repro_torch.runtime.supervise import RestartPolicy, Supervisor, http_ready, serve_command

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    url = f"http://127.0.0.1:{port}/healthz"
    probe = functools.partial(http_ready, url)
    sup = Supervisor(
        serve_command(
            ["--port", str(port), "--no-warm", "--domain", "8", "6", "4", "--drain-timeout", "2",
             "--backend", "torch", "--device", "cpu"]
        ),
        probe=probe,
        policy=RestartPolicy(backoff_s=0.1, max_crashes=10, crash_window_s=300.0),
        ready_timeout_s=120.0,
        probe_interval_s=0.1,
    )

    def forecast_completes():
        phi0 = request_state((8, 6, 4), seed=1)

        async def go():
            rep = await drive_server(
                f"ws://127.0.0.1:{port}/ws",
                [RequestSpec("forecast_step", {"phi": phi0}, steps=2)],
                read_timeout_s=60.0,
            )
            return rep.results[0]

        res = asyncio.run(go())
        assert res.ok, res.error_reason
        assert res.steps_seen == [1, 2]

    sup.start()
    runner = threading.Thread(target=sup.run_forever, daemon=True)
    runner.start()
    try:
        forecast_completes()
        first_pid = sup.proc.pid
        sup.proc.kill()  # the forced crash
        deadline = _time.monotonic() + 120.0
        while _time.monotonic() < deadline:
            if sup.proc is not None and sup.proc.pid != first_pid and probe():
                break
            _time.sleep(0.1)
        assert probe(), "supervisor never restored /healthz-ready serving"
        assert sup.stats["restarts"] >= 1
        forecast_completes()  # the restarted process actually serves
    finally:
        sup.stop()
        runner.join(timeout=15.0)
    assert not runner.is_alive()
