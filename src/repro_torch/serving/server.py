"""Websocket transport for the forecast engine (aiohttp, optional dep).

The engine (``serving.engine``) is transport-agnostic; this module exposes it
over HTTP/websockets when ``aiohttp`` is installed (``pip install
repro[serving]``):

* ``GET /ws``       — the websocket endpoint speaking ``serving.protocol``
* ``GET /healthz``  — liveness probe
* ``GET /stats``    — engine counters (requests, batches, occupancy, stragglers)
  plus the full metrics-registry dump under ``"metrics"``
* ``GET /metrics``  — the same registry as Prometheus text exposition 0.0.4
  (per-program request/retry/bisect counters, queue-depth/state gauges,
  latency summaries, SLO burn-rate/breach gauges)
* ``GET /slo``      — evaluate the engine's SLOs now; burn rates per
  objective and window, breach flags
* ``GET /autoscale``— the desired-replica recommendation (documented rule
  over queue depth, capacity, p99-vs-SLO pressure; hysteresis-damped)
* ``GET /programs`` — the catalog, same payload as a ``programs`` frame

Each connection may multiplex many requests: frames carry ``request_id`` and
every request's events are streamed in submission order (one pump task per
request; a per-connection send lock keeps frames whole).

Disconnect handling: a client that vanishes mid-stream (send failure, or the
connection closing with pumps still running) gets its in-flight requests
marked *abandoned* — the engine stops gathering/emitting for those member
slots, the batch's other requests finish untouched, and nothing is leaked
into the next batch.  ``/healthz`` reflects the engine health state machine:
200 while ``SERVING``/``DEGRADED``, 503 once ``DRAINING`` so supervisors and
load balancers stop routing to a process that is shutting down."""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

try:
    from aiohttp import WSMsgType, web
except ImportError:  # pragma: no cover - exercised via _require_aiohttp
    web = None
    WSMsgType = None

from . import protocol
from .engine import DRAINING, ForecastRequest, ServingEngine
from .protocol import ServingError


def _require_aiohttp() -> None:
    if web is None:
        raise RuntimeError(
            "the websocket transport needs aiohttp (pip install aiohttp); "
            "the engine itself (repro_torch.serving.ServingEngine) has no such dependency"
        )


async def _send(ws, lock: asyncio.Lock, frame: Dict[str, Any]) -> None:
    async with lock:
        await ws.send_str(protocol.dumps(protocol.encode_event(frame)))


async def _pump(engine: ServingEngine, req: ForecastRequest, ws, lock: asyncio.Lock) -> None:
    """Stream one request's events to its connection until done/error.  A
    send failure (the client vanished, or an injected ``ws_send`` fault —
    indistinguishable from here) abandons the request: the engine stops
    emitting for its member slot and the rest of the batch is unaffected."""
    try:
        async for ev in engine.stream(req):
            engine.faults.check("ws_send", keys=(req.request_id,))
            await _send(ws, lock, ev)
    except asyncio.CancelledError:
        req.abandoned = True
        raise
    except Exception:  # noqa: BLE001 — any transport failure means nobody is listening
        req.abandoned = True


async def _handle_frame(
    engine: ServingEngine, msg: Dict[str, Any], ws, lock, pumps: Dict[asyncio.Task, ForecastRequest]
):
    kind = msg["type"]
    if kind == "programs":
        await _send(ws, lock, {"type": "catalog", "programs": engine.catalog()})
        return
    if kind != "forecast":
        raise ServingError(protocol.BAD_REQUEST, f"unknown frame type {kind!r}")
    kwargs = protocol.parse_forecast(msg)
    program = kwargs.pop("program")
    fields = kwargs.pop("fields")
    scalars = kwargs.pop("scalars")
    req = engine.submit(program, fields, scalars, **kwargs)
    task = asyncio.get_running_loop().create_task(_pump(engine, req, ws, lock))
    pumps[task] = req
    task.add_done_callback(lambda t: pumps.pop(t, None))


def create_app(engine: ServingEngine) -> "web.Application":
    _require_aiohttp()

    async def ws_handler(request: "web.Request") -> "web.WebSocketResponse":
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        lock = asyncio.Lock()
        pumps: Dict[asyncio.Task, ForecastRequest] = {}
        try:
            async for raw in ws:
                if raw.type != WSMsgType.TEXT:
                    continue
                request_id = None
                try:
                    msg = protocol.loads(raw.data)
                    request_id = msg.get("request_id")
                    await _handle_frame(engine, msg, ws, lock, pumps)
                except ServingError as e:
                    await _send(
                        ws,
                        lock,
                        protocol.error_frame(
                            e.code, e.reason, request_id, retry_after_ms=e.retry_after_ms
                        ),
                    )
        finally:
            # connection gone: abandon every request still streaming so the
            # engine frees their member slots instead of gathering into the void
            for t, req in list(pumps.items()):
                req.abandoned = True
                t.cancel()
        return ws

    async def healthz(_request: "web.Request") -> "web.Response":
        ok = engine.state != DRAINING
        return web.json_response({"ok": ok, "state": engine.state}, status=200 if ok else 503)

    async def stats(_request: "web.Request") -> "web.Response":
        payload = engine.stats()
        payload["metrics"] = engine.metrics.collect()
        return web.json_response(payload)

    async def metrics(_request: "web.Request") -> "web.Response":
        return web.Response(
            body=engine.metrics.to_prometheus().encode("utf-8"),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    async def programs(_request: "web.Request") -> "web.Response":
        return web.json_response({"programs": engine.catalog()})

    async def slo(_request: "web.Request") -> "web.Response":
        return web.json_response(engine.slo.evaluate())

    async def autoscale(_request: "web.Request") -> "web.Response":
        return web.json_response(engine.autoscale_signal())

    app = web.Application()
    app.router.add_get("/ws", ws_handler)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/stats", stats)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/slo", slo)
    app.router.add_get("/autoscale", autoscale)
    app.router.add_get("/programs", programs)
    return app


class ForecastServer:
    """Engine + aiohttp app bound to a host:port (0 → ephemeral, see
    ``.port`` after ``start()``)."""

    def __init__(self, engine: ServingEngine, *, host: str = "127.0.0.1", port: int = 0):
        _require_aiohttp()
        self.engine = engine
        self.host = host
        self.port = port
        self._runner: Optional["web.AppRunner"] = None

    async def start(self) -> "ForecastServer":
        self._runner = web.AppRunner(create_app(self.engine))
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self

    @property
    def ws_url(self) -> str:
        return f"ws://{self.host}:{self.port}/ws"

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        await self.engine.aclose()

    async def __aenter__(self) -> "ForecastServer":
        return await self.start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()
