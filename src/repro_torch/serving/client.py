"""Serving clients + the deterministic load generator.

Two drivers share one request/report shape:

* :func:`drive_engine` — in-process, pure asyncio against a
  :class:`~repro_torch.serving.engine.ServingEngine` (no aiohttp; this is what the
  contract tests and the ``serving_throughput`` bench use, so the bench runs
  in the minimal CI environment).
* :func:`drive_server` — over a real websocket (aiohttp client) against a
  running :class:`~repro_torch.serving.server.ForecastServer`.

Both issue all requests concurrently, record per-request latency
(submit → done), assert streamed steps arrive strictly in order, and keep
the streamed states so callers can verify bit-identity against sequential
execution.

Resilience: both drivers honor 503 ``OVERLOADED`` rejections by backing off
``retry_after_ms`` and resubmitting, up to ``retry_503`` attempts; the
websocket driver additionally bounds the connect and per-frame read waits
(``connect_timeout_s`` / ``read_timeout_s``) so a dead server yields error
results instead of a hung client.  A request that ends in an ``error`` event
(or times out) folds into a :class:`RequestResult` carrying ``error_code`` /
``error_reason`` rather than raising — load reports under fault injection
count recovered vs. failed requests instead of dying on the first casualty."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import monotonic

from .engine import ServingEngine
from .protocol import OVERLOADED, ServingError, decode_event, dumps, encode_array, loads

#: error code used for client-side failures (timeouts, closed connections)
#: that never reached the server — deliberately outside the HTTP range
CLIENT_TIMEOUT = 0

#: never sleep longer than this on a 503, whatever retry_after_ms claims
MAX_RETRY_SLEEP_S = 2.0


@dataclass
class RequestSpec:
    """One simulated client request."""

    program: str
    fields: Dict[str, np.ndarray]
    scalars: Dict[str, Any] = field(default_factory=dict)
    steps: int = 1
    stream_every: int = 1
    stats: bool = False
    request_id: Optional[str] = None
    fingerprint: Optional[str] = None
    deadline_ms: Optional[float] = None
    priority: Optional[int] = None  # urgency class, lower = more urgent


@dataclass
class RequestResult:
    """What came back for one request; ``error_code`` is None iff it completed."""

    request_id: str
    steps_seen: List[int]
    final_fields: Dict[str, np.ndarray]
    step_fields: Dict[int, Dict[str, np.ndarray]]
    latency_s: float
    occupancy: float
    members: int
    error_code: Optional[int] = None
    error_reason: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error_code is None

    @property
    def in_order(self) -> bool:
        ordered = self.steps_seen == sorted(self.steps_seen)
        return ordered and len(set(self.steps_seen)) == len(self.steps_seen)


@dataclass
class LoadReport:
    """Aggregate view of one load-generator run.  Latency percentiles cover
    *completed* requests only; errored ones show up in ``errors`` and drag
    ``recovered_rate`` down instead of polluting the timing."""

    results: List[RequestResult]
    wall_s: float

    @property
    def requests(self) -> int:
        return len(self.results)

    @property
    def completed(self) -> List[RequestResult]:
        return [r for r in self.results if r.ok]

    @property
    def errors(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for r in self.results:
            if not r.ok:
                out[r.error_code] = out.get(r.error_code, 0) + 1
        return out

    @property
    def recovered_rate(self) -> float:
        return len(self.completed) / self.requests if self.requests else 0.0

    @property
    def requests_per_second(self) -> float:
        return self.requests / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def latencies_ms(self) -> List[float]:
        return [r.latency_s * 1e3 for r in self.completed]

    @property
    def p50_ms(self) -> float:
        return percentile(self.latencies_ms, 50.0)

    @property
    def p99_ms(self) -> float:
        return percentile(self.latencies_ms, 99.0)

    @property
    def mean_occupancy(self) -> float:
        done = self.completed
        return float(np.mean([r.occupancy for r in done])) if done else 0.0

    @property
    def all_in_order(self) -> bool:
        return all(r.in_order for r in self.results)

    def summary(self) -> Dict[str, float]:
        return {
            "requests": self.requests,
            "completed": len(self.completed),
            "recovered_rate": self.recovered_rate,
            "wall_s": self.wall_s,
            "requests_per_second": self.requests_per_second,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "mean_occupancy": self.mean_occupancy,
        }


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile — deterministic, no interpolation surprises."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
    return float(ordered[min(rank, len(ordered)) - 1])


def _fold_events(request_id: str, events: List[Dict[str, Any]], t0: float, keep: str) -> RequestResult:
    steps_seen: List[int] = []
    step_fields: Dict[int, Dict[str, np.ndarray]] = {}
    final_fields: Dict[str, np.ndarray] = {}
    occupancy, members, latency = 0.0, 0, monotonic() - t0
    error_code: Optional[int] = None
    error_reason: Optional[str] = None
    for ev in events:
        if ev["type"] == "error":
            error_code = int(ev.get("code", 500))
            error_reason = str(ev.get("reason", ""))
        if ev["type"] == "step":
            steps_seen.append(int(ev["step"]))
            if keep == "all":
                step_fields[int(ev["step"])] = ev["fields"]
            if keep in ("all", "final"):
                final_fields = ev["fields"]
        if ev["type"] == "done":
            occupancy = float(ev["batch"]["occupancy"])
            members = int(ev["batch"]["members"])
            latency = float(ev.get("latency_s", latency))
    return RequestResult(
        request_id=request_id,
        steps_seen=steps_seen,
        final_fields=final_fields,
        step_fields=step_fields,
        latency_s=latency,
        occupancy=occupancy,
        members=members,
        error_code=error_code,
        error_reason=error_reason,
    )


def _retry_sleep_s(retry_after_ms: Optional[float], attempt: int = 1) -> float:
    """How long to back off before resubmitting a 503-rejected request: the
    server's estimate, scaled up linearly per attempt (the estimate proving
    optimistic is itself a sign of overload), floored and capped."""
    base = 0.01 if retry_after_ms is None or retry_after_ms <= 0 else retry_after_ms / 1e3
    return min(max(base, 0.005) * max(attempt, 1), MAX_RETRY_SLEEP_S)


async def drive_engine(
    engine: ServingEngine,
    specs: Sequence[RequestSpec],
    *,
    keep_fields: str = "all",
    retry_503: int = 3,
) -> LoadReport:
    """Issue all specs concurrently against an in-process engine."""

    async def one(i: int, spec: RequestSpec) -> RequestResult:
        rid = spec.request_id or f"load-{i}"
        t0 = monotonic()
        attempt = 0
        while True:
            try:
                req = engine.submit(
                    spec.program,
                    spec.fields,
                    spec.scalars,
                    steps=spec.steps,
                    stream_every=spec.stream_every,
                    fingerprint=spec.fingerprint,
                    request_id=rid,
                    stats=spec.stats,
                    deadline_ms=spec.deadline_ms,
                    priority=spec.priority,
                )
                break
            except ServingError as e:
                if e.code == OVERLOADED and attempt < retry_503:
                    attempt += 1
                    await asyncio.sleep(_retry_sleep_s(e.retry_after_ms, attempt))
                    continue
                return _fold_events(
                    rid,
                    [{"type": "error", "code": e.code, "reason": e.reason}],
                    t0,
                    keep_fields,
                )
        events = [ev async for ev in engine.stream(req)]
        return _fold_events(rid, events, t0, keep_fields)

    t0 = monotonic()
    results = await asyncio.gather(*(one(i, s) for i, s in enumerate(specs)))
    return LoadReport(results=list(results), wall_s=monotonic() - t0)


def _forecast_frame(rid: str, spec: RequestSpec) -> Dict[str, Any]:
    frame: Dict[str, Any] = {
        "type": "forecast",
        "request_id": rid,
        "program": spec.program,
        "steps": spec.steps,
        "stream_every": spec.stream_every,
        "fields": {n: encode_array(a) for n, a in spec.fields.items()},
        "scalars": {n: float(v) for n, v in spec.scalars.items()},
        "stats": spec.stats,
    }
    if spec.fingerprint is not None:
        frame["fingerprint"] = spec.fingerprint
    if spec.deadline_ms is not None:
        frame["deadline_ms"] = spec.deadline_ms
    if spec.priority is not None:
        frame["priority"] = spec.priority
    return frame


async def drive_server(
    url: str,
    specs: Sequence[RequestSpec],
    *,
    keep_fields: str = "all",
    connect_timeout_s: float = 10.0,
    read_timeout_s: float = 60.0,
    retry_503: int = 3,
) -> LoadReport:
    """Issue all specs concurrently over one real websocket connection.

    The connect wait and every frame read are bounded; a server that stops
    answering turns still-pending requests into ``CLIENT_TIMEOUT`` error
    results rather than hanging the driver.  503 rejections are resubmitted
    after their advertised ``retry_after_ms`` (capped), ``retry_503`` times."""
    try:
        import aiohttp
    except ImportError:
        raise RuntimeError("drive_server needs aiohttp (pip install aiohttp)") from None

    ids = [s.request_id or f"load-{i}" for i, s in enumerate(specs)]
    frames = {rid: _forecast_frame(rid, spec) for rid, spec in zip(ids, specs)}
    events: Dict[str, List[Dict[str, Any]]] = {rid: [] for rid in ids}
    done: Dict[str, asyncio.Event] = {rid: asyncio.Event() for rid in ids}
    retries: Dict[str, int] = {rid: 0 for rid in ids}
    t0s: Dict[str, float] = {}

    def _fail_pending(reason: str) -> None:
        for rid, d in done.items():
            if not d.is_set():
                events[rid].append(
                    {"type": "error", "code": CLIENT_TIMEOUT, "reason": reason, "request_id": rid}
                )
                d.set()

    async with aiohttp.ClientSession() as session:
        ws = await asyncio.wait_for(session.ws_connect(url), connect_timeout_s)
        resend_tasks: List[asyncio.Task] = []
        try:

            async def resend(rid: str, after_ms: Optional[float]) -> None:
                await asyncio.sleep(_retry_sleep_s(after_ms, retries[rid]))
                await ws.send_str(dumps(frames[rid]))

            async def reader() -> None:
                loop = asyncio.get_running_loop()
                while not all(d.is_set() for d in done.values()):
                    try:
                        raw = await ws.receive(timeout=read_timeout_s)
                    except asyncio.TimeoutError:
                        _fail_pending(f"no frame from server within {read_timeout_s}s")
                        return
                    if raw.type in (
                        aiohttp.WSMsgType.CLOSE,
                        aiohttp.WSMsgType.CLOSED,
                        aiohttp.WSMsgType.ERROR,
                    ):
                        _fail_pending("connection closed by server")
                        return
                    if raw.type != aiohttp.WSMsgType.TEXT:
                        continue
                    ev = decode_event(loads(raw.data))
                    rid = ev.get("request_id")
                    if rid not in events:
                        continue
                    if ev["type"] == "error" and ev.get("code") == OVERLOADED and retries[rid] < retry_503:
                        retries[rid] += 1
                        resend_tasks.append(loop.create_task(resend(rid, ev.get("retry_after_ms"))))
                        continue
                    events[rid].append(ev)
                    if ev["type"] in ("done", "error"):
                        done[rid].set()

            pump = asyncio.get_running_loop().create_task(reader())
            t0 = monotonic()
            for rid in ids:
                t0s[rid] = monotonic()
                await ws.send_str(dumps(frames[rid]))
            await asyncio.gather(*(d.wait() for d in done.values()))
            wall = monotonic() - t0
            pump.cancel()
            for t in resend_tasks:
                t.cancel()
        finally:
            await ws.close()
    results = [_fold_events(rid, events[rid], t0s[rid], keep_fields) for rid in ids]
    return LoadReport(results=results, wall_s=wall)
