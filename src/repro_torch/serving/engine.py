"""Forecast-as-a-service engine: requests-as-members dynamic batching.

The ensemble machinery is a request batcher in disguise: members are
*independent*, so K concurrent forecast requests can ride the member axis of
ONE batched ``iterate`` dispatch instead of K sequential program calls.  On
the ``cuda`` backend and the card that dispatch is one member-batched launch
per fused group and step (``gridDim.z`` = members).
The engine holds compiled artifacts hot and turns a stream of websocket-sized
requests into full batches:

1. **Admission** — requests are admitted against a registered
   :class:`ProgramEntry` keyed by the existing
   ``caching.program_fingerprint``: unknown programs 404, stale fingerprints
   409, wrong field shapes/dtypes 413, bad scalars/steps 422.  A request that
   would trigger a recompile is *rejected at the door*, never silently
   stalled behind a trace and a kernel build.  The admission queue is **bounded**: a full
   queue rejects with 503 + ``retry_after_ms`` (computed from the watchdog's
   median dispatch wall and the queue depth) instead of buffering unbounded
   work it cannot finish.
2. **Batching window** — a worker task moves arrivals into the pluggable
   scheduler's backlog (:mod:`serving.scheduler`): on an empty backlog it
   blocks for the first arrival, then keeps collecting until ``window_ms``
   elapses or the backlog covers the present programs' member caps; a
   non-empty backlog dispatches immediately (only already-arrived requests
   join).  The scheduler then forms **per-program windows in urgency order**
   (default ``edf``: earliest deadline first within priority classes —
   FIFO-identical when requests carry neither), distinct programs dispatch
   concurrently, and the surplus stays in the backlog where it is re-ordered
   against newer, possibly more urgent, arrivals every round.  Requests that
   expired while queued are 504'd at pickup without burning a dispatch.
   Under load (state ``DEGRADED``) the window shrinks so queued work drains
   faster.
3. **Padding to tuned member counts** — the batch is padded up to the nearest
   registered member count (by default the counts with a persisted autotune
   ``batch`` record, via :func:`tuned_member_counts`, plus small powers of
   two) by repeating the last request's state.  Padded members compute
   garbage nobody gathers; in exchange every dispatch reuses warm,
   possibly autotuned, prepared launches.  The loop closes both ways: observed
   ``(batch size → wall)`` records are written back into the tune store
   (:func:`repro_torch.core.autotune.record_batch_observation`), so the counts
   :func:`tuned_member_counts` prefers are learned from real traffic.
4. **Segmented iterate + streaming** — the union of the batch's stream points
   splits the horizon into segments; each segment is one member-batched
   ``Ensemble.iterate`` dispatch, after which per-request member slices are
   gathered (host copies) and streamed as ``step`` events.  Chunking is
   bit-safe: ``iterate(a); iterate(b)`` ≡ ``iterate(a+b)`` ≡ the sequential
   per-request loop, which the contract tests assert to 0 ULP in float64.

Resilience (the failure model, chaos-tested via :mod:`serving.faults`):

* **Deadlines** — a request may carry ``deadline_ms``; expiry is checked at
  window pickup (a request that died in the queue is 504'd before any
  scatter or dispatch is spent on it) and again at every segment boundary,
  so expired requests get a 504-style ``error`` event instead of burning
  further dispatches.
* **Retry-with-bisect** — a failed batched dispatch retries with exponential
  backoff; if it keeps failing and the batch holds more than one request,
  the batch is *bisected* (current member states gathered and re-scattered
  into two half-batches) so one poison request ends up alone, gets its own
  ``error`` event, and its co-batched neighbors still complete — and because
  gather→re-scatter round-trips bit-exactly and ``iterate`` chunks exactly,
  the survivors remain bit-identical to their unfaulted sequential runs.
* **Health states** — ``SERVING`` → ``DEGRADED`` (queue above the watermark:
  sheds per-step statistics and shrinks the batching window) → ``DRAINING``
  (:meth:`ServingEngine.drain`: stop admitting, finish in-flight work, then
  stop the worker) — the graceful-SIGTERM path of the serve CLI.
* **No orphaned requests** — a worker-level failure (e.g. while grouping)
  fails every in-flight request with an ``error`` event and the worker keeps
  running; a worker *death* fails everything queued and the next submission
  respawns it.  Every accepted request terminates.

The engine is pure asyncio + numpy/torch — no websocket dependency; transports
(``serving.server``) and in-process drivers (``serving.client``) sit on top.

(The reference package's ``repro/serving/engine.py``.  What differs: programs
on the ``torch``/``cuda`` backends; request fields reach the card by a host
copy per member (``ensemble.batch.scatter_members``) and stream back by one
(``gather_member``); and a dispatch's executor job waits for the fields'
stream before it returns, so the dispatch wall the watchdog, the
``serving_dispatch_seconds`` histogram, ``retry_after_ms`` and the tune-store
feedback read is the card's time, not the time to queue the launches — and
an asynchronous CUDA error surfaces inside the dispatch's retry-with-bisect.)
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import json
import math
from dataclasses import dataclass, field as dc_field
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import autotune, caching
from repro_torch.core.storage import TORCH_BACKENDS, Storage
from repro_torch.ensemble import Ensemble
from repro_torch.ensemble import batch as ens_batch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import trace as otrace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.trace import monotonic
from repro_torch.program.compile import ProgramObject
from repro_torch.runtime.supervise import StragglerWatchdog

from .faults import FaultInjector, InjectedFault
from .protocol import (
    DEADLINE_EXCEEDED,
    FINGERPRINT_MISMATCH,
    INTERNAL,
    INVALID_VALUE,
    OVERLOADED,
    SHAPE_MISMATCH,
    UNKNOWN_PROGRAM,
    ServingError,
)
from .scheduler import BatchingScheduler, make_scheduler

#: padding targets always available, even with no autotune record on disk
DEFAULT_MEMBER_COUNTS = (1, 2, 4, 8, 16)

#: engine health states
SERVING = "SERVING"
DEGRADED = "DEGRADED"
DRAINING = "DRAINING"

#: per-program counter families: stats() flat key → (family name, help).
#: Every one of these carries a ``program`` label so a multi-program engine
#: is diagnosable per workload on /metrics and /stats.
PROGRAM_COUNTERS = (
    ("requests", "serving_requests_total", "requests admitted"),
    ("batches", "serving_batches_total", "batching windows dispatched"),
    ("dispatches", "serving_dispatches_total", "segment dispatches completed"),
    ("steps_streamed", "serving_steps_streamed_total", "step events emitted"),
    ("padded_members", "serving_padded_members_total",
     "member slots dispatched (padding included)"),
    ("live_members", "serving_live_members_total",
     "request-backed member slots dispatched"),
    ("deadline_expired", "serving_deadline_expired_total",
     "requests expired at window pickup or a segment boundary"),
    ("retries", "serving_retries_total", "scatter/dispatch/gather retries"),
    ("bisects", "serving_bisects_total", "batch bisections after exhausted retries"),
    ("abandoned", "serving_abandoned_total", "requests abandoned by clients"),
)

#: per-program histogram families: entry key → (family name, help)
PROGRAM_HISTOGRAMS = (
    ("occupancy", "serving_batch_occupancy", "live members / padded members per batch"),
    ("dispatch", "serving_dispatch_seconds", "segment dispatch wall seconds"),
    ("queue_wait", "serving_queue_wait_seconds", "submit-to-window-pickup wait seconds"),
    ("latency", "serving_request_latency_seconds", "submit-to-done latency seconds"),
)


def tuned_member_counts(cp, faults: Optional[FaultInjector] = None) -> List[int]:
    """Member counts with a persisted autotune ``batch`` record.

    The Pallas autotuner writes ``<name>_<fp>.tune.json`` next to each
    generated group module (``caching.tuning_path``); records measured on
    member-batched shapes carry the batch extent under ``"batch"``.  Those
    extents are exactly the batch sizes the store holds a measured tile for,
    so the engine prefers padding to them.  An unreadable store (or an
    injected ``tune_read`` fault) degrades gracefully to the default counts —
    tuning data is an optimization, never a liveness dependency."""
    counts = set()
    for obj in getattr(cp, "group_objects", ()):
        path = caching.tuning_path(obj.name, obj.fingerprint)
        try:
            if faults is not None:
                faults.check("tune_read", keys=(obj.name,))
            store = json.loads(path.read_text())
        except (OSError, ValueError, InjectedFault):
            continue
        for rec in store.get("domains", {}).values():
            b = rec.get("batch") if isinstance(rec, dict) else None
            if b:
                counts.add(int(b))
    return sorted(counts)


@dataclass
class ForecastRequest:
    """One admitted request: inputs plus the event queue results stream to."""

    request_id: str
    entry: "ProgramEntry"
    steps: int
    stream_every: int
    fields: Dict[str, np.ndarray]
    scalars: Dict[str, Any]
    want_stats: bool = False
    deadline_ms: Optional[float] = None
    priority: int = 0  # urgency class in [0, engine.priority_classes), 0 most urgent
    seq: int = 0  # admission sequence number — the deterministic tiebreaker
    submitted_at: float = 0.0
    sampled: bool = True  # head-sampling decision, made once at submit
    queue_wait_s: Optional[float] = None  # submit → window pickup, set by the worker
    deadline_at: Optional[float] = None  # monotonic deadline, set at submit
    abandoned: bool = False  # transport saw the client vanish — stop emitting
    terminal: bool = False  # a done/error was posted; later events are dropped
    events: "asyncio.Queue[Dict[str, Any]]" = dc_field(default_factory=asyncio.Queue)

    def post(self, event: Dict[str, Any]) -> None:
        """Deliver one event; a terminal event seals the stream (at-most-one
        ``done``/``error`` per request, no matter how many failure paths
        race) and an abandoned request drops events instead of buffering
        frames nobody will read."""
        if self.terminal:
            return
        if event["type"] in ("done", "error"):
            self.terminal = True
        elif self.abandoned:
            return
        self.events.put_nowait(event)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_at is None:
            return False
        return (monotonic() if now is None else now) > self.deadline_at


class ProgramEntry:
    """One registered program held hot: the compiled single-member artifact,
    per-member-count ensembles, and the admission contract requests are
    checked against."""

    def __init__(
        self,
        engine: "ServingEngine",
        prog: ProgramObject,
        *,
        fields: Dict[str, Storage],
        scalars: Dict[str, Any],
        request_fields: Sequence[str],
        stream_fields: Optional[Sequence[str]] = None,
        member_counts: Optional[Sequence[int]] = None,
        max_steps: int = 10_000,
    ):
        if prog.backend not in TORCH_BACKENDS:
            raise ServingError(INTERNAL, f"serving requires a torch/cuda program, not {prog.backend!r}")
        missing = [n for n in prog.field_params if n not in fields]
        if missing:
            raise ServingError(INTERNAL, f"register({prog.name!r}): missing template fields {missing}")
        missing = [n for n in prog.scalar_params if n not in scalars]
        if missing:
            raise ServingError(INTERNAL, f"register({prog.name!r}): missing default scalars {missing}")
        bad = [n for n in request_fields if n not in prog.field_params]
        if bad:
            raise ServingError(INTERNAL, f"register({prog.name!r}): unknown request fields {bad}")
        self.engine = engine
        self.prog = prog
        self.name = prog.name
        self.fields = {n: fields[n] for n in prog.field_params}
        self.scalars = {n: scalars[n] for n in prog.scalar_params}
        self.request_fields = tuple(request_fields)
        self.stream_fields = tuple(stream_fields or request_fields)

        # compile (or hit the cache for) the single-member artifact NOW —
        # admission is a fingerprint check, never a recompile stall later
        cp = prog.compiled(self.fields, self.scalars)
        if cp.iterable_reason is not None:
            raise ServingError(INTERNAL, f"program {prog.name!r} cannot be served: {cp.iterable_reason}")
        self.cp = cp
        self.fingerprint = cp.fingerprint

        # everything the program writes must be member-batched (members would
        # race on one buffer) — same classification the ensemble layer enforces
        written = set(cp.written_buffers) | set(cp.outputs.values())
        written |= {o for o in cp.outputs if o in self.fields}
        self.batched_fields = tuple(
            sorted(set(self.request_fields) | {b for b in written if b in self.fields})
        )
        self.shared_fields = tuple(n for n in prog.field_params if n not in self.batched_fields)

        counts = (
            list(member_counts)
            if member_counts
            else tuned_member_counts(cp, faults=engine.faults) + list(DEFAULT_MEMBER_COUNTS)
        )
        self.member_counts = tuple(sorted({int(c) for c in counts if int(c) >= 1}))
        if not self.member_counts:
            raise ServingError(INTERNAL, f"register({prog.name!r}): empty member_counts")
        self.max_batch = self.member_counts[-1]
        self.max_steps = int(max_steps)
        self.ensembles = {m: Ensemble(prog, m, name=f"{self.name}_serve{m}") for m in self.member_counts}
        # per-program labeled metric children, created eagerly so /metrics
        # shows zeroed families for every registered program from the start
        self.counters, self.hist = engine._program_metrics(self.name)

    def pad_to(self, k: int) -> int:
        """Smallest registered member count holding ``k`` live requests."""
        for m in self.member_counts:
            if m >= k:
                return m
        return self.max_batch

    def admit_fields(self, fields: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        got, want = set(fields), set(self.request_fields)
        if got != want:
            missing, extra = sorted(want - got), sorted(got - want)
            raise ServingError(
                SHAPE_MISMATCH,
                f"program {self.name!r} takes request fields {sorted(want)}"
                + (f"; missing {missing}" if missing else "")
                + (f"; unexpected {extra}" if extra else ""),
            )
        out = {}
        for n in self.request_fields:
            arr = np.asarray(fields[n])
            tmpl = self.fields[n]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ServingError(
                    SHAPE_MISMATCH,
                    f"field {n!r} has shape {tuple(arr.shape)}, program {self.name!r} is compiled "
                    f"for {tuple(tmpl.shape)} — other geometries are not admitted (no recompile)",
                )
            if str(arr.dtype) != str(tmpl.dtype):
                raise ServingError(
                    SHAPE_MISMATCH, f"field {n!r} has dtype {arr.dtype}, program expects {tmpl.dtype}"
                )
            out[n] = arr
        return out

    def admit_scalars(self, scalars: Dict[str, Any]) -> Dict[str, Any]:
        bad = [n for n in scalars if n not in self.scalars]
        if bad:
            raise ServingError(
                INVALID_VALUE, f"unknown scalars {sorted(bad)}; program takes {sorted(self.scalars)}"
            )
        for n, v in scalars.items():
            if np.ndim(v) != 0:
                raise ServingError(INVALID_VALUE, f"scalar {n!r} must be a number, got shape {np.shape(v)}")
        merged = dict(self.scalars)
        merged.update({n: float(v) for n, v in scalars.items()})
        return merged

    def warm(self, chunk: int = 1) -> None:
        """Run every member count once, so the first real batch pays dispatch
        cost only: the member-batched kernels are built and loaded, their
        blocks tuned (``autotune=True``) and their launches prepared.
        ``chunk`` should match the serving segment length (``stream_every``)."""
        sample = {n: self.fields[n].to_numpy() for n in self.request_fields}
        for m in self.member_counts:
            storages = self._batch_storages([sample], m)
            self.ensembles[m].iterate(
                int(chunk), *[storages[n] for n in self.prog.field_params], **self.scalars
            )

    def _batch_storages(
        self, states: List[Dict[str, np.ndarray]], m: int, *, full_state: bool = False
    ) -> Dict[str, Storage]:
        """Scatter K requests into member slots of fresh batched storages.

        A fresh batch (``full_state=False``) scatters request fields onto the
        member axis and broadcasts written workspace fresh per batch (never
        reused — a batch must not see a previous batch's scratch).  A
        *resumed* batch (``full_state=True``, the retry-with-bisect path)
        scatters every batched field from the members' gathered mid-horizon
        states, so the re-formed half-batch continues bit-exactly where the
        failed dispatch left off.  Shared read-only fields pass through as
        the registered template storages either way, which the ensemble layer
        broadcasts without materializing copies and never writes back."""
        storages: Dict[str, Storage] = {}
        scattered = self.batched_fields if full_state else self.request_fields
        for n in self.prog.field_params:
            tmpl = self.fields[n]
            if n in scattered:
                storages[n] = ens_batch.scatter_members([s[n] for s in states], m, template=tmpl)
            elif n in self.batched_fields:
                storages[n] = ens_batch.broadcast(tmpl, m)
            else:
                storages[n] = tmpl
        return storages

    def gather_state(self, storages: Dict[str, Storage], i: int) -> Dict[str, np.ndarray]:
        """Member ``i``'s complete batched state as host copies — everything
        needed to resume its horizon in a fresh batch (bisect path)."""
        return {n: ens_batch.gather_member(storages[n], i) for n in self.batched_fields}

    def describe(self) -> Dict[str, Any]:
        return {
            "program": self.name,
            "backend": self.prog.backend,
            "fingerprint": self.fingerprint,
            "request_fields": {
                n: {"shape": list(self.fields[n].shape), "dtype": str(self.fields[n].dtype)}
                for n in self.request_fields
            },
            "stream_fields": list(self.stream_fields),
            "scalars": {n: float(v) for n, v in self.scalars.items()},
            "member_counts": list(self.member_counts),
            "max_steps": self.max_steps,
        }


def _segment_plan(requests: Sequence[ForecastRequest]) -> List[int]:
    """Split the batch horizon at the union of every request's stream points
    (multiples of its ``stream_every`` plus its final step), so each segment
    is one fused dispatch and every emission lands on a segment boundary."""
    points = sorted(
        {
            t
            for r in requests
            for t in itertools.chain(range(r.stream_every, r.steps + 1, r.stream_every), (r.steps,))
        }
    )
    segments, prev = [], 0
    for t in points:
        segments.append(t - prev)
        prev = t
    return segments


def _field_stats(arr: np.ndarray) -> Dict[str, float]:
    return {"min": float(arr.min()), "max": float(arr.max()), "mean": float(arr.mean())}


class ServingEngine:
    """The asyncio compute server core: admission, batching, streaming,
    and the resilience policies (backpressure, deadlines, retry-with-bisect,
    health states) that keep it operable under faults and overload."""

    def __init__(
        self,
        *,
        window_ms: float = 2.0,
        straggler_factor: float = 3.0,
        max_queue: int = 128,
        degraded_watermark: float = 0.5,
        retry_attempts: int = 3,
        retry_backoff_ms: float = 20.0,
        faults: Optional[FaultInjector] = None,
        tracer: Optional[otrace.Tracer] = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        slos: Optional[Sequence[obs_slo.Objective]] = None,
        autoscaler: Optional[obs_slo.Autoscaler] = None,
        flight: Optional[FlightRecorder] = None,
        scheduler: Union[str, BatchingScheduler, None] = None,
        priority_classes: int = 3,
    ):
        self.window_s = float(window_ms) / 1e3
        self.max_queue = int(max_queue)
        self.degraded_watermark = float(degraded_watermark)
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_s = float(retry_backoff_ms) / 1e3
        self.faults = faults if faults is not None else FaultInjector.from_env()
        self._programs: Dict[str, ProgramEntry] = {}
        self._queue: "asyncio.Queue[ForecastRequest]" = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None
        self._request_ids = itertools.count()
        self._batch_seq = itertools.count()
        self._dispatch_seq = itertools.count()
        self._submit_seq = itertools.count()
        self._inflight = 0
        self._draining = False
        self.scheduler = make_scheduler(scheduler)
        self.priority_classes = max(1, int(priority_classes))
        # best observed us/step per (program, batch size) — gates tune-store
        # write-backs so the hot path rewrites the store only on improvement
        self._batch_best: Dict[Tuple[str, int], float] = {}
        self.watchdog = StragglerWatchdog(factor=straggler_factor)
        # a fixed tracer wins; otherwise spans follow the contextvar routing
        # (capture() overrides, REPRO_TRACE/configure() for the process default)
        self._tracer = tracer
        # every operational counter lives in the registry; stats() is a view
        # of it, and the transport serves to_prometheus() on GET /metrics
        self.metrics = metrics if metrics is not None else obs_metrics.MetricsRegistry()
        reg = self.metrics
        # per-program counters/histograms (PROGRAM_COUNTERS/_HISTOGRAMS) are
        # created at registration and live on each ProgramEntry; only the
        # genuinely engine-global instruments stay unlabeled here
        self._c: Dict[str, obs_metrics.Counter] = {
            "rejected_overloaded": reg.counter(
                "serving_rejected_overloaded_total", "503 backpressure rejections"
            ),
            "worker_failures": reg.counter(
                "serving_worker_failures_total", "batching-worker failures survived"
            ),
        }
        reg.gauge(
            "serving_queue_depth",
            "requests waiting for dispatch (admission queue + scheduler backlog)",
            fn=self.queue_depth,
        )
        reg.gauge(
            "serving_inflight",
            "requests inside a batching window or dispatch",
            fn=lambda: self._inflight,
        )
        for st in (SERVING, DEGRADED, DRAINING):
            reg.gauge(
                "serving_state",
                "engine health state (1 marks the current state)",
                fn=lambda s=st: float(self.state == s),
                state=st,
            )
        self._h_window = reg.histogram(
            "serving_window_requests", "requests collected per batching window"
        )
        # SLO evaluation + the autoscaling signal read the same registry the
        # counters above write; breaches trigger a flight-recorder dump
        self.slo = obs_slo.SloEngine(
            reg, list(slos or ()), tracer=self._trace, on_breach=self._on_slo_breach
        )
        # latency objectives evaluate over windows scaled to the batching
        # window, so a breach recovery is observable within one evaluation
        # cycle of good traffic instead of waiting out the 5-minute default
        self.slo.wire_batch_window(self.window_s)
        self.autoscaler = autoscaler if autoscaler is not None else obs_slo.Autoscaler()
        self.flight = flight if flight is not None else FlightRecorder.from_env()
        if self.flight is not None:
            self.flight.bind(
                tracer=self._trace,
                metrics=reg,
                stats=self.stats,
                slo=self.slo,
                config={
                    "window_ms": self.window_s * 1e3,
                    "scheduler": self.scheduler.name,
                    "priority_classes": self.priority_classes,
                    "max_queue": self.max_queue,
                    "degraded_watermark": self.degraded_watermark,
                    "retry_attempts": self.retry_attempts,
                    "retry_backoff_ms": self.retry_backoff_s * 1e3,
                },
            )

    # -- telemetry plumbing --------------------------------------------------

    def _trace(self) -> otrace.Tracer:
        return self._tracer if self._tracer is not None else otrace.current_tracer()

    def _span(self, name: str, **kwargs: Any):
        return self._trace().span(name, category="serving", **kwargs)

    def _tevent(self, name: str, **kwargs: Any) -> None:
        self._trace().event(name, category="serving", **kwargs)

    def _program_metrics(
        self, program: str
    ) -> Tuple[Dict[str, obs_metrics.Counter], Dict[str, obs_metrics.Histogram]]:
        """The labeled children every registered program gets (cached on its
        ProgramEntry so the hot path never rebuilds a label key)."""
        reg = self.metrics
        counters = {
            key: reg.counter(fam, help_, program=program)
            for key, fam, help_ in PROGRAM_COUNTERS
        }
        hists = {
            key: reg.histogram(fam, help_, program=program)
            for key, fam, help_ in PROGRAM_HISTOGRAMS
        }
        return counters, hists

    def _sched_decision(self, decision: str) -> obs_metrics.Counter:
        """Scheduler decision counters (``serving_scheduler_decisions_total``
        labeled by policy + decision): windows formed, windows whose dispatch
        order differs from arrival order, concurrent-program rounds, and
        requests expired at pickup."""
        return self.metrics.counter(
            "serving_scheduler_decisions_total",
            "batching-scheduler decisions",
            scheduler=self.scheduler.name,
            decision=decision,
        )

    def _priority_hist(self, program: str, priority: int) -> obs_metrics.Histogram:
        """Per-priority-class latency (its own family, not extra labels on
        ``serving_request_latency_seconds`` — the existing summary's roll-up
        reads would double-count a second label dimension)."""
        return self.metrics.histogram(
            "serving_priority_latency_seconds",
            "submit-to-done latency seconds per priority class",
            program=program,
            priority=str(priority),
        )

    def _post_error(self, req: ForecastRequest, code: int, reason: str) -> None:
        """The one chokepoint every terminal error flows through: counted in
        ``serving_errors_total{program=,code=}`` (what the SLO engine burns
        budget against), the request id force-sampled so the tail of a
        failing story survives head sampling, then the sealed error post."""
        if req.terminal:
            return
        tracer = self._trace()
        if tracer.enabled:
            tracer.force_sample(req.request_id)
        self.metrics.counter(
            "serving_errors_total",
            "requests terminated by an error event",
            program=req.entry.name,
            code=str(code),
        ).inc()
        req.post({"type": "error", "code": code, "reason": reason, "request_id": req.request_id})

    def _on_slo_breach(self, status: Dict[str, Any]) -> None:
        self._flight_dump(f"slo_breach:{status['objective']}", extra={"breach": status})

    def _flight_dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> None:
        if self.flight is not None:
            self.flight.dump(reason, extra=extra)

    def autoscale_signal(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /autoscale`` payload: evaluate the SLOs, then apply the
        documented desired-replica rule (queue depth + batch capacity +
        latency-vs-SLO pressure + active breaches, hysteresis-damped)."""
        slo_status = self.slo.evaluate(now=now)
        max_batch = max((e.max_batch for e in self._programs.values()), default=1)
        rec = self.autoscaler.recommend(
            queue_depth=self.queue_depth(),
            inflight=self._inflight,
            max_batch=max_batch,
            latency_ratio=self.slo.latency_pressure(),
            breaching=slo_status["breaching"],
        )
        rec["slo"] = slo_status
        return rec

    # -- health state --------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting for dispatch: the admission queue plus the
        scheduler's backlog (arrivals the worker has pooled but not yet taken
        into a window) — the quantity backpressure, the DEGRADED watermark,
        and the autoscaler all key on."""
        return self._queue.qsize() + self.scheduler.backlog()

    @property
    def state(self) -> str:
        """``SERVING`` → ``DEGRADED`` (queue past the watermark — shed
        optional work) → ``DRAINING`` (reject new, finish in-flight)."""
        if self._draining:
            return DRAINING
        if self.queue_depth() >= max(1, math.ceil(self.degraded_watermark * self.max_queue)):
            return DEGRADED
        return SERVING

    def _retry_after_ms(self) -> float:
        """How long an overload-rejected client should back off: the median
        dispatch wall (watchdog) times the number of batches queued ahead.

        Before any dispatch has been recorded the watchdog median is 0.0 (and
        it must never be NaN-poisoned by an empty sample set), so the window
        length stands in as the only latency scale the engine knows yet."""
        med_s = self.watchdog.stats.median_s
        if not med_s or math.isnan(med_s):
            med_s = max(self.window_s, 1e-3)
        cap = max((e.max_batch for e in self._programs.values()), default=1)
        pending = self.queue_depth() + self._inflight
        batches_ahead = max(1, math.ceil(max(pending, 1) / cap))
        return med_s * batches_ahead * 1e3

    # -- registration ------------------------------------------------------

    def register(
        self,
        prog: ProgramObject,
        *,
        fields: Dict[str, Storage],
        scalars: Dict[str, Any],
        request_fields: Sequence[str],
        stream_fields: Optional[Sequence[str]] = None,
        member_counts: Optional[Sequence[int]] = None,
        max_steps: int = 10_000,
        warm: bool = False,
        warm_chunk: int = 1,
    ) -> ProgramEntry:
        """Compile ``prog`` on the template ``fields``/``scalars`` and hold it
        hot.  Only registered (program, geometry) pairs are ever admitted."""
        entry = ProgramEntry(
            self,
            prog,
            fields=fields,
            scalars=scalars,
            request_fields=request_fields,
            stream_fields=stream_fields,
            member_counts=member_counts,
            max_steps=max_steps,
        )
        self._programs[entry.name] = entry
        if warm:
            entry.warm(warm_chunk)
        return entry

    def catalog(self) -> List[Dict[str, Any]]:
        return [e.describe() for e in self._programs.values()]

    # -- admission + submission --------------------------------------------

    def admit(
        self,
        program: str,
        fields: Dict[str, np.ndarray],
        scalars: Optional[Dict[str, Any]] = None,
        *,
        steps: int = 1,
        stream_every: int = 1,
        fingerprint: Optional[str] = None,
        request_id: Optional[str] = None,
        stats: bool = False,
        deadline_ms: Optional[float] = None,
        priority: Optional[int] = None,
    ) -> ForecastRequest:
        entry = self._programs.get(program)
        if entry is None:
            raise ServingError(
                UNKNOWN_PROGRAM, f"unknown program {program!r}; serving {sorted(self._programs)}"
            )
        if fingerprint is not None and fingerprint != entry.fingerprint:
            raise ServingError(
                FINGERPRINT_MISMATCH,
                f"fingerprint {fingerprint} does not match served artifact {entry.fingerprint} "
                f"for program {program!r} — refresh the catalog",
            )
        try:
            steps, stream_every = int(steps), int(stream_every)
        except (TypeError, ValueError):
            raise ServingError(INVALID_VALUE, "steps and stream_every must be integers") from None
        if not 1 <= steps <= entry.max_steps:
            raise ServingError(INVALID_VALUE, f"steps must be in [1, {entry.max_steps}], got {steps}")
        if stream_every < 1:
            raise ServingError(INVALID_VALUE, f"stream_every must be >= 1, got {stream_every}")
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError):
                raise ServingError(INVALID_VALUE, "deadline_ms must be a number") from None
            if not deadline_ms > 0:
                raise ServingError(INVALID_VALUE, f"deadline_ms must be > 0, got {deadline_ms}")
        if priority is None:
            # the "normal" class: below the most urgent (0) whenever more
            # than one class exists, so explicit urgency means something
            priority = min(1, self.priority_classes - 1)
        else:
            if isinstance(priority, bool) or not isinstance(priority, (int, np.integer)):
                raise ServingError(
                    INVALID_VALUE, f"priority must be an integer, got {priority!r}"
                )
            priority = int(priority)
            if not 0 <= priority < self.priority_classes:
                raise ServingError(
                    INVALID_VALUE,
                    f"priority must be in [0, {self.priority_classes}), got {priority}",
                )
        return ForecastRequest(
            request_id=request_id or f"req-{next(self._request_ids)}",
            entry=entry,
            steps=steps,
            stream_every=stream_every,
            fields=entry.admit_fields(fields),
            scalars=entry.admit_scalars(dict(scalars or {})),
            want_stats=bool(stats),
            deadline_ms=deadline_ms,
            priority=priority,
        )

    def submit(self, *args: Any, **kwargs: Any) -> ForecastRequest:
        """Admit and enqueue (synchronous — admission errors raise here, so a
        rejected request never occupies the batching window).  Backpressure
        rejections (503 + ``retry_after_ms``) also raise here: a full queue
        never buffers work the engine cannot finish in time."""
        if self._draining:
            raise ServingError(
                OVERLOADED,
                "engine is draining — not admitting new requests",
                retry_after_ms=self._retry_after_ms(),
            )
        if self.queue_depth() >= self.max_queue:
            self._c["rejected_overloaded"].inc()
            self._tevent(
                "serving.reject", reason="overloaded", queue_depth=self.queue_depth()
            )
            raise ServingError(
                OVERLOADED,
                f"admission queue full ({self.max_queue} requests)",
                retry_after_ms=self._retry_after_ms(),
            )
        tracer = self._trace()
        t_admit = monotonic()
        try:
            req = self.admit(*args, **kwargs)
        except ServingError as e:
            # rejected admissions still leave a trace: forced, so 4xx
            # stories survive head sampling
            tracer.add_span(
                "serving.admit", t_admit, monotonic(), category="serving",
                force=True, error=f"ServingError: {e.reason}", code=e.code,
            )
            raise
        # the head-sampling decision is made ONCE here and rides the request;
        # the admit span is recorded retroactively so a sampled-out request
        # pays one hash check instead of a span allocation
        req.sampled = tracer.sampling.decide(req.request_id)
        if req.sampled:
            tracer.add_span(
                "serving.admit", t_admit, monotonic(), category="serving",
                trace_ids=(req.request_id,), program=req.entry.name, steps=req.steps,
            )
        req.submitted_at = monotonic()
        if req.deadline_ms is not None:
            req.deadline_at = req.submitted_at + req.deadline_ms / 1e3
        req.seq = next(self._submit_seq)
        req.entry.counters["requests"].inc()
        self._ensure_worker()
        self._queue.put_nowait(req)
        req.post(
            {
                "type": "accepted",
                "request_id": req.request_id,
                "program": req.entry.name,
                "fingerprint": req.entry.fingerprint,
                "steps": req.steps,
                "stream_every": req.stream_every,
            }
        )
        return req

    async def stream(self, req: ForecastRequest) -> AsyncIterator[Dict[str, Any]]:
        """Yield this request's events until its terminal ``done``/``error``."""
        while True:
            ev = await req.events.get()
            yield ev
            if ev["type"] in ("done", "error"):
                return

    async def forecast(self, *args: Any, **kwargs: Any) -> AsyncIterator[Dict[str, Any]]:
        """Submit + stream in one call (the in-process client convenience)."""
        req = self.submit(*args, **kwargs)
        async for ev in self.stream(req):
            yield ev

    # -- the batching worker ------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(self._run_worker())
            self._worker.add_done_callback(self._worker_died)

    def _worker_died(self, task: asyncio.Task) -> None:
        """Failsafe for the orphaned-request hang: if the worker task ever
        dies with an exception (it should survive everything), fail every
        queued request instead of leaving them waiting forever; the next
        submission respawns the worker."""
        if task.cancelled() or task.exception() is None:
            return
        self._c["worker_failures"].inc()
        exc = task.exception()
        self._fail_all_queued(f"worker died: {type(exc).__name__}: {exc}")
        if self._worker is task:
            self._worker = None
        # the black box: dump spans/metrics/stats at the moment of death,
        # after the queued requests were failed (so their errors are counted)
        self._flight_dump(
            "worker_death", extra={"error": f"{type(exc).__name__}: {exc}"}
        )

    def _fail_all_queued(self, reason: str) -> None:
        for req in self.scheduler.flush():
            self._post_error(req, INTERNAL, reason)
        while True:
            try:
                req = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            self._post_error(req, INTERNAL, reason)

    def _fail_requests(self, requests: Sequence[ForecastRequest], code: int, reason: str) -> None:
        for r in requests:
            self._post_error(r, code, reason)

    def _pool_admit(self, req: ForecastRequest) -> bool:
        """Move one arrival from the admission queue into the scheduler's
        backlog — unless it is already dead: abandoned/terminal requests are
        dropped, and a request whose deadline expired while queued is 504'd
        right here, before any window slot or dispatch is spent on it."""
        if not self._still_wanted(req):
            return False
        if req.expired():
            self._expire_at_pickup(req)
            return False
        self.scheduler.push(req)
        return True

    def _expire_at_pickup(self, req: ForecastRequest, now: Optional[float] = None) -> None:
        """The 504-at-pickup path: the request died waiting in the queue, so
        it terminates without burning a scatter or dispatch (the satellite
        bugfix — previously an expired request still rode a full first
        segment before ``_mark_expired`` caught it)."""
        now = monotonic() if now is None else now
        req.entry.counters["deadline_expired"].inc()
        self._sched_decision("expired_at_pickup").inc()
        self._tevent(
            "serving.deadline",
            trace_ids=(req.request_id,),
            force=True,
            deadline_ms=req.deadline_ms,
            waited_ms=(now - req.submitted_at) * 1e3,
            at="pickup",
        )
        self._post_error(
            req,
            DEADLINE_EXCEEDED,
            f"deadline of {req.deadline_ms:.0f} ms expired after "
            f"{(now - req.submitted_at) * 1e3:.0f} ms in queue — not dispatched",
        )

    def _sweep_expired(self) -> None:
        """Purge the backlog of requests that died waiting (expired,
        abandoned, or already terminal) before windows form."""
        now = monotonic()
        dead = self.scheduler.sweep(lambda r: r.terminal or r.abandoned or r.expired(now))
        for req in dead:
            if self._still_wanted(req) and req.expired(now):
                self._expire_at_pickup(req, now)

    def _picked_up(self, req: ForecastRequest) -> None:
        """Queue-wait accounting at the moment the worker pops a request:
        the wait becomes a histogram sample and a retroactive span (nothing
        brackets it live, so it is recorded from its two endpoints)."""
        now = monotonic()
        if not req.submitted_at:
            return
        req.queue_wait_s = now - req.submitted_at
        req.entry.hist["queue_wait"].observe(req.queue_wait_s)
        tracer = self._trace()
        # the cached head decision gates the retro span; forced ids (a
        # request already in error territory) are kept regardless
        if tracer.enabled and (req.sampled or tracer.sampling.is_forced(req.request_id)):
            tracer.add_span(
                "serving.queue",
                req.submitted_at,
                now,
                category="serving",
                trace_ids=(req.request_id,),
            )

    async def _run_worker(self) -> None:
        while True:
            sched = self.scheduler
            fresh = False
            if not sched.backlog():
                # idle: block for the first arrival, then open a window
                if not self._pool_admit(await self._queue.get()):
                    continue
                fresh = True
            picked: List[ForecastRequest] = []
            try:
                loop = asyncio.get_running_loop()
                # DEGRADED sheds batching latency: a quarter window drains the
                # queue faster at the cost of occupancy
                window = self.window_s * (0.25 if self.state == DEGRADED else 1.0)
                with self._span(
                    "serving.window", window_s=window, scheduler=sched.name
                ) as wsp:
                    if fresh:
                        deadline = loop.time() + window
                        while sched.backlog() < sched.window_cap():
                            remaining = deadline - loop.time()
                            if remaining <= 0:
                                break
                            try:
                                req = await asyncio.wait_for(self._queue.get(), remaining)
                            except asyncio.TimeoutError:
                                break
                            self._pool_admit(req)
                    # everything already handed off joins the pool regardless
                    # of the cap — the cap only bounds how long we WAIT for
                    # more, never what the ordering policy gets to see (a
                    # leftover backlog therefore dispatches immediately: only
                    # already-arrived requests join, no second window wait)
                    while True:
                        try:
                            self._pool_admit(self._queue.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                    self._sweep_expired()
                    windows = sched.take(monotonic())
                    picked = [r for _, chunk in windows for r in chunk]
                    for r in picked:
                        self._inflight += 1
                        self._picked_up(r)
                        wsp.link(r.request_id)
                    wsp.set("requests", len(picked))
                    wsp.set("windows", len(windows))
                if not picked:
                    continue
                self._h_window.observe(len(picked))
                self._count_decisions(windows)
                # distinct programs' windows dispatch CONCURRENTLY (they hold
                # independent compiled artifacts); _run_group contains per-window
                # failures so one program's poison never fails another's batch
                await asyncio.gather(
                    *(self._run_group(entry, chunk) for entry, chunk in windows)
                )
            except asyncio.CancelledError:
                self._fail_requests(picked + sched.flush(), INTERNAL, "engine shutting down")
                raise
            except Exception as e:  # noqa: BLE001 — window/scheduling failures must not strand requests
                self._c["worker_failures"].inc()
                self._fail_requests(
                    picked + sched.flush(),
                    INTERNAL,
                    f"worker failure: {type(e).__name__}: {e}",
                )
            finally:
                self._inflight -= len(picked)

    async def _run_group(self, entry: ProgramEntry, chunk: List[ForecastRequest]) -> None:
        """One program's window: any failure terminates exactly this chunk's
        requests and the worker (plus the other programs' windows) survives."""
        try:
            await self._run_batch(entry, chunk)
        except asyncio.CancelledError:
            raise
        except ServingError as e:
            self._fail_requests(chunk, e.code, e.reason)
        except Exception as e:  # noqa: BLE001 — the worker must survive any batch
            self._fail_requests(chunk, INTERNAL, f"{type(e).__name__}: {e}")

    def _count_decisions(
        self, windows: List[Tuple[ProgramEntry, List[ForecastRequest]]]
    ) -> None:
        self._sched_decision("window").inc(len(windows))
        if len(windows) > 1:
            self._sched_decision("concurrent_programs").inc()
        # "reordered" = the policy actually changed an outcome this round: the
        # pickup order differs from arrival order, or a picked request
        # overtook an older one still waiting in the backlog
        seqs = [r.seq for _, chunk in windows for r in chunk]
        oldest = self.scheduler.oldest_waiting()
        if seqs and (seqs != sorted(seqs) or (oldest is not None and max(seqs) > oldest)):
            self._sched_decision("reordered").inc()

    # -- batch execution: segments, deadlines, retry-with-bisect -------------

    async def _run_batch(self, entry: ProgramEntry, requests: List[ForecastRequest]) -> None:
        batch_id = next(self._batch_seq)
        entry.counters["batches"].inc()
        pairs = [(r, dict(r.fields)) for r in requests]
        # ONE batch span links every co-batched request; the scatter/dispatch/
        # gather spans and any retry/bisect events nest inside it
        with self._span(
            "serving.batch",
            trace_ids=[r.request_id for r in requests],
            batch_id=batch_id,
            program=entry.name,
            requests=len(requests),
        ):
            await self._run_span(entry, pairs, 0, None, initial=True, batch_id=batch_id)

    async def _run_span(
        self,
        entry: ProgramEntry,
        pairs: List[Tuple[ForecastRequest, Dict[str, np.ndarray]]],
        t0: int,
        segments: Optional[List[int]],
        *,
        initial: bool,
        batch_id: int,
    ) -> None:
        """Run one scattered membership from absolute step ``t0`` through
        ``segments``.  The initial span covers the whole batch from step 0;
        bisected spans resume half-batches mid-horizon from gathered states."""
        loop = asyncio.get_running_loop()
        pairs = [p for p in pairs if self._still_wanted(p[0])]
        if not pairs:
            return
        reqs = [r for r, _ in pairs]
        if segments is None:
            segments = _segment_plan(reqs)
        k = len(pairs)
        m = entry.pad_to(k)
        ens = entry.ensembles[m]
        if initial:
            entry.counters["live_members"].inc(k)
            entry.counters["padded_members"].inc(m)
            entry.hist["occupancy"].observe(k / m)
        batch_info = {"id": batch_id, "members": m, "requests": k, "occupancy": k / m}

        try:
            with self._span(
                "serving.scatter",
                trace_ids=[r.request_id for r in reqs],
                members=m,
                resumed=not initial,
            ):
                storages = await self._retrying(
                    "scatter",
                    [r.request_id for r in reqs],
                    lambda: entry._batch_storages([s for _, s in pairs], m, full_state=not initial),
                    counters=entry.counters,
                )
        except Exception as e:  # noqa: BLE001 — scatter failure: bisect like a failed dispatch
            await self._bisect_or_fail(entry, pairs, t0, segments, e, batch_id, None)
            return

        args = [storages[n] for n in entry.prog.field_params]
        scalars = _merge_scalars(entry, reqs, m)

        t = t0
        for si, seg in enumerate(segments):
            live = self._mark_expired(pairs)
            if not live:
                return
            try:
                t1 = monotonic()
                with self._span(
                    "serving.dispatch",
                    profile_name=f"serving.dispatch[{entry.name}]",
                    trace_ids=[r.request_id for r, _ in live],
                    batch_id=batch_id,
                    segment=si,
                    steps=seg,
                    members=m,
                    requests=len(live),
                ):
                    # run_in_executor does not propagate contextvars, so pin
                    # the resolved tracer (and the open dispatch span) into a
                    # context snapshot the executor thread runs under — the
                    # ensemble.dispatch/iterate spans then land in the same
                    # tracer, nested under serving.dispatch, instead of the
                    # usually-disabled process default
                    with otrace.use_tracer(self._trace()):
                        run_ctx = contextvars.copy_context()
                    await self._retrying(
                        "dispatch",
                        [r.request_id for r, _ in live],
                        lambda seg=seg: loop.run_in_executor(
                            None, run_ctx.run, lambda: _iterate_and_wait(ens, seg, args, scalars)
                        ),
                        is_async=True,
                        counters=entry.counters,
                    )
                dt = monotonic() - t1
                self.watchdog.record(next(self._dispatch_seq), dt)
                entry.hist["dispatch"].observe(dt)
                entry.counters["dispatches"].inc()
                self._observe_batch_shape(entry, m, seg, dt)
            except Exception as e:  # noqa: BLE001 — dispatch exhausted its retries
                await self._bisect_or_fail(entry, live, t, segments[si:], e, batch_id, storages)
                return
            t += seg
            for i, (r, _) in enumerate(pairs):
                if not self._still_wanted(r):
                    continue
                if t > r.steps or (t % r.stream_every != 0 and t != r.steps):
                    continue
                await self._emit_step(entry, storages, r, i, t, batch_info)
        for r, _ in pairs:
            if not self._still_wanted(r):
                continue
            latency_s = monotonic() - r.submitted_at
            entry.hist["latency"].observe(latency_s)
            self._priority_hist(entry.name, r.priority).observe(latency_s)
            self._tevent(
                "serving.done", trace_ids=(r.request_id,), latency_s=latency_s, steps=r.steps
            )
            done_event = {
                "type": "done",
                "request_id": r.request_id,
                "steps": r.steps,
                "batch": dict(batch_info),
                "latency_s": latency_s,
            }
            if r.queue_wait_s is not None:
                done_event["queue_wait_s"] = r.queue_wait_s
            r.post(done_event)

    def _observe_batch_shape(self, entry: ProgramEntry, m: int, steps: int, dt: float) -> None:
        """Feed the observed (batch size → wall) back into the tune store so
        :func:`tuned_member_counts` — and with it tuned-count padding — learns
        from real traffic.  Gated on improvement: only a new batch size, or a
        ≥2% better per-step wall, rewrites the store (the merge itself is an
        atomic read-merge-write inside :mod:`repro_torch.core.autotune`, so
        concurrent engines don't clobber each other's records)."""
        if steps <= 0 or dt <= 0:
            return
        us_per_step = dt / steps * 1e6
        key = (entry.name, m)
        best = self._batch_best.get(key)
        if best is not None and us_per_step >= best * 0.98:
            return
        self._batch_best[key] = us_per_step if best is None else min(best, us_per_step)
        for obj in getattr(entry.cp, "group_objects", ()):
            try:
                autotune.record_batch_observation(obj.name, obj.fingerprint, m, us_per_step)
            except Exception:  # noqa: BLE001 — tune feedback is never a liveness dependency
                pass

    def _still_wanted(self, r: ForecastRequest) -> bool:
        if r.terminal:
            return False
        if r.abandoned:
            r.entry.counters["abandoned"].inc()
            r.terminal = True  # nobody is listening — seal it so it counts once
            return False
        return True

    def _mark_expired(
        self, pairs: List[Tuple[ForecastRequest, Dict[str, np.ndarray]]]
    ) -> List[Tuple[ForecastRequest, Dict[str, np.ndarray]]]:
        """Deadline enforcement at a segment boundary: expired requests get
        their 504-style error NOW instead of burning another dispatch; the
        still-live members of the batch are returned."""
        now = monotonic()
        live = []
        for r, s in pairs:
            if not self._still_wanted(r):
                continue
            if r.expired(now):
                r.entry.counters["deadline_expired"].inc()
                self._tevent(
                    "serving.deadline",
                    trace_ids=(r.request_id,),
                    force=True,
                    deadline_ms=r.deadline_ms,
                    waited_ms=(now - r.submitted_at) * 1e3,
                )
                self._post_error(
                    r,
                    DEADLINE_EXCEEDED,
                    f"deadline of {r.deadline_ms:.0f} ms expired "
                    f"after {(now - r.submitted_at) * 1e3:.0f} ms",
                )
                continue
            live.append((r, s))
        return live

    async def _retrying(self, site: str, keys: Sequence[str], thunk, *, is_async: bool = False,
                        counters: Optional[Dict[str, obs_metrics.Counter]] = None):
        """Run ``thunk`` under the fault injector's ``site`` check with
        exponential-backoff retries.  The last failure propagates; the caller
        decides between bisect (batches) and a per-request error (gathers).
        ``counters`` is the owning program's labeled set (retries are
        per-program); retry events are force-sampled — a request that hit a
        retry has entered tail-latency territory and its story is kept."""
        attempt = 0
        while True:
            try:
                self.faults.check(site, keys)
                result = thunk()
                return await result if is_async else result
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — injected and real faults retry alike
                attempt += 1
                if attempt >= self.retry_attempts:
                    raise
                if counters is not None:
                    counters["retries"].inc()
                self._tevent(
                    "serving.retry",
                    trace_ids=keys,
                    force=True,
                    site=site,
                    attempt=attempt,
                    error=f"{type(e).__name__}: {e}",
                )
                await asyncio.sleep(self.retry_backoff_s * 2 ** (attempt - 1))

    async def _bisect_or_fail(
        self,
        entry: ProgramEntry,
        pairs: List[Tuple[ForecastRequest, Dict[str, np.ndarray]]],
        t0: int,
        segments: List[int],
        error: Exception,
        batch_id: int,
        storages: Optional[Dict[str, Storage]],
    ) -> None:
        """A span failed past its retries.  Alone → that request errors.
        Together → gather current member states and recurse on each half, so
        a poison request is isolated while its neighbors complete."""
        live = [(i, r, s) for i, (r, s) in enumerate(pairs) if self._still_wanted(r)]
        if not live:
            return
        if len(live) == 1:
            _, r, _ = live[0]
            self._tevent(
                "serving.request_failed",
                trace_ids=(r.request_id,),
                force=True,
                error=f"{type(error).__name__}: {error}",
            )
            self._post_error(
                r,
                INTERNAL,
                f"dispatch failed after {self.retry_attempts} attempts: "
                f"{type(error).__name__}: {error}",
            )
            return
        entry.counters["bisects"].inc()
        self._tevent(
            "serving.bisect",
            trace_ids=[r.request_id for _, r, _ in live],
            force=True,
            requests=len(live),
            resume_step=t0,
            error=f"{type(error).__name__}: {error}",
        )
        if storages is not None:
            # resume from the batch's current (step-t0) states, not the inputs
            resumed = [(r, entry.gather_state(storages, i)) for i, r, _ in live]
        else:
            # scatter itself failed — re-split the states we were handed
            resumed = [(r, s) for _, r, s in live]
        # a half-span is "initial" (request fields only, fresh workspace) iff
        # its states are request-shaped; resumed states carry every batched field
        initial = all(set(s) == set(entry.request_fields) for _, s in resumed)
        half = (len(resumed) + 1) // 2
        for part in (resumed[:half], resumed[half:]):
            if not part:
                continue
            await self._run_span(entry, part, t0, list(segments), initial=initial, batch_id=batch_id)

    async def _emit_step(
        self,
        entry: ProgramEntry,
        storages: Dict[str, Storage],
        r: ForecastRequest,
        i: int,
        t: int,
        batch_info: Dict[str, Any],
    ) -> None:
        """Gather member ``i`` and stream a ``step`` event; a gather that
        fails past its retries errors only this request (the batch and its
        other members keep going)."""
        try:
            with self._span("serving.gather", trace_id=r.request_id, step=t, member=i):
                gathered = await self._retrying(
                    "gather",
                    [r.request_id],
                    lambda: {
                        f: ens_batch.gather_member(storages[f], i) for f in entry.stream_fields
                    },
                    counters=entry.counters,
                )
        except Exception as e:  # noqa: BLE001
            self._post_error(
                r,
                INTERNAL,
                f"gather failed after {self.retry_attempts} attempts: "
                f"{type(e).__name__}: {e}",
            )
            return
        ev: Dict[str, Any] = {
            "type": "step",
            "request_id": r.request_id,
            "step": t,
            "fields": gathered,
            "batch": dict(batch_info),
        }
        # DEGRADED sheds optional work: per-step statistics are dropped first
        if r.want_stats and self.state != DEGRADED:
            ev["stats"] = {f: _field_stats(a) for f, a in gathered.items()}
        r.post(ev)
        entry.counters["steps_streamed"].inc()

    # -- lifecycle / introspection ------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The operational snapshot — a *view* of the metrics registry (every
        counter here is also a Prometheus series on ``GET /metrics``).  Flat
        keys are engine-wide sums across programs (the pre-label contract the
        clients and benches read); ``per_program`` carries the labeled
        breakdown."""
        reg = self.metrics
        out: Dict[str, Any] = {
            key: int(reg.sum_value(fam)) for key, fam, _ in PROGRAM_COUNTERS
        }
        out["errors"] = int(reg.sum_value("serving_errors_total"))
        for k, c in self._c.items():
            out[k] = int(c.value)
        out["programs"] = sorted(self._programs)
        out["per_program"] = {
            name: {
                **{
                    key: int(reg.sum_value(fam, program=name))
                    for key, fam, _ in PROGRAM_COUNTERS
                },
                "errors": int(reg.sum_value("serving_errors_total", program=name)),
            }
            for name in sorted(self._programs)
        }
        out["state"] = self.state
        out["queue_depth"] = self.queue_depth()
        out["inflight"] = self._inflight
        out["scheduler"] = {
            "policy": self.scheduler.name,
            "backlog": self.scheduler.backlog(),
            "priority_classes": self.priority_classes,
            "decisions": {
                labels["decision"]: int(c.value)
                for labels, c in reg.read(
                    "serving_scheduler_decisions_total", scheduler=self.scheduler.name
                )
            },
            "priority_latency_p99_s": reg.quantiles_by(
                "serving_priority_latency_seconds", 0.99, "priority"
            ),
        }
        padded = out["padded_members"]
        out["mean_occupancy"] = out["live_members"] / padded if padded else None
        out["straggler"] = {
            "dispatches": self.watchdog.stats.steps,
            "stragglers": self.watchdog.stats.stragglers,
            "median_s": self.watchdog.stats.median_s,
        }
        if self.slo.objectives:
            out["slo"] = self.slo.status()
        if self.faults.enabled:
            out["faults"] = self.faults.stats()
        return out

    async def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (new submits 503), let the
        worker finish everything queued and in flight, then stop it.  Returns
        True when fully drained, False on timeout (remaining work is failed)."""
        self._draining = True
        deadline = None if timeout_s is None else monotonic() + timeout_s
        while self.queue_depth() or self._inflight:
            if deadline is not None and monotonic() > deadline:
                self._fail_all_queued("engine drain timed out")
                await self.aclose()
                return False
            await asyncio.sleep(0.005)
        await self.aclose()
        return True

    async def aclose(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
            self._worker = None
        self._fail_all_queued("engine closed")

    async def __aenter__(self) -> "ServingEngine":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.aclose()


def _merge_scalars(entry: ProgramEntry, requests: List[ForecastRequest], m: int) -> Dict[str, Any]:
    """Per-request scalar overrides become per-member scalar arrays (length
    ``m``, padded like the fields); a scalar every request agrees on stays
    shared so the common case hits the all-shared kernel specialization."""
    out: Dict[str, Any] = {}
    for name, default in entry.scalars.items():
        vals = [r.scalars.get(name, default) for r in requests]
        if all(v == vals[0] for v in vals[1:]):
            out[name] = vals[0]
        else:
            out[name] = np.asarray(vals + [vals[-1]] * (m - len(vals)), dtype=np.float64)
    return out


def _iterate_and_wait(ens: Ensemble, steps: int, args: List[Storage], scalars: Dict[str, Any]) -> None:
    """One dispatch: ``steps`` member-batched steps, then a wait for the
    stream the fields' launches went to.  Launches return once queued; the
    wait makes the dispatch's wall the card's time, and an asynchronous CUDA
    error is raised here, inside the dispatch's retry, not at a later gather."""
    ens.iterate(steps, *args, **scalars)
    for a in args:
        if isinstance(a, Storage) and a.device is not None and a.device.type == "cuda":
            torch.cuda.current_stream(a.device).synchronize()
            break
