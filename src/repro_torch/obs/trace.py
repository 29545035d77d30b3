"""Structured span tracing with a strict no-op fast path.

One process-wide :class:`Tracer` records nested, wall-clocked spans into a
bounded ring buffer; exporters (``obs.export``) turn the buffer into
Chrome-trace/Perfetto JSON.  Design constraints, in order:

1. **Disabled ≈ free.**  Serving and stencil hot paths call ``span()``
   unconditionally; when tracing is off the call returns one shared
   :data:`NOOP_SPAN` singleton after a single attribute check — no
   allocation, no clock read, no buffer write.  ``tests/test_obs.py``
   asserts both the identity and a generous wall bound on a million
   disabled calls.
2. **One clock.**  :func:`monotonic` is THE time source for every latency,
   deadline, and span timestamp in the serving stack (engine, client,
   watchdog) — mixing ``time.time`` with ``perf_counter`` arithmetic is how
   deadline math silently breaks, so everything imports this one name.
3. **Bounded retention.**  Finished spans land in a ``deque(maxlen=...)``
   ring: a long-running server never grows without bound; exporters drain
   the most recent ``capacity`` spans.
4. **Async-safe nesting.**  The current span is a :mod:`contextvars` var, so
   parent/child links are correct across ``await`` points and threads
   (each asyncio task sees its own span stack).

Trace IDs are *request correlation*, not span identity: a span may carry
many ``trace_ids`` (one batched dispatch serves several requests), and every
span/event that touches a request lists its id — that is what lets one slow
request be followed through admission, the shared batch dispatches it rode,
and any retry/bisect events that hit it.

Enable globally with ``REPRO_TRACE=1`` (capacity via
``REPRO_TRACE_CAPACITY``), programmatically with :func:`configure`, or
locally/temporarily with :class:`capture` (used by the per-call
``exec_info={"trace": True}`` opt-in on stencils and programs).

While a ``torch.profiler`` session records, every :meth:`Tracer.span`
also opens a ``torch.profiler.record_function`` range of the same name, so
the port's spans land in the profile as ``user_annotation`` events on the
device trace's clock, beside the kernels they launch.  That holds whether
the tracer itself is on or off: an off tracer hands out a span that only
the profiler sees, and the ring buffer keeps nothing of it.  With no
profiler recording, the off path stays one flag check and one read of
``torch.autograd.profiler._is_profiler_enabled``.  Opening or closing the
range never fails the wrapped work, and the body's exception propagates
unchanged.

Always-on production tracing rides head-based sampling
(:mod:`repro_torch.obs.sampling`): ``REPRO_TRACE_SAMPLE=0.1`` /
``Tracer(sample_rate=0.1)`` drops spans whose trace ids all hash out, for
one hash check per id — while ``force=True`` events (the engine's
retry/bisect/deadline/error paths) both survive the gate and pin their ids
so the rest of those requests' stories are retained.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

import torch.autograd.profiler as _autograd_profiler

from . import sampling as _sampling

#: the ONE monotonic clock for spans, latencies, and deadlines (satellite:
#: no mixed time.time/perf_counter arithmetic across engine/client/watchdog)
monotonic = time.perf_counter

#: opens a profiler range; a module attribute so a test can break it
_record_function = _autograd_profiler.record_function


def _annotate(name: str):
    """A ``torch.profiler`` range named ``name``, opened, while a profiler
    records; None otherwise, or where opening it fails."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    try:
        rf = _record_function(name)
        rf.__enter__()
        return rf
    except Exception:  # noqa: BLE001 — profiling must never fail the work it labels
        return None


def _close(rf) -> None:
    if rf is not None:
        try:
            rf.__exit__(None, None, None)
        except Exception:  # noqa: BLE001, S110 — closing the label is best-effort
            pass


class Span:
    """One finished-or-open span; also its own context manager."""

    __slots__ = (
        "name",
        "category",
        "span_id",
        "parent_id",
        "trace_ids",
        "start_s",
        "end_s",
        "attrs",
        "events",
        "_tracer",
        "_token",
        "_rf",
        "_label",
    )

    def __init__(self, tracer: "Tracer", name: str, category: str, span_id: int,
                 parent_id: Optional[int], trace_ids: List[str], attrs: Dict[str, Any],
                 label: Optional[str] = None):
        self.name = name
        self.category = category
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_ids = trace_ids
        self.start_s = monotonic()
        self.end_s: Optional[float] = None
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None
        self._rf = None
        self._label = label or name  # the profiler range's name

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        """An instant event inside this span (rendered as an arrow/instant)."""
        self.events.append({"name": name, "ts_s": monotonic(), "attrs": attrs})

    def link(self, trace_id: str) -> None:
        """Correlate one more request/trace id with this span."""
        if trace_id not in self.trace_ids:
            self.trace_ids.append(trace_id)

    def __enter__(self) -> "Span":
        self._token = self._tracer._current.set(self)
        self._rf = _annotate(self._label)
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        _close(self._rf)
        self._rf = None
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        if self._token is not None:
            self._tracer._current.reset(self._token)
            self._token = None
        self._tracer._finish(self)
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "cat": self.category,
            "id": self.span_id,
            "parent": self.parent_id,
            "trace_ids": list(self.trace_ids),
            "start_s": self.start_s,
            "end_s": self.end_s,
            "attrs": dict(self.attrs),
            "events": [dict(e) for e in self.events],
            "tid": threading.get_ident(),
        }


class _NoopSpan:
    """The shared disabled-path span: every method is a constant no-op."""

    __slots__ = ()

    def set(self, key: str, value: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def link(self, trace_id: str) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


#: singleton returned by every span() call while tracing is disabled
NOOP_SPAN = _NoopSpan()


class _ProfiledSpan(_NoopSpan):
    """A disabled tracer's span while a profiler records: the profiler's
    range and nothing else (no clock read, nothing retained)."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "_ProfiledSpan":
        self._rf = _annotate(self.name)
        return self

    def __exit__(self, *exc: Any) -> bool:
        _close(self._rf)
        self._rf = None
        return False


class Tracer:
    """Span recorder: ring-buffered retention, contextvar nesting."""

    def __init__(self, *, enabled: bool = False, capacity: int = 65536,
                 sample_rate: Optional[float] = None, sample_seed: int = 0):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        # None → the REPRO_TRACE_SAMPLE env default (1.0: keep everything)
        if sample_rate is None:
            sample_rate = _sampling.rate_from_env()
        self.sampling = _sampling.SamplingPolicy(sample_rate, seed=sample_seed)
        self._spans: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
            "repro_obs_current_span", default=None
        )
        self._lock = threading.Lock()

    @property
    def sample_rate(self) -> float:
        return self.sampling.rate

    def force_sample(self, *trace_ids: str) -> None:
        """Pin ids as always-sampled (error paths: the tail of a failing
        request's story must survive even when its head hashed out)."""
        self.sampling.force(*trace_ids)

    def keeps(self, trace_ids: Iterable[str]) -> bool:
        """Would a span carrying ``trace_ids`` be retained right now?  One
        hash check per id on the sampled-out path; constant-time at rate 1.0."""
        return self.enabled and self.sampling.sampled(trace_ids)

    # -- recording ----------------------------------------------------------

    def span(self, name: str, *, category: str = "repro",
             trace_id: Optional[str] = None, trace_ids: Iterable[str] = (),
             profile_name: Optional[str] = None, **attrs: Any):
        """Open a span (use as a context manager).  Disabled → NOOP_SPAN, or
        while a profiler records a span only the profiler sees.  Sampling: a
        span whose trace ids ALL hash out (none forced) is NOOP too — id-free
        spans (compiles, windows) are always kept.  ``profile_name`` names
        the profiler's range in place of ``name`` (the span keeps ``name``)."""
        if not self.enabled:
            return _ProfiledSpan(profile_name or name) if _autograd_profiler._is_profiler_enabled else NOOP_SPAN
        ids = [str(t) for t in trace_ids]
        if trace_id is not None and str(trace_id) not in ids:
            ids.insert(0, str(trace_id))
        if ids and not self.sampling.sampled(ids):
            return _ProfiledSpan(profile_name or name) if _autograd_profiler._is_profiler_enabled else NOOP_SPAN
        parent = self._current.get()
        return Span(
            self,
            name,
            category,
            next(self._ids),
            parent.span_id if parent is not None else None,
            ids,
            dict(attrs),
            profile_name,
        )

    def event(self, name: str, *, category: str = "repro",
              trace_ids: Iterable[str] = (), force: bool = False,
              **attrs: Any) -> None:
        """A standalone instant event: attached to the current span when one
        is open, else recorded as a zero-duration entry of its own — so
        retry/bisect/fault markers survive even outside any span.

        ``force=True`` (the engine's error paths) bypasses the sampling gate
        AND pins the event's trace ids as force-sampled, so everything that
        happens to those requests from here on is retained."""
        if not self.enabled:
            return
        trace_ids = [str(t) for t in trace_ids]
        if force and trace_ids:
            self.sampling.force(*trace_ids)
        elif not force and not self.sampling.sampled(trace_ids):
            return
        current = self._current.get()
        if current is not None:
            ids = list(trace_ids)
            for t in ids:
                current.link(t)
            if ids:
                attrs = {**attrs, "trace_ids": ids}
            current.event(name, **attrs)
            return
        now = monotonic()
        self._record(
            {
                "name": name,
                "cat": category,
                "id": next(self._ids),
                "parent": None,
                "trace_ids": [str(t) for t in trace_ids],
                "start_s": now,
                "end_s": now,
                "attrs": dict(attrs),
                "events": [],
                "tid": threading.get_ident(),
                "instant": True,
            }
        )

    def add_span(self, name: str, start_s: float, end_s: float, *,
                 category: str = "repro", trace_ids: Iterable[str] = (),
                 force: bool = False, **attrs: Any) -> None:
        """Record a retroactive span from explicit timestamps (e.g. queue
        wait, measured between two points that no context manager brackets).
        ``force=True`` bypasses sampling and pins the ids, like
        :meth:`event`."""
        if not self.enabled:
            return
        trace_ids = [str(t) for t in trace_ids]
        if force and trace_ids:
            self.sampling.force(*trace_ids)
        elif trace_ids and not force and not self.sampling.sampled(trace_ids):
            return
        self._record(
            {
                "name": name,
                "cat": category,
                "id": next(self._ids),
                "parent": None,
                "trace_ids": [str(t) for t in trace_ids],
                "start_s": float(start_s),
                "end_s": float(end_s),
                "attrs": dict(attrs),
                "events": [],
                "tid": threading.get_ident(),
            }
        )

    def _record(self, entry: Dict[str, Any]) -> None:
        """Every retained-buffer write lands here, under the same lock that
        snapshot()/clear() take — recording happens from loop and executor
        threads alike, and the discipline must not silently rely on deque
        append atomicity."""
        with self._lock:
            self._spans.append(entry)

    def _finish(self, span: Span) -> None:
        span.end_s = monotonic()
        self._record(span.to_dict())

    # -- inspection ---------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """The finished spans currently retained (oldest first)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        return len(self._spans)


# ---------------------------------------------------------------------------
# process default + contextvar override (capture)
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TRACE", "") not in ("", "0")


_default = Tracer(
    enabled=_env_enabled(),
    capacity=int(os.environ.get("REPRO_TRACE_CAPACITY", "65536")),
)

_local: contextvars.ContextVar[Optional[Tracer]] = contextvars.ContextVar(
    "repro_obs_local_tracer", default=None
)


def get_tracer() -> Tracer:
    """The process-default tracer (ignores any :class:`capture` override)."""
    return _default


def current_tracer() -> Tracer:
    """The tracer module-level ``span()``/``event()`` route to: a
    :class:`capture` override in this context, else the process default."""
    local = _local.get()
    return local if local is not None else _default


def configure(*, enabled: Optional[bool] = None, capacity: Optional[int] = None,
              sample_rate: Optional[float] = None) -> Tracer:
    """Reconfigure the process-default tracer; returns it."""
    global _default
    if capacity is not None and capacity != _default.capacity:
        _default = Tracer(
            enabled=_default.enabled,
            capacity=capacity,
            sample_rate=_default.sample_rate,
        )
    if enabled is not None:
        _default.enabled = bool(enabled)
    if sample_rate is not None:
        _default.sampling = _sampling.SamplingPolicy(
            sample_rate, seed=_default.sampling.seed
        )
    return _default


def enabled() -> bool:
    return current_tracer().enabled


def span(name: str, **kwargs: Any):
    return current_tracer().span(name, **kwargs)


def event(name: str, **kwargs: Any) -> None:
    current_tracer().event(name, **kwargs)


class use_tracer:
    """Route this context's module-level :func:`span`/:func:`event` calls to
    an *existing* tracer (contrast :class:`capture`, which makes a fresh one).

    The serving engine uses this to pin its resolved tracer before snapshotting
    a :mod:`contextvars` context for an executor thread —
    ``loop.run_in_executor`` does not propagate contextvars, so without the
    pin the instrumented code running in the executor (e.g.
    ``ensemble.dispatch``/``ensemble.iterate`` spans) would silently land in
    the process-default tracer instead of the engine's or a capture()'s::

        with trace.use_tracer(tracer):
            ctx = contextvars.copy_context()
        await loop.run_in_executor(None, ctx.run, work)
    """

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Tracer:
        self._token = _local.set(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        if self._token is not None:
            _local.reset(self._token)
            self._token = None
        return False


class capture:
    """Temporarily route this context's spans into a fresh enabled tracer.

    Powers the per-call trace opt-in (``exec_info={"trace": True}``): the
    instrumented code keeps calling module-level :func:`span`, and for the
    duration of the ``with`` block (in this task/thread only) those spans
    land in ``capture.tracer`` instead of the process default::

        with trace.capture() as t:
            stencil(...)
        chrome = export.chrome_trace(t.snapshot())
    """

    def __init__(self, capacity: int = 16384, sample_rate: float = 1.0):
        # a deliberate per-call capture defaults to keeping everything —
        # the env sampling knob governs the always-on process tracer only
        self.tracer = Tracer(enabled=True, capacity=capacity, sample_rate=sample_rate)
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Tracer:
        self._token = _local.set(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        if self._token is not None:
            _local.reset(self._token)
            self._token = None
        return False


# ---------------------------------------------------------------------------
# device probe: spans timed on the device, and counts made there
# ---------------------------------------------------------------------------


class DeviceProbe:
    """Device time of named spans and counts the code adds, while armed
    (:func:`arm_probe`, :func:`probing`); nothing is recorded, and nothing
    synchronises, while no probe is armed.  It is the port's one span timer:
    the LM's spans, the distributed step's (``rank_timings``) and a profiled
    program call's groups (``node_timings``) are all read from it.

    On the card each :meth:`span` records a CUDA event at its bounds on the
    current stream (read once, by :meth:`result`), elsewhere the host clock.
    The events are external ones, so that a probe armed while a CUDA graph
    is captured puts them into the graph: each replay then records them
    anew, and :meth:`result` after a replay reads that replay.
    :meth:`add` sums a count: a Python number, or a device tensor that stays
    on the device until :meth:`result` reads it, so counting never waits for
    the device.  A span is also the tracer's :func:`span` of the same name
    (a ``torch.profiler`` range while a profiler records)."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.card = torch.device(device).type == "cuda"
        self.intervals: Dict[str, List[Any]] = {}
        self.counts: Dict[str, Any] = {}

    def _mark(self):
        if not self.card:
            return monotonic()
        ev = self._torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def span(self, name: str, **attrs: Any):
        return _ProbeSpan(self, name, attrs)

    def add(self, name: str, value: Any) -> None:
        self.counts[name] = self.counts[name] + value if name in self.counts else value

    def result(self) -> Dict[str, Any]:
        """``seconds``, ``calls`` and ``durations`` (each call's seconds, in
        call order) by span name, and ``counts`` (a list for a tensor count,
        else a number); synchronises once."""
        if self.card:
            self._torch.cuda.synchronize()

        def seconds(a, b):
            return a.elapsed_time(b) / 1e3 if self.card else b - a

        def plain(v):
            return v.tolist() if isinstance(v, self._torch.Tensor) else v

        durations = {n: [seconds(a, b) for a, b in iv] for n, iv in self.intervals.items()}
        return {"clock": "cuda_events" if self.card else "host",
                "seconds": {n: sum(d) for n, d in durations.items()},
                "calls": {n: len(d) for n, d in durations.items()},
                "durations": durations,
                "counts": {n: plain(v) for n, v in self.counts.items()}}


class _ProbeSpan:
    __slots__ = ("probe", "name", "attrs", "_span", "_start")

    def __init__(self, probe: DeviceProbe, name: str, attrs: Dict[str, Any]):
        self.probe, self.name, self.attrs = probe, name, attrs

    def __enter__(self) -> "_ProbeSpan":
        self._span = span(self.name, **self.attrs)
        self._span.__enter__()
        self._start = self.probe._mark()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.probe.intervals.setdefault(self.name, []).append((self._start, self.probe._mark()))
        self._span.__exit__(*exc)
        return False


_probe: Optional[DeviceProbe] = None


def arm_probe(device) -> DeviceProbe:
    """Arm a fresh process-wide :class:`DeviceProbe` on ``device``; returns it."""
    global _probe
    _probe = DeviceProbe(device)
    return _probe


def disarm_probe() -> Optional[DeviceProbe]:
    """Disarm the probe; returns it (None where none was armed)."""
    global _probe
    p, _probe = _probe, None
    return p


@contextmanager
def probing(device):
    """Arm a fresh :class:`DeviceProbe` on ``device`` inside (yields it); on
    exit re-arm whatever probe was armed before, so probings nest."""
    global _probe
    outer, _probe = _probe, DeviceProbe(device)
    try:
        yield _probe
    finally:
        _probe = outer


def probe() -> Optional[DeviceProbe]:
    """The armed probe, or None."""
    return _probe


def device_span(name: str, **attrs: Any):
    """:func:`span` of ``name`` (with ``attrs``), also timed on the device
    while a probe is armed."""
    p = _probe
    return span(name, **attrs) if p is None else p.span(name, **attrs)


# ---------------------------------------------------------------------------
# taps: tensors the model names on its way, handed to a sink while one is set
# ---------------------------------------------------------------------------


_sink = None


class tapping:
    """While inside, each :func:`tap` hands its name and tensor to
    ``sink(name, tensor)`` (a check keeping some rows of the model's
    intermediate values, on the device, for a reference to start from).
    Outside, :func:`tap` is one read of a module global."""

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self) -> "tapping":
        global _sink
        self._old, _sink = _sink, self.sink
        return self

    def __exit__(self, *exc: Any) -> bool:
        global _sink
        _sink = self._old
        return False


def tap(name: str, tensor: Any) -> None:
    """Hand ``tensor`` to the sink of the innermost :class:`tapping`, if any."""
    if _sink is not None:
        _sink(name, tensor)
