"""Metrics registry: counters, gauges, streaming-quantile histograms.

Zero-dependency (stdlib only) and Prometheus-text exportable — the serving
engine keeps every operational counter here (``engine.stats()`` is a *view*
of this registry), and the transport serves :func:`MetricsRegistry.to_prometheus`
on ``GET /metrics``.

Three instrument kinds:

* :class:`Counter` — monotonically increasing (requests, retries, bisects).
* :class:`Gauge` — a point-in-time level; either set explicitly or backed by
  a zero-argument callable evaluated at read time (queue depth, health
  state), so scrapes always see the live value without anyone having to
  remember to update it.
* :class:`Histogram` — streaming quantiles over a bounded window of recent
  observations (dispatch walls, request latency, batch occupancy) plus
  all-time ``count``/``sum``.  Exported as a Prometheus ``summary``
  (``{quantile="0.5"}`` samples + ``_sum``/``_count``); windowed nearest-rank
  quantiles are deterministic and allocation-bounded, which matters more
  here than sketch-grade accuracy.

Metric *families* are keyed by name; each family holds children keyed by
label values, created on first touch::

    reg = MetricsRegistry()
    reg.counter("serving_rejected_total", "requests rejected", reason="overloaded").inc()
    print(reg.to_prometheus())

Thread-safety: instrument updates take the registry lock (they happen on
the asyncio loop and executor threads alike); reads take it too so an
export never sees a half-updated histogram window.  The lock is reentrant:
:meth:`MetricsRegistry.to_prometheus` and :meth:`MetricsRegistry.collect`
hold it across the whole walk (a scrape concurrent with first-touch child
creation must not see the family dicts mid-mutation) while the per-child
reads they call take it again.
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: quantiles exported for every histogram (summary-style)
QUANTILES = (0.5, 0.9, 0.99)


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(float(value))


class Counter:
    """Monotonic counter (one labeled child of a counter family)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable level, or a live read-through when built with ``fn``."""

    def __init__(self, lock: threading.RLock, fn: Optional[Callable[[], float]] = None):
        self._lock = lock
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never take the server down
                return float("nan")
        return self._value


class Histogram:
    """All-time count/sum + nearest-rank quantiles over a recent window."""

    def __init__(self, lock: threading.RLock, window: int = 512):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self._window: "deque[float]" = deque(maxlen=int(window))

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self._window.append(value)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile of the retained window; NaN when empty."""
        with self._lock:
            if not self._window:
                return float("nan")
            ordered = sorted(self._window)
            rank = max(1, math.ceil(q * len(ordered)))
            return ordered[min(rank, len(ordered)) - 1]

    def summary(self) -> Dict[str, float]:
        with self._lock:  # count/sum/quantiles from ONE consistent snapshot
            out: Dict[str, float] = {"count": float(self.count), "sum": self.sum}
            # a never-observed histogram has NO quantiles, not NaN ones —
            # the keys are omitted so /stats JSON consumers don't choke
            if self._window:
                for q in QUANTILES:
                    out[f"p{int(q * 100)}"] = self.quantile(q)
            return out


class _Family:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind  # "counter" | "gauge" | "summary"
        self.children: Dict[Tuple[Tuple[str, str], ...], Any] = {}


class MetricsRegistry:
    """Named metric families with labeled children; Prometheus-exportable."""

    def __init__(self):
        # reentrant: exports hold it across the family walk while the
        # per-child value/quantile reads take it again
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, help_text: str, kind: str) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, help_text, kind)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as a {fam.kind}")
        return fam

    @staticmethod
    def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _child(self, name: str, help_text: str, kind: str, labels: Dict[str, str], build):
        with self._lock:
            fam = self._family(name, help_text, kind)
            key = self._label_key(labels)
            child = fam.children.get(key)
            if child is None:
                child = build()
                fam.children[key] = child
            return child

    def counter(self, name: str, help_text: str = "", **labels: str) -> Counter:
        return self._child(name, help_text, "counter", labels, lambda: Counter(self._lock))

    def gauge(self, name: str, help_text: str = "",
              fn: Optional[Callable[[], float]] = None, **labels: str) -> Gauge:
        gauge = self._child(name, help_text, "gauge", labels, lambda: Gauge(self._lock, fn))
        if fn is not None:
            gauge._fn = fn  # re-registration refreshes a stale callback
        return gauge

    def histogram(self, name: str, help_text: str = "", window: int = 512,
                  **labels: str) -> Histogram:
        return self._child(name, help_text, "summary", labels,
                           lambda: Histogram(self._lock, window=window))

    # -- reads (the SLO engine and autoscaler sit on these) ------------------

    def read(self, name: str, **labels: str) -> List[Tuple[Dict[str, str], Any]]:
        """Children of family ``name`` whose labels include every given
        ``labels`` pair (subset match, so ``program="x"`` finds children that
        also carry a ``code`` label); ``[]`` for an unknown family."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            want = {(k, str(v)) for k, v in labels.items()}
            return [
                (dict(key), child)
                for key, child in fam.children.items()
                if want <= set(key)
            ]

    def sum_value(self, name: str, **labels: str) -> float:
        """Sum of matching counter/gauge children (0.0 when none match) —
        how a per-program family with extra label dimensions rolls up."""
        return sum(
            child.value
            for _, child in self.read(name, **labels)
            if not isinstance(child, Histogram)
        )

    def quantile(self, name: str, q: float, **labels: str) -> Optional[float]:
        """The worst (max) ``q``-quantile across matching histogram children,
        or None when nothing has been observed yet."""
        vals = [
            child.quantile(q)
            for _, child in self.read(name, **labels)
            if isinstance(child, Histogram) and child.count
        ]
        vals = [v for v in vals if not math.isnan(v)]
        return max(vals) if vals else None

    def quantiles_by(self, name: str, q: float, label: str, **labels: str) -> Dict[str, float]:
        """The ``q``-quantile per value of ``label`` across matching histogram
        children (max within each group, same roll-up as :meth:`quantile`) —
        e.g. p99 request latency keyed by priority class."""
        groups: Dict[str, List[float]] = {}
        for child_labels, child in self.read(name, **labels):
            if not isinstance(child, Histogram) or not child.count or label not in child_labels:
                continue
            v = child.quantile(q)
            if math.isnan(v):
                continue
            groups.setdefault(child_labels[label], []).append(v)
        return {k: max(vs) for k, vs in sorted(groups.items())}

    # -- export -------------------------------------------------------------

    @staticmethod
    def _sample(name: str, labels: Sequence[Tuple[str, str]], value: float) -> str:
        if labels:
            body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
            return f"{name}{{{body}}} {_fmt(value)}"
        return f"{name} {_fmt(value)}"

    def to_prometheus(self) -> str:
        """The Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        with self._lock:  # a scrape must not race first-touch child creation
            for name in sorted(self._families):
                fam = self._families[name]
                lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, child in sorted(fam.children.items()):
                    labels = list(key)
                    if isinstance(child, Histogram):
                        # Prometheus-idiomatic empty summary: _sum/_count at
                        # zero, no quantile samples (never NaN — scrapers and
                        # the text-format parser both reject it)
                        if child._window:
                            for q in QUANTILES:
                                lines.append(
                                    self._sample(
                                        name, labels + [("quantile", str(q))], child.quantile(q)
                                    )
                                )
                        lines.append(self._sample(f"{name}_sum", labels, child.sum))
                        lines.append(self._sample(f"{name}_count", labels, child.count))
                    else:
                        lines.append(self._sample(name, labels, child.value))
        return "\n".join(lines) + "\n"

    def collect(self) -> Dict[str, Any]:
        """A JSON-friendly dump (what enriches ``/stats``): counters and
        gauges as numbers, histograms as their quantile summaries."""
        out: Dict[str, Any] = {}
        with self._lock:  # same discipline as to_prometheus()
            for name, fam in sorted(self._families.items()):
                entries: Dict[str, Any] = {}
                for key, child in sorted(fam.children.items()):
                    label = ",".join(f"{k}={v}" for k, v in key) or ""
                    value = child.summary() if isinstance(child, Histogram) else child.value
                    entries[label] = value
                out[name] = entries[""] if list(entries) == [""] else entries
        return out


#: process-default registry (the serving engine builds its own by default so
#: tests stay isolated; CLI/process-wide consumers can share this one)
default_registry = MetricsRegistry()
