"""Exporters: span buffer → Chrome-trace/Perfetto JSON, optional torch.profiler labels.

The span dicts produced by :mod:`repro_torch.obs.trace` convert to the Chrome
Trace Event format (the JSON flavor Perfetto, ``chrome://tracing`` and
``ui.perfetto.dev`` all load):

* a finished span → one complete event (``"ph": "X"``) with microsecond
  ``ts``/``dur``, its attributes and trace ids under ``args``;
* an in-span event → one instant event (``"ph": "i"``, thread-scoped);
* per-request correlation rides ``args.trace_ids`` on every event, so
  filtering a request id in the Perfetto query bar surfaces its admission,
  every batched dispatch it shared, and the retry/bisect instants that hit
  it.

:func:`validate_chrome_trace` is the schema contract the tests and the CI
extras leg assert against; ``python -m repro_torch.obs.export TRACE.json``
validates a captured file from the command line and prints a span census.

:func:`torch_profiler_span` is the opt-in bridge to ``torch.profiler``: it
opens a ``record_function`` range so serving dispatches show up inside a
torch profile beside the card's kernels; on any profiler error it is a
no-op — telemetry must never take the dispatch down.  (The reference
package's ``repro/obs/export.py``, whose bridge is ``jax.profiler``.)
"""

from __future__ import annotations

import json
import os
import sys
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

from . import trace as trace_mod

#: event phases this exporter emits (and the validator accepts)
_PHASES = {"X", "i", "M"}


def chrome_trace(spans: Sequence[Dict[str, Any]],
                 *, process_name: str = "repro_torch",
                 metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Span dicts (``Tracer.snapshot()``) → a Chrome-trace JSON object."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    for sp in spans:
        start = float(sp["start_s"])
        end = float(sp["end_s"] if sp.get("end_s") is not None else start)
        tid = int(sp.get("tid", 0))
        args = dict(sp.get("attrs", {}))
        if sp.get("trace_ids"):
            args["trace_ids"] = list(sp["trace_ids"])
        args["span_id"] = sp.get("id")
        if sp.get("parent") is not None:
            args["parent_span_id"] = sp["parent"]
        if sp.get("instant"):
            events.append(
                {
                    "name": sp["name"],
                    "cat": sp.get("cat", "repro_torch"),
                    "ph": "i",
                    "s": "t",
                    "ts": start * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        else:
            events.append(
                {
                    "name": sp["name"],
                    "cat": sp.get("cat", "repro_torch"),
                    "ph": "X",
                    "ts": start * 1e6,
                    "dur": max(0.0, (end - start) * 1e6),
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        for ev in sp.get("events", ()):
            events.append(
                {
                    "name": ev["name"],
                    "cat": sp.get("cat", "repro_torch"),
                    "ph": "i",
                    "s": "t",
                    "ts": float(ev["ts_s"]) * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": {**dict(ev.get("attrs", {})), "span_id": sp.get("id")},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": dict(metadata or {}),
    }


def write_chrome_trace(path, spans: Optional[Sequence[Dict[str, Any]]] = None,
                       *, tracer: Optional[trace_mod.Tracer] = None,
                       metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Dump spans (default: the process tracer's buffer) to ``path``."""
    if spans is None:
        spans = (tracer or trace_mod.get_tracer()).snapshot()
    data = chrome_trace(spans, metadata=metadata)
    Path(path).write_text(json.dumps(data) + "\n")
    return data


def validate_chrome_trace(data: Any) -> List[Dict[str, Any]]:
    """Assert ``data`` is a loadable Chrome-trace object; returns its events.

    Raises ``ValueError`` naming the first offending event — this is the
    schema contract the telemetry tests and the CI trace-capture step check.
    """
    if not isinstance(data, dict) or not isinstance(data.get("traceEvents"), list):
        raise ValueError("chrome trace must be an object with a 'traceEvents' list")
    for i, ev in enumerate(data["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"traceEvents[{i}] has unknown phase {ev['ph']!r}")
        if ev["ph"] != "M" and not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] missing numeric 'ts'")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}] complete event missing numeric 'dur'")
    return data["traceEvents"]


def request_events(data: Dict[str, Any], trace_id: str) -> List[Dict[str, Any]]:
    """Every event correlated with ``trace_id`` (via ``args.trace_ids`` or a
    direct ``request_id`` attribute) — the per-request view of a trace."""
    out = []
    for ev in data.get("traceEvents", ()):
        args = ev.get("args", {})
        if trace_id in args.get("trace_ids", ()) or args.get("request_id") == trace_id:
            out.append(ev)
    return out


# ---------------------------------------------------------------------------
# torch.profiler bridge (opt-in)
# ---------------------------------------------------------------------------

_record_function = None
_probe_lock = threading.Lock()
_probed = False


def torch_profiler_available() -> bool:
    """True when ``torch.profiler.record_function`` can be opened."""
    global _record_function, _probed
    if not _probed:
        with _probe_lock:
            if not _probed:
                try:
                    from torch.profiler import record_function as _rf  # noqa: PLC0415

                    _record_function = _rf
                except Exception:  # noqa: BLE001 — no profiler hook
                    _record_function = None
                _probed = True
    return _record_function is not None


@contextmanager
def torch_profiler_span(name: str):
    """Label the enclosed work in a ``torch.profiler`` trace
    (``record_function``), so serving dispatches show up beside the card's
    kernels in a profile; outside a profiling session the label costs one
    host-side range.

    Only the *annotation* is guarded: an exception raised by the wrapped
    block must propagate with its original type/message (retry-with-bisect
    keys off it), so the body is never re-yielded from an ``except`` branch —
    that would turn every dispatch failure into contextlib's
    ``RuntimeError("generator didn't stop after throw()")``.
    """
    ctx = None
    if torch_profiler_available():
        try:
            ctx = _record_function(name)
            ctx.__enter__()
        except Exception:  # noqa: BLE001 — profiling must never fail the dispatch
            ctx = None
    try:
        yield
    finally:
        if ctx is not None:
            try:
                ctx.__exit__(None, None, None)
            except Exception:  # noqa: BLE001, S110 — annotation teardown is best-effort
                pass


def _census(events: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") == "M":
            continue
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.obs.export [--census-json] TRACE.json`` — validate
    and summarize a captured dump.

    The exit code is the contract: 0 only for a readable, schema-valid trace;
    1 with a one-line reason on stderr for anything unreadable or invalid —
    in EVERY mode, so the CI trace-validation leg can never silently pass on
    a missing or truncated dump.  ``--census-json`` prints the span census as
    one machine-readable JSON line (what the CI sampled-vs-unsampled
    comparison diffs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    census_json = "--census-json" in argv
    argv = [a for a in argv if a != "--census-json"]
    if len(argv) != 1 or argv[0].startswith("-"):
        print("usage: python -m repro_torch.obs.export [--census-json] TRACE.json", file=sys.stderr)
        return 2
    path = Path(argv[0])
    try:
        events = validate_chrome_trace(json.loads(path.read_text()))
    except (OSError, ValueError) as e:
        print(f"INVALID trace {path}: {e}", file=sys.stderr)
        return 1
    census = _census(events)
    if census_json:
        print(json.dumps(
            {"path": str(path), "events": sum(census.values()), "names": census},
            sort_keys=True,
        ))
        return 0
    print(f"OK: {path} holds {len(events)} events, {len(census)} distinct names")
    for name in sorted(census):
        print(f"  {census[name]:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
