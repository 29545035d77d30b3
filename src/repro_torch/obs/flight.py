"""Failure flight recorder: a self-contained JSON black box per incident.

When something goes wrong in a serving process — a worker death, a
crash-loop give-up, an SLO breach, or an operator poking SIGUSR2 — the
question is always the same: *what was happening just before?*  The flight
recorder answers it with one JSON bundle written at the moment of failure,
holding everything the process knows:

* ``spans``   — the most recent slice of the tracer's span ring (the black
  box's "cockpit voice recorder": admissions, batch dispatches, retries,
  bisects, deadline events — error paths are force-sampled, so the story of
  the request that killed the worker is in here even under heavy sampling);
* ``metrics`` — the full :class:`~repro_torch.obs.metrics.MetricsRegistry` dump
  (per-program counters, burn-rate gauges, latency summaries);
* ``stats``   — the owner's stats snapshot (engine counters, health state,
  fault-injector tallies — whatever callable was bound);
* ``slo``     — the last-evaluated breach state, when an SLO engine is bound;
* ``config`` / ``versions`` — what was deployed, on what stack.

Bundles are written atomically (tmp + rename), pruned to ``max_bundles``,
and **dumping never raises** — a diagnostic must not be the second failure.
Arm with ``REPRO_FLIGHT_DIR=/path`` (the serving engine and the supervisor
both check it) or construct/bind explicitly.

Inspect from the command line::

    python -m repro_torch.obs.flight BUNDLE.json              # validate + summary
    python -m repro_torch.obs.flight BUNDLE.json --request ID # one request's story
    python -m repro_torch.obs.flight A.json --diff B.json     # what changed

Exit codes: 0 valid, 1 unreadable/invalid (one-line reason on stderr),
2 usage — same contract as ``python -m repro_torch.obs.export``.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from . import export as obs_export
from . import metrics as obs_metrics
from .trace import Tracer, monotonic

#: bundle schema tag; bump on breaking layout changes
SCHEMA = "repro_torch.obs.flight/1"

#: keys every bundle must carry to validate
_REQUIRED = ("schema", "reason", "wall_time", "monotonic_s", "pid",
             "versions", "spans", "metrics", "stats")

_TracerSource = Union[Tracer, Callable[[], Tracer], None]


def _versions() -> Dict[str, Any]:
    """The software and the card the bundle was written under: the torch
    build, the CUDA version it was built for, and the first card's name
    (``None`` on a host without one)."""
    import numpy as np

    import repro_torch

    out: Dict[str, Any] = {
        "python": platform.python_version(),
        "numpy": np.__version__,
        "repro_torch": getattr(repro_torch, "__version__", "0"),
        "torch": None,
        "cuda": None,
        "device": None,
    }
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            out["device"] = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001, S110 — a bundle is written whatever the device state
        pass
    return out


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion so a dump never dies on a numpy scalar or an
    exotic attr value sitting in a span."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        pass
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):  # numpy scalars
        try:
            return obj.item()
        except Exception:  # noqa: BLE001
            pass
    return repr(obj)


class FlightRecorder:
    """Bind telemetry sources once; :meth:`dump` writes one bundle per call."""

    def __init__(
        self,
        out_dir: Union[str, Path],
        *,
        tracer: _TracerSource = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        stats: Optional[Callable[[], Dict[str, Any]]] = None,
        slo: Any = None,
        config: Optional[Dict[str, Any]] = None,
        max_spans: int = 4096,
        max_bundles: int = 16,
    ):
        self.out_dir = Path(out_dir)
        self.max_spans = int(max_spans)
        self.max_bundles = int(max_bundles)
        self._tracer = tracer
        self._metrics = metrics
        self._stats = stats
        self._slo = slo
        self.config: Dict[str, Any] = dict(config or {})
        self._seq = 0
        self.last_bundle: Optional[Path] = None

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None, **kwargs: Any) -> Optional["FlightRecorder"]:
        """A recorder targeting ``$REPRO_FLIGHT_DIR``, or None when unset —
        the same arming pattern as the fault injector's ``from_env``."""
        env = os.environ if env is None else env
        out_dir = env.get("REPRO_FLIGHT_DIR", "")
        if not out_dir:
            return None
        return cls(out_dir, **kwargs)

    def bind(
        self,
        *,
        tracer: _TracerSource = None,
        metrics: Optional[obs_metrics.MetricsRegistry] = None,
        stats: Optional[Callable[[], Dict[str, Any]]] = None,
        slo: Any = None,
        config: Optional[Dict[str, Any]] = None,
    ) -> "FlightRecorder":
        """Attach (or replace) telemetry sources after construction — the
        engine binds itself onto a recorder the CLI armed from the env."""
        if tracer is not None:
            self._tracer = tracer
        if metrics is not None:
            self._metrics = metrics
        if stats is not None:
            self._stats = stats
        if slo is not None:
            self._slo = slo
        if config is not None:
            self.config.update(config)
        return self

    # -- snapshotting --------------------------------------------------------

    def _resolve_tracer(self) -> Optional[Tracer]:
        t = self._tracer
        return t() if callable(t) else t

    def _section(self, fn: Callable[[], Any]) -> Any:
        """One guarded section: a failing source becomes an error note, not a
        failed dump."""
        try:
            return _jsonable(fn())
        except Exception as e:  # noqa: BLE001 — diagnostics must not cascade
            return {"error": f"{type(e).__name__}: {e}"}

    def snapshot(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The bundle as a dict (every section individually guarded)."""
        self._seq += 1
        tracer = None
        try:
            tracer = self._resolve_tracer()
        except Exception:  # noqa: BLE001, S110
            pass
        spans: List[Dict[str, Any]] = []
        if tracer is not None:
            spans = self._section(tracer.snapshot)
            if isinstance(spans, list) and len(spans) > self.max_spans:
                spans = spans[-self.max_spans :]
        bundle: Dict[str, Any] = {
            "schema": SCHEMA,
            "reason": str(reason),
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "monotonic_s": monotonic(),
            "pid": os.getpid(),
            "sequence": self._seq,
            "argv": list(sys.argv),
            "versions": self._section(_versions),
            "config": self._section(lambda: dict(self.config)),
            "spans": spans if isinstance(spans, list) else [],
            "metrics": self._section(self._metrics.collect) if self._metrics is not None else {},
            "stats": self._section(self._stats) if self._stats is not None else {},
            "slo": self._section(self._slo.status) if self._slo is not None else None,
            "extra": self._section(lambda: dict(extra or {})),
        }
        return bundle

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None) -> Optional[Path]:
        """Write one bundle; returns its path, or None when writing failed
        (a flight recorder must never be the second failure)."""
        try:
            bundle = self.snapshot(reason, extra)
            self.out_dir.mkdir(parents=True, exist_ok=True)
            slug = "".join(c if c.isalnum() else "-" for c in str(reason))[:48].strip("-")
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            path = self.out_dir / f"flight-{stamp}-p{os.getpid()}-{bundle['sequence']:03d}-{slug}.json"
            tmp = path.with_suffix(".tmp")
            tmp.write_text(json.dumps(bundle) + "\n")
            tmp.rename(path)
            self.last_bundle = path
            self._prune()
            return path
        except Exception:  # noqa: BLE001 — never raise out of a failure path
            return None

    def _prune(self) -> None:
        bundles = sorted(self.out_dir.glob("flight-*.json"))
        for old in bundles[: max(0, len(bundles) - self.max_bundles)]:
            try:
                old.unlink()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# validation / inspection
# ---------------------------------------------------------------------------


def validate_flight_bundle(data: Any) -> Dict[str, Any]:
    """Assert ``data`` is a well-formed bundle; returns it.  Raises
    ``ValueError`` naming the first offence — the schema contract the chaos
    CI leg and the supervise tests assert against."""
    if not isinstance(data, dict):
        raise ValueError("flight bundle must be a JSON object")
    if data.get("schema") != SCHEMA:
        raise ValueError(f"unknown flight schema {data.get('schema')!r} (want {SCHEMA!r})")
    for key in _REQUIRED:
        if key not in data:
            raise ValueError(f"flight bundle missing {key!r}")
    if not isinstance(data["spans"], list):
        raise ValueError("flight bundle 'spans' must be a list")
    for i, sp in enumerate(data["spans"]):
        if not isinstance(sp, dict) or "name" not in sp:
            raise ValueError(f"spans[{i}] is not a span dict")
    if not isinstance(data["metrics"], dict):
        raise ValueError("flight bundle 'metrics' must be an object")
    if not isinstance(data["stats"], dict):
        raise ValueError("flight bundle 'stats' must be an object")
    return data


def load_bundle(path: Union[str, Path]) -> Dict[str, Any]:
    """Read + validate one bundle file (OSError/ValueError propagate)."""
    return validate_flight_bundle(json.loads(Path(path).read_text()))


def span_census(bundle: Dict[str, Any]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for sp in bundle.get("spans", ()):
        counts[sp["name"]] = counts.get(sp["name"], 0) + 1
    return counts


def request_story(bundle: Dict[str, Any], request_id: str) -> List[Dict[str, Any]]:
    """Every trace event correlated with one request id, in time order —
    the "what happened to req X" view of a bundle."""
    data = obs_export.chrome_trace(bundle.get("spans", ()))
    events = obs_export.request_events(data, request_id)
    return sorted(events, key=lambda ev: ev.get("ts", 0.0))


def _flatten(prefix: str, obj: Any, out: Dict[str, Any]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)


def diff_bundles(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Numeric metric/stat deltas and the span-census delta, a → b."""
    out: Dict[str, Any] = {"metrics": {}, "stats": {}, "spans": {}}
    for section in ("metrics", "stats"):
        fa: Dict[str, Any] = {}
        fb: Dict[str, Any] = {}
        _flatten("", a.get(section, {}), fa)
        _flatten("", b.get(section, {}), fb)
        for key in sorted(set(fa) | set(fb)):
            va, vb = fa.get(key, 0.0), fb.get(key, 0.0)
            if va != vb:
                out[section][key] = {"a": va, "b": vb, "delta": vb - va}
    ca, cb = span_census(a), span_census(b)
    for name in sorted(set(ca) | set(cb)):
        if ca.get(name, 0) != cb.get(name, 0):
            out["spans"][name] = {"a": ca.get(name, 0), "b": cb.get(name, 0)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.obs.flight BUNDLE.json [--diff OTHER] [--request ID]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = "usage: python -m repro_torch.obs.flight BUNDLE.json [--diff OTHER.json] [--request ID]"
    paths: List[str] = []
    diff_path: Optional[str] = None
    request_id: Optional[str] = None
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--diff":
            i += 1
            if i >= len(argv):
                print(usage, file=sys.stderr)
                return 2
            diff_path = argv[i]
        elif arg == "--request":
            i += 1
            if i >= len(argv):
                print(usage, file=sys.stderr)
                return 2
            request_id = argv[i]
        elif arg.startswith("-"):
            print(usage, file=sys.stderr)
            return 2
        else:
            paths.append(arg)
        i += 1
    if len(paths) != 1:
        print(usage, file=sys.stderr)
        return 2
    try:
        bundle = load_bundle(paths[0])
    except (OSError, ValueError) as e:
        print(f"INVALID flight bundle {paths[0]}: {e}", file=sys.stderr)
        return 1
    if diff_path is not None:
        try:
            other = load_bundle(diff_path)
        except (OSError, ValueError) as e:
            print(f"INVALID flight bundle {diff_path}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(diff_bundles(bundle, other), indent=2))
        return 0
    if request_id is not None:
        story = request_story(bundle, request_id)
        print(f"{len(story)} events for request {request_id!r} in {paths[0]}")
        for ev in story:
            print(f"  {ev.get('ts', 0.0) / 1e6:.6f}s  {ev['ph']:>2}  {ev['name']}")
        return 0
    census = span_census(bundle)
    print(
        f"OK: {paths[0]} — reason {bundle['reason']!r} at {bundle['wall_time']} "
        f"(pid {bundle['pid']}), {len(bundle['spans'])} spans, "
        f"{len(census)} distinct names"
    )
    for name in sorted(census):
        print(f"  {census[name]:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
