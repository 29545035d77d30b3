"""Process supervision and health watchdogs (the reference package's
``repro/runtime/supervise.py``).

The rolling-median straggler watchdog and the restore-and-retry restart
policy apply to a *serving* process: a forecast server must be spawned,
probed for readiness, restarted with backoff when it dies, and given up on
when it crash-loops.  The supervised child is always the port's own
``python -m repro_torch.launch.serve``.

* :class:`StragglerWatchdog` — rolling-median step/dispatch timer.
* :class:`RestartPolicy` — exponential backoff + crash-loop detection over a
  sliding window.
* :class:`Supervisor` — spawn a child process, poll a readiness probe,
  restart on exit per the policy, raise :class:`SupervisorGaveUp` on a crash
  loop.  Synchronous on purpose: it supervises a *separate* process and is
  itself the thing that must stay simple enough to never crash.
* :func:`http_ready` — a stdlib-only readiness probe for ``/healthz``-style
  endpoints (no aiohttp dependency in the supervising process).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.trace import monotonic

log = logging.getLogger("repro_torch.runtime")


# ---------------------------------------------------------------------------
# straggler watchdog (moved from runtime/loop.py)
# ---------------------------------------------------------------------------


@dataclass
class WatchdogStats:
    steps: int = 0
    stragglers: int = 0
    median_s: float = 0.0


class StragglerWatchdog:
    """Rolling-median step timer; flags steps slower than ``factor``×median."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.stats = WatchdogStats()
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        self.stats.steps += 1
        flagged = False
        # straggler flagging compares dt against the median of the PRIOR
        # samples (>= 8 of them, the warm-up), so a slow step is judged
        # against history it is not part of
        prior = self.times[-self.window :]
        self.times.append(dt)
        # ...but the published rolling median includes the sample just
        # recorded: consumers like the serving engine's retry_after_ms need
        # a real estimate from the very first dispatch, not the second
        self.stats.median_s = float(np.median(self.times[-self.window :]))
        if len(prior) >= 8:
            med = float(np.median(prior))
            if dt > self.factor * med:
                self.stats.stragglers += 1
                flagged = True
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        return flagged


# ---------------------------------------------------------------------------
# restart policy: backoff + crash-loop detection
# ---------------------------------------------------------------------------


@dataclass
class RestartPolicy:
    """Exponential backoff between restarts; give up on a crash loop.

    A *crash loop* is ``max_crashes`` exits within ``crash_window_s`` of each
    other — a child that keeps dying right after (or before) becoming ready
    will not be restarted forever."""

    backoff_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    crash_window_s: float = 60.0
    max_crashes: int = 5
    _crash_times: List[float] = field(default_factory=list)
    _restarts: int = 0

    def next_backoff(self) -> float:
        b = min(self.backoff_s * self.backoff_factor**self._restarts, self.backoff_max_s)
        self._restarts += 1
        return b

    def reset_backoff(self) -> None:
        self._restarts = 0

    def record_crash(self, now: Optional[float] = None) -> bool:
        """Record one child exit; returns True when this tips into a crash
        loop (caller should give up instead of restarting)."""
        now = monotonic() if now is None else now
        self._crash_times.append(now)
        window = [t for t in self._crash_times if now - t <= self.crash_window_s]
        self._crash_times = window
        return len(window) >= self.max_crashes


class SupervisorGaveUp(RuntimeError):
    """The supervised child crash-looped past the restart policy."""


def http_ready(url: str, timeout_s: float = 1.0) -> bool:
    """True iff ``url`` answers 2xx within ``timeout_s`` (stdlib only)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return 200 <= resp.status < 300
    except (urllib.error.URLError, OSError, ValueError):
        return False


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


class Supervisor:
    """Spawn → probe readiness → restart with backoff → give up on crash loop.

    ``probe`` is any zero-argument callable returning True once the child is
    ready (:func:`http_ready` partial'd onto ``/healthz`` for the forecast
    server; tests use file- or socket-based probes).  A child that exits (or
    never probes ready within ``ready_timeout_s``) counts as one crash.

    When a flight recorder is armed (``flight=`` or ``$REPRO_FLIGHT_DIR``),
    the supervisor drops a bundle *before* every restart and on crash-loop
    give-up: the child's own recorder (same env var, inherited through
    :func:`_child_env`) captures the in-process story, and the supervisor's
    bundle captures the outside view — exit codes, restart cadence, backoff
    state — so an operator can reconstruct a crash loop from the bundles
    alone.
    """

    def __init__(
        self,
        cmd: Sequence[str],
        *,
        probe: Callable[[], bool],
        policy: Optional[RestartPolicy] = None,
        ready_timeout_s: float = 60.0,
        probe_interval_s: float = 0.1,
        on_event: Optional[Callable[[str, Dict], None]] = None,
        flight: Optional[FlightRecorder] = None,
    ):
        self.cmd = list(cmd)
        self.probe = probe
        self.policy = policy or RestartPolicy()
        self.ready_timeout_s = float(ready_timeout_s)
        self.probe_interval_s = float(probe_interval_s)
        self.on_event = on_event
        self.proc: Optional[subprocess.Popen] = None
        self._stopping = False
        self.stats: Dict[str, int] = {"spawns": 0, "crashes": 0, "restarts": 0}
        self.flight = flight if flight is not None else FlightRecorder.from_env()
        if self.flight is not None:
            self.flight.bind(
                stats=self._flight_stats,
                config={"cmd": self.cmd, "ready_timeout_s": self.ready_timeout_s},
            )

    def _event(self, kind: str, **detail) -> None:
        log.info("supervisor: %s %s", kind, detail)
        if self.on_event:
            self.on_event(kind, detail)

    def _flight_stats(self) -> Dict:
        return {
            **self.stats,
            "restarts_since_ready": self.policy._restarts,
            "crashes_in_window": len(self.policy._crash_times),
            "child_pid": self.proc.pid if self.proc is not None else None,
            "child_returncode": self.proc.poll() if self.proc is not None else None,
        }

    # -- lifecycle ----------------------------------------------------------

    def spawn(self) -> subprocess.Popen:
        self.stats["spawns"] += 1
        self.proc = subprocess.Popen(self.cmd, env=_child_env())
        self._event("spawned", pid=self.proc.pid)
        return self.proc

    def wait_ready(self) -> bool:
        """Poll the probe until ready; False if the child dies, ``stop()`` is
        called or the readiness timeout expires first."""
        deadline = monotonic() + self.ready_timeout_s
        while monotonic() < deadline:
            # stop() detaches the child (proc None): waiting on would probe a
            # server that is gone until the deadline
            if self._stopping or self.proc.poll() is not None:
                return False
            if self.probe():
                self._event("ready", pid=self.proc.pid if self.proc else None)
                return True
            time.sleep(self.probe_interval_s)
        return False

    def start(self) -> None:
        """Spawn and block until ready; crash-loop rules apply from the very
        first spawn (a child that can't ever become ready gives up too)."""
        while not self._stopping:
            self.spawn()
            if self.wait_ready():
                self.policy.reset_backoff()
                return
            if self._stopping:
                return
            self._crash_and_backoff("never became ready")

    def run_forever(self) -> None:
        """Supervise until :class:`SupervisorGaveUp` or an external stop():
        wait for the child to exit, restart it, re-probe readiness (crash-loop
        accounting applies to the restarts exactly as to the first spawn)."""
        if self.proc is None:
            self.start()
        while not self._stopping:
            proc = self.proc
            if proc is None:  # stop() detached it: deliberate shutdown
                return
            code = proc.wait()
            if self._stopping or self.proc is not proc:
                return
            self._crash_and_backoff(f"exit code {code}")
            self.stats["restarts"] += 1
            self.start()

    def _crash_and_backoff(self, why: str) -> None:
        self.stats["crashes"] += 1
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.policy.record_crash():
            self._event("gave_up", reason=why, crashes=self.stats["crashes"])
            if self.flight is not None:
                self.flight.dump("supervisor_gave_up", extra={"why": why})
            raise SupervisorGaveUp(
                f"{self.policy.max_crashes} crashes within {self.policy.crash_window_s}s ({why})"
            )
        backoff = self.policy.next_backoff()
        self._event("crashed", reason=why, backoff_s=backoff)
        # the black box goes down with the plane: record what the supervisor
        # saw BEFORE the restart, while the dead child's exit state is fresh
        if self.flight is not None:
            self.flight.dump("supervisor_restart", extra={"why": why, "backoff_s": backoff})
        time.sleep(backoff)

    def stop(self, grace_s: float = 5.0) -> None:
        """Terminate the child (SIGTERM, then SIGKILL after ``grace_s``) and
        end supervision — run_forever/start return instead of respawning.
        Terminal for this instance: build a fresh Supervisor to serve again."""
        self._stopping = True
        proc, self.proc = self.proc, None
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        self._event("stopped", pid=proc.pid)


def _child_env() -> Dict[str, str]:
    """The environment for a supervised child: the parent's, with the root
    this process imported :mod:`repro_torch` from prepended to ``PYTHONPATH`` —
    ``sys.path`` edits (a source checkout, the test conftest) do not survive
    into a subprocess, and without this a ``-m repro_torch.launch.serve`` child
    dies with ModuleNotFoundError before it can ever become ready."""
    import repro_torch

    env = dict(os.environ)
    root = str(Path(repro_torch.__file__).resolve().parent.parent)
    existing = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if root not in existing:
        env["PYTHONPATH"] = os.pathsep.join([root, *existing])
    return env


def serve_command(argv: Sequence[str]) -> List[str]:
    """The child command for a supervised forecast server: this interpreter,
    ``-m repro_torch.launch.serve``, the caller's serve args."""
    return [sys.executable, "-m", "repro_torch.launch.serve", *argv]
