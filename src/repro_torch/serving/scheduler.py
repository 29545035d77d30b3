"""Pluggable batching schedulers: who rides the next window, in what order.

The engine's worker used to be a strict FIFO single-window loop: pop the
oldest request, collect arrivals for one ``window_ms``, dispatch, repeat.
That policy is blind to everything the request already tells us — its
deadline, its priority class, which program it targets.  This module owns
that decision instead:

* The scheduler holds the **backlog**: every request the worker has pulled
  off the admission queue but not yet taken into a dispatch window.  The
  admission queue stays a plain FIFO hand-off between ``submit()`` and the
  worker; ordering policy applies to the whole backlog, not just to whatever
  happened to arrive inside one window.
* ``take()`` forms **per-program windows**: for each program present in the
  backlog (in policy order) it takes up to that program's ``max_batch`` most
  urgent requests.  The engine dispatches distinct programs' windows
  concurrently; the surplus stays in the backlog and is *re-ordered again*
  on the next round, so a tight-deadline request that arrived late still
  overtakes a queued bulk job.
* ``window_cap()`` is derived from the programs **actually present** in the
  backlog — not ``max()`` over the whole registry — which both fixes the
  over-collection bug (a window for a small-cap program no longer waits to
  fill a larger program's cap, then chunks the surplus into serial
  dispatches) and removes the ``max()``-on-empty-registry crash.

Policies are deterministic: every sort key ends in the admission sequence
number, so the same backlog always yields the same windows, and any two
requests are totally ordered.  Reordering is safe because batched execution
is bit-identical to sequential execution per request (the PR-6/7 contract):
a request computes the same bits no matter which window it rides.

``fifo``
    Arrival order (admission sequence).  The PR-6 behavior, kept as the
    baseline policy and for A/B comparison in the bench.

``edf``
    Earliest-deadline-first within priority classes: order by
    ``(priority, deadline, arrival)``.  Lower ``priority`` values are more
    urgent; a request without a deadline sorts after every request with one
    in the same class.  This is the default — with no deadlines and one
    priority class it degenerates to exactly FIFO.

Select with ``ServingEngine(scheduler=...)``, the serve CLI ``--scheduler``
flag, or the ``REPRO_SCHEDULER`` environment variable.
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING, Callable, Dict, List, Tuple, Union

if TYPE_CHECKING:  # engine imports this module; never the other way at runtime
    from .engine import ForecastRequest, ProgramEntry

#: environment knob honored when the engine is built without an explicit policy
SCHEDULER_ENV = "REPRO_SCHEDULER"


class BatchingScheduler:
    """Base policy: FIFO by admission sequence.  Subclasses override
    :meth:`sort_key`; everything else — backlog ownership, per-program window
    formation, the present-programs cap — is policy-independent."""

    name = "fifo"

    def __init__(self) -> None:
        self._backlog: List["ForecastRequest"] = []

    # -- backlog ------------------------------------------------------------

    def push(self, req: "ForecastRequest") -> None:
        self._backlog.append(req)

    def backlog(self) -> int:
        return len(self._backlog)

    def oldest_waiting(self) -> Union[int, None]:
        """Smallest admission seq still pooled (None when empty) — the engine
        compares it against each round's picks to count real reorderings."""
        return min((r.seq for r in self._backlog), default=None)

    def flush(self) -> List["ForecastRequest"]:
        """Remove and return the entire backlog (worker failure/shutdown:
        the engine fails them rather than spinning on a poisoned pool)."""
        out, self._backlog = self._backlog, []
        return out

    def sweep(self, dead: Callable[["ForecastRequest"], bool]) -> List["ForecastRequest"]:
        """Remove and return every backlog request ``dead`` says to drop
        (expired / abandoned / already terminal) — checked at pickup, before
        any window slot or dispatch is spent on them."""
        gone = [r for r in self._backlog if dead(r)]
        if gone:
            self._backlog = [r for r in self._backlog if not dead(r)]
        return gone

    # -- policy -------------------------------------------------------------

    def sort_key(self, req: "ForecastRequest") -> Tuple:
        return (req.seq,)

    def window_cap(self) -> int:
        """How many requests one collection round can usefully hold: the sum
        of ``max_batch`` over the programs *present* in the backlog (each
        program dispatches its own window concurrently).  Zero on an empty
        backlog — never a ``max()`` over the registry."""
        entries: Dict[str, "ProgramEntry"] = {}
        for r in self._backlog:
            entries.setdefault(r.entry.name, r.entry)
        return sum(e.max_batch for e in entries.values())

    def take(self, now: float) -> List[Tuple["ProgramEntry", List["ForecastRequest"]]]:
        """Form this round's windows: order the backlog by policy, then give
        each program (in order of its most urgent request) its up-to-
        ``max_batch`` most urgent requests.  The surplus stays in the backlog
        in policy order and competes again next round."""
        ordered = sorted(self._backlog, key=self.sort_key)
        windows: List[Tuple["ProgramEntry", List["ForecastRequest"]]] = []
        index: Dict[str, int] = {}
        leftover: List["ForecastRequest"] = []
        for r in ordered:
            slot = index.get(r.entry.name)
            if slot is None:
                index[r.entry.name] = len(windows)
                windows.append((r.entry, [r]))
            elif len(windows[slot][1]) < r.entry.max_batch:
                windows[slot][1].append(r)
            else:
                leftover.append(r)
        self._backlog = leftover
        return windows


class FifoScheduler(BatchingScheduler):
    """Arrival order — the explicit name for the base policy."""

    name = "fifo"


class EdfScheduler(BatchingScheduler):
    """Earliest-deadline-first within priority classes.

    Key: ``(priority, deadline_at, seq)`` — class 0 preempts class 1, the
    soonest deadline wins within a class, deadline-less requests sort last in
    their class, and the admission sequence breaks every remaining tie so
    the order is total and deterministic."""

    name = "edf"

    def sort_key(self, req: "ForecastRequest") -> Tuple:
        deadline = req.deadline_at if req.deadline_at is not None else math.inf
        return (req.priority, deadline, req.seq)


SCHEDULERS: Dict[str, type] = {
    FifoScheduler.name: FifoScheduler,
    EdfScheduler.name: EdfScheduler,
}


def make_scheduler(
    spec: Union[str, BatchingScheduler, None] = None,
) -> BatchingScheduler:
    """Resolve a scheduler: an instance passes through, a name looks up the
    registry, ``None`` reads ``$REPRO_SCHEDULER`` and falls back to ``edf``
    (which is FIFO-identical when requests carry no deadlines/priorities)."""
    if isinstance(spec, BatchingScheduler):
        return spec
    if spec is None:
        spec = os.environ.get(SCHEDULER_ENV, "") or EdfScheduler.name
    try:
        cls = SCHEDULERS[str(spec).lower()]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {spec!r}; available: {sorted(SCHEDULERS)}"
        ) from None
    return cls()
