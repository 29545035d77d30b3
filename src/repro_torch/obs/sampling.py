"""Head-based trace sampling: deterministic per-request-id keep decisions.

Always-on tracing is only viable in production if most requests cost almost
nothing to trace.  The head-based scheme here makes the keep/drop decision
once per request id, at the "head" of its story, from a hash of the id —
no coordination, no RNG state, and the same id samples the same way on every
process that sees it (a batched dispatch span kept on the engine is also
kept by any sidecar hashing the same ids):

* :func:`sample_unit` maps ``(seed, trace_id)`` → uniform [0, 1) via the same
  ``blake2b`` recipe the fault injector uses for per-site decisions — one
  short-string hash, no allocation beyond the digest.
* :class:`SamplingPolicy` holds a tracer's rate plus the *force-sampled*
  override set: error/bisect/deadline paths force a request's id so the tail
  of its story is retained even when the head hash said drop (tail-latency
  stories never get dropped).
* Spans carrying **no** trace ids (compile spans, batching windows before any
  link) are always kept — sampling is a per-request budget, not a global one.
* A span carrying **many** ids (one batched dispatch serves several requests)
  is kept iff *any* of its ids is sampled, so a sampled request always sees
  the shared batch spans it rode.

Arm process-wide with ``REPRO_TRACE_SAMPLE=0.1`` (read once per
:class:`~repro_torch.obs.trace.Tracer` construction) or per tracer via
``Tracer(sample_rate=0.1)``.  Rate 1.0 (the default) keeps everything and
skips the hash entirely; rate 0.0 keeps only forced ids.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from hashlib import blake2b
from typing import Iterable

#: force-sampled ids retained per policy — errors are rare, so this is a
#: backstop against a crash-looping client growing the set without bound,
#: not a knob anyone should need to raise
FORCED_CAPACITY = 4096


def sample_unit(trace_id: str, seed: int = 0) -> float:
    """Deterministic uniform-[0, 1) draw for one trace id."""
    digest = blake2b(f"{seed}:{trace_id}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2**64


def head_sampled(trace_id: str, rate: float, seed: int = 0) -> bool:
    """The pure head decision: hash the id, keep iff it lands under ``rate``."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return sample_unit(str(trace_id), seed) < rate


def rate_from_env(default: float = 1.0) -> float:
    """``REPRO_TRACE_SAMPLE`` as a clamped [0, 1] rate; ``default`` when the
    variable is unset or unparseable (a typo must not silently disable
    tracing in production)."""
    raw = os.environ.get("REPRO_TRACE_SAMPLE", "")
    if not raw:
        return default
    try:
        rate = float(raw)
    except ValueError:
        return default
    return min(1.0, max(0.0, rate))


class SamplingPolicy:
    """One tracer's sampling state: the head rate plus forced-id overrides."""

    def __init__(self, rate: float = 1.0, *, seed: int = 0,
                 forced_capacity: int = FORCED_CAPACITY):
        self.rate = min(1.0, max(0.0, float(rate)))
        self.seed = int(seed)
        self.forced_capacity = int(forced_capacity)
        self._forced: "OrderedDict[str, None]" = OrderedDict()
        self._lock = threading.Lock()

    @property
    def always(self) -> bool:
        """True when every span is kept — the hash is skipped entirely."""
        return self.rate >= 1.0

    def force(self, *trace_ids: str) -> None:
        """Pin ids as always-sampled from now on (error paths call this the
        moment a request enters retry/bisect/deadline territory)."""
        with self._lock:
            for t in trace_ids:
                self._forced[str(t)] = None
                self._forced.move_to_end(str(t))
            while len(self._forced) > self.forced_capacity:
                self._forced.popitem(last=False)

    def is_forced(self, trace_id: str) -> bool:
        return str(trace_id) in self._forced

    def decide(self, trace_id: str) -> bool:
        """Keep/drop for one id: forced wins, else the head hash."""
        if self.rate >= 1.0:
            return True
        tid = str(trace_id)
        if tid in self._forced:
            return True
        return head_sampled(tid, self.rate, self.seed)

    def sampled(self, trace_ids: Iterable[str]) -> bool:
        """Keep/drop for a span: no ids → keep; any sampled id → keep."""
        if self.rate >= 1.0:
            return True
        ids = list(trace_ids)
        if not ids:
            return True
        return any(self.decide(t) for t in ids)
