"""Deterministic fault injection for the serving path.

The resilience layer (retry-with-bisect, worker restart, request abandonment,
tune-store degradation) is only trustworthy if its failure handling is
*exercised*, and failures must be reproducible to be debuggable.  This module
is the one chaos source every failure-prone site checks:

* ``dispatch``  — before a batched ``Ensemble.iterate`` dispatch
* ``scatter``   — while scattering request fields into member slots
* ``gather``    — while gathering a member's state back out for streaming
* ``ws_send``   — while writing a frame to a websocket
* ``tune_read`` — while reading the persisted autotune store at registration

Faults are **deterministic**: the n-th check at a site fails iff a keyed
blake2b hash of ``(seed, site, n)`` lands under ``rate`` — no RNG state, no
wall clock, so a failing run replays exactly under the same seed, and a
*retry* of a failed dispatch advances the per-site counter and (at rate < 1)
eventually succeeds.  ``poison`` keys are the exception: a check whose
``keys`` include a poisoned id fails *every* attempt — that is what drives
the engine's bisect until the poisoned request is alone and can be failed
individually.

Off by default.  Armed either explicitly (``FaultInjector(sites=...,
rate=...)`` passed to :class:`~repro_torch.serving.engine.ServingEngine`) or from
the environment — the CI chaos matrix sets::

    REPRO_FAULT_SITES=dispatch,gather   # comma-separated sites (required)
    REPRO_FAULT_RATE=0.15               # per-check failure probability
    REPRO_FAULT_SEED=1234               # replay seed (default 0)
    REPRO_FAULT_POISON=req-3,req-9      # always-fail keys (optional)

``InjectedFault`` deliberately subclasses ``RuntimeError``, not
``ServingError``: injected faults must travel the same recovery paths as
real infrastructure failures, never the admission-rejection path.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, FrozenSet, Iterable, Mapping, Optional, Sequence

#: every site the engine/transport threads a check through
SITES = ("dispatch", "scatter", "gather", "ws_send", "tune_read")

_ENV_SITES = "REPRO_FAULT_SITES"
_ENV_RATE = "REPRO_FAULT_RATE"
_ENV_SEED = "REPRO_FAULT_SEED"
_ENV_POISON = "REPRO_FAULT_POISON"


class InjectedFault(RuntimeError):
    """An injected infrastructure failure (NOT an admission rejection)."""

    def __init__(self, site: str, detail: str):
        super().__init__(f"injected fault at {site}: {detail}")
        self.site = site
        self.detail = detail


def _unit_hash(seed: int, site: str, n: int) -> float:
    """Deterministic uniform in [0, 1): keyed blake2b, stable across
    processes and platforms (unlike ``hash()``)."""
    digest = hashlib.blake2b(f"{seed}:{site}:{n}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2**64


class FaultInjector:
    """Seeded, site-addressed, counter-deterministic fault source.

    ``check(site, keys=...)`` raises :class:`InjectedFault` when the die says
    so; it is a no-op for sites the injector is not armed at, so threading
    checks through hot paths costs one set lookup when chaos is off.
    """

    def __init__(
        self,
        *,
        sites: Iterable[str] = (),
        rate: float = 0.0,
        seed: int = 0,
        poison: Iterable[str] = (),
    ):
        sites = frozenset(sites)
        unknown = sites - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; known: {SITES}")
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        self.sites: FrozenSet[str] = sites
        self.rate = float(rate)
        self.seed = int(seed)
        self.poison: FrozenSet[str] = frozenset(str(k) for k in poison)
        self._counters: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.sites) and (self.rate > 0.0 or bool(self.poison))

    def armed(self, site: str) -> bool:
        return site in self.sites and (self.rate > 0.0 or bool(self.poison))

    def check(self, site: str, keys: Sequence[Any] = ()) -> None:
        """Maybe raise an :class:`InjectedFault` at ``site``.

        ``keys`` identify what the operation is acting on (request ids for a
        dispatch, one id for a gather); a poisoned key fails deterministically
        on EVERY attempt, while rate-based faults advance a per-site counter
        so retries see fresh dice."""
        if site not in self.sites:
            return
        if self.poison:
            for k in keys:
                if str(k) in self.poison:
                    self.injected[site] = self.injected.get(site, 0) + 1
                    raise InjectedFault(site, f"poisoned key {k!r}")
        if self.rate <= 0.0:
            return
        n = self._counters.get(site, 0)
        self._counters[site] = n + 1
        if _unit_hash(self.seed, site, n) < self.rate:
            self.injected[site] = self.injected.get(site, 0) + 1
            raise InjectedFault(site, f"check #{n} (seed {self.seed}, rate {self.rate})")

    def stats(self) -> Dict[str, Any]:
        return {
            "sites": sorted(self.sites),
            "rate": self.rate,
            "seed": self.seed,
            "poison": sorted(self.poison),
            "checks": dict(self._counters),
            "injected": dict(self.injected),
        }

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "FaultInjector":
        """The env-armed injector (disabled when ``REPRO_FAULT_SITES`` is
        unset/empty) — what a :class:`ServingEngine` builds by default, so a
        CI chaos leg arms every engine in the process without code changes."""
        env = os.environ if env is None else env
        sites = tuple(s.strip() for s in env.get(_ENV_SITES, "").split(",") if s.strip())
        if not sites:
            return cls()
        rate = float(env.get(_ENV_RATE, "0.1"))
        seed = int(env.get(_ENV_SEED, "0"))
        poison = tuple(p.strip() for p in env.get(_ENV_POISON, "").split(",") if p.strip())
        return cls(sites=sites, rate=rate, seed=seed, poison=poison)
