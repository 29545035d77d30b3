"""Per-program SLOs with multi-window burn-rate alerting, and the
autoscaling signal computed from them.

An SLO here is a declarative :class:`Objective` — "program ``climate_step``
serves 99.9% of requests without an error event", "p99 latency stays under
500 ms for at least 99% of traffic" — evaluated over the live
:class:`~repro_torch.obs.metrics.MetricsRegistry` the serving engine already
maintains.  Nothing is double-counted: the SLO engine *reads* the same
per-program counters ``/metrics`` exports.

**Burn-rate math** (the Google SRE multi-window multi-burn-rate recipe).
Every objective has an *error budget*: the fraction of traffic allowed to be
bad (``1 - target`` for availability, ``target`` for an error-rate
objective, ``budget`` — default 1% — for a latency objective, whose "bad"
traffic is the requests that finished while the windowed p99 exceeded the
target).  The *burn rate* over a window is::

    burn = (bad traffic / total traffic in the window) / error budget

``burn == 1`` spends the budget exactly at the sustainable rate; ``burn ==
14.4`` exhausts a 30-day budget in ~2 days.  A single window either pages on
noise (short) or pages an hour late (long), so each :class:`BurnRule` pairs
a short and a long window and fires only when BOTH exceed its threshold:
the default rules are **fast** (5 m AND 1 h above 14.4× — a page) and
**slow** (30 m AND 6 h above 6× — a ticket).  Latency objectives can instead
evaluate over windows scaled to the serving engine's *batching window*
(:meth:`SloEngine.wire_batch_window`, called by the engine at construction):
latency badness is made of slow batching windows, so sizing the burn windows
in units of them makes a breach recovery observable within one evaluation
cycle of good traffic rather than five minutes later.  Breach *transitions*
emit
``slo.breach``/``slo.recovered`` trace instants, flip the
``serving_slo_breach{program=,objective=}`` gauge, and invoke ``on_breach``
(the engine points that at the flight recorder).

Evaluation is sample-driven and clock-injectable: :meth:`SloEngine.evaluate`
takes an explicit ``now`` so a seeded chaos run replays the exact same
breach timeline twice — the determinism the acceptance tests lock.

**Autoscaling signal** (:class:`Autoscaler`): the documented desired-replica
rule served on ``GET /autoscale``, fed by queue depth, occupancy-derived
utilization, and p99-vs-SLO-target pressure, hysteresis-damped so the
recommendation is immediate on the way up and deliberate on the way down.
See docs/observability.md for the rule, worked through.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as obs_metrics
from .trace import Tracer, monotonic

#: objective kinds and the registry families they read
AVAILABILITY = "availability"
ERROR_RATE = "error_rate"
LATENCY_P99 = "latency_p99"
_KINDS = (AVAILABILITY, ERROR_RATE, LATENCY_P99)

#: default fraction of traffic a latency objective allows past its target
LATENCY_BUDGET = 0.01


@dataclass(frozen=True)
class Objective:
    """One declarative objective over a program's served traffic.

    ``target`` means: availability → the good fraction (0.999); error_rate →
    the max bad fraction (0.001); latency_p99 → the p99 latency bound in
    seconds.  ``budget`` (bad-traffic fraction) is derived from the target
    for the ratio kinds and defaults to :data:`LATENCY_BUDGET` for latency.
    """

    name: str
    program: str
    kind: str
    target: float
    budget: Optional[float] = None
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r}; one of {_KINDS}")

    def error_budget(self) -> float:
        if self.budget is not None:
            return max(1e-9, float(self.budget))
        if self.kind == AVAILABILITY:
            return max(1e-9, 1.0 - self.target)
        if self.kind == ERROR_RATE:
            return max(1e-9, self.target)
        return LATENCY_BUDGET


@dataclass(frozen=True)
class BurnRule:
    """Fire when burn exceeds ``max_burn`` over BOTH paired windows."""

    name: str
    short_s: float
    long_s: float
    max_burn: float


#: Google SRE defaults scaled to seconds: page fast, ticket slow
DEFAULT_RULES = (
    BurnRule("fast", short_s=300.0, long_s=3600.0, max_burn=14.4),
    BurnRule("slow", short_s=1800.0, long_s=21600.0, max_burn=6.0),
)


def default_objectives(program: str, *, availability: float = 0.999,
                       p99_s: float = 0.5) -> List["Objective"]:
    """The serve launcher's out-of-the-box SLOs for one program: 99.9%
    of requests error-free, p99 under half a second."""
    return [
        Objective(f"{program}-availability", program, AVAILABILITY, availability,
                  description=f"{availability:.1%} of {program} requests succeed"),
        Objective(f"{program}-latency", program, LATENCY_P99, p99_s,
                  description=f"{program} p99 latency under {p99_s * 1000:.0f} ms"),
    ]


class SloEngine:
    """Evaluate objectives against the metrics registry; track breaches."""

    def __init__(
        self,
        registry: obs_metrics.MetricsRegistry,
        objectives: Sequence[Objective] = (),
        *,
        tracer: Optional[Callable[[], Tracer]] = None,
        rules: Sequence[BurnRule] = DEFAULT_RULES,
        max_samples: int = 8192,
        on_breach: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.registry = registry
        self.objectives: List[Objective] = []
        self.rules = tuple(rules)
        self.on_breach = on_breach
        self._tracer = tracer
        self.max_samples = int(max_samples)
        # per objective: cumulative (t, total, bad) samples; latency "bad"
        # traffic is self-accumulated from request deltas while the windowed
        # p99 sits above target (the registry only holds cumulative counters)
        self._samples: Dict[str, "deque[Tuple[float, float, float]]"] = {}
        self._breaching: Dict[str, bool] = {}
        # batch-window-scaled rules for LATENCY objectives only, armed by
        # wire_batch_window(); None means every kind uses self.rules
        self._latency_rules: Optional[Tuple[BurnRule, ...]] = None
        self.add(*objectives)

    def wire_batch_window(
        self,
        window_s: float,
        *,
        short_windows: float = 64.0,
        min_short_s: float = 0.25,
    ) -> "SloEngine":
        """Scale the **latency** objectives' burn windows to the engine's
        batching window instead of the 5-minute SRE defaults.

        A latency breach is made of requests that rode slow batching windows,
        so its natural evaluation timescale is the window length, not wall-
        clock minutes: with the short window at ``~64`` batching windows
        (floored at ``min_short_s`` so a 2 ms window doesn't evaluate over
        noise), one evaluation cycle after traffic goes good again the bad
        samples have aged out of the short window and the breach recovers —
        observable immediately, instead of waiting out five minutes of
        history.  Availability/error-rate objectives keep the default rules:
        their failure modes aren't paced by the batching window."""
        w = max(float(window_s), 1e-4)
        short = max(w * float(short_windows), float(min_short_s))
        self._latency_rules = (
            BurnRule("batch_fast", short_s=short, long_s=short * 8.0, max_burn=14.4),
            BurnRule("batch_slow", short_s=short * 4.0, long_s=short * 32.0, max_burn=6.0),
        )
        return self

    def rules_for(self, obj: Objective) -> Tuple[BurnRule, ...]:
        """The burn rules one objective evaluates under (latency objectives
        get the batch-window-scaled pair once :meth:`wire_batch_window` ran)."""
        if obj.kind == LATENCY_P99 and self._latency_rules is not None:
            return self._latency_rules
        return self.rules

    def add(self, *objectives: Objective) -> "SloEngine":
        """Register objectives after construction — programs arrive at the
        serving engine one ``register()`` at a time, and their SLOs with
        them.  Duplicate names replace (fresh sample ring)."""
        for obj in objectives:
            if obj.name in self._samples:
                self.objectives = [o for o in self.objectives if o.name != obj.name]
            self.objectives.append(obj)
            self._samples[obj.name] = deque(maxlen=self.max_samples)
            self._breaching[obj.name] = False
        return self

    # -- reads ---------------------------------------------------------------

    def _totals(self, obj: Objective) -> Tuple[float, float, Optional[float]]:
        """Cumulative (total, bad, p99) for one objective right now."""
        reg = self.registry
        total = reg.sum_value("serving_requests_total", program=obj.program)
        p99 = reg.quantile("serving_request_latency_seconds", 0.99, program=obj.program)
        if obj.kind == LATENCY_P99:
            return total, 0.0, p99  # bad accumulated in sample()
        bad = reg.sum_value("serving_errors_total", program=obj.program)
        return total, bad, p99

    def latency_pressure(self) -> Optional[float]:
        """Worst current p99/target ratio across latency objectives; None
        when no latency objective is armed or nothing has been observed."""
        ratios = []
        for obj in self.objectives:
            if obj.kind != LATENCY_P99:
                continue
            p99 = self.registry.quantile(
                "serving_request_latency_seconds", 0.99, program=obj.program
            )
            if p99 is not None and obj.target > 0:
                ratios.append(p99 / obj.target)
        return max(ratios) if ratios else None

    # -- sampling + burn math ------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """Append one cumulative sample per objective (idempotent per ``now``:
        re-sampling the same instant replaces nothing and hurts nothing)."""
        now = monotonic() if now is None else float(now)
        for obj in self.objectives:
            ring = self._samples[obj.name]
            total, bad, p99 = self._totals(obj)
            if obj.kind == LATENCY_P99:
                prev_t, prev_total, prev_bad = ring[-1] if ring else (now, 0.0, 0.0)
                delta = max(0.0, total - prev_total)
                bad = prev_bad + (delta if (p99 is not None and p99 > obj.target) else 0.0)
            ring.append((now, total, bad))

    def _window_burn(self, obj: Objective, window_s: float, now: float) -> float:
        """Burn rate over ``[now - window_s, now]`` from the sample ring."""
        ring = self._samples[obj.name]
        if not ring:
            return 0.0
        t_end, total_end, bad_end = ring[-1]
        cutoff = now - window_s
        # the newest sample at-or-before the window start anchors the diff;
        # a window older than history falls back to "since the beginning"
        t0, total0, bad0 = ring[0]
        for t, total, bad in ring:
            if t <= cutoff:
                t0, total0, bad0 = t, total, bad
            else:
                break
        dt_total = total_end - total0
        if dt_total <= 0:
            return 0.0
        rate = max(0.0, bad_end - bad0) / dt_total
        return rate / obj.error_budget()

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Sample, compute every rule's burn rates, fire breach transitions;
        returns the status dict ``GET /autoscale`` and ``/stats`` embed."""
        now = monotonic() if now is None else float(now)
        self.sample(now)
        out: List[Dict[str, Any]] = []
        for obj in self.objectives:
            rules = []
            breaching = False
            for rule in self.rules_for(obj):
                short = self._window_burn(obj, rule.short_s, now)
                long = self._window_burn(obj, rule.long_s, now)
                fired = short > rule.max_burn and long > rule.max_burn
                breaching = breaching or fired
                rules.append(
                    {
                        "rule": rule.name,
                        "max_burn": rule.max_burn,
                        "short_burn": short,
                        "long_burn": long,
                        "breaching": fired,
                    }
                )
                self.registry.gauge(
                    "serving_slo_burn_rate",
                    "error-budget burn rate per objective and window",
                    objective=obj.name,
                    program=obj.program,
                    window=f"{rule.name}_short",
                ).set(short)
                self.registry.gauge(
                    "serving_slo_burn_rate",
                    "error-budget burn rate per objective and window",
                    objective=obj.name,
                    program=obj.program,
                    window=f"{rule.name}_long",
                ).set(long)
            _, total, bad = (
                self._samples[obj.name][-1] if self._samples[obj.name] else (now, 0.0, 0.0)
            )
            status = {
                "objective": obj.name,
                "program": obj.program,
                "kind": obj.kind,
                "target": obj.target,
                "budget": obj.error_budget(),
                "breaching": breaching,
                "rules": rules,
                "totals": {"requests": total, "bad": bad},
            }
            out.append(status)
            self._transition(obj, status, now)
        return {"breaching": any(s["breaching"] for s in out), "objectives": out}

    def _transition(self, obj: Objective, status: Dict[str, Any], now: float) -> None:
        was, is_now = self._breaching[obj.name], status["breaching"]
        self._breaching[obj.name] = is_now
        self.registry.gauge(
            "serving_slo_breach",
            "1 while the objective's burn rate breaches a rule",
            objective=obj.name,
            program=obj.program,
        ).set(1.0 if is_now else 0.0)
        if is_now == was:
            return
        tracer = self._tracer() if self._tracer is not None else None
        worst = max(
            (r for r in status["rules"]),
            key=lambda r: (r["breaching"], min(r["short_burn"], r["long_burn"])),
        )
        if tracer is not None:
            tracer.event(
                "slo.breach" if is_now else "slo.recovered",
                category="slo",
                objective=obj.name,
                program=obj.program,
                kind=obj.kind,
                rule=worst["rule"],
                short_burn=worst["short_burn"],
                long_burn=worst["long_burn"],
            )
        if is_now and self.on_breach is not None:
            try:
                self.on_breach(status)
            except Exception:  # noqa: BLE001, S110 — alerting must never take serving down
                pass

    def status(self) -> Dict[str, Any]:
        """The last-evaluated breach state without re-sampling (flight
        recorder snapshots call this from failure paths)."""
        return {
            "breaching": any(self._breaching.values()),
            "objectives": [
                {
                    "objective": o.name,
                    "program": o.program,
                    "kind": o.kind,
                    "target": o.target,
                    "breaching": self._breaching[o.name],
                }
                for o in self.objectives
            ],
        }


# ---------------------------------------------------------------------------
# the autoscaling signal
# ---------------------------------------------------------------------------


class Autoscaler:
    """Desired-replica recommendation, hysteresis-damped.

    The rule (documented with a worked example in docs/observability.md):

    * ``backlog = queue_depth + inflight`` — member-slots of waiting work.
    * ``utilization = backlog / (replicas * max_batch)`` — how full the
      fleet's batch capacity is; the queue term asks for the replica count
      that brings utilization back to ``target_utilization``:
      ``queue_term = replicas * utilization / target_utilization``.
    * ``latency_term = replicas * min(p99/target, latency_ratio_cap)`` when a
      latency objective is armed, its p99 pressure exceeds 1, and scaling
      could plausibly help (capped so one outlier cannot demand the moon).
    * ``breach_term = replicas + 1`` while any SLO objective is in breach —
      an active burn-rate alert always asks for at least one more replica.
    * ``desired = clamp(ceil(max(terms)), min_replicas, max_replicas)``.

    Hysteresis: an *increase* publishes immediately (underprovisioning burns
    error budget); a *decrease* publishes only after ``down_stable_evals``
    consecutive evaluations agreed, and then steps down one replica at a
    time (flap damping).  The recommendation never self-applies — a future
    multi-replica supervisor consumes it and reports back via
    :meth:`observe_replicas`.
    """

    def __init__(
        self,
        *,
        replicas: int = 1,
        min_replicas: int = 1,
        max_replicas: int = 8,
        target_utilization: float = 0.75,
        latency_ratio_cap: float = 4.0,
        down_stable_evals: int = 3,
    ):
        self.replicas = max(1, int(replicas))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.target_utilization = float(target_utilization)
        self.latency_ratio_cap = float(latency_ratio_cap)
        self.down_stable_evals = max(1, int(down_stable_evals))
        self._down_streak = 0

    def observe_replicas(self, n: int) -> None:
        """Tell the rule what is actually running (resets flap damping only
        when the fleet really changed size)."""
        n = max(1, int(n))
        if n != self.replicas:
            self.replicas = n
            self._down_streak = 0

    def recommend(
        self,
        *,
        queue_depth: int,
        inflight: int,
        max_batch: int,
        latency_ratio: Optional[float] = None,
        breaching: bool = False,
    ) -> Dict[str, Any]:
        r = max(self.min_replicas, self.replicas)
        backlog = max(0, int(queue_depth)) + max(0, int(inflight))
        capacity = max(1, r * max(1, int(max_batch)))
        utilization = backlog / capacity
        terms: Dict[str, float] = {
            "queue": r * utilization / max(1e-9, self.target_utilization)
        }
        if latency_ratio is not None and latency_ratio > 1.0:
            terms["latency"] = r * min(latency_ratio, self.latency_ratio_cap)
        if breaching:
            terms["slo_breach"] = float(r + 1)
        raw = max(terms.values())
        # deterministic dominant-term name (ties break alphabetically)
        dominant = min(t for t, v in terms.items() if v == raw)
        candidate = max(self.min_replicas, min(self.max_replicas, math.ceil(raw - 1e-9)))

        if candidate >= r:
            self._down_streak = 0
            published = min(candidate, self.max_replicas)
            reason = (
                f"scale_up:{dominant}" if published > r else f"hold:{dominant}"
            )
        else:
            # flap damping: agree for down_stable_evals evaluations, then
            # step down exactly one replica
            self._down_streak += 1
            if self._down_streak >= self.down_stable_evals:
                self._down_streak = 0
                published = max(candidate, r - 1, self.min_replicas)
                reason = "scale_down:stable"
            else:
                published = r
                reason = f"hold:damping({self._down_streak}/{self.down_stable_evals})"

        return {
            "desired_replicas": int(published),
            "replicas": int(r),
            "reason": reason,
            "inputs": {
                "queue_depth": int(queue_depth),
                "inflight": int(inflight),
                "max_batch": int(max_batch),
                "utilization": utilization,
                "latency_ratio": latency_ratio,
                "breaching": bool(breaching),
            },
            "terms": {k: round(v, 4) for k, v in terms.items()},
        }
