"""Optimization pass pipeline over the Implementation IR.

This is the analysis/transform layer the paper's toolchain puts between the
frontend and the code generators (§2.3): the *same* definition IR is
specialized by composable, individually toggleable passes before any backend
sees it.  Each pass is a named ``Pass`` with a legality argument documented
in ``docs/passes.md``; a shared ``PassContext`` records per-pass wall time
and before/after IR statistics, surfaced to users through
``exec_info["pass_report"]`` (mirroring the paper's Fig. 3 instrumentation).

Pipeline (in application order; ``min_opt_level`` in parentheses)::

    constant_folding        (3)  literal arithmetic + algebraic identities + dead branches
    dead_temp_pruning       (2)  liveness fixpoint: drop unread temporaries and the
                                 stages that only feed them, shrink extents
    interval_splitting      (1)  peel carry-free boundary intervals off sequential
                                 sweeps into vectorized PARALLEL multi-stages so the
                                 steady-state interior loop carries less state
    interval_merging        (2)  merge adjacent k-intervals with identical stage bodies
    multistage_fusion       (1)  fuse adjacent PARALLEL multi-stages so the Pallas
                                 backend keeps intermediates VMEM-resident
    algebraic_reassociation (2)  canonicalize commutative (and, with ``exact=False``,
                                 associative) float chains so equivalent spellings
                                 share one shape for cross_stage_cse to hit
    cross_stage_cse         (3)  hash subexpressions across the fused stages (modulo
                                 a uniform offset shift) and hoist repeats into new
                                 temporaries computed once
    temp_demotion           (2)  demote single-interval, zero-offset temporaries to
                                 stage-local values (no field allocation / DMA)

``opt_level`` semantics: 0 = verbatim lowering (no passes), 1 = fusion +
interval splitting (+ numpy stage tiling, a backend-schedule pass living in
``codegen_array.py``), 2 = + structural passes + reassociation, 3 (default)
= everything.  Individual passes toggle via
``backend_opts={"disable_passes": (...,)}`` / ``{"enable_passes": (...)}``;
``backend_opts={"exact": False}`` additionally unlocks the value-changing
(reassociating) rewrites of ``algebraic_reassociation``.

The environment variables ``REPRO_OPT_LEVEL`` and ``REPRO_DISABLE_PASSES``
(comma-separated pass names) shift the *defaults* seen by every stencil
build in the process — the CI pass-matrix leg uses them to re-run the whole
differential corpus with one pass knocked out, so a miscompiling pass fails
with its name in the job title.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import analysis, ir

DEFAULT_OPT_LEVEL = 3

# Backend-schedule passes: toggled through the same ``opt_level`` /
# ``disable_passes`` surface (and folded into the cache fingerprint via the
# pass configuration) but applied inside a code generator rather than as an
# IR → IR transform.  ``numpy_stage_tiling`` lives in ``codegen_array.py``.
SCHEDULE_PASS_NAMES: Tuple[str, ...] = ("numpy_stage_tiling",)


# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------


def impl_stats(impl: ir.StencilImplementation) -> Dict[str, int]:
    """Coarse IR size statistics (what the passes are expected to shrink)."""
    return {
        "multi_stages": len(impl.multi_stages),
        "intervals": sum(len(ms.intervals) for ms in impl.multi_stages),
        "stages": sum(len(itv.stages) for ms in impl.multi_stages for itv in ms.intervals),
        "temporaries": len(impl.temporaries),
        "locals": len(impl.local_decls),
    }


@dataclass
class PassContext:
    """Shared state of one pipeline run: configuration + per-pass records."""

    opt_level: int = DEFAULT_OPT_LEVEL
    # IEEE-exact mode (default): passes may only apply bit-preserving
    # rewrites.  ``exact=False`` (via backend_opts) additionally legalizes
    # value-changing but algebraically-valid rewrites (reassociation).
    exact: bool = True
    records: List[Dict[str, Any]] = field(default_factory=list)
    # per-pass structured detail (e.g. CSE's eliminated-occurrence count),
    # stashed by Pass.apply and folded into the next record
    _detail: Optional[Dict[str, Any]] = None

    def set_detail(self, detail: Dict[str, Any]) -> None:
        self._detail = dict(detail)

    def pop_detail(self) -> Optional[Dict[str, Any]]:
        d, self._detail = self._detail, None
        return d

    def record(
        self,
        name: str,
        seconds: float,
        before: Dict[str, int],
        after: Dict[str, int],
        changed: bool,
    ) -> None:
        rec = {
            "pass": name,
            "seconds": seconds,
            "before": before,
            "after": after,
            "changed": changed,
        }
        detail = self.pop_detail()
        if detail is not None:
            rec["detail"] = detail
        self.records.append(rec)


class Pass:
    """A named, toggleable IR → IR transform."""

    name: str = "pass"
    min_opt_level: int = 1

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        raise NotImplementedError

    def __call__(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        before = impl_stats(impl)
        t0 = time.perf_counter()
        out = self.apply(impl, ctx)
        seconds = time.perf_counter() - t0
        # structural (deep) inequality: passes may rewrite expressions without
        # moving any of the coarse stats
        ctx.record(self.name, seconds, before, impl_stats(out), out != impl)
        return out


# ---------------------------------------------------------------------------
# Pass 1: constant / scalar folding
# ---------------------------------------------------------------------------

_BINOP_FOLD = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
    "and": lambda a, b: bool(a and b),
    "or": lambda a, b: bool(a or b),
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# Pure math builtins safe to evaluate at compile time (python floats are IEEE
# doubles, exactly what the generated code computes on literal operands).
_NATIVE_FOLD = {
    "abs": abs,
    "min": min,
    "max": max,
    # floored modulo, matching np.mod/jnp.mod (and python %) — NOT math.fmod
    "mod": lambda a, b: a % b,
    "sqrt": math.sqrt,
    "exp": math.exp,
    "log": math.log,
    "log2": math.log2,
    "pow": pow,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "arcsin": math.asin,
    "arccos": math.acos,
    "arctan": math.atan,
    "sinh": math.sinh,
    "cosh": math.cosh,
    "tanh": math.tanh,
    "erf": math.erf,
    "erfc": math.erfc,
    "floor": math.floor,
    "ceil": math.ceil,
    "trunc": math.trunc,
    "isfinite": math.isfinite,
    "isnan": math.isnan,
}


def _literal(value: Any) -> ir.Literal:
    if isinstance(value, bool):
        return ir.Literal(value, "bool")
    if isinstance(value, int):
        return ir.Literal(value, "int")
    return ir.Literal(float(value), "float")


def _is_float_lit(e: ir.Expr, value: float) -> bool:
    return isinstance(e, ir.Literal) and e.dtype == "float" and e.value == value


def _fold_expr_node(e: ir.Expr) -> ir.Expr:
    """Fold one node whose children are already folded.  Anything that could
    raise (division by zero, domain errors) is left for the runtime."""
    if isinstance(e, ir.UnaryOp) and isinstance(e.operand, ir.Literal):
        if e.op == "-" and e.operand.dtype in ("int", "float"):
            return ir.Literal(-e.operand.value, e.operand.dtype)
        if e.op == "not":
            return ir.Literal(not e.operand.value, "bool")
    if isinstance(e, ir.BinOp):
        left, right = e.left, e.right
        if isinstance(left, ir.Literal) and isinstance(right, ir.Literal):
            fn = _BINOP_FOLD.get(e.op)
            if fn is not None:
                try:
                    return _literal(fn(left.value, right.value))
                except Exception:
                    return e
        # value-preserving identities (IEEE-exact: x·1, x/1, x−0 preserve every
        # input bit-for-bit; x+0 does NOT — it flips −0.0 to +0.0 — so it is
        # deliberately absent)
        if e.op == "*" and _is_float_lit(right, 1.0):
            return left
        if e.op == "*" and _is_float_lit(left, 1.0):
            return right
        if e.op == "/" and _is_float_lit(right, 1.0):
            return left
        if e.op == "-" and _is_float_lit(right, 0.0):
            return left
    if isinstance(e, ir.TernaryOp) and isinstance(e.cond, ir.Literal):
        return e.true_expr if e.cond.value else e.false_expr
    if isinstance(e, ir.NativeCall) and all(isinstance(a, ir.Literal) for a in e.args):
        fn = _NATIVE_FOLD.get(e.func)
        if fn is not None:
            try:
                return _literal(fn(*[a.value for a in e.args]))
            except Exception:
                return e
    if isinstance(e, ir.Cast) and isinstance(e.expr, ir.Literal):
        # only value-exact casts fold: narrowing (float32/bfloat16, or an
        # int literal outside the target's range, which wraps at runtime)
        # would change the value the runtime computes.
        _INT_BITS = {"int32": 32, "int64": 64}
        if (
            e.dtype in _INT_BITS
            and e.expr.dtype == "int"
            and -(2 ** (_INT_BITS[e.dtype] - 1)) <= e.expr.value < 2 ** (_INT_BITS[e.dtype] - 1)
        ):
            return e.expr
        if e.dtype == "float64" and e.expr.dtype in ("int", "float", "bool"):
            return ir.Literal(float(e.expr.value), "float")
    return e


def _fold_stmt(s: ir.Stmt) -> List[ir.Stmt]:
    if isinstance(s, ir.Assign):
        return [ir.Assign(s.target, ir.map_exprs_bottom_up(s.value, _fold_expr_node))]
    if isinstance(s, ir.If):
        cond = ir.map_exprs_bottom_up(s.cond, _fold_expr_node)
        body = [f for b in s.body for f in _fold_stmt(b)]
        orelse = [f for b in s.orelse for f in _fold_stmt(b)]
        if isinstance(cond, ir.Literal):
            return body if cond.value else orelse
        if not body and not orelse:
            return []
        if not body:  # folded-away then-branch: invert so no backend emits an empty block
            return [ir.If(ir.UnaryOp("not", cond), tuple(orelse))]
        return [ir.If(cond, tuple(body), tuple(orelse))]
    if isinstance(s, ir.While):
        cond = ir.map_exprs_bottom_up(s.cond, _fold_expr_node)
        if isinstance(cond, ir.Literal) and not cond.value:
            return []
        return [ir.While(cond, tuple(f for b in s.body for f in _fold_stmt(b)))]
    return [s]


class ConstantFolding(Pass):
    """Fold literal arithmetic, prune dead conditional branches, and apply
    value-preserving algebraic identities in stage expressions.

    Legality: folding mirrors exactly what the generated code would compute —
    python-float (IEEE double) arithmetic on literal operands; anything that
    could raise or change a value (narrowing casts, division by zero) is left
    in place.
    """

    name = "constant_folding"
    min_opt_level = 3

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        changed = False
        multi_stages: List[ir.MultiStage] = []
        for ms in impl.multi_stages:
            intervals: List[ir.MultiStageInterval] = []
            for itv in ms.intervals:
                stages: List[ir.Stage] = []
                for st in itv.stages:
                    stmts = tuple(f for s in st.stmts for f in _fold_stmt(s))
                    if stmts != st.stmts:
                        changed = True
                    if stmts:
                        stages.append(ir.make_stage(stmts, st.compute_extent))
                if stages:
                    intervals.append(ir.MultiStageInterval(itv.interval, tuple(stages)))
            if intervals:
                multi_stages.append(ir.MultiStage(ms.order, tuple(intervals)))
        if not changed:
            return impl
        impl = dataclasses.replace(impl, multi_stages=tuple(multi_stages))
        # folding may have killed reads → temporaries can die, extents shrink
        return analysis.recompute_implementation(impl)


# ---------------------------------------------------------------------------
# Pass 2: dead-temporary pruning
# ---------------------------------------------------------------------------


class DeadTempPruning(Pass):
    """Drop temporaries that are never read (and the stages that only feed
    them) and shrink all extents to what the surviving statements require.

    Legality: temporaries are never observable outside the stencil (paper
    §2.2), so removing unread ones cannot change any output.
    """

    name = "dead_temp_pruning"
    min_opt_level = 2

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        return analysis.recompute_implementation(impl)


# ---------------------------------------------------------------------------
# Pass 3: vertical interval splitting (boundary specialization)
# ---------------------------------------------------------------------------


def _ms_writes(ms: ir.MultiStage) -> set:
    return {w for itv in ms.intervals for st in itv.stages for w in st.writes}


def _interval_carry_free(itv: ir.MultiStageInterval, writes: set) -> bool:
    """True when no statement of ``itv`` reads a multi-stage-written field at
    a nonzero vertical offset — the interval has no loop-carried input, so
    its levels are independent of the sweep."""
    for st in itv.stages:
        for stmt in st.stmts:
            for rname, off in ir.stmt_reads(stmt):
                if off[2] != 0 and rname in writes:
                    return False
    return True


class IntervalSplitting(Pass):
    """Peel boundary intervals with no loop-carried input off FORWARD /
    BACKWARD multi-stages into their own *PARALLEL* multi-stages — the
    boundary specialization of the ROADMAP: the first/last levels of a sweep
    (``interval(0, 1)`` inits, ``interval(-1, None)`` closures) usually seed
    or drain the recurrence without depending on it, so they become
    vectorized blocks and the steady-state interior ``fori_loop`` carries
    only the true recurrence state.

    Mechanics: intervals are considered in execution order (descending for
    BACKWARD).  The leading run of *carry-free* intervals — no read of any
    field written in this multi-stage at a nonzero vertical offset — is
    peeled into a PARALLEL multi-stage placed before the remaining sweep;
    the trailing run is peeled symmetrically after it.  A multi-stage whose
    every interval is carry-free converts to PARALLEL outright (a "sweep"
    with no recurrence at all).

    Legality:

    * Both the sequential and PARALLEL emitters execute one interval at a
      time, stage by stage, so peeling whole intervals preserves statement
      order exactly; within a carry-free interval, converting the per-level
      loop to one vectorized block is observationally identical because no
      statement reads multi-stage-written state at a vertical offset (and
      horizontal reads never cross k-planes).
    * Peeled intervals are mutually independent (disjoint k-slabs, no
      carried reads), so each peeled run is re-sorted into ascending order —
      this lets ``interval_merging`` re-merge identical boundary bodies that
      a BACKWARD sweep stored descending.
    * A peel may reclassify a sweep-local temporary as cross-multi-stage
      state (``analysis.sequential_carry_plan`` would then carry it as a
      full 3-D array instead of a rolling window).  Every candidate peel is
      therefore checked against the carry plan of the whole stencil and
      rejected if it would increase ``(full carries, window depth)``
      lexicographically — splitting never pessimizes the k-blocked schedule.

    The peeled-interval count is reported as ``intervals_split`` in the pass
    record's ``detail`` (surfaced via ``exec_info["pass_report"]`` and the
    smoke bench).
    """

    name = "interval_splitting"
    min_opt_level = 1

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        detail = {"intervals_split": 0, "parallelized_sweeps": 0, "rejected_by_carry_guard": 0}
        current = impl
        changed = False
        mi = 0
        while mi < len(current.multi_stages):
            ms = current.multi_stages[mi]
            if ms.order == ir.IterationOrder.PARALLEL:
                mi += 1
                continue
            pieces = self._peel(ms)
            if pieces is None:
                mi += 1
                continue
            trial = dataclasses.replace(
                current,
                multi_stages=current.multi_stages[:mi] + tuple(pieces) + current.multi_stages[mi + 1:],
            )
            if self._carry_totals(trial) > self._carry_totals(current):
                detail["rejected_by_carry_guard"] += 1
                mi += 1
                continue
            detail["intervals_split"] += sum(
                len(p.intervals) for p in pieces if p.order == ir.IterationOrder.PARALLEL
            )
            if all(p.order == ir.IterationOrder.PARALLEL for p in pieces):
                detail["parallelized_sweeps"] += 1
            current = trial
            changed = True
            mi += len(pieces)
        ctx.set_detail(detail)
        if not changed:
            return impl
        # peeled intervals now run under PARALLEL extent semantics (vertical
        # reads become real k-extents, not loop-carried) → re-analyze
        return analysis.recompute_implementation(current)

    @staticmethod
    def _peel(ms: ir.MultiStage) -> Optional[List[ir.MultiStage]]:
        writes = _ms_writes(ms)
        flags = [_interval_carry_free(itv, writes) for itv in ms.intervals]
        n = len(flags)
        p = 0
        while p < n and flags[p]:
            p += 1
        q = n
        while q > p and flags[q - 1]:
            q -= 1
        if p == 0 and q == n:
            return None  # nothing carry-free at either boundary

        def parallel_piece(intervals) -> ir.MultiStage:
            ordered = sorted(intervals, key=lambda itv: itv.interval.start.key())
            return ir.MultiStage(ir.IterationOrder.PARALLEL, tuple(ordered))

        pieces: List[ir.MultiStage] = []
        if p:
            pieces.append(parallel_piece(ms.intervals[:p]))
        if q > p:
            pieces.append(ir.MultiStage(ms.order, tuple(ms.intervals[p:q])))
        if q < n:
            pieces.append(parallel_piece(ms.intervals[q:]))
        return pieces

    @staticmethod
    def _carry_totals(impl: ir.StencilImplementation) -> Tuple[int, int]:
        """(full 3-D carries, summed window depth) across all sweeps — the
        nk-independent lexicographic size of the carried state."""
        plans = analysis.sequential_carry_plan(impl)
        full = sum(len(p.full) for p in plans.values())
        depth = sum(d for p in plans.values() for _, d in p.window)
        return (full, depth)


# ---------------------------------------------------------------------------
# Pass 4: k-interval merging
# ---------------------------------------------------------------------------


class IntervalMerging(Pass):
    """Merge adjacent vertical intervals whose stage bodies are structurally
    identical into a single interval (fewer loop bounds, larger fused blocks).

    Legality: the merged interval executes the same statements over the union
    k-range; bodies are compared with structural equality (same statements
    AND same compute extents), and only representation-adjacent bounds merge,
    so the rewrite is domain-size independent.  For BACKWARD multi-stages the
    interval list is stored in execution (descending) order, so adjacency is
    checked in the reversed direction.

    PARALLEL multi-stages additionally require the body to read no
    body-written field at a nonzero vertical offset: per-interval execution
    completes a writer stage over one slab before a reader stage looks up or
    down within it, so merging the slabs would let the reader observe planes
    the original schedule had not yet written (the ``t`` / ``t[0, 0, 1]``
    miscompile the differential fuzzer caught).
    """

    name = "interval_merging"
    min_opt_level = 2

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        multi_stages: List[ir.MultiStage] = []
        for ms in impl.multi_stages:
            backward = ms.order == ir.IterationOrder.BACKWARD
            parallel = ms.order == ir.IterationOrder.PARALLEL
            merged: List[ir.MultiStageInterval] = []
            for itv in ms.intervals:
                if (
                    merged
                    and ir.stages_structurally_equal(merged[-1].stages, itv.stages)
                    and (not parallel or self._parallel_merge_safe(itv.stages))
                ):
                    prev = merged[-1]
                    if not backward and ir.intervals_adjacent(prev.interval, itv.interval):
                        merged[-1] = ir.MultiStageInterval(
                            ir.interval_span(prev.interval, itv.interval), prev.stages
                        )
                        continue
                    if backward and ir.intervals_adjacent(itv.interval, prev.interval):
                        merged[-1] = ir.MultiStageInterval(
                            ir.interval_span(itv.interval, prev.interval), prev.stages
                        )
                        continue
                merged.append(itv)
            multi_stages.append(ir.MultiStage(ms.order, tuple(merged)))
        return dataclasses.replace(impl, multi_stages=tuple(multi_stages))

    @staticmethod
    def _parallel_merge_safe(stages: Tuple[ir.Stage, ...]) -> bool:
        """No vertical read of a body-written field → slab merge is exact."""
        writes = {w for st in stages for w in st.writes}
        for st in stages:
            for stmt in st.stmts:
                for rname, off in ir.stmt_reads(stmt):
                    if off[2] != 0 and rname in writes:
                        return False
        return True


# ---------------------------------------------------------------------------
# Pass 5: multi-stage fusion
# ---------------------------------------------------------------------------


class MultiStageFusion(Pass):
    """Fuse adjacent PARALLEL multi-stages into one — the GridTools fusion
    that lets the Pallas backend keep all intermediate stages VMEM-resident
    instead of round-tripping through HBM between kernels.

    Two compatible shapes:

    * identical single-interval structure → stages are concatenated into the
      shared interval (enables cross-computation temporary demotion);
    * anything else → the interval lists are concatenated *in order*.  Our
      backends execute a PARALLEL multi-stage interval-by-interval,
      stage-by-stage, each statement fully vectorized over its region, so
      concatenation preserves the original statement order exactly — which
      makes it unconditionally legal.  Sequential (FORWARD/BACKWARD)
      multi-stages never fuse: their k-sweep ordering is semantic.
    """

    name = "multistage_fusion"
    min_opt_level = 1

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        fused: List[ir.MultiStage] = []
        for ms in impl.multi_stages:
            if (
                fused
                and ms.order == ir.IterationOrder.PARALLEL
                and fused[-1].order == ir.IterationOrder.PARALLEL
            ):
                prev = fused.pop()
                if (
                    len(prev.intervals) == 1
                    and len(ms.intervals) == 1
                    and prev.intervals[0].interval == ms.intervals[0].interval
                ):
                    intervals = (
                        ir.MultiStageInterval(
                            prev.intervals[0].interval,
                            tuple(prev.intervals[0].stages) + tuple(ms.intervals[0].stages),
                        ),
                    )
                else:
                    intervals = tuple(prev.intervals) + tuple(ms.intervals)
                fused.append(ir.MultiStage(ir.IterationOrder.PARALLEL, intervals))
            else:
                fused.append(ms)
        return dataclasses.replace(impl, multi_stages=tuple(fused))


# ---------------------------------------------------------------------------
# Pass 6: algebraic reassociation / commutative canonicalization
# ---------------------------------------------------------------------------

_COMMUTATIVE_OPS = {"+", "*"}


def _expr_sort_key(e: ir.Expr) -> Tuple:
    """Deterministic structural ordering key for commutative canonicalization.

    Field offsets participate as *numeric* tuples, so two operand lists that
    differ only by a uniform offset shift sort into the same relative order —
    which keeps this canonicalization composable with ``cross_stage_cse``'s
    shift-canonical matching.
    """
    if isinstance(e, ir.Literal):
        return ("0literal", e.dtype, repr(e.value))
    if isinstance(e, ir.ScalarRef):
        return ("1scalar", e.name)
    if isinstance(e, ir.FieldAccess):
        return ("2field", e.name, tuple(int(x) for x in e.offset))
    if isinstance(e, ir.UnaryOp):
        return ("3unary", e.op, _expr_sort_key(e.operand))
    if isinstance(e, ir.BinOp):
        return ("4bin", e.op, _expr_sort_key(e.left), _expr_sort_key(e.right))
    if isinstance(e, ir.TernaryOp):
        return (
            "5ternary",
            _expr_sort_key(e.cond),
            _expr_sort_key(e.true_expr),
            _expr_sort_key(e.false_expr),
        )
    if isinstance(e, ir.NativeCall):
        return ("6call", e.func) + tuple(_expr_sort_key(a) for a in e.args)
    if isinstance(e, ir.Cast):
        return ("7cast", e.dtype, _expr_sort_key(e.expr))
    return ("9other", repr(e))


def _flatten_chain(e: ir.Expr, op: str) -> List[ir.Expr]:
    if isinstance(e, ir.BinOp) and e.op == op:
        return _flatten_chain(e.left, op) + _flatten_chain(e.right, op)
    return [e]


def _rebuild_chain(op: str, terms: List[ir.Expr]) -> ir.Expr:
    out = terms[0]
    for t in terms[1:]:
        out = ir.BinOp(op, out, t)
    return out


class AlgebraicReassociation(Pass):
    """Canonicalize commutative float chains so algebraically-equal spellings
    share one structural shape, which is what ``cross_stage_cse`` hashes —
    ``u * v`` and ``v * u`` (or k-shifted neighbor sums written in either
    order) collapse into one hoisted temporary instead of two misses.

    Two tiers, split by IEEE legality:

    * **Commutative canonicalization** (always on): operands of ``+`` / ``*``
      are ordered by a deterministic structural key.  IEEE-754 addition and
      multiplication are commutative *including* rounding — ``a + b`` and
      ``b + a`` produce the same bits — so this tier is exact and safe for
      the bit-identical differential suite.
    * **Reassociation** (only with ``backend_opts={"exact": False}``): whole
      same-op chains are flattened, sorted, and rebuilt left-associated
      (``a + (b + c)`` → ``(a + b) + c`` with sorted terms).  Changing the
      association changes rounding, so users must explicitly waive bit
      reproducibility — the flag travels with the pass configuration into
      the cache fingerprint.

    Node-rewrite counts surface as ``commuted`` / ``reassociated`` in the
    pass record's ``detail``.
    """

    name = "algebraic_reassociation"
    min_opt_level = 2

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        counts = {"commuted": 0, "reassociated": 0, "exact": ctx.exact}
        exact = ctx.exact

        def canon(e: ir.Expr) -> ir.Expr:
            if not (isinstance(e, ir.BinOp) and e.op in _COMMUTATIVE_OPS):
                return e
            if not exact:
                terms = _flatten_chain(e, e.op)
                if len(terms) > 2:
                    rebuilt = _rebuild_chain(e.op, sorted(terms, key=_expr_sort_key))
                    if rebuilt != e:
                        counts["reassociated"] += 1
                        return rebuilt
                    return e
            if _expr_sort_key(e.right) < _expr_sort_key(e.left):
                counts["commuted"] += 1
                return ir.BinOp(e.op, e.right, e.left)
            return e

        changed = False
        multi_stages: List[ir.MultiStage] = []
        for ms in impl.multi_stages:
            intervals: List[ir.MultiStageInterval] = []
            for itv in ms.intervals:
                stages: List[ir.Stage] = []
                for st in itv.stages:
                    stmts = tuple(ir.map_stmt_exprs(s, canon) for s in st.stmts)
                    if stmts != st.stmts:
                        changed = True
                        stages.append(ir.make_stage(stmts, st.compute_extent))
                    else:
                        stages.append(st)
                intervals.append(ir.MultiStageInterval(itv.interval, tuple(stages)))
            multi_stages.append(ir.MultiStage(ms.order, tuple(intervals)))
        ctx.set_detail(counts)
        if not changed:
            return impl
        # pure expression-shape rewrite: accesses, extents and liveness are
        # untouched, so no re-analysis is needed
        return dataclasses.replace(impl, multi_stages=tuple(multi_stages))


# ---------------------------------------------------------------------------
# Pass 7: cross-stage common-subexpression elimination
# ---------------------------------------------------------------------------


_BOOL_BINOPS = {"<", ">", "<=", ">=", "==", "!=", "and", "or"}
_BOOL_NATIVES = {"isnan", "isfinite"}


class _DtypeConflict(Exception):
    """Raised when a subexpression mixes distinct concrete dtypes."""


def _infer_expr_dtype(
    e: ir.Expr,
    field_dtype: Dict[str, str],
    scalar_dtype: Dict[str, str],
) -> Optional[str]:
    """Concrete dtype of ``e``, None when only weak literals constrain it.

    Raises :class:`_DtypeConflict` on mixed concrete dtypes — the CSE pass
    skips such expressions rather than guess a promotion rule.
    """

    def unify(a: Optional[str], b: Optional[str]) -> Optional[str]:
        if a is None:
            return b
        if b is None or a == b:
            return a
        raise _DtypeConflict(f"{a} vs {b}")

    if isinstance(e, ir.Literal):
        return "bool" if e.dtype == "bool" else None
    if isinstance(e, ir.ScalarRef):
        return scalar_dtype.get(e.name)
    if isinstance(e, ir.FieldAccess):
        return field_dtype.get(e.name)
    if isinstance(e, ir.UnaryOp):
        inner = _infer_expr_dtype(e.operand, field_dtype, scalar_dtype)
        return "bool" if e.op == "not" else inner
    if isinstance(e, ir.BinOp):
        left = _infer_expr_dtype(e.left, field_dtype, scalar_dtype)
        right = _infer_expr_dtype(e.right, field_dtype, scalar_dtype)
        if e.op in _BOOL_BINOPS:
            return "bool"
        return unify(left, right)
    if isinstance(e, ir.TernaryOp):
        return unify(
            _infer_expr_dtype(e.true_expr, field_dtype, scalar_dtype),
            _infer_expr_dtype(e.false_expr, field_dtype, scalar_dtype),
        )
    if isinstance(e, ir.NativeCall):
        if e.func in _BOOL_NATIVES:
            return "bool"
        out: Optional[str] = None
        for a in e.args:
            out = unify(out, _infer_expr_dtype(a, field_dtype, scalar_dtype))
        return out
    if isinstance(e, ir.Cast):
        return e.dtype
    return None


def _expr_weight(e: ir.Expr) -> Tuple[int, int]:
    """(op_count, field_access_count) of ``e`` — the hoisting-worthiness metric."""
    ops = accesses = 0
    for node in ir.walk_exprs(e):
        if isinstance(node, ir.FieldAccess):
            accesses += 1
        elif isinstance(node, (ir.BinOp, ir.UnaryOp, ir.TernaryOp, ir.NativeCall, ir.Cast)):
            ops += 1
    return ops, accesses


def _cse_worthwhile(e: ir.Expr) -> bool:
    """Worth a temporary: compound, and either touches >= 2 field values or
    performs >= 2 operations on at least one (single accesses / bare
    negations are cheaper re-done than materialized)."""
    if not isinstance(e, (ir.BinOp, ir.UnaryOp, ir.TernaryOp, ir.NativeCall, ir.Cast)):
        return False
    ops, accesses = _expr_weight(e)
    return accesses >= 2 or (ops >= 2 and accesses >= 1)


def _canonicalize(e: ir.Expr) -> Tuple[Optional[ir.Expr], Tuple[int, int, int]]:
    """Shift ``e`` so its first field access sits at zero offset.

    Two subexpressions that differ only by a uniform offset shift (the
    ``gcv`` / ``gcv(k-1)`` motif of tridiagonal assembly) share a canonical
    form and can be computed once.  Returns (canonical expr, shift) where
    ``e == shift_accesses(canonical, shift)``; (None, 0-shift) when ``e``
    contains no field access.
    """
    for node in ir.walk_exprs(e):
        if isinstance(node, ir.FieldAccess):
            shift = node.offset
            if shift == (0, 0, 0):
                return e, shift
            neg = (-shift[0], -shift[1], -shift[2])
            return ir.shift_accesses(e, neg), shift
    return None, (0, 0, 0)


def _shifted_interval(
    itv: ir.VerticalInterval, lo: int, hi: int
) -> Optional[ir.VerticalInterval]:
    """The interval covering ``itv`` shifted by every k in [lo, hi] — where a
    k-shifted hoist must evaluate.  None when not representable as axis
    bounds (the hoist is then rejected)."""
    try:
        return ir.VerticalInterval(
            ir.AxisBound(itv.start.level, itv.start.offset + lo),
            ir.AxisBound(itv.end.level, itv.end.offset + hi),
        )
    except ValueError:
        return None


class CrossStageCSE(Pass):
    """Hoist subexpressions repeated across the stages of a PARALLEL
    multi-stage interval (modulo a uniform offset shift) into a temporary
    computed once — typical wins are the shifted neighbor-sum / coefficient
    chains of tridiagonal assembly, which otherwise recompute per stage.

    Legality:

    * Only PARALLEL multi-stages participate: sequential sweeps carry
      loop-order semantics where a k-shifted occurrence reads a *different
      iteration's* value of any field written in the sweep.
    * A repeat is only hoisted when no stage between (and including) its
      first and last occurrence writes any field the expression reads, so
      every occurrence provably sees identical operand values.
    * Occurrences whose shifts agree on k insert the defining stage right
      before the first use, inside the same interval.  Occurrences that
      differ by a *vertical* shift evaluate the expression at k-planes
      outside the source interval, so the defining stage is emitted in its
      own vertical interval spanning the union of evaluation planes — which
      is exactly the set of planes some occurrence already evaluated the
      expression at, so every operand read stays in-domain.  (Such hoists
      additionally require that *no* stage up to the last occurrence writes
      an operand, since the defining interval runs before the whole source
      interval.)  Unrepresentable unions reject the hoist.
    * Occurrences are collected from top-level assignment expressions only;
      statements nested in conditionals keep their expressions (the masked
      write machinery stays untouched).
    * The hoisted temporary's dtype is structurally inferred; expressions
      mixing concrete dtypes are skipped rather than promoted.

    The vectorized backends evaluate the hoisted statement over the union of
    its readers' extents — exactly the regions the occurrences covered.
    Eliminated-occurrence counts are reported via the pass record's
    ``detail`` (surfaced in ``exec_info["pass_report"]``).
    """

    name = "cross_stage_cse"
    min_opt_level = 3

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        field_dtype = {f.name: f.dtype for f in impl.all_fields}
        scalar_dtype = {s.name: s.dtype for s in impl.scalars}
        taken = set(field_dtype) | set(scalar_dtype)
        new_temps: List[ir.FieldDecl] = []
        eliminated = 0
        counter = 0

        def fresh_name() -> str:
            nonlocal counter
            while True:
                name = f"_cse{counter}"
                counter += 1
                if name not in taken:
                    taken.add(name)
                    return name

        multi_stages: List[ir.MultiStage] = []
        for ms in impl.multi_stages:
            if ms.order != ir.IterationOrder.PARALLEL:
                multi_stages.append(ms)
                continue
            intervals: List[ir.MultiStageInterval] = []
            for itv in ms.intervals:
                stages = list(itv.stages)
                defines: List[ir.MultiStageInterval] = []
                rejected: set = set()
                while True:
                    hoist = self._pick_hoist(stages, rejected)
                    if hoist is None:
                        break
                    key, occurrences = hoist
                    try:
                        dtype = _infer_expr_dtype(key, field_dtype, scalar_dtype)
                    except _DtypeConflict:
                        dtype = None
                    if dtype is None:
                        rejected.add(key)  # untypeable: leave it in place
                        continue
                    # Re-base the canonical so the occurrence-shift hull
                    # contains zero on every axis: the Extent model pads
                    # regions to include the origin, so any other base would
                    # over-approximate the operands' halos (and can demand
                    # halo the user never allocated).
                    base = tuple(min(s[ax] for _, s in occurrences) for ax in range(3))
                    shifts = [
                        (s[0] - base[0], s[1] - base[1], s[2] - base[2])
                        for _, s in occurrences
                    ]
                    k_shifts = sorted(s[2] for s in shifts)
                    define_itv = itv.interval
                    if k_shifts[0] != 0 or k_shifts[-1] != 0:
                        define_itv = _shifted_interval(itv.interval, k_shifts[0], k_shifts[-1])
                        if define_itv is None:
                            rejected.add(key)  # evaluation range unrepresentable
                            continue
                    temp = fresh_name()
                    first = min(idx for idx, _ in occurrences)
                    stages = self._rewrite(stages, key, temp, base)
                    define = ir.make_stage(
                        (ir.Assign(ir.FieldAccess(temp, (0, 0, 0)), ir.shift_accesses(key, base)),),
                        ir.Extent.zero(),
                    )
                    if define_itv is itv.interval:
                        stages.insert(first, define)
                    else:
                        defines.append(ir.MultiStageInterval(define_itv, (define,)))
                    new_temps.append(ir.FieldDecl(temp, dtype, ir.AXES_IJK, is_api=False))
                    field_dtype[temp] = dtype
                    eliminated += len(occurrences) - 1
                intervals.extend(defines)
                intervals.append(ir.MultiStageInterval(itv.interval, tuple(stages)))
            multi_stages.append(ir.MultiStage(ms.order, tuple(intervals)))

        ctx.set_detail({"hoisted": len(new_temps), "eliminated": eliminated})
        if not new_temps:
            return impl
        impl = dataclasses.replace(
            impl,
            multi_stages=tuple(multi_stages),
            temporaries=tuple(impl.temporaries) + tuple(new_temps),
        )
        # new defining stages need compute extents; reader extents may grow
        return analysis.recompute_implementation(impl)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _collect(
        stages: List[ir.Stage], rejected: set
    ) -> Dict[ir.Expr, List[Tuple[int, Tuple[int, int, int]]]]:
        occ: Dict[ir.Expr, List[Tuple[int, Tuple[int, int, int]]]] = {}
        for idx, st in enumerate(stages):
            for stmt in st.stmts:
                if not isinstance(stmt, ir.Assign):
                    continue  # conditionals keep their expressions
                for node in ir.walk_exprs(stmt.value):
                    if not _cse_worthwhile(node):
                        continue
                    key, shift = _canonicalize(node)
                    if key is None or key in rejected:
                        continue
                    occ.setdefault(key, []).append((idx, shift))
        return occ

    def _pick_hoist(
        self, stages: List[ir.Stage], rejected: set
    ) -> Optional[Tuple[ir.Expr, List[Tuple[int, Tuple[int, int, int]]]]]:
        """The biggest legal repeated subexpression, or None."""
        candidates = []
        for key, occurrences in self._collect(stages, rejected).items():
            if len(occurrences) < 2:
                continue
            reads = {e.name for e in ir.walk_exprs(key) if isinstance(e, ir.FieldAccess)}
            lo = min(idx for idx, _ in occurrences)
            hi = max(idx for idx, _ in occurrences)
            if any(shift[2] != 0 for _, shift in occurrences):
                lo = 0  # defining interval runs before the whole source interval
            if any(set(stages[i].writes) & reads for i in range(lo, hi + 1)):
                continue  # an operand is rewritten between occurrences
            ops, accesses = _expr_weight(key)
            candidates.append((len(occurrences), ops + accesses, key, occurrences))
        if not candidates:
            return None
        # most occurrences first, then largest expression; repr breaks ties
        # deterministically so codegen is reproducible
        candidates.sort(key=lambda c: (-c[0], -c[1], repr(c[2])))
        _, _, key, occurrences = candidates[0]
        return key, occurrences

    def _rewrite(
        self, stages: List[ir.Stage], key: ir.Expr, temp: str, base: Tuple[int, int, int]
    ) -> List[ir.Stage]:
        def rewrite_expr(e: ir.Expr) -> ir.Expr:
            if _cse_worthwhile(e):
                canon, shift = _canonicalize(e)
                if canon == key:
                    return ir.FieldAccess(
                        temp, (shift[0] - base[0], shift[1] - base[1], shift[2] - base[2])
                    )
            if isinstance(e, ir.UnaryOp):
                return ir.UnaryOp(e.op, rewrite_expr(e.operand))
            if isinstance(e, ir.BinOp):
                return ir.BinOp(e.op, rewrite_expr(e.left), rewrite_expr(e.right))
            if isinstance(e, ir.TernaryOp):
                return ir.TernaryOp(
                    rewrite_expr(e.cond), rewrite_expr(e.true_expr), rewrite_expr(e.false_expr)
                )
            if isinstance(e, ir.NativeCall):
                return ir.NativeCall(e.func, tuple(rewrite_expr(a) for a in e.args))
            if isinstance(e, ir.Cast):
                return ir.Cast(e.dtype, rewrite_expr(e.expr))
            return e

        out: List[ir.Stage] = []
        for st in stages:
            stmts = tuple(
                ir.Assign(s.target, rewrite_expr(s.value)) if isinstance(s, ir.Assign) else s
                for s in st.stmts
            )
            out.append(ir.make_stage(stmts, st.compute_extent) if stmts != st.stmts else st)
        return out


# ---------------------------------------------------------------------------
# Pass 8: temporary demotion
# ---------------------------------------------------------------------------


class TempDemotion(Pass):
    """Demote temporaries to stage-local values: no field allocation, no
    zero-init, no functional slice updates — the vectorized backends bind the
    computed block/plane directly to a variable.

    A temporary demotes when (all conditions checked structurally):

    * every access (read or write) happens inside one multi-stage interval,
      so one bound variable covers its whole live range;
    * every read is at zero offset — the value never crosses the horizontal
      plane or the k-sweep, so no neighborhood/history is needed;
    * every touching stage has the same compute extent — the writer's block
      is shape-identical to every reader's region;
    * its first access is an unconditional top-level write (never in
      ``zero_init_temps``), so the variable is always defined before use;
    * it spans all of I, J, K (frontend default for temporaries).
    """

    name = "temp_demotion"
    min_opt_level = 2

    def apply(self, impl: ir.StencilImplementation, ctx: PassContext) -> ir.StencilImplementation:
        temps = {f.name: f for f in impl.temporaries}
        if not temps:
            return impl

        sites: Dict[str, set] = {n: set() for n in temps}
        read_offsets: Dict[str, set] = {n: set() for n in temps}
        extents: Dict[str, List[ir.Extent]] = {n: [] for n in temps}
        first_access: Dict[str, str] = {}  # name -> 'uncond_write' | 'other'

        for mi, ms in enumerate(impl.multi_stages):
            for ii, itv in enumerate(ms.intervals):
                for st in itv.stages:
                    touched: List[str] = []
                    for stmt in st.stmts:
                        for rname, off in ir.stmt_reads(stmt):
                            if rname in temps:
                                read_offsets[rname].add(off)
                                touched.append(rname)
                        uncond = {stmt.target.name} if isinstance(stmt, ir.Assign) else set()
                        for w in ir.stmt_writes(stmt):
                            if w in temps:
                                touched.append(w)
                                first_access.setdefault(
                                    w, "uncond_write" if w in uncond else "other"
                                )
                    for n in touched:
                        sites[n].add((mi, ii))
                        extents[n].append(st.compute_extent)

        zero_init = set(impl.zero_init_temps)
        demoted: List[ir.FieldDecl] = []
        for name, decl in temps.items():
            if decl.axes != ir.AXES_IJK or name in zero_init:
                continue
            if len(sites[name]) != 1:
                continue
            if any(off != (0, 0, 0) for off in read_offsets[name]):
                continue
            if first_access.get(name) != "uncond_write":
                continue
            exts = extents[name]
            if not exts or any(e != exts[0] for e in exts):
                continue
            demoted.append(decl)

        if not demoted:
            return impl
        names = {d.name for d in demoted}
        return dataclasses.replace(
            impl,
            temporaries=tuple(f for f in impl.temporaries if f.name not in names),
            local_decls=tuple(impl.local_decls) + tuple(demoted),
        )


# ---------------------------------------------------------------------------
# Pipeline assembly
# ---------------------------------------------------------------------------

PIPELINE: Tuple[Pass, ...] = (
    ConstantFolding(),
    DeadTempPruning(),
    IntervalSplitting(),
    IntervalMerging(),
    MultiStageFusion(),
    AlgebraicReassociation(),
    CrossStageCSE(),
    TempDemotion(),
)

PASS_NAMES: Tuple[str, ...] = tuple(p.name for p in PIPELINE)
# every name the disable/enable surface accepts (IR passes + the
# backend-schedule passes applied inside the code generators)
ALL_PASS_NAMES: Tuple[str, ...] = PASS_NAMES + SCHEDULE_PASS_NAMES


def build_pipeline(
    opt_level: int = DEFAULT_OPT_LEVEL,
    disable: Iterable[str] = (),
    enable: Iterable[str] = (),
) -> List[Pass]:
    disable = set(disable)
    enable = set(enable)
    unknown = (disable | enable) - set(ALL_PASS_NAMES)
    if unknown:
        raise ValueError(
            f"unknown pass name(s) {sorted(unknown)}; available: {list(ALL_PASS_NAMES)}"
        )
    selected = []
    for p in PIPELINE:
        on = opt_level >= p.min_opt_level
        if p.name in disable:
            on = False
        if p.name in enable:
            on = True
        if on:
            selected.append(p)
    return selected


def schedule_pass_enabled(
    name: str,
    opt_level: int = DEFAULT_OPT_LEVEL,
    disable: Iterable[str] = (),
    enable: Iterable[str] = (),
    min_opt_level: int = 1,
) -> bool:
    """The ``build_pipeline`` on/off rule applied to a backend-schedule pass
    (``SCHEDULE_PASS_NAMES``) — shared by the code generators so the toggle
    surface stays uniform with the IR passes."""
    assert name in SCHEDULE_PASS_NAMES, name
    on = opt_level >= min_opt_level
    if name in set(disable):
        on = False
    if name in set(enable):
        on = True
    return on


def run_pipeline(
    impl: ir.StencilImplementation,
    opt_level: int = DEFAULT_OPT_LEVEL,
    disable: Iterable[str] = (),
    enable: Iterable[str] = (),
    exact: bool = True,
) -> Tuple[ir.StencilImplementation, List[Dict[str, Any]]]:
    """Apply the configured passes; returns (optimized IR, pass report)."""
    ctx = PassContext(opt_level=int(opt_level), exact=bool(exact))
    for p in build_pipeline(ctx.opt_level, disable, enable):
        impl = p(impl, ctx)
    return impl, ctx.records


def split_backend_opts(backend_opts: Optional[Dict[str, Any]]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split ``backend_opts`` into (pass configuration, codegen options).

    Pass configuration keys: ``opt_level`` (int), ``disable_passes`` /
    ``enable_passes`` (iterables of pass names, including the
    backend-schedule passes of ``SCHEDULE_PASS_NAMES``), and ``exact``
    (bool; ``False`` legalizes value-changing rewrites like reassociation).
    Everything else goes to the backend's source generator (e.g. the Pallas
    ``block`` shape or the numpy ``tile``).

    ``REPRO_OPT_LEVEL`` / ``REPRO_DISABLE_PASSES`` shift the process-wide
    defaults (explicit per-stencil options still win for ``opt_level``;
    env-disabled passes are unioned in) — the CI pass matrix runs the
    differential suite through these.
    """
    opts = dict(backend_opts or {})
    env_level = os.environ.get("REPRO_OPT_LEVEL", "")
    default_level = int(env_level) if env_level else DEFAULT_OPT_LEVEL
    env_disable = {p for p in os.environ.get("REPRO_DISABLE_PASSES", "").split(",") if p}
    cfg = {
        "opt_level": int(opts.pop("opt_level", default_level)),
        "disable": tuple(sorted(set(opts.pop("disable_passes", ())) | env_disable)),
        "enable": tuple(sorted(opts.pop("enable_passes", ()))),
        "exact": bool(opts.pop("exact", True)),
    }
    return cfg, opts
