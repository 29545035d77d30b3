"""Intermediate representations for the GTScript-style stencil DSL.

Two levels, mirroring the paper (GT4Py, §2.3):

* **Definition IR** — what the user wrote: computations / intervals /
  statements with relative field offsets.  Produced by ``frontend.py``.
* **Implementation IR** — what the backends consume: multi-stages with
  scheduled stages, per-stage *compute extents*, classified symbols
  (API fields vs. temporaries vs. scalars) and per-field halo (access)
  extents.  Produced by ``analysis.py``.

All nodes are frozen dataclasses so the whole tree is hashable and a
structural fingerprint (``caching.py``) can be derived from ``repr``.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Iteration / axis machinery
# ---------------------------------------------------------------------------


class IterationOrder(enum.Enum):
    PARALLEL = "parallel"
    FORWARD = "forward"
    BACKWARD = "backward"

    def __repr__(self) -> str:  # stable across python versions, for hashing
        return f"IterationOrder.{self.name}"


class LevelMarker(enum.Enum):
    START = "start"
    END = "end"

    def __repr__(self) -> str:
        return f"LevelMarker.{self.name}"


@dataclass(frozen=True)
class AxisBound:
    """A bound on the vertical axis: ``level + offset``.

    ``AxisBound(START, 0)`` is the first level of the compute domain,
    ``AxisBound(END, 0)`` is one-past the last level (python convention).
    """

    level: LevelMarker
    offset: int = 0

    def __post_init__(self) -> None:
        if self.level == LevelMarker.START and self.offset < 0:
            raise ValueError("start-relative bound cannot have negative offset")
        if self.level == LevelMarker.END and self.offset > 0:
            raise ValueError("end-relative bound cannot have positive offset")

    def resolve(self, nk: int) -> int:
        base = 0 if self.level == LevelMarker.START else nk
        return base + self.offset

    def key(self) -> Tuple[int, int]:
        """Sortable key assuming a 'large enough' domain."""
        return (0, self.offset) if self.level == LevelMarker.START else (1, self.offset)


@dataclass(frozen=True)
class VerticalInterval:
    start: AxisBound
    end: AxisBound

    def resolve(self, nk: int) -> Tuple[int, int]:
        return self.start.resolve(nk), self.end.resolve(nk)

    @staticmethod
    def full() -> "VerticalInterval":
        return VerticalInterval(AxisBound(LevelMarker.START, 0), AxisBound(LevelMarker.END, 0))

    def min_levels(self) -> int:
        """Minimum nk for which this interval is non-empty."""
        s, e = self.start, self.end
        if s.level == e.level:
            return 1 if (e.offset - s.offset) > 0 or s.level == LevelMarker.END else s.offset + 1
        # start-relative .. end-relative: need nk + e.offset > s.offset
        return s.offset - e.offset + 1


# ---------------------------------------------------------------------------
# Extents (halo regions)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Extent:
    """Per-axis (lo, hi) growth of a region; lo <= 0 <= hi."""

    i: Tuple[int, int] = (0, 0)
    j: Tuple[int, int] = (0, 0)
    k: Tuple[int, int] = (0, 0)

    @staticmethod
    def zero() -> "Extent":
        return Extent()

    def union(self, other: "Extent") -> "Extent":
        return Extent(
            (min(self.i[0], other.i[0]), max(self.i[1], other.i[1])),
            (min(self.j[0], other.j[0]), max(self.j[1], other.j[1])),
            (min(self.k[0], other.k[0]), max(self.k[1], other.k[1])),
        )

    def add_offset(self, off: Tuple[int, int, int]) -> "Extent":
        """Extent of a read at ``off`` performed from everywhere in ``self``."""

        def _axis(lohi: Tuple[int, int], o: int) -> Tuple[int, int]:
            return (lohi[0] + min(o, 0), lohi[1] + max(o, 0))

        return Extent(_axis(self.i, off[0]), _axis(self.j, off[1]), _axis(self.k, off[2]))

    def shift(self, off: Tuple[int, int, int]) -> "Extent":
        return Extent(
            (self.i[0] + off[0], self.i[1] + off[0]),
            (self.j[0] + off[1], self.j[1] + off[1]),
            (self.k[0] + off[2], self.k[1] + off[2]),
        )

    @property
    def halo(self) -> Tuple[int, int, int]:
        return (
            max(-self.i[0], self.i[1]),
            max(-self.j[0], self.j[1]),
            max(-self.k[0], self.k[1]),
        )

    def as_tuple(self) -> Tuple[Tuple[int, int], ...]:
        return (self.i, self.j, self.k)


# ---------------------------------------------------------------------------
# Expressions (Definition IR)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Literal(Expr):
    value: Union[int, float, bool]
    dtype: str = "float"  # 'float' | 'int' | 'bool'


@dataclass(frozen=True)
class ScalarRef(Expr):
    """Run-time scalar parameter (keyword-only stencil argument)."""

    name: str


@dataclass(frozen=True)
class FieldAccess(Expr):
    name: str
    offset: Tuple[int, int, int] = (0, 0, 0)


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # '-', '+', 'not'
    operand: Expr


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # '+', '-', '*', '/', '//', '%', '**', 'and', 'or',
    # '<', '>', '<=', '>=', '==', '!='
    left: Expr
    right: Expr


@dataclass(frozen=True)
class TernaryOp(Expr):
    cond: Expr
    true_expr: Expr
    false_expr: Expr


@dataclass(frozen=True)
class NativeCall(Expr):
    """Call to a whitelisted math builtin (min, max, sqrt, exp, ...)."""

    func: str
    args: Tuple[Expr, ...]


@dataclass(frozen=True)
class Cast(Expr):
    dtype: str
    expr: Expr


NATIVE_FUNCTIONS = {
    "abs": 1,
    "min": 2,
    "max": 2,
    "mod": 2,
    "sqrt": 1,
    "exp": 1,
    "log": 1,
    "log2": 1,
    "pow": 2,
    "sin": 1,
    "cos": 1,
    "tan": 1,
    "arcsin": 1,
    "arccos": 1,
    "arctan": 1,
    "sinh": 1,
    "cosh": 1,
    "tanh": 1,
    "erf": 1,
    "erfc": 1,
    "floor": 1,
    "ceil": 1,
    "trunc": 1,
    "isfinite": 1,
    "isnan": 1,
    "sigmoid": 1,
}


# ---------------------------------------------------------------------------
# Statements (Definition IR)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stmt:
    pass


@dataclass(frozen=True)
class Assign(Stmt):
    target: FieldAccess  # write offset must be (0, 0, 0)
    value: Expr


@dataclass(frozen=True)
class If(Stmt):
    cond: Expr
    body: Tuple[Stmt, ...]
    orelse: Tuple[Stmt, ...] = ()


@dataclass(frozen=True)
class While(Stmt):
    """Scalar-condition loop; only valid with compile-time-bounded trip
    counts in generated code (used rarely; supported for completeness)."""

    cond: Expr
    body: Tuple[Stmt, ...]


# ---------------------------------------------------------------------------
# Declarations & stencil definition (Definition IR root)
# ---------------------------------------------------------------------------


AXES_IJK = ("I", "J", "K")


@dataclass(frozen=True)
class FieldDecl:
    name: str
    dtype: str = "float64"
    axes: Tuple[str, ...] = AXES_IJK
    is_api: bool = True  # False => temporary


@dataclass(frozen=True)
class ScalarDecl:
    name: str
    dtype: str = "float64"


@dataclass(frozen=True)
class IntervalBlock:
    interval: VerticalInterval
    body: Tuple[Stmt, ...]


@dataclass(frozen=True)
class ComputationBlock:
    order: IterationOrder
    intervals: Tuple[IntervalBlock, ...]


@dataclass(frozen=True)
class StencilDefinition:
    name: str
    api_fields: Tuple[FieldDecl, ...]
    scalars: Tuple[ScalarDecl, ...]
    computations: Tuple[ComputationBlock, ...]
    externals: Tuple[Tuple[str, Union[int, float, bool]], ...] = ()
    docstring: str = ""

    def field_decl(self, name: str) -> Optional[FieldDecl]:
        for f in self.api_fields:
            if f.name == name:
                return f
        return None


# ---------------------------------------------------------------------------
# Implementation IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stage:
    """A group of statements executed together over ``compute_extent``."""

    stmts: Tuple[Stmt, ...]
    compute_extent: Extent
    writes: Tuple[str, ...]
    reads: Tuple[str, ...]


@dataclass(frozen=True)
class MultiStageInterval:
    interval: VerticalInterval
    stages: Tuple[Stage, ...]


@dataclass(frozen=True)
class MultiStage:
    order: IterationOrder
    intervals: Tuple[MultiStageInterval, ...]


@dataclass(frozen=True)
class StencilImplementation:
    name: str
    api_fields: Tuple[FieldDecl, ...]
    temporaries: Tuple[FieldDecl, ...]
    scalars: Tuple[ScalarDecl, ...]
    multi_stages: Tuple[MultiStage, ...]
    # Access extents: for API fields this is the read halo needed around the
    # compute domain; for temporaries it's the region they must be computed on.
    field_extents: Tuple[Tuple[str, Extent], ...]
    k_extents: Tuple[Tuple[str, Tuple[int, int]], ...]  # vertical read offsets
    externals: Tuple[Tuple[str, Union[int, float, bool]], ...] = ()
    min_k_levels: int = 1
    # temporaries whose first write is conditional → zero-initialized
    zero_init_temps: Tuple[str, ...] = ()
    # temporaries demoted by the pass pipeline to stage-local values: every
    # access is zero-offset inside one multi-stage interval, so the vectorized
    # backends bind them as plain block/plane variables (no field allocation).
    # The debug backend may still allocate them as arrays (it is the oracle,
    # not an optimization target) — their extents stay in ``field_extents``.
    local_decls: Tuple[FieldDecl, ...] = ()

    def extent_of(self, name: str) -> Extent:
        for n, e in self.field_extents:
            if n == name:
                return e
        return Extent.zero()

    @property
    def all_fields(self) -> Tuple[FieldDecl, ...]:
        return tuple(self.api_fields) + tuple(self.temporaries) + tuple(self.local_decls)

    def field(self, name: str) -> FieldDecl:
        for f in self.all_fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def written_api_fields(self) -> Tuple[str, ...]:
        """API fields written by any stage, in first-write order — the one
        definition of "what does this stencil produce" shared by the array
        codegen, ``StencilObject.apply``, and the program tracer/graph."""
        api = {f.name for f in self.api_fields}
        written: list = []
        for ms in self.multi_stages:
            for itv in ms.intervals:
                for st in itv.stages:
                    for w in st.writes:
                        if w in api and w not in written:
                            written.append(w)
        return tuple(written)

    @property
    def max_halo(self) -> Tuple[int, int, int]:
        h = (0, 0, 0)
        for name, e in self.field_extents:
            decl = self.field(name)
            if not decl.is_api:
                continue
            eh = e.halo
            h = (max(h[0], eh[0]), max(h[1], eh[1]), max(h[2], eh[2]))
        return h


# ---------------------------------------------------------------------------
# IR traversal helpers
# ---------------------------------------------------------------------------


def walk_exprs(node: Union[Expr, Stmt]):
    """Yield every Expr reachable from ``node`` (pre-order)."""
    if isinstance(node, Expr):
        yield node
        if isinstance(node, UnaryOp):
            yield from walk_exprs(node.operand)
        elif isinstance(node, BinOp):
            yield from walk_exprs(node.left)
            yield from walk_exprs(node.right)
        elif isinstance(node, TernaryOp):
            yield from walk_exprs(node.cond)
            yield from walk_exprs(node.true_expr)
            yield from walk_exprs(node.false_expr)
        elif isinstance(node, NativeCall):
            for a in node.args:
                yield from walk_exprs(a)
        elif isinstance(node, Cast):
            yield from walk_exprs(node.expr)
    elif isinstance(node, Assign):
        yield from walk_exprs(node.target)
        yield from walk_exprs(node.value)
    elif isinstance(node, If):
        yield from walk_exprs(node.cond)
        for s in node.body:
            yield from walk_exprs(s)
        for s in node.orelse:
            yield from walk_exprs(s)
    elif isinstance(node, While):
        yield from walk_exprs(node.cond)
        for s in node.body:
            yield from walk_exprs(s)


def stmt_reads(stmt: Stmt):
    """Yield (name, offset) for every field read in ``stmt``."""
    if isinstance(stmt, Assign):
        for e in walk_exprs(stmt.value):
            if isinstance(e, FieldAccess):
                yield e.name, e.offset
    elif isinstance(stmt, If):
        for e in walk_exprs(stmt.cond):
            if isinstance(e, FieldAccess):
                yield e.name, e.offset
        for s in tuple(stmt.body) + tuple(stmt.orelse):
            yield from stmt_reads(s)
    elif isinstance(stmt, While):
        for e in walk_exprs(stmt.cond):
            if isinstance(e, FieldAccess):
                yield e.name, e.offset
        for s in stmt.body:
            yield from stmt_reads(s)


def stmt_writes(stmt: Stmt):
    """Yield field names written by ``stmt``."""
    if isinstance(stmt, Assign):
        yield stmt.target.name
    elif isinstance(stmt, If):
        for s in tuple(stmt.body) + tuple(stmt.orelse):
            yield from stmt_writes(s)
    elif isinstance(stmt, While):
        for s in stmt.body:
            yield from stmt_writes(s)


def map_field_accesses(node, fn):
    """Rebuild ``node`` applying ``fn(FieldAccess) -> Expr`` to every access."""
    if isinstance(node, FieldAccess):
        return fn(node)
    if isinstance(node, (Literal, ScalarRef)):
        return node
    if isinstance(node, UnaryOp):
        return UnaryOp(node.op, map_field_accesses(node.operand, fn))
    if isinstance(node, BinOp):
        return BinOp(node.op, map_field_accesses(node.left, fn), map_field_accesses(node.right, fn))
    if isinstance(node, TernaryOp):
        return TernaryOp(
            map_field_accesses(node.cond, fn),
            map_field_accesses(node.true_expr, fn),
            map_field_accesses(node.false_expr, fn),
        )
    if isinstance(node, NativeCall):
        return NativeCall(node.func, tuple(map_field_accesses(a, fn) for a in node.args))
    if isinstance(node, Cast):
        return Cast(node.dtype, map_field_accesses(node.expr, fn))
    if isinstance(node, Assign):
        tgt = fn(node.target)
        if not isinstance(tgt, FieldAccess):
            raise TypeError("assignment target must remain a FieldAccess")
        return Assign(tgt, map_field_accesses(node.value, fn))
    if isinstance(node, If):
        return If(
            map_field_accesses(node.cond, fn),
            tuple(map_field_accesses(s, fn) for s in node.body),
            tuple(map_field_accesses(s, fn) for s in node.orelse),
        )
    if isinstance(node, While):
        return While(map_field_accesses(node.cond, fn), tuple(map_field_accesses(s, fn) for s in node.body))
    raise TypeError(f"unhandled IR node {type(node)}")


def rename_fields(node, mapping):
    """Rename field accesses according to ``mapping`` (missing names kept)."""

    def _fn(fa: FieldAccess) -> FieldAccess:
        return FieldAccess(mapping.get(fa.name, fa.name), fa.offset)

    return map_field_accesses(node, _fn)


def shift_accesses(node, offset: Tuple[int, int, int], only: Optional[set] = None):
    """Shift every field access (optionally restricted to ``only``) by offset."""

    def _fn(fa: FieldAccess) -> FieldAccess:
        if only is not None and fa.name not in only:
            return fa
        off = (fa.offset[0] + offset[0], fa.offset[1] + offset[1], fa.offset[2] + offset[2])
        return FieldAccess(fa.name, off)

    return map_field_accesses(node, _fn)


# ---------------------------------------------------------------------------
# IR rewrite helpers (used by the optimization pass pipeline, passes.py)
# ---------------------------------------------------------------------------


def map_exprs_bottom_up(expr: Expr, fn) -> Expr:
    """Rebuild ``expr`` applying ``fn(Expr) -> Expr`` to every node, children
    first — the workhorse of expression-level rewrites (constant folding)."""
    if isinstance(expr, UnaryOp):
        expr = UnaryOp(expr.op, map_exprs_bottom_up(expr.operand, fn))
    elif isinstance(expr, BinOp):
        expr = BinOp(expr.op, map_exprs_bottom_up(expr.left, fn), map_exprs_bottom_up(expr.right, fn))
    elif isinstance(expr, TernaryOp):
        expr = TernaryOp(
            map_exprs_bottom_up(expr.cond, fn),
            map_exprs_bottom_up(expr.true_expr, fn),
            map_exprs_bottom_up(expr.false_expr, fn),
        )
    elif isinstance(expr, NativeCall):
        expr = NativeCall(expr.func, tuple(map_exprs_bottom_up(a, fn) for a in expr.args))
    elif isinstance(expr, Cast):
        expr = Cast(expr.dtype, map_exprs_bottom_up(expr.expr, fn))
    return fn(expr)


def map_stmt_exprs(stmt: Stmt, fn) -> Stmt:
    """Rebuild ``stmt`` applying ``fn`` bottom-up to every contained
    expression tree (assignment values, conditions) — assignment *targets*
    are left alone (they must stay zero-offset FieldAccess nodes)."""
    if isinstance(stmt, Assign):
        return Assign(stmt.target, map_exprs_bottom_up(stmt.value, fn))
    if isinstance(stmt, If):
        return If(
            map_exprs_bottom_up(stmt.cond, fn),
            tuple(map_stmt_exprs(s, fn) for s in stmt.body),
            tuple(map_stmt_exprs(s, fn) for s in stmt.orelse),
        )
    if isinstance(stmt, While):
        return While(
            map_exprs_bottom_up(stmt.cond, fn),
            tuple(map_stmt_exprs(s, fn) for s in stmt.body),
        )
    return stmt


def retype_definition(defn: StencilDefinition, dtype_map) -> StencilDefinition:
    """A copy of ``defn`` with field/scalar (and explicit ``Cast``) dtypes
    rewritten through ``dtype_map`` (e.g. ``{"float64": "float32"}``) —
    how the float32 variants of the benchmark stencils are derived without
    duplicating every definition function."""

    def _cast(e: Expr) -> Expr:
        if isinstance(e, Cast) and e.dtype in dtype_map:
            return Cast(dtype_map[e.dtype], e.expr)
        return e

    computations = tuple(
        ComputationBlock(
            block.order,
            tuple(
                IntervalBlock(ib.interval, tuple(map_stmt_exprs(s, _cast) for s in ib.body))
                for ib in block.intervals
            ),
        )
        for block in defn.computations
    )
    return dataclasses.replace(
        defn,
        name=f"{defn.name}_{'_'.join(sorted(set(dtype_map.values())))}",
        api_fields=tuple(
            dataclasses.replace(f, dtype=dtype_map.get(f.dtype, f.dtype)) for f in defn.api_fields
        ),
        scalars=tuple(
            dataclasses.replace(s, dtype=dtype_map.get(s.dtype, s.dtype)) for s in defn.scalars
        ),
        computations=computations,
    )


def make_stage(stmts: Tuple[Stmt, ...], compute_extent: Extent) -> Stage:
    """Build a Stage with writes/reads recomputed from ``stmts``."""
    writes: list = []
    reads: set = set()
    for s in stmts:
        for w in stmt_writes(s):
            if w not in writes:
                writes.append(w)
        for r, _off in stmt_reads(s):
            reads.add(r)
    return Stage(
        stmts=tuple(stmts),
        compute_extent=compute_extent,
        writes=tuple(sorted(writes)),
        reads=tuple(sorted(reads)),
    )


# ---------------------------------------------------------------------------
# Structural equality / adjacency utilities (frozen dataclasses give deep
# ``==`` for free; these express the pass-pipeline legality questions)
# ---------------------------------------------------------------------------


def stages_structurally_equal(a: Tuple[Stage, ...], b: Tuple[Stage, ...]) -> bool:
    """True when two stage sequences perform identical computations (same
    statements, same compute extents) — the k-interval-merging condition."""
    return len(a) == len(b) and all(
        sa.stmts == sb.stmts and sa.compute_extent == sb.compute_extent for sa, sb in zip(a, b)
    )


def intervals_adjacent(first: VerticalInterval, second: VerticalInterval) -> bool:
    """True when ``second`` starts exactly where ``first`` ends (same axis
    bound representation, so adjacency is domain-size independent)."""
    return first.end == second.start


def interval_span(first: VerticalInterval, second: VerticalInterval) -> VerticalInterval:
    """The single interval covering two adjacent intervals (first below)."""
    return VerticalInterval(first.start, second.end)
