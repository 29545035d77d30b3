"""Analysis pipeline: Definition IR → Implementation IR.

Mirrors the paper's §2.3 pipeline.  Passes, in order:

1. **interval validation** — intervals within a computation must be disjoint
   and are re-ordered to execution order (ascending for FORWARD/PARALLEL,
   descending for BACKWARD).
2. **race / offset checks** — the paper's compile-time access checks:
   in a PARALLEL computation a statement may not read its own target with a
   nonzero offset ("self assignment is forbidden ... if it has
   dependencies"); in FORWARD/BACKWARD computations reads of fields written
   in the same computation may not look *ahead* of the sweep direction, and
   may not use horizontal offsets within the defining statement.
3. **definition checks** — temporaries must be written before read;
   temporaries first defined inside a conditional are zero-initialized.
4. **liveness + extent analysis** — demand-driven reverse fixpoint
   computing, for every field, the region it must be available on
   (halo for API inputs, compute extent for temporaries); dead temporaries
   and the statements that only feed them are pruned.
5. **stage scheduling** — one stage per statement, grouped into
   multi-stages (one per computation block).

The result is the *unoptimized* Implementation IR — a verbatim lowering of
the definition.  Architecture-independent optimizations (multi-stage fusion,
temporary demotion, interval merging, constant folding) live in the
composable pass pipeline of ``passes.py``, which runs between this module
and the codegen backends.  ``recompute_implementation`` is the shared
fixpoint the passes use to refresh extents/liveness after IR rewrites.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import ir
from .gtscript import GTScriptSemanticError


# ---------------------------------------------------------------------------
# Pass 1: interval validation / normalization
# ---------------------------------------------------------------------------


def _validate_and_sort_intervals(block: ir.ComputationBlock, name: str) -> ir.ComputationBlock:
    ivs = list(block.intervals)
    # sort by start bound (large-domain ordering)
    ivs.sort(key=lambda ib: ib.interval.start.key())
    for a, b in zip(ivs, ivs[1:]):
        ka, kb = a.interval.end.key(), b.interval.start.key()
        # end of a must be <= start of b under large-domain ordering
        if ka > kb:
            raise GTScriptSemanticError(
                f"stencil {name}: overlapping vertical intervals "
                f"{a.interval} and {b.interval} in a {block.order.name} computation"
            )
    if block.order == ir.IterationOrder.BACKWARD:
        ivs.reverse()
    return ir.ComputationBlock(order=block.order, intervals=tuple(ivs))


# ---------------------------------------------------------------------------
# Pass 2: race / offset checks
# ---------------------------------------------------------------------------


def _check_stmt_offsets(
    stmt: ir.Stmt,
    order: ir.IterationOrder,
    block_writes: set,
    name: str,
) -> None:
    if isinstance(stmt, ir.If):
        for s in tuple(stmt.body) + tuple(stmt.orelse):
            _check_stmt_offsets(s, order, block_writes, name)
        return
    if not isinstance(stmt, ir.Assign):
        return
    target = stmt.target.name
    for rname, off in ir.stmt_reads(stmt):
        di, dj, dk = off
        if rname == target and off != (0, 0, 0):
            if order == ir.IterationOrder.PARALLEL:
                raise GTScriptSemanticError(
                    f"stencil {name}: statement writing {target!r} reads it at offset {off} "
                    "in a PARALLEL computation (self-assignment with dependencies, paper §2.2)"
                )
            if (di, dj) != (0, 0):
                raise GTScriptSemanticError(
                    f"stencil {name}: statement writing {target!r} reads it at horizontal offset "
                    f"{(di, dj)} — the horizontal plane executes in parallel"
                )
        if rname in block_writes and rname != target:
            # cross-statement reads of block-written fields: whole-plane stage
            # semantics make same-level / already-swept levels well defined;
            # looking ahead of the sweep is a compile-time error.
            pass
        if rname in block_writes:
            if order == ir.IterationOrder.FORWARD and dk > 0:
                raise GTScriptSemanticError(
                    f"stencil {name}: read of {rname}[{di},{dj},{dk}] looks ahead of a FORWARD sweep "
                    f"that writes {rname!r}"
                )
            if order == ir.IterationOrder.BACKWARD and dk < 0:
                raise GTScriptSemanticError(
                    f"stencil {name}: read of {rname}[{di},{dj},{dk}] looks behind a BACKWARD sweep "
                    f"that writes {rname!r}"
                )
            if order == ir.IterationOrder.PARALLEL and rname == target and dk != 0:
                raise GTScriptSemanticError(
                    f"stencil {name}: vertical self-dependency {rname}[{di},{dj},{dk}] "
                    "in a PARALLEL computation"
                )


def _check_races(definition: ir.StencilDefinition) -> None:
    for block in definition.computations:
        block_writes: set = set()
        for ib in block.intervals:
            for s in ib.body:
                block_writes.update(ir.stmt_writes(s))
        for ib in block.intervals:
            for s in ib.body:
                _check_stmt_offsets(s, block.order, block_writes, definition.name)


# ---------------------------------------------------------------------------
# Pass 3: definition checks (use-before-def, conditional first definitions)
# ---------------------------------------------------------------------------


def _definition_checks(definition: ir.StencilDefinition) -> Tuple[str, ...]:
    api = {f.name for f in definition.api_fields if f.is_api}
    temps = {f.name for f in definition.api_fields if not f.is_api}
    defined: set = set(api)
    zero_init: List[str] = []

    def _walk(stmts: Sequence[ir.Stmt], conditional: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, ir.Assign):
                for rname, _off in ir.stmt_reads(stmt):
                    if rname in temps and rname not in defined:
                        raise GTScriptSemanticError(
                            f"stencil {definition.name}: temporary {rname!r} read before definition"
                        )
                if conditional and stmt.target.name in temps and stmt.target.name not in defined:
                    if stmt.target.name not in zero_init:
                        zero_init.append(stmt.target.name)
                defined.add(stmt.target.name)
            elif isinstance(stmt, ir.If):
                for rname, _off in (
                    (e.name, e.offset) for e in ir.walk_exprs(stmt.cond) if isinstance(e, ir.FieldAccess)
                ):
                    if rname in temps and rname not in defined:
                        raise GTScriptSemanticError(
                            f"stencil {definition.name}: temporary {rname!r} read before definition"
                        )
                _walk(stmt.body, True)
                _walk(stmt.orelse, True)

    for block in definition.computations:
        for ib in block.intervals:
            _walk(ib.body, False)
    return tuple(zero_init)


# ---------------------------------------------------------------------------
# Pass 4: liveness + extent analysis (demand-driven reverse fixpoint)
# ---------------------------------------------------------------------------


_MAX_FIXPOINT_ITERS = 64

# A fixpoint "unit" is anything with an iteration order, writes, and reads:
# a Definition-IR statement during the initial lowering, an Implementation-IR
# stage when the pass pipeline re-analyzes after a rewrite.
_FixpointUnit = Tuple[ir.IterationOrder, int, List[str], List[Tuple[str, Tuple[int, int, int]]]]


def _extent_fixpoint(
    units: List[_FixpointUnit],
    api: set,
    error: str,
) -> Tuple[Dict[str, Optional[ir.Extent]], Dict[int, ir.Extent]]:
    """Demand-driven reverse fixpoint over ``units`` in program order.

    Returns (required extent per field | absent if dead, compute extent per
    unit key; units that never become live stay absent).  Shared by the
    statement-level lowering and the pass pipeline's stage-level re-analysis
    so the two can never drift apart.
    """
    required: Dict[str, Optional[ir.Extent]] = {}
    for _order, _key, writes, _reads in units:
        for w in writes:
            if w in api:
                required[w] = ir.Extent.zero()

    unit_extent: Dict[int, ir.Extent] = {}
    for _it in range(_MAX_FIXPOINT_ITERS):
        changed = False
        for order, key, writes, reads in reversed(units):
            if not any(required.get(w) is not None for w in writes):
                continue
            ext = ir.Extent.zero()
            for w in writes:
                r = required.get(w)
                if r is None:
                    continue
                # API fields are only ever written on the compute domain
                # (writes never touch the halo); temporaries are computed on
                # their full required extent.
                ext = ext.union(ir.Extent.zero() if w in api else r)
            prev = unit_extent.get(key)
            new_ext = ext if prev is None else prev.union(ext)
            if prev != new_ext:
                unit_extent[key] = new_ext
                changed = True
            ext = unit_extent[key]
            sequential = order != ir.IterationOrder.PARALLEL
            for rname, off in reads:
                if sequential:
                    # vertical offsets in FORWARD/BACKWARD sweeps read levels
                    # already computed inside the domain — they are loop-carried
                    # dependencies, not halo reads, and must not grow extents.
                    off = (off[0], off[1], 0)
                nreq = ext.add_offset(off)
                old = required.get(rname)
                new = nreq if old is None else old.union(nreq)
                if old != new:
                    required[rname] = new
                    changed = True
        if not changed:
            return required, unit_extent
    raise GTScriptSemanticError(error)


def _compute_extents(
    definition: ir.StencilDefinition,
) -> Tuple[Dict[str, Optional[ir.Extent]], Dict[int, ir.Extent]]:
    """Returns (required extent per field | None if dead, compute extent per stmt id)."""
    api = {f.name for f in definition.api_fields if f.is_api}

    units: List[_FixpointUnit] = []
    for block in definition.computations:
        for ib in block.intervals:
            for s in ib.body:
                units.append((block.order, id(s), list(ir.stmt_writes(s)), list(ir.stmt_reads(s))))

    required, stmt_extent = _extent_fixpoint(
        units,
        api,
        f"stencil {definition.name}: extent analysis did not converge — a field's halo "
        "grows with every vertical level (vertically-propagating horizontal dependency); "
        "this pattern is not supported",
    )
    for name in api:
        required.setdefault(name, None)
    return required, stmt_extent


# ---------------------------------------------------------------------------
# Pass 5: stage scheduling + fusion
# ---------------------------------------------------------------------------


def _build_stages(
    definition: ir.StencilDefinition,
    stmt_extent: Dict[int, ir.Extent],
) -> List[ir.MultiStage]:
    multi_stages: List[ir.MultiStage] = []
    for block in definition.computations:
        ms_intervals: List[ir.MultiStageInterval] = []
        for ib in block.intervals:
            stages: List[ir.Stage] = []
            for stmt in ib.body:
                ext = stmt_extent.get(id(stmt))
                if ext is None:
                    continue  # dead statement (feeds only unused temporaries)
                stages.append(
                    ir.Stage(
                        stmts=(stmt,),
                        compute_extent=ext,
                        writes=tuple(sorted(set(ir.stmt_writes(stmt)))),
                        reads=tuple(sorted({r for r, _ in ir.stmt_reads(stmt)})),
                    )
                )
            if stages:
                ms_intervals.append(ir.MultiStageInterval(interval=ib.interval, stages=tuple(stages)))
        if ms_intervals:
            multi_stages.append(ir.MultiStage(order=block.order, intervals=tuple(ms_intervals)))
    return multi_stages


# ---------------------------------------------------------------------------
# Vertical bounds (the paper's compile-time offset checks, K axis)
# ---------------------------------------------------------------------------


def _check_vertical_bounds(definition: ir.StencilDefinition) -> int:
    """Statically verify vertical reads stay inside [0, nk); returns the
    extra min-k-levels requirement implied by cross-boundary offsets."""
    temps = {f.name for f in definition.api_fields if not f.is_api}
    extra_min_k = 1
    for block in definition.computations:
        for ib in block.intervals:
            s, e = ib.interval.start, ib.interval.end
            for stmt in ib.body:
                for rname, off in ir.stmt_reads(stmt):
                    dk = off[2]
                    if dk == 0 or rname in temps:
                        continue  # temporaries are allocated k-extended
                    if dk < 0:
                        if s.level == ir.LevelMarker.START and s.offset + dk < 0:
                            raise GTScriptSemanticError(
                                f"stencil {definition.name}: read {rname}[k{dk:+d}] from interval "
                                f"starting at level {s.offset} reaches below the vertical domain"
                            )
                        if s.level == ir.LevelMarker.END:
                            extra_min_k = max(extra_min_k, -(s.offset + dk))
                    else:
                        if e.level == ir.LevelMarker.END and e.offset + dk > 0:
                            raise GTScriptSemanticError(
                                f"stencil {definition.name}: read {rname}[k+{dk}] from interval "
                                f"ending at level end{e.offset:+d} reaches above the vertical domain"
                            )
                        if e.level == ir.LevelMarker.START:
                            extra_min_k = max(extra_min_k, e.offset + dk)
    return extra_min_k


# ---------------------------------------------------------------------------
# K-extent bookkeeping
# ---------------------------------------------------------------------------


def _k_extents(definition: ir.StencilDefinition) -> Dict[str, Tuple[int, int]]:
    kext: Dict[str, Tuple[int, int]] = {}
    for block in definition.computations:
        for ib in block.intervals:
            for s in ib.body:
                for rname, off in ir.stmt_reads(s):
                    lo, hi = kext.get(rname, (0, 0))
                    kext[rname] = (min(lo, off[2]), max(hi, off[2]))
    return kext


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def analyze(definition: ir.StencilDefinition, fuse: bool = False) -> ir.StencilImplementation:
    """Lower a Definition IR to the (unoptimized) Implementation IR.

    ``fuse=True`` additionally applies the multi-stage fusion pass — kept for
    back-compatibility with callers that predate ``passes.py``; the build
    pipeline now runs fusion (and the other passes) itself."""
    # 1. intervals
    blocks = tuple(_validate_and_sort_intervals(b, definition.name) for b in definition.computations)
    definition = ir.StencilDefinition(
        name=definition.name,
        api_fields=definition.api_fields,
        scalars=definition.scalars,
        computations=blocks,
        externals=definition.externals,
        docstring=definition.docstring,
    )

    # 2. races / offsets
    _check_races(definition)

    # 3. definitions
    zero_init = _definition_checks(definition)

    # 4. liveness + extents
    required, stmt_extent = _compute_extents(definition)

    # 5. stages
    multi_stages = _build_stages(definition, stmt_extent)

    api_fields = tuple(f for f in definition.api_fields if f.is_api)
    live_temps = tuple(
        f for f in definition.api_fields if not f.is_api and required.get(f.name) is not None
    )

    field_extents = tuple(
        sorted((name, ext) for name, ext in required.items() if ext is not None)
    )
    kext = _k_extents(definition)
    k_extents = tuple(sorted((name, rng) for name, rng in kext.items()))

    min_k = _check_vertical_bounds(definition)
    for block in definition.computations:
        ordered = sorted(block.intervals, key=lambda ib: ib.interval.start.key())
        for ib in ordered:
            min_k = max(min_k, ib.interval.min_levels())
        for a, b in zip(ordered, ordered[1:]):
            ae, bs = a.interval.end, b.interval.start
            if ae.level == ir.LevelMarker.START and bs.level == ir.LevelMarker.END:
                # intervals validated under large-domain ordering: a START-
                # relative end [.., START+x) before an END-relative start
                # [END+y, ..) is only actually disjoint when nk + y >= x —
                # without this, e.g. interval(0, 1) + interval(-1, None)
                # silently execute the same level twice at nk == 1
                min_k = max(min_k, ae.offset - bs.offset)

    impl = ir.StencilImplementation(
        name=definition.name,
        api_fields=api_fields,
        temporaries=live_temps,
        scalars=definition.scalars,
        multi_stages=tuple(multi_stages),
        field_extents=field_extents,
        k_extents=k_extents,
        externals=definition.externals,
        min_k_levels=min_k,
        zero_init_temps=tuple(t for t in zero_init if any(f.name == t for f in live_temps)),
    )
    if fuse:
        from .passes import MultiStageFusion, PassContext

        impl = MultiStageFusion()(impl, PassContext(opt_level=1))
    return impl


# ---------------------------------------------------------------------------
# Sequential-sweep carry liveness (k-blocking plan for the jax/pallas loops)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepCarryPlan:
    """Which state one FORWARD/BACKWARD multi-stage must materialize.

    ``full``   — fields whose every written plane stays live: API outputs, and
                 temporaries some *other* multi-stage reads.  The loop carries
                 the whole (ni, nj, nk) array, as before.
    ``window`` — temporaries written only in this multi-stage and read only in
                 this multi-stage, at trailing vertical offsets.  Only the last
                 ``depth`` planes are live at any point of the sweep, so the
                 loop carries a rolling window of ``depth`` 2-D planes instead
                 of a full 3-D array (depth = max trailing-offset distance;
                 0 means the value never crosses an iteration).
    """

    full: Tuple[str, ...]
    window: Tuple[Tuple[str, int], ...]  # (name, depth), first-write order

    def carried_planes(self, nk: int) -> int:
        return len(self.full) * nk + sum(d for _, d in self.window)

    def baseline_planes(self, nk: int) -> int:
        return (len(self.full) + len(self.window)) * nk


def sequential_carry_plan(impl: ir.StencilImplementation) -> Dict[int, SweepCarryPlan]:
    """Per sequential multi-stage (by index), the liveness-proven carry plan.

    Legality of the window classification: a temporary written *only* inside
    multi-stage ``mi`` and read *only* inside ``mi`` can never be observed at
    a plane more than ``depth`` iterations behind the sweep — the race checks
    (`_check_stmt_offsets`) already reject reads ahead of the sweep, so every
    in-sweep read is a trailing read.  Planes the sweep never wrote read as
    the zero initialization either way (the rolling window starts zeroed and
    each iteration's plane starts zeroed, exactly like the zero-initialized
    3-D temporary it replaces).
    """
    api = {f.name for f in impl.api_fields}
    locals_ = {f.name for f in impl.local_decls}

    reads_by_ms: Dict[int, Dict[str, set]] = {}
    writes_by_ms: Dict[int, set] = {}
    for mi, ms in enumerate(impl.multi_stages):
        reads: Dict[str, set] = {}
        writes: set = set()
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    for rname, off in ir.stmt_reads(stmt):
                        reads.setdefault(rname, set()).add(off)
                    writes.update(ir.stmt_writes(stmt))
        reads_by_ms[mi] = reads
        writes_by_ms[mi] = writes

    plans: Dict[int, SweepCarryPlan] = {}
    for mi, ms in enumerate(impl.multi_stages):
        if ms.order == ir.IterationOrder.PARALLEL:
            continue
        written: List[str] = []
        for itv in ms.intervals:
            for st in itv.stages:
                for w in st.writes:
                    if w not in written and w not in locals_:
                        written.append(w)
        full: List[str] = []
        window: List[Tuple[str, int]] = []
        for name in written:
            decl = impl.field(name)
            windowable = (
                name not in api
                and decl.axes == ir.AXES_IJK
                and not any(
                    name in reads_by_ms[mj] or name in writes_by_ms[mj]
                    for mj in reads_by_ms
                    if mj != mi
                )
            )
            if windowable:
                depth = max((abs(off[2]) for off in reads_by_ms[mi].get(name, ())), default=0)
                window.append((name, depth))
            else:
                full.append(name)
        plans[mi] = SweepCarryPlan(full=tuple(full), window=tuple(window))
    return plans


# ---------------------------------------------------------------------------
# Implementation-IR re-analysis (shared fixpoint for the pass pipeline)
# ---------------------------------------------------------------------------


def recompute_implementation(impl: ir.StencilImplementation) -> ir.StencilImplementation:
    """Recompute liveness, per-stage compute extents, field extents and
    k-extents of an Implementation IR after a pass rewrote its stages.

    The same demand-driven reverse fixpoint as ``_compute_extents``, run at
    stage granularity: dead stages (feeding only unread temporaries) are
    dropped, dead temporaries removed, and extents shrink to what the
    surviving statements actually require.
    """
    api = {f.name for f in impl.api_fields}

    units: List[_FixpointUnit] = []
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                reads = [r for stmt in st.stmts for r in ir.stmt_reads(stmt)]
                units.append((ms.order, id(st), list(st.writes), reads))

    required, stage_extent = _extent_fixpoint(
        units,
        api,
        f"stencil {impl.name}: extent re-analysis did not converge after an IR rewrite",
    )

    multi_stages: List[ir.MultiStage] = []
    for ms in impl.multi_stages:
        intervals: List[ir.MultiStageInterval] = []
        for itv in ms.intervals:
            stages: List[ir.Stage] = []
            for st in itv.stages:
                ext = stage_extent.get(id(st))
                if ext is None:
                    continue  # dead stage
                stages.append(ir.make_stage(st.stmts, ext))
            if stages:
                intervals.append(ir.MultiStageInterval(itv.interval, tuple(stages)))
        if intervals:
            multi_stages.append(ir.MultiStage(ms.order, tuple(intervals)))

    temporaries = tuple(f for f in impl.temporaries if required.get(f.name) is not None)
    local_decls = tuple(f for f in impl.local_decls if required.get(f.name) is not None)
    field_extents = tuple(sorted((n, e) for n, e in required.items() if e is not None))

    kext: Dict[str, Tuple[int, int]] = {}
    for ms in multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    for rname, off in ir.stmt_reads(stmt):
                        lo, hi = kext.get(rname, (0, 0))
                        kext[rname] = (min(lo, off[2]), max(hi, off[2]))
    k_extents = tuple(sorted((name, rng) for name, rng in kext.items()))

    live = {f.name for f in temporaries}
    return dataclasses.replace(
        impl,
        multi_stages=tuple(multi_stages),
        temporaries=temporaries,
        local_decls=local_decls,
        field_extents=field_extents,
        k_extents=k_extents,
        zero_init_temps=tuple(t for t in impl.zero_init_temps if t in live),
    )
