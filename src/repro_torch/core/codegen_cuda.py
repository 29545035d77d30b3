"""CUDA backend: one generated Hopper kernel per stencil.

This replaces the reference package's Pallas TPU kernel, the fused
per-stencil kernel that ``repro/core/codegen_pallas.py::generate_pallas_source``
emits (and its two instances ``repro/kernels/hdiff`` and ``repro/kernels/vadv``).
It ports what that kernel computes and what it keeps out of device memory,
not its blocks.  The schedule is GridTools' ``gtcuda`` one:

* one thread block per horizontal ``(BI, BJ)`` tile, k iterated inside the
  kernel, every multi-stage of the stencil fused into one launch;
* every multi-stage runs plane by plane: PARALLEL and FORWARD multi-stages
  in ascending k, BACKWARD ones in descending k.  Within a plane the stages
  run in order, each over its compute extent (``impl.extent_of``) of the
  tile, in groups of consecutive stages with equal extents and no horizontal
  hazard between them, with a ``__syncthreads()`` after each group;
* read-only inputs read at horizontal offsets are staged plane by plane,
  tile plus halo, into shared memory, double-buffered: the next plane's copy
  (``cp.async``) overlaps the current plane's stages; temporaries live in
  registers (demoted ``impl.local_decls`` whose stages share one group), in
  shared-memory planes (temporaries of one PARALLEL interval, and the rolling
  ``window`` planes of ``analysis.sequential_carry_plan``), or, when they
  cross intervals or multi-stages outside a k-walk (below), or are read
  after it (the ``full`` carries, vadv's ``cp``/``dp``), in a per-block
  device scratch the wrapper allocates;
* ragged tiles are masked in the kernel and outputs are written in place, so
  inout, masked and partial-k outputs keep the caller's values.

The load pipeline.  A PARALLEL interval (or k-sweep) that no k-walk holds and
that may span more than one level streams every read-only IJK input it reads,
own-column ones too, through a ring of ``D`` shared-memory slots a (input,
plane offset), tile plus the input's extent, so that no stage of a plane
reads device memory and ``D - 1`` planes are in flight while one computes.
Each plane's copies are one ``cp.async`` group, and the loop waits for the
group of its plane alone (``cp.async.wait_group D - 2``; every group in the
last planes), behind one barrier a plane, which also frees the slot the next
copy refills.  A copy moves 16 bytes where a field's rows start 16-byte
aligned (its base, and its I, K and member pitches, multiples of 16 bytes:
the kernel checks what it is handed), into rows widened to 16-byte chunks;
else one element.  A thread's first chunk of each input, and a tile point's
thread, are fixed before the loop, so a plane costs no division.  ``D`` is
``PIPE_DEPTH``, 3.  A pipelined kernel asks for the shared memory that
leaves an SM room for ``PIPE_THREADS`` resident threads and no more (fewer
blocks in flight stream faster), and one whose rings do not fit beside them
at ``DEFAULT_BLOCK`` keeps its loads.  A plane temporary that one assignment alone in its stage
computes from staged planes, scalars and other such temporaries is not
stored (``inline``): each read evaluates it at the reader's offset in
registers, with the same operations, so its stage and barrier go.
``SCHEDULE["prefetch"]`` lists each such loop; ``prefetch_counts()`` the
bytes launches brought through the rings.  ``async_staging=False`` keeps the
plain loads of the staged planes only (what ``chip_smoke.py`` times the
pipeline against).

What bounds it on an H100: hdiff and vadv do a few flops per byte, far below
the card's float64 ridge point, so they are bound by device-memory bytes.
``threadIdx.x`` walks J, and so does every loop over a tile, so a warp's
loads and stores are contiguous rows when J has stride 1: the card layout in
which ``storage`` allocates the ``cuda`` backend's fields (K slowest, then
I, then J).  Every field is read through the strides it is handed, so a
C-order field gives the same answer, with a warp's accesses ``nk`` elements
apart.

A PARALLEL interval whose stages read, at a vertical offset, a field that
another of its stages writes runs as several consecutive k-sweeps over its k
range (``_k_sweeps``), so that plane-by-plane order inside each sweep gives
the reference's stage-by-stage order; a temporary that crosses sweeps is
``full`` scratch, and a written API field is the block's own column.

A k-walk runs a chain of consecutive PARALLEL intervals (or k-sweeps) and
contiguous FORWARD multi-stages as one ascending loop: at step ``k`` each
runs level ``k + lead``, its lead the least that keeps every pair of
accesses to a field, one of them a write, in the reference's order
(``_walk_shifts``), so a producer runs ahead of the stages that read it
above.  What one interval passes to the next then lives on chip: a ring of
registers holds the newest levels a field was written at
(``_Plan._find_rings``), and serves each read at its own column that the
intervals' bounds prove to find a level the walk wrote; a temporary all of
whose reads it serves needs no memory (``ring``), one read at other columns
takes shared-memory planes (``plane_ring``), and the rest stay ``full``.  A
walk that keeps no temporary out of memory keeps the loops; a kernel that
walks asks for 1024 resident threads an SM (64 registers a thread), so that
other blocks hide each level's memory latency.  ``SCHEDULE["k_walks"]``
lists each walk's units with their leads and its registers.

Limits, checked when the source is generated, are the reference's: a written
API field may not be read at a horizontal offset, or from a stage whose
compute extent reaches into a neighbouring tile (``GTScriptSemanticError``);
K-axis outputs raise ``NotImplementedError``.

The generated Python module exports ``CUDA_SOURCE``, ``SCHEDULE`` (the keys of
the Pallas module's) and ``_smem_bytes(bi, bj)``.  :class:`CudaKernel`
compiles the source with ``nvcc`` into the stencil cache at first use, loads
it with ``ctypes`` and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.obs import trace as otrace

from . import analysis, ir
from .codegen_common import Emitter, _c, bound_expr, multistage_plan
from .gtscript import GTScriptSemanticError

# bump on any change to the generated source: it is part of the fingerprint
CODEGEN_VERSION = "cuda-5"
DEFAULT_BLOCK: Tuple[int, int] = (8, 32)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SMEM_DEFAULT_LIMIT = 48 * 1024  # above it the launcher raises the kernel's attribute
SMEM_MAX = 232448  # what one H100 block may use
_SMEM_ALIGN = 16
# the load pipeline's slots a ring: two planes in flight while one computes
# (deeper rings measured slower on the H100: PERF.md §6)
PIPE_DEPTH = 3
# resident threads an SM a pipelined kernel runs: its launch asks for the
# shared memory that leaves room for no more (more resident blocks measured
# slower on the H100: PERF.md §6); a kernel whose rings do not fit beside
# them at DEFAULT_BLOCK keeps its loads.  An SM has 228 KB of shared memory,
# of which each resident block reserves 1 KB
PIPE_THREADS = 768
_SMEM_SM = 233472
_SMEM_BLOCK_RESERVED = 1024

_CTYPE = {
    "float64": "double",
    "float32": "float",
    "int64": "long long",
    "int32": "int",
    "int16": "short",
    "int8": "signed char",
    "bool": "bool",
}

# every live kernel (each CudaKernel, and the hand-written kernels'
# ``kernels._build.HandKernel``s), for ``reset_launch_counts``
_KERNELS: weakref.WeakSet = weakref.WeakSet()

# launches by kernel key since the last reset; a kernel's ``launches``
# setter moves it, so a kernel freed since (a driver's stencils die when it
# returns) still counts
_LAUNCHES: Counter = Counter()

# bytes of full scratch the launches wrote, by kernel key since the last reset
_SCRATCH: Counter = Counter()

# bytes the launches brought through the load pipeline's rings, by kernel key
_PREFETCH: Counter = Counter()


def register_kernel(kernel) -> None:
    """Let ``reset_launch_counts()`` reach a ``CountedKernel``."""
    _KERNELS.add(kernel)


class CountedKernel:
    """A kernel with a ``key`` and a ``launches`` count, which its launch
    site raises by one; every change to it also moves ``launch_counts()``."""

    _launches = 0

    @property
    def launches(self) -> int:
        return self._launches

    @launches.setter
    def launches(self, value: int) -> None:
        _LAUNCHES[self.key] += int(value) - self._launches
        self._launches = int(value)

    def count_launch(self, scratch_bytes: int = 0, prefetch_bytes: int = 0) -> None:
        """One launch more, which wrote ``scratch_bytes`` of full scratch and
        brought ``prefetch_bytes`` through its load pipeline."""
        self.launches += 1
        _SCRATCH[self.key] += scratch_bytes
        _PREFETCH[self.key] += prefetch_bytes


def launch_counts() -> Dict[str, int]:
    """Launches by kernel key since the last reset, of live kernels and of
    kernels freed since."""
    return dict(_LAUNCHES)


def scratch_counts() -> Dict[str, int]:
    """Bytes of full scratch the launches wrote, by kernel key since the last
    reset: each launch counts its launcher's whole scratch, which the kernel
    writes before it reads."""
    return dict(_SCRATCH)


def prefetch_counts() -> Dict[str, int]:
    """Bytes the launches brought through the load pipeline's rings, by
    kernel key since the last reset: each staged plane's tile plus extent,
    clipped to the domain, once a level of its loop (not the chunks' padding)."""
    return dict(_PREFETCH)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and every key's launch, scratch and
    prefetch counts, to 0."""
    for k in list(_KERNELS):
        k.launches = 0
    for counter in (_LAUNCHES, _SCRATCH, _PREFETCH):
        for key in counter:
            counter[key] = 0


def _ctype(dtype: str) -> str:
    try:
        return _CTYPE[dtype]
    except KeyError:
        raise GTScriptSemanticError(f"cuda backend: unsupported dtype {dtype!r}") from None


def _cname(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# schedule metadata shared with the Pallas module (same definitions)
# ---------------------------------------------------------------------------


def _masked_writes(impl: ir.StencilImplementation) -> Set[str]:
    masked: Set[str] = set()
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    if isinstance(stmt, ir.If):
                        masked.update(ir.stmt_writes(stmt))
    return masked


def _covers(intervals: List[ir.VerticalInterval]) -> bool:
    """Whether ``intervals`` together cover every level of the domain."""
    if not intervals:
        return False
    ivs = sorted(intervals, key=lambda iv: iv.start.key())
    if ivs[0].start != ir.AxisBound(ir.LevelMarker.START, 0):
        return False
    end = ivs[0].end
    for iv in ivs[1:]:
        if iv.start.key() > end.key():
            return False
        if iv.end.key() > end.key():
            end = iv.end
    return end == ir.AxisBound(ir.LevelMarker.END, 0)


def _written_k_coverage_full(impl: ir.StencilImplementation, name: str) -> bool:
    intervals = [
        itv.interval
        for ms in impl.multi_stages
        for itv in ms.intervals
        if any(name in st.writes for st in itv.stages)
    ]
    return not intervals or _covers(intervals)


def _schedule(impl: ir.StencilImplementation, carry_plans) -> Dict[str, Any]:
    """The Pallas module's ``SCHEDULE`` keys, computed the same way."""
    api = {f.name: f for f in impl.api_fields}
    reads: Dict[str, list] = {}
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    for n, off in ir.stmt_reads(stmt):
                        reads.setdefault(n, []).append(off)
    written_api = list(impl.written_api_fields())
    masked = _masked_writes(impl)
    inout = [n for n in written_api
             if n in reads or n in masked or not _written_k_coverage_full(impl, n)]
    read_api = [f.name for f in impl.api_fields if f.name in reads]
    input_api = [n for n in read_api if n not in written_api] + inout
    dma_inputs = [n for n in input_api if api[n].axes != ("K",)]
    first_use: Dict[str, int] = {}
    for mi, ms in enumerate(impl.multi_stages):
        touched: set = set()
        for itv in ms.intervals:
            for st in itv.stages:
                touched.update(st.reads)
                touched.update(st.writes)
        for n in dma_inputs:
            if n in touched:
                first_use.setdefault(n, mi)
    for n in dma_inputs:
        first_use.setdefault(n, 0)
    windowed: Dict[str, int] = {}
    for plan in carry_plans.values():
        windowed.update(dict(plan.window))
    return {
        "halo": max(impl.max_halo[0], impl.max_halo[1]),
        "dma_inputs": list(dma_inputs),
        "dma_first_use_ms": dict(sorted(first_use.items())),
        "sweeps": {
            mi: {"full": list(plan.full), "window": dict(plan.window)}
            for mi, plan in sorted(carry_plans.items())
        },
        "full_carry_fields": sum(len(p.full) for p in carry_plans.values()),
        "window_fields": len(windowed),
        "window_planes": sum(windowed.values()),
    }


# ---------------------------------------------------------------------------
# access analysis and storage classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Access:
    mi: int
    ii: int
    si: int  # stage index inside the interval
    write: bool
    offset: Tuple[int, int, int]
    extent: ir.Extent
    masked: bool


def _stmt_accesses(stmt: ir.Stmt, masked: bool, out: List[Tuple[str, bool, Tuple[int, int, int], bool]]):
    if isinstance(stmt, ir.Assign):
        for n, off in ir.stmt_reads(stmt):
            out.append((n, False, off, masked))
        out.append((stmt.target.name, True, (0, 0, 0), masked))
    elif isinstance(stmt, ir.If):
        for e in ir.walk_exprs(stmt.cond):
            if isinstance(e, ir.FieldAccess):
                out.append((e.name, False, e.offset, masked))
        for s in tuple(stmt.body) + tuple(stmt.orelse):
            _stmt_accesses(s, True, out)
    else:
        raise GTScriptSemanticError(f"cuda backend: unsupported statement {type(stmt).__name__}")


def _collect(impl: ir.StencilImplementation) -> Dict[str, List[_Access]]:
    acc: Dict[str, List[_Access]] = {}
    for mi, ms in enumerate(impl.multi_stages):
        for ii, itv in enumerate(ms.intervals):
            for si, st in enumerate(itv.stages):
                found: list = []
                for stmt in st.stmts:
                    _stmt_accesses(stmt, False, found)
                for n, w, off, m in found:
                    acc.setdefault(n, []).append(_Access(mi, ii, si, w, off, st.compute_extent, m))
    return acc


def _groups(itv: ir.MultiStageInterval, skip: Set[int] = frozenset()) -> List[List[int]]:
    """Consecutive stages with one compute extent and no horizontal hazard:
    no stage reads, at a horizontal offset, a field an earlier stage of the
    group writes, nor writes a field an earlier stage read at one.  The
    stages in ``skip`` (those of inlined temporaries) are left out."""
    groups: List[List[int]] = []
    cur: List[int] = []
    written: Set[str] = set()
    read_off: Set[str] = set()
    for si, st in enumerate(itv.stages):
        if si in skip:
            continue
        s_off = {n for stmt in st.stmts for n, o in ir.stmt_reads(stmt) if (o[0], o[1]) != (0, 0)}
        hazard = bool(cur) and (
            st.compute_extent != itv.stages[cur[0]].compute_extent
            or bool(s_off & (written | set(st.writes)))
            or bool(set(st.writes) & read_off)
        )
        if hazard:
            groups.append(cur)
            cur, written, read_off = [], set(), set()
        cur.append(si)
        written |= set(st.writes)
        read_off |= s_off
    if cur:
        groups.append(cur)
    return groups


def _k_sweeps(itv: ir.MultiStageInterval) -> List[List[int]]:
    """The stages of a PARALLEL interval, cut into consecutive sweeps over
    its k range, so that running each sweep plane by plane in ascending k
    gives the reference's stage-by-stage order.  A sweep ends before a stage
    that reads a field at a plane above, where an earlier stage of the sweep
    writes it (that write would come later), or that writes a field an
    earlier stage of the sweep read at a plane below (that read would see
    the new value).  Inside one stage both orders agree."""
    sweeps: List[List[int]] = []
    cur: List[int] = []
    written: Set[str] = set()
    read_below: Set[str] = set()
    for si, st in enumerate(itv.stages):
        reads = [(n, off[2]) for stmt in st.stmts for n, off in ir.stmt_reads(stmt)]
        if cur and ({n for n, dk in reads if dk > 0} & written or set(st.writes) & read_below):
            sweeps.append(cur)
            cur, written, read_below = [], set(), set()
        cur.append(si)
        written |= set(st.writes)
        read_below |= {n for n, dk in reads if dk < 0}
    if cur:
        sweeps.append(cur)
    return sweeps


def _read_before_written(impl: ir.StencilImplementation, name: str) -> bool:
    """Whether a read of ``name`` may find a plane inside the domain that the
    kernel's order has not written yet, where the zero-initialized temporary
    reads 0 (a PARALLEL read one plane up, in an interval that runs before
    the one writing that plane).  A read is safe where the intervals before
    its own write every plane; or where it reads its own plane after an
    earlier stage of its interval wrote it; or where it reads a plane its
    sweep has passed, its interval writes the field and, with the intervals
    before it, every plane.  The frontend refuses the other orders (a
    temporary read before its definition, or ahead of a sequential sweep
    that writes it)."""
    before: List[ir.VerticalInterval] = []
    for ms in impl.multi_stages:
        step = -1 if ms.order == ir.IterationOrder.BACKWARD else 1
        for itv in ms.intervals:
            writers = [si for si, st in enumerate(itv.stages) if name in st.writes]
            for si, st in enumerate(itv.stages):
                for stmt in st.stmts:
                    for n, off in ir.stmt_reads(stmt):
                        if n != name or _covers(before):
                            continue
                        dk = off[2] * step
                        if dk == 0 and writers and writers[0] < si:
                            continue
                        if dk < 0 and writers and _covers(before + [itv.interval]):
                            continue
                        return True
            if writers:
                before.append(itv.interval)
    return False


def _contiguous(ms: ir.MultiStage) -> bool:
    ivs = [itv.interval for itv in ms.intervals]
    if ms.order == ir.IterationOrder.BACKWARD:
        return all(a.start == b.end for a, b in zip(ivs, ivs[1:]))
    return all(a.end == b.start for a, b in zip(ivs, ivs[1:]))


def _walk_chains(impl: ir.StencilImplementation,
                 acc: Dict[str, List[_Access]]) -> List[List[List[Tuple[int, int]]]]:
    """Runs of consecutive nodes that one ascending loop over k can walk: a
    node is one PARALLEL interval (or k-sweep), or a whole FORWARD
    multi-stage whose intervals follow one another.  A BACKWARD or a gapped
    FORWARD multi-stage ends a run, and so does a node that touches a
    written non-IJK field an earlier node of the run touches (its levels
    alias)."""
    flat_written = {f.name for f in impl.api_fields if f.axes != ir.AXES_IJK} & set(impl.written_api_fields())
    touched: Dict[Tuple[int, int], Set[str]] = {}
    for n, accs in acc.items():
        for a in accs:
            touched.setdefault((a.mi, a.ii), set()).add(n)
    chains: List[List[List[Tuple[int, int]]]] = [[]]
    seen: Set[str] = set()
    for mi, ms in enumerate(impl.multi_stages):
        units = [(mi, ii) for ii in range(len(ms.intervals))]
        forward = ms.order == ir.IterationOrder.FORWARD
        if ms.order == ir.IterationOrder.BACKWARD or (forward and not _contiguous(ms)):
            chains.append([])
            seen = set()
            continue
        for node in ([units] if forward else [[u] for u in units]):
            flat = set().union(*(touched.get(u, set()) for u in node)) & flat_written
            if flat & seen:
                chains.append([])
                seen = set()
            chains[-1].append(node)
            seen |= flat
    return [c for c in chains if len(c) > 1]


def _walk_shifts(node_accs: List[List[Tuple[str, bool, int]]]) -> List[int]:
    """The least level lead of each node of a walk, so that every pair of
    accesses to one field, one of them a write, keeps the reference's order.
    A node ``u`` before ``v`` that touches a level at offset ``a`` which
    ``v`` touches at offset ``b`` must reach it no later: ``s_u - s_v >=
    b - a``.  Every bound points from an earlier node to a later one, so the
    leads follow from the last node back and always exist."""
    shifts = [0] * len(node_accs)
    for u in range(len(node_accs) - 2, -1, -1):
        for v in range(u + 1, len(node_accs)):
            for n, w, a in node_accs[u]:
                for m, w2, b in node_accs[v]:
                    if n == m and (w or w2):
                        shifts[u] = max(shifts[u], shifts[v] + b - a)
    return shifts


@dataclasses.dataclass
class _Unit:
    mi: int
    ii: int
    shift: int = 0  # runs level k + shift at the walk's step k
    node: int = 0  # its node in the walk (a FORWARD multi-stage's intervals share one)


def _on_tile(a: _Access) -> bool:
    """Whether the access's stage computes on the tile alone (each thread at
    its own point)."""
    return (a.extent.i, a.extent.j) == ((0, 0), (0, 0))


@dataclasses.dataclass
class _Ring:
    """A walk's registers for one field: slot ``d`` holds the level written
    ``d`` steps ago by its writers at ``lead``; ``served`` gives the slot of
    each read it serves, by (multi-stage, interval, stage, dk); ``memory``
    whether the writes also go to the field's memory."""

    lead: int
    depth: int
    served: Dict[Tuple[int, int, int, int], int]
    memory: bool = True


@dataclasses.dataclass
class _Loop:
    """One loop over k: a single interval, or a walk of several nodes at one
    step each (``units`` in the reference's order)."""

    units: List[_Unit]
    # staged (input, plane offset from the loop's k), and the units reading each
    planes: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    readers: Dict[Tuple[str, int], List[int]] = dataclasses.field(default_factory=dict)
    rings: Dict[str, _Ring] = dataclasses.field(default_factory=dict)  # by field
    # the load pipeline's (input, plane offset) rings; empty where the loop has none
    pipe: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    @property
    def walk(self) -> bool:
        return len(self.units) > 1

    @property
    def lookahead(self) -> int:
        return max(u.shift for u in self.units)


@dataclasses.dataclass
class _Temp:
    name: str
    kind: str  # 'reg' | 'plane' | 'window' | 'ring' | 'plane_ring' | 'full'
    ctype: str
    itemsize: int
    ext: ir.Extent
    depth: int = 0  # window, ring, plane_ring: planes kept behind the newest
    k_lo: int = 0  # full: k margin below / above the domain
    k_hi: int = 0
    masked: bool = False
    group: Optional[Tuple[int, int, int]] = None  # reg: (mi, ii, group index)
    zero_all: bool = False  # full: unwritten points can be read, so zero it all
    expr: Optional[ir.Expr] = None  # inline: the value, evaluated at each read's offset

    @property
    def rows_extra(self) -> int:
        return self.ext.i[1] - self.ext.i[0]

    @property
    def cols_extra(self) -> int:
        return self.ext.j[1] - self.ext.j[0]


class _Plan:
    """Everything the emitter needs: storage classes, staged inputs, smem."""

    def __init__(self, impl: ir.StencilImplementation, block: Tuple[int, int], async_staging: bool = True):
        # each PARALLEL interval cut into its k-sweeps: from here on an
        # "interval" is one sweep, run after the one before it
        self.sweeps: Dict[int, List[int]] = {}
        multi_stages = []
        for mi, ms in enumerate(impl.multi_stages):
            if ms.order != ir.IterationOrder.PARALLEL:
                multi_stages.append(ms)
                continue
            cut = [[ir.MultiStageInterval(itv.interval, tuple(itv.stages[si] for si in sweep))
                    for sweep in _k_sweeps(itv)] for itv in ms.intervals]
            if any(len(c) > 1 for c in cut):
                self.sweeps[mi] = [len(c) for c in cut]
            multi_stages.append(ir.MultiStage(ms.order, tuple(x for c in cut for x in c)))
        self.impl = impl = dataclasses.replace(impl, multi_stages=tuple(multi_stages))
        self.bi, self.bj = int(block[0]), int(block[1])
        if self.bi <= 0 or self.bj <= 0 or self.bi * self.bj > 1024:
            raise ValueError(f"cuda backend: block {block} must have 1..1024 threads")
        self.api = {f.name: f for f in impl.api_fields}
        self.acc = _collect(impl)
        self.carry = analysis.sequential_carry_plan(impl)
        self.groups = {
            (mi, ii): _groups(itv)
            for mi, ms in enumerate(impl.multi_stages)
            for ii, itv in enumerate(ms.intervals)
        }
        self.written = set(impl.written_api_fields())
        self._check_api()
        chains = _walk_chains(impl, self.acc)
        self.loops = self._loops(chains)
        self._find_rings()
        self.temps = self._classify_temps()
        # a walk that keeps no temporary out of memory gains nothing for the
        # registers it costs: its intervals keep their loops
        onchip = [n for n, t in self.temps.items() if t.kind in ("ring", "plane_ring")]
        kept = [c for c in chains if any(self.loop_of[(a.mi, a.ii)] is self.loop_of[c[0][0]]
                                         for n in onchip for a in self.acc[n])]
        if len(kept) < len(chains):
            self.loops = self._loops(kept)
            self._find_rings()
        for loop in self.loops:
            for n in list(loop.rings):
                kind = self.temps[n].kind if n in self.temps else None
                if kind == "ring":
                    loop.rings[n].memory = False
                elif kind not in (None, "full"):  # a register, a plane or a window needs none
                    del loop.rings[n]
        self.staged = self._staged_inputs()
        self._stage_loops()
        if async_staging:
            self._pipeline_loops()
            self._inline_temps()
        # outside the pipelines, staged planes double-buffered and filled by
        # cp.async (4- and 8-byte elements)
        self.double_buffer = async_staging and bool(self.staged) and all(
            np.dtype(self.api[n].dtype).itemsize in (4, 8) for lst in self.staged.values() for n, _ in lst)
        self.async_staging = self.double_buffer or any(loop.pipe for loop in self.loops)
        self._layout_smem()

    def group_of(self, mi: int, ii: int, si: int) -> int:
        for g, stages in enumerate(self.groups[(mi, ii)]):
            if si in stages:
                return g
        raise KeyError((mi, ii, si))

    # -- checks ---------------------------------------------------------------

    def _check_api(self) -> None:
        for n, f in self.api.items():
            if f.axes not in (("I", "J", "K"), ("I", "J"), ("K",)):
                raise GTScriptSemanticError(f"cuda backend: unsupported axes {f.axes} for {n!r}")
            _ctype(f.dtype)
        for n in self.written:
            if self.api[n].axes == ("K",):
                raise NotImplementedError(f"cuda backend: K-field output {n!r}")
            for a in self.acc.get(n, ()):
                if a.write and (a.extent.i, a.extent.j) != ((0, 0), (0, 0)):
                    raise GTScriptSemanticError(
                        f"cuda backend: API field {n!r} is written over an extended region "
                        f"{a.extent.as_tuple()[:2]}; stage the value through a temporary instead"
                    )
                if a.write:
                    continue
                if (a.offset[0], a.offset[1]) != (0, 0):
                    raise GTScriptSemanticError(
                        f"cuda backend: written API field {n!r} is read at horizontal offset "
                        f"{a.offset}; stage the value through a temporary instead"
                    )
                if (a.extent.i, a.extent.j) != ((0, 0), (0, 0)):
                    raise GTScriptSemanticError(
                        f"cuda backend: written API field {n!r} is read by a stage computing on "
                        f"the extended region {a.extent.as_tuple()[:2]}, which other thread blocks "
                        "write; stage the value through a temporary instead"
                    )

    # -- k-walks -----------------------------------------------------------------

    def _loops(self, chains) -> List[_Loop]:
        """Every interval's loop over k, in order; the intervals of each
        walk chain share one loop, each at its node's lead."""
        walk_of: Dict[Tuple[int, int], _Loop] = {}
        for chain in chains:
            node_accs = [sorted({(n, a.write, a.offset[2]) for n, accs in self.acc.items()
                                 for a in accs if (a.mi, a.ii) in node}) for node in chain]
            shifts = _walk_shifts(node_accs)
            loop = _Loop([_Unit(mi, ii, s, ni)
                          for ni, (node, s) in enumerate(zip(chain, shifts)) for mi, ii in node])
            for u in loop.units:
                walk_of[(u.mi, u.ii)] = loop
        loops: List[_Loop] = []
        self.unit_of: Dict[Tuple[int, int], _Unit] = {}
        self.loop_of: Dict[Tuple[int, int], _Loop] = {}
        for mi, ms in enumerate(self.impl.multi_stages):
            for ii in range(len(ms.intervals)):
                loop = walk_of.get((mi, ii)) or _Loop([_Unit(mi, ii)])
                if loop.units[0].mi == mi and loop.units[0].ii == ii:
                    loops.append(loop)
                self.loop_of[(mi, ii)] = loop
                self.unit_of[(mi, ii)] = next(u for u in loop.units if (u.mi, u.ii) == (mi, ii))
        return loops

    def _find_rings(self) -> None:
        """Each walk's register rings: for a field (temporary or IJK API
        field) whose every write in the walk is unmasked, from a stage on the
        tile alone and at one lead, registers ``r_<name>_0..depth`` hold the
        newest levels it wrote (slot ``d`` the level written ``d`` steps
        ago).  They serve each read in the walk at the reader's own column,
        from a stage on the tile, that finds at every nk a level a write of
        the walk before it has written (``_reads_see_walk_writes``); the
        other reads, and every read outside the walk, read memory, which the
        writes still fill unless the field is a ``ring`` temporary."""
        for loop in self.loops:
            if not loop.walk:
                continue
            for n, accs in self.acc.items():
                if n in self.api and self.api[n].axes != ir.AXES_IJK:
                    continue
                inside = [a for a in accs if self.loop_of[(a.mi, a.ii)] is loop]
                writes = [a for a in inside if a.write]
                if not writes or any(a.masked or not _on_tile(a) for a in writes):
                    continue
                leads = {self.unit_of[(a.mi, a.ii)].shift for a in writes}
                if len(leads) != 1:
                    continue
                (lead,) = leads
                served: Dict[Tuple[int, int, int, int], int] = {}
                for a in inside:
                    # the read finds the level its writers passed ``lag`` steps ago
                    lag = lead - self.unit_of[(a.mi, a.ii)].shift - a.offset[2]
                    if (not a.write and a.offset[:2] == (0, 0) and _on_tile(a) and lag >= 0
                            and self._reads_see_walk_writes(loop, writes, [a])):
                        served[(a.mi, a.ii, a.si, a.offset[2])] = lag
                if served:
                    loop.rings[n] = _Ring(lead, max(served.values()), served)

    def _walk_planes(self, accs: List[_Access]) -> Optional[int]:
        """The depth of the shared-memory planes a walk keeps a
        temporary in when some access reaches another column or comes from
        a stage beyond the tile: every access in one walk, every write
        unmasked and at one lead, every read finding a level a write of the
        walk before it has written; else None."""
        if not accs or any(a.write and a.masked for a in accs):
            return None
        loop = self.loop_of[(accs[0].mi, accs[0].ii)]
        if not loop.walk or any(self.loop_of[(a.mi, a.ii)] is not loop for a in accs):
            return None
        leads = {self.unit_of[(a.mi, a.ii)].shift for a in accs if a.write}
        if len(leads) != 1:
            return None
        (lead,) = leads
        reads = [a for a in accs if not a.write]
        lags = [lead - self.unit_of[(a.mi, a.ii)].shift - a.offset[2] for a in reads]
        if min(lags, default=0) < 0 or not self._reads_see_walk_writes(loop, [a for a in accs if a.write], reads):
            return None
        return max(lags, default=0)

    def _reads_see_walk_writes(self, loop: _Loop, writes: List[_Access], reads: List[_Access]) -> bool:
        """Whether, in the reference's order, each of ``reads`` finds a level
        inside the domain that one of ``writes`` (of the walk) before it has
        written, at every nk.  The bounds are ``START + a`` or ``END + b``, so
        past the levels the offsets, the reads and the leads reach from either
        end, a larger nk only repeats the middle level."""
        units = loop.units
        index = {(u.mi, u.ii): ui for ui, u in enumerate(units)}
        ivs = [self.impl.multi_stages[u.mi].intervals[u.ii].interval for u in units]
        forward = [self.impl.multi_stages[u.mi].order == ir.IterationOrder.FORWARD for u in units]
        reach = (max(abs(b.offset) for iv in ivs for b in (iv.start, iv.end))
                 + max(abs(a.offset[2]) for a in reads) + loop.lookahead + 1)
        wr = [(index[(a.mi, a.ii)], a.si) for a in writes]

        def before(wu: int, ws: int, wk: int, ru: int, rs: int, rk: int) -> bool:
            if units[wu].node != units[ru].node:
                return units[wu].node < units[ru].node
            if forward[ru]:
                return (wk, wu, ws) < (rk, ru, rs)
            return ws < rs

        for nk in range(max(1, self.impl.min_k_levels), 2 * reach + 4):
            levels = [range(*iv.resolve(nk)) for iv in ivs]
            for a in reads:
                ru = index[(a.mi, a.ii)]
                for k in levels[ru]:
                    lv = k + a.offset[2]
                    if not 0 <= lv < nk or not any(
                        lv in levels[wu] and before(wu, ws, lv, ru, a.si, k) for wu, ws in wr
                    ):
                        return False
        return True

    # -- storage classes ------------------------------------------------------

    def _sole_ring(self, n: str, accs: List[_Access]) -> Optional["_Ring"]:
        """The walk's ring of a temporary whose every access lies in that
        walk and every read of which the ring serves: no memory needed."""
        if not accs:
            return None
        loop = self.loop_of[(accs[0].mi, accs[0].ii)]
        ring = loop.rings.get(n)
        if ring is None or any(self.loop_of[(a.mi, a.ii)] is not loop for a in accs):
            return None
        if any((a.mi, a.ii, a.si, a.offset[2]) not in ring.served for a in accs if not a.write):
            return None
        return ring

    def _classify_temps(self) -> Dict[str, _Temp]:
        impl = self.impl
        locals_ = {f.name for f in impl.local_decls}
        window: Dict[str, int] = {}
        for mi, plan in self.carry.items():
            if _contiguous(impl.multi_stages[mi]):
                window.update(dict(plan.window))
        temps: Dict[str, _Temp] = {}
        for decl in tuple(impl.temporaries) + tuple(impl.local_decls):
            n = decl.name
            if decl.axes != ir.AXES_IJK:
                raise GTScriptSemanticError(f"cuda backend: temporary {n!r} has axes {decl.axes}")
            accs = self.acc.get(n, [])
            ct = _ctype(decl.dtype)
            isz = np.dtype(decl.dtype).itemsize
            ext = impl.extent_of(n)
            masked = any(a.write and a.masked for a in accs)
            itvs = {(a.mi, a.ii) for a in accs}
            groups = {(a.mi, a.ii, self.group_of(a.mi, a.ii, a.si)) for a in accs}
            order = impl.multi_stages[next(iter(itvs))[0]].order if itvs else ir.IterationOrder.PARALLEL
            flat = all(a.offset == (0, 0, 0) for a in accs)
            if n in locals_ and flat and len(groups) == 1:
                temps[n] = _Temp(n, "reg", ct, isz, ext, masked=masked, group=next(iter(groups)))
            elif n in window:
                temps[n] = _Temp(n, "window", ct, isz, ext, depth=window[n], masked=masked)
            elif len(itvs) <= 1 and all(a.offset[2] == 0 for a in accs) and (
                order == ir.IterationOrder.PARALLEL or n in locals_
            ):
                temps[n] = _Temp(n, "plane", ct, isz, ext, masked=masked)
            elif (ring := self._sole_ring(n, accs)) is not None:
                temps[n] = _Temp(n, "ring", ct, isz, ext, depth=ring.depth)
            elif (depth := self._walk_planes(accs)) is not None:
                temps[n] = _Temp(n, "plane_ring", ct, isz, ext, depth=depth)
            else:
                dks = [a.offset[2] for a in accs] or [0]
                temps[n] = _Temp(n, "full", ct, isz, ext,
                                 k_lo=max(0, -min(dks)), k_hi=max(0, max(dks)), masked=masked,
                                 zero_all=masked or not _written_k_coverage_full(impl, n)
                                 or _read_before_written(impl, n))
        return temps

    def _staged_inputs(self) -> Dict[Tuple[int, int], List[Tuple[str, int]]]:
        """Per (multi-stage, interval): read-only IJK inputs, by vertical
        offset, that some stage reads beyond its own column."""
        staged: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}
        for n, f in self.api.items():
            if n in self.written or f.axes != ir.AXES_IJK:
                continue
            for a in self.acc.get(n, ()):
                wide = (a.offset[0], a.offset[1]) != (0, 0) or (a.extent.i, a.extent.j) != ((0, 0), (0, 0))
                key = (a.mi, a.ii)
                if wide and (n, a.offset[2]) not in staged.get(key, []):
                    staged.setdefault(key, []).append((n, a.offset[2]))
        return staged

    def _stage_loops(self) -> None:
        """Each loop's staged planes, by offset from the loop's k: a walk's
        unit at lead ``s`` reads plane ``dk`` at ``s + dk``."""
        for loop in self.loops:
            for ui, u in enumerate(loop.units):
                for n, dk in self.staged.get((u.mi, u.ii), []):
                    key = (n, dk + u.shift)
                    if key not in loop.readers:
                        loop.planes.append(key)
                    loop.readers.setdefault(key, []).append(ui)

    def staged_planes(self) -> List[Tuple[str, int]]:
        """Every staged (input, plane offset) of the kernel, each once."""
        out: List[Tuple[str, int]] = []
        for (mi, ii), lst in self.staged.items():
            shift = self.unit_of[(mi, ii)].shift
            for n, dk in lst:
                if (n, dk + shift) not in out:
                    out.append((n, dk + shift))
        return out

    # -- the load pipeline --------------------------------------------------------

    def _pipeline_loops(self) -> None:
        """Give each loop that streams its inputs its rings (``_Loop.pipe``):
        a PARALLEL interval (or k-sweep) that no walk holds and that may span
        more than one level, every read-only IJK input of which has 4- or
        8-byte elements; one ring for each (input, plane offset) it reads.
        None where the kernel's rings do not fit in the shared memory a block
        of ``DEFAULT_BLOCK`` asks for (``_pipe_smem``; many inputs: the
        ensemble statistics read every member)."""
        order = {n: i for i, n in enumerate(self.api)}
        for loop in self.loops:
            u = loop.units[0]
            iv = self.impl.multi_stages[u.mi].intervals[u.ii].interval
            if (loop.walk or self.impl.multi_stages[u.mi].order != ir.IterationOrder.PARALLEL
                    or (iv.start.level == iv.end.level and iv.end.offset - iv.start.offset <= 1)):
                continue
            planes = sorted({(n, a.offset[2]) for n, accs in self.acc.items()
                             if n in self.api and n not in self.written and self.api[n].axes == ir.AXES_IJK
                             for a in accs if (a.mi, a.ii) == (u.mi, u.ii) and not a.write},
                            key=lambda p: (order[p[0]], p[1]))
            if planes and all(np.dtype(self.api[n].dtype).itemsize in (4, 8) for n, _ in planes):
                loop.pipe = planes
        bi, bj = DEFAULT_BLOCK
        ring_bytes = 0
        for n, _dk in self.ring_planes():
            e, isz = self.impl.extent_of(n), np.dtype(self.api[n].dtype).itemsize
            rows, cols = bi + e.i[1] - e.i[0], bj + _ring_cols(e.j[1] - e.j[0], isz)
            ring_bytes += PIPE_DEPTH * _round_up(rows * cols * isz, _SMEM_ALIGN)
        if ring_bytes > _pipe_smem(bi * bj):
            for loop in self.loops:
                loop.pipe = []

    def ring_planes(self) -> List[Tuple[str, int]]:
        """Every (input, plane offset) some loop streams through a ring, each once."""
        out: List[Tuple[str, int]] = []
        for loop in self.loops:
            out += [p for p in loop.pipe if p not in out]
        return out

    def _inline_temps(self) -> None:
        """Mark ``inline`` each plane temporary of a pipelined loop that one
        unmasked assignment, alone in its stage, computes from the loop's
        staged planes, scalars and other inline temporaries; then group the
        stages that are left.  Not where the value is a product, which a
        reader's sum could fuse into one fma where the stored value is
        rounded first: the outputs keep their bits."""
        found = True
        while found:
            found = False
            for n, t in self.temps.items():
                writes = [a for a in self.acc.get(n, ()) if a.write]
                if t.kind != "plane" or t.masked or len(writes) != 1:
                    continue
                w = writes[0]
                loop = self.loop_of[(w.mi, w.ii)]
                stmts = self.impl.multi_stages[w.mi].intervals[w.ii].stages[w.si].stmts
                if not loop.pipe or len(stmts) != 1 or not isinstance(stmts[0], ir.Assign):
                    continue
                value = stmts[0].value
                if _may_fuse(value) or not all(
                        (fa.name, fa.offset[2]) in loop.pipe
                        or (fa.offset[2] == 0 and getattr(self.temps.get(fa.name), "kind", None) == "inline")
                        for fa in ir.walk_exprs(value) if isinstance(fa, ir.FieldAccess)):
                    continue
                t.kind, t.expr = "inline", value
                found = True
        dropped: Dict[Tuple[int, int], Set[int]] = {}
        for n, t in self.temps.items():
            if t.kind == "inline":
                for a in self.acc[n]:
                    if a.write:
                        dropped.setdefault((a.mi, a.ii), set()).add(a.si)
        for (mi, ii), skip in dropped.items():
            self.groups[(mi, ii)] = _groups(self.impl.multi_stages[mi].intervals[ii], skip)
        for t in self.temps.values():
            if t.kind == "reg" and (t.group[0], t.group[1]) in dropped:
                a = self.acc[t.name][0]
                t.group = (a.mi, a.ii, self.group_of(a.mi, a.ii, a.si))

    # -- shared memory ----------------------------------------------------------

    def _layout_smem(self) -> None:
        """Byte offsets of every shared-memory plane, and the estimate terms
        ``(extra_rows, extra_cols, planes, itemsize)`` of ``_smem_bytes``.
        A ring's rows are widened to whole 16-byte chunks (``_ring_cols``)."""
        self.smem_terms: List[Tuple[int, int, int, int]] = []
        self.smem_off: Dict[str, int] = {}
        off = 0

        def add(key: str, er: int, ec: int, planes: int, isz: int) -> None:
            nonlocal off
            self.smem_off[key] = off
            self.smem_terms.append((er, ec, planes, isz))
            off += _round_up((self.bi + er) * (self.bj + ec) * isz, _SMEM_ALIGN) * planes

        ring = self.ring_planes()
        self.depth = PIPE_DEPTH if ring else 0
        staged = self.staged_planes()
        for n, dk in staged + [p for p in ring if p not in staged]:
            e = self.impl.extent_of(n)
            isz = np.dtype(self.api[n].dtype).itemsize
            if (n, dk) in ring:
                add(_staged_key(n, dk), e.i[1] - e.i[0], _ring_cols(e.j[1] - e.j[0], isz), self.depth, isz)
            else:
                add(_staged_key(n, dk), e.i[1] - e.i[0], e.j[1] - e.j[0], 2 if self.double_buffer else 1, isz)
        for t in self.temps.values():
            if t.kind == "plane":
                add(t.name, t.rows_extra, t.cols_extra, 1, t.itemsize)
            elif t.kind in ("window", "plane_ring"):
                add(t.name, t.rows_extra, t.cols_extra, t.depth + 1, t.itemsize)
        self.smem_bytes = off

    def full_temps(self) -> List[_Temp]:
        return [t for t in self.temps.values() if t.kind == "full"]


def _staged_key(name: str, dk: int) -> str:
    return f"{name}@{dk}"


def _pipe_smem(threads: int) -> int:
    """The shared memory a block of ``threads`` asks for in a pipelined
    kernel, at least: what leaves an SM room for ``PIPE_THREADS`` resident
    threads and no more."""
    return _SMEM_SM // -(-PIPE_THREADS // threads) - _SMEM_BLOCK_RESERVED


def _ring_cols(cols_extra: int, itemsize: int) -> int:
    """A ring row's columns beyond the tile's: the input's extra columns and
    room to start the row at the 16-byte boundary below its first element,
    rounded up to whole 16-byte chunks (the tile's width is a whole number
    of chunks where the copies are wide)."""
    per = _SMEM_ALIGN // itemsize
    return _round_up(cols_extra + per - 1, per)


def _may_fuse(e: ir.Expr) -> bool:
    """Whether an expression's value may be a product, which a sum reading it
    could fuse into one fma."""
    if isinstance(e, ir.BinOp):
        return e.op == "*"
    if isinstance(e, ir.UnaryOp):
        return _may_fuse(e.operand)
    if isinstance(e, ir.TernaryOp):
        return _may_fuse(e.true_expr) or _may_fuse(e.false_expr)
    if isinstance(e, ir.Cast):
        return _may_fuse(e.expr)
    return False


def _dk_tag(dk: int) -> str:
    return f"m{-dk}" if dk < 0 else f"p{dk}"


# ---------------------------------------------------------------------------
# C++ expression printer
# ---------------------------------------------------------------------------

_NATIVE_C = {
    "abs": "fabs", "sqrt": "sqrt", "exp": "exp", "log": "log", "log2": "log2",
    "sin": "sin", "cos": "cos", "tan": "tan", "arcsin": "asin", "arccos": "acos",
    "arctan": "atan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "erf": "erf",
    "erfc": "erfc", "floor": "floor", "ceil": "ceil", "trunc": "trunc",
    "isfinite": "isfinite", "isnan": "isnan", "pow": "pow", "min": "gt_min",
    "max": "gt_max", "mod": "gt_mod",
}


class _CPrinter:
    def __init__(self, plan: _Plan):
        self.plan = plan
        # the staged (input, plane offset) planes of the unit being printed,
        # its lead (its k is the loop's k + shift), its loop's register rings
        # and the (multi-stage, interval, stage) being printed
        self.staged: Set[Tuple[str, int]] = set()
        self.shift = 0
        self.rings: Dict[str, _Ring] = {}
        self.at: Tuple[int, int, int] = (0, 0, 0)
        # the horizontal offset an inline temporary's value is printed at
        self.shift_ij: Tuple[int, int] = (0, 0)

    def literal(self, e: ir.Literal) -> str:
        if e.dtype == "bool" or isinstance(e.value, bool):
            return "true" if e.value else "false"
        v = float(e.value)
        if v != v:
            return "real_t(NAN)"
        if v in (float("inf"), float("-inf")):
            return "real_t(INFINITY)" if v > 0 else "real_t(-INFINITY)"
        return f"real_t({v!r})"

    def read(self, fa: ir.FieldAccess) -> str:
        ring = self.rings.get(fa.name)
        if ring is not None and fa.offset[:2] == (0, 0):
            lag = ring.served.get(self.at + (fa.offset[2],))
            if lag is not None:
                return f"r_{fa.name}_{lag}"
        si, sj = self.shift_ij
        return self._memory(fa.name, (fa.offset[0] + si, fa.offset[1] + sj, fa.offset[2]))

    def _memory(self, n: str, offset: Tuple[int, int, int]) -> str:
        di, dj, dk = offset
        t = self.plan.temps.get(n)
        if t is not None:
            if t.kind == "reg":
                return f"r_{n}"
            if t.kind == "inline":
                outer, self.shift_ij = self.shift_ij, (di, dj)
                try:
                    return f"({self.expr(t.expr)})"
                finally:
                    self.shift_ij = outer
            if t.kind == "plane":
                return f"P_{n}({di}, {dj})"
            if t.kind in ("window", "plane_ring"):
                return f"W_{n}({di}, {dj}, {dk})"
            return f"F_{n}({di}, {dj}, {dk})"
        axes = self.plan.api[n].axes
        if (n, dk + self.shift) in self.staged:
            return f"S_{n}_{_dk_tag(dk + self.shift)}({di}, {dj})"
        if axes == ir.AXES_IJK:
            return f"A_{n}({di}, {dj}, {dk})"
        if axes == ("I", "J"):
            return f"A_{n}({di}, {dj})"
        return f"A_{n}({dk})"

    def target(self, name: str) -> str:
        ring = self.rings.get(name)
        if ring is not None and not ring.memory:
            return f"r_{name}_0"
        return self._memory(name, (0, 0, 0))

    def expr(self, e: ir.Expr) -> str:
        if isinstance(e, ir.Literal):
            return self.literal(e)
        if isinstance(e, ir.ScalarRef):
            return f"s_{e.name}"
        if isinstance(e, ir.FieldAccess):
            return self.read(e)
        if isinstance(e, ir.UnaryOp):
            op = "!" if e.op == "not" else e.op
            return f"({op}{self.expr(e.operand)})"
        if isinstance(e, ir.BinOp):
            a, b = self.expr(e.left), self.expr(e.right)
            if e.op == "and":
                return f"({a} && {b})"
            if e.op == "or":
                return f"({a} || {b})"
            if e.op == "//":
                return f"floor(real_t({a}) / real_t({b}))"
            if e.op == "%":
                return f"gt_mod(real_t({a}), real_t({b}))"
            if e.op == "**":
                return f"pow(real_t({a}), real_t({b}))"
            return f"({a} {e.op} {b})"
        if isinstance(e, ir.TernaryOp):
            return f"({self.expr(e.cond)} ? {self.expr(e.true_expr)} : {self.expr(e.false_expr)})"
        if isinstance(e, ir.NativeCall):
            args = [self.expr(a) for a in e.args]
            if e.func == "sigmoid":
                return f"(real_t(1) / (real_t(1) + exp(-real_t({args[0]}))))"
            fn = _NATIVE_C.get(e.func)
            if fn is None:
                raise GTScriptSemanticError(f"cuda backend: unsupported native call {e.func!r}")
            if fn in ("gt_min", "gt_max", "gt_mod", "pow"):
                return f"{fn}(real_t({args[0]}), real_t({args[1]}))"
            return f"{fn}(real_t({args[0]}))"
        if isinstance(e, ir.Cast):
            return f"(({_ctype(e.dtype)})({self.expr(e.expr)}))"
        raise GTScriptSemanticError(f"cuda backend: unsupported expression {type(e).__name__}")

    def stmt(self, em: Emitter, s: ir.Stmt) -> None:
        if isinstance(s, ir.Assign):
            n = s.target.name
            ring = self.rings.get(n)
            if ring is not None and ring.memory:
                # the walk's readers take the value from the ring, the rest from memory
                em.line(f"r_{n}_0 = {self.expr(s.value)};")
                em.line(f"{self.target(n)} = r_{n}_0;")
            else:
                em.line(f"{self.target(n)} = {self.expr(s.value)};")
        elif isinstance(s, ir.If):
            em.line(f"if ({self.expr(s.cond)}) {{")
            em.push()
            for b in s.body:
                self.stmt(em, b)
            em.pop()
            if s.orelse:
                em.line("} else {")
                em.push()
                for b in s.orelse:
                    self.stmt(em, b)
                em.pop()
            em.line("}")
        else:
            raise GTScriptSemanticError(f"cuda backend: unsupported statement {type(s).__name__}")


# ---------------------------------------------------------------------------
# source generation
# ---------------------------------------------------------------------------

_PRELUDE = r"""
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ real_t gt_min(real_t a, real_t b) { return (a <= b || isnan(a)) ? a : b; }
__device__ __forceinline__ real_t gt_max(real_t a, real_t b) { return (a >= b || isnan(a)) ? a : b; }
// floored modulo, as numpy's np.mod (fmod truncates)
__device__ __forceinline__ real_t gt_mod(real_t a, real_t b) {
    real_t m = fmod(a, b);
    if (m != real_t(0)) {
        if ((b < real_t(0)) != (m < real_t(0))) m += b;
    } else {
        m = copysign(real_t(0), b);
    }
    return m;
}
__device__ __forceinline__ int gt_slot(int level, int slots) {
    int r = level % slots;
    return r < 0 ? r + slots : r;
}
// one element from device to shared memory, asynchronously (N: 4 or 8 bytes)
template <int N>
__device__ __forceinline__ void gt_cp_async(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "n"(N) : "memory");
}
// wait for this thread's outstanding cp.async copies
__device__ __forceinline__ void gt_cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
"""

# the load pipeline's copies, in the kernels that have one
_PIPE_PRELUDE = r"""
// 16 bytes from device to shared memory, asynchronously: the first src_bytes
// read, the rest zero-filled (a row's last chunk reads nothing past the row)
__device__ __forceinline__ void gt_cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(src_bytes) : "memory");
}
// close this thread's copies issued since the last commit into one group
__device__ __forceinline__ void gt_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's newest groups are still in flight
template <int N>
__device__ __forceinline__ void gt_cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }
"""


def _region_loop(em: Emitter, ext_i: Tuple[int, int], ext_j: Tuple[int, int]) -> None:
    """Open a loop of the block's threads over the tile (clipped to the
    domain) extended by ``ext``; binds tile-relative ``ii``, ``jj``."""
    (ilo, ihi), (jlo, jhi) = ext_i, ext_j
    em.line("{")
    em.push()
    em.line(f"const int rh = ti + {ihi - ilo}, rw = tj + {jhi - jlo};")
    em.line("for (int p = tid; p < rh * rw; p += NT) {")
    em.push()
    em.line(f"const int ii = p / rw + ({ilo}), jj = p % rw + ({jlo});")


def _close_region_loop(em: Emitter, sync: bool = True) -> None:
    em.pop()
    em.line("}")
    em.pop()
    em.line("}")
    if sync:
        em.line("__syncthreads();")


def _generate(impl: ir.StencilImplementation, block: Tuple[int, int], async_staging: bool = True,
              member_scalars: Optional[Tuple[str, ...]] = None):
    plan = _Plan(impl, block, async_staging)
    impl = plan.impl
    pr = _CPrinter(plan)
    kname = _cname(impl.name)
    float_dt = next((f.dtype for f in impl.api_fields if f.dtype.startswith("float")), "float64")
    # the member grid axis: blockIdx.z is the ensemble member
    members = member_scalars is not None
    unknown = set(member_scalars or ()) - {s.name for s in impl.scalars}
    if unknown:
        raise ValueError(f"cuda backend: per-member scalars {sorted(unknown)} are no scalars of {impl.name!r}")

    params: List[str] = []
    for f in impl.api_fields:
        ct = _ctype(f.dtype)
        params.append(f"{ct}* f_{f.name}")
        params += [f"long long st_{f.name}_{d}" for d in range(len(f.axes))]
        if members:
            params.append(f"long long sm_{f.name}")  # member stride: 0 for a shared field
        params += [f"int oi_{f.name}", f"int oj_{f.name}", f"int ok_{f.name}"]
    params += ["int ni", "int nj", "int nk"]
    for s in impl.scalars:
        if members and s.name in member_scalars:
            params.append(f"const {_ctype(s.dtype)}* sv_{s.name}")  # one value a member, on the card
        else:
            params.append(f"{_ctype(s.dtype)} s_{s.name}")
    for t in plan.full_temps():
        params.append(f"{t.ctype}* sc_{t.name}")
    call_args = [p.split()[-1] for p in params]

    em = Emitter()
    em.line(f"// Auto-generated by repro_torch.core.codegen_cuda ({CODEGEN_VERSION}) — stencil {impl.name!r}.")
    em.line("// Hopper counterpart of the fused Pallas TPU kernel that")
    em.line("// repro/core/codegen_pallas.py::generate_pallas_source emits for this stencil.")
    em.line("// Bound on the card: device-memory bytes (each input read once, each output")
    em.line("// written once, over the H100's 3.35 TB/s); a few flops per byte.  So what")
    em.line("// one interval passes to the next stays on chip where the order allows: a")
    em.line("// k-walk runs consecutive PARALLEL and FORWARD intervals as one loop down")
    em.line("// each column, each a few levels ahead of those that read it, and keeps")
    em.line("// their temporaries in registers or shared-memory planes, not in scratch.")
    for mi, ms in enumerate(impl.multi_stages):
        em.line(f"// multi-stage {mi}: {multistage_plan(ms)}")
    for w in _k_walks(plan):
        em.line(f"// k-walk: {'; '.join(f'ms {mi} {iv} at k{_c(s)}' for mi, iv, s in w['units'])}")
    for t in plan.temps.values():
        depth = t.kind in ("window", "ring", "plane_ring")
        em.line(f"// temporary {t.name}: {t.kind}" + (f" (depth {t.depth})" if depth else ""))
    em.line(f"typedef {_ctype(float_dt)} real_t;")
    em.line(f"#define BI {plan.bi}")
    em.line(f"#define BJ {plan.bj}")
    em.line("#define NT (BI * BJ)")
    em.line(f"#define SMEM_BYTES {plan.smem_bytes}")
    smem = "SMEM_BYTES"
    if plan.ring_planes():
        # the shared memory a block asks for: at most PIPE_THREADS resident threads an SM
        smem = "SMEM_LAUNCH"
        em.line(f"#define SMEM_LAUNCH {max(plan.smem_bytes, _pipe_smem(plan.bi * plan.bj))}")
    if members:
        em.line("// member grid axis: blockIdx.z is the ensemble member; each field moves by its")
        em.line("// member stride (0 for a field the members share), scratch by a member's blocks")
    ring = plan.ring_planes()
    for ln in (_PRELUDE + (_PIPE_PRELUDE if ring else "")).strip("\n").splitlines():
        em.line(ln)
    em.line()

    # accessors: API fields by global index, temporaries by tile-relative index
    for f in impl.api_fields:
        n = f.name
        if f.axes == ir.AXES_IJK:
            em.line(f"#define A_{n}(di, dj, dk) f_{n}[(long long)(oi_{n} + i0 + ii + (di)) * st_{n}_0"
                    f" + (long long)(oj_{n} + j0 + jj + (dj)) * st_{n}_1 + (long long)(ok_{n} + k + (dk)) * st_{n}_2]")
        elif f.axes == ("I", "J"):
            em.line(f"#define A_{n}(di, dj) f_{n}[(long long)(oi_{n} + i0 + ii + (di)) * st_{n}_0"
                    f" + (long long)(oj_{n} + j0 + jj + (dj)) * st_{n}_1]")
        else:
            em.line(f"#define A_{n}(dk) f_{n}[(long long)(ok_{n} + k + (dk)) * st_{n}_0]")
    staged = plan.staged_planes()
    for n, dk in staged + [p for p in ring if p not in staged]:
        e = impl.extent_of(n)
        if (n, dk) in ring:
            # slot ``stg`` of the ring; a row starts ``sh_<n>`` elements before
            # the input's first column, at a 16-byte boundary where copies are wide
            w = plan.bj + _ring_cols(e.j[1] - e.j[0], np.dtype(plan.api[n].dtype).itemsize)
            em.line(f"#define S_{n}_{_dk_tag(dk)}(di, dj) ss_{n}_{_dk_tag(dk)}[stg * {_ring_slot_elems(plan, n)}"
                    f" + (ii + (di) - ({e.i[0]})) * {w} + (jj + (dj) - ({e.j[0]}) + sh_{n})]")
            continue
        w = plan.bj + e.j[1] - e.j[0]
        # double-buffered: ``stg`` is the buffer of the plane being computed
        buf = f"stg * {_staged_plane_elems(plan, n)} + " if plan.double_buffer else ""
        em.line(f"#define S_{n}_{_dk_tag(dk)}(di, dj) ss_{n}_{_dk_tag(dk)}"
                f"[{buf}(ii + (di) - ({e.i[0]})) * {w} + (jj + (dj) - ({e.j[0]}))]")
    for t in plan.temps.values():
        w = plan.bj + t.cols_extra
        h = plan.bi + t.rows_extra
        ilo, jlo = t.ext.i[0], t.ext.j[0]
        idx = f"(ii + (di) - ({ilo})) * {w} + (jj + (dj) - ({jlo}))"
        if t.kind == "plane":
            em.line(f"#define P_{t.name}(di, dj) sp_{t.name}[{idx}]")
        elif t.kind in ("window", "plane_ring"):
            stride = _round_up(h * w * t.itemsize, _SMEM_ALIGN) // t.itemsize
            em.line(f"#define W_{t.name}(di, dj, dk) sp_{t.name}[gt_slot(k + (dk), {t.depth + 1}) * {stride} + {idx}]")
        elif t.kind == "full":
            nkt = f"(nk + {t.k_lo + t.k_hi})"
            em.line(f"#define F_{t.name}(di, dj, dk) sc_{t.name}[blk * ((long long){h * w} * {nkt})"
                    f" + ((long long)(k + (dk) + {t.k_lo}) * {h} + (ii + (di) - ({ilo}))) * {w}"
                    f" + (jj + (dj) - ({jlo}))]")
    em.line()

    bounds = "NT"
    if any(loop.walk for loop in plan.loops):
        # a walk carries its levels in registers: ask for 1024 resident threads
        # an SM (64 registers a thread), so that other blocks hide each level's
        # memory latency, and let the compiler spill the rest
        bounds = f"NT, {max(1, 1024 // (plan.bi * plan.bj))}"
    em.line(f"__global__ void __launch_bounds__({bounds}) k_{kname}({', '.join(params)}) {{")
    em.push()
    em.line("extern __shared__ __align__(16) unsigned char smem[];")
    for key, off in plan.smem_off.items():
        if "@" in key:
            n, dk = key.split("@")
            ct = _ctype(plan.api[n].dtype)
            em.line(f"{ct}* ss_{n}_{_dk_tag(int(dk))} = reinterpret_cast<{ct}*>(smem + {off});")
        else:
            em.line(f"{plan.temps[key].ctype}* sp_{key} = reinterpret_cast<{plan.temps[key].ctype}*>(smem + {off});")
    if members:
        for f in impl.api_fields:
            em.line(f"f_{f.name} += (long long)blockIdx.z * sm_{f.name};")
        for s in impl.scalars:
            if s.name in member_scalars:
                em.line(f"const {_ctype(s.dtype)} s_{s.name} = sv_{s.name}[blockIdx.z];")
    em.line("const int tid = threadIdx.y * BJ + threadIdx.x;")
    em.line("const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;")
    em.line("const int ti = min(BI, ni - i0), tj = min(BJ, nj - j0);")
    if members:
        em.line("const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;")
    else:
        em.line("const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;")
    em.line("(void)blk; (void)nk;")
    _emit_ring_chunks(em, plan)
    full = plan.full_temps()
    for t in full:
        # the zero-initialized temporary: its k margins always, all of it
        # when a masked or partial-k write leaves points unwritten
        h, w = plan.bi + t.rows_extra, plan.bj + t.cols_extra
        base = f"sc_{t.name} + blk * ((long long){h * w} * (nk + {t.k_lo + t.k_hi}))"
        if t.zero_all:
            em.line(f"for (long long p = tid; p < (long long){h * w} * (nk + {t.k_lo + t.k_hi}); p += NT) "
                    f"({base})[p] = {t.ctype}(0);")
            continue
        if t.k_lo:
            em.line(f"for (int p = tid; p < {h * w * t.k_lo}; p += NT) ({base})[p] = {t.ctype}(0);")
        if t.k_hi:
            em.line(f"for (int p = tid; p < {h * w * t.k_hi}; p += NT) "
                    f"({base})[(long long){h * w} * (nk + {t.k_lo}) + p] = {t.ctype}(0);")
    if any(t.zero_all or t.k_lo or t.k_hi for t in full):
        em.line("__syncthreads();")

    done = -1
    for loop in plan.loops:
        for mi in sorted({u.mi for u in loop.units} - set(range(done + 1))):
            em.line(f"// ---- multi-stage {mi}: {multistage_plan(impl.multi_stages[mi])}")
            windows = _windows(plan, mi)
            if windows:
                # history planes start zeroed, like the zero-initialized temporary
                for t in windows:
                    em.line(f"for (int p = tid; p < {(t.depth + 1)} * {_plane_elems(plan, t)}; p += NT) "
                            f"sp_{t.name}[p] = {t.ctype}(0);")
                em.line("__syncthreads();")
            done = mi
        _emit_loop(em, plan, pr, loop)
    em.pop()
    em.line("}")
    em.line()

    em.line(f"extern \"C\" int launch_{kname}({', '.join(params + (['int nm'] if members else []) + ['void* stream'])}) {{")
    em.push()
    em.line("const dim3 block(BJ, BI);")
    if members:
        em.line("const dim3 grid((nj + BJ - 1) / BJ, (ni + BI - 1) / BI, nm);")
    else:
        em.line("const dim3 grid((nj + BJ - 1) / BJ, (ni + BI - 1) / BI);")
    em.line(f"if ({smem} > {SMEM_DEFAULT_LIMIT}) {{")
    em.push()
    em.line(f"cudaError_t e = cudaFuncSetAttribute(k_{kname}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});")
    em.line("if (e != cudaSuccess) return (int)e;")
    em.pop()
    em.line("}")
    em.line(f"k_{kname}<<<grid, block, {smem}, (cudaStream_t)stream>>>({', '.join(call_args)});")
    em.line("return (int)cudaGetLastError();")
    em.pop()
    em.line("}")
    return em.source(), plan


def _windows(plan: _Plan, mi: int) -> List[_Temp]:
    return [t for t in plan.temps.values() if t.kind == "window"
            and any(a.mi == mi for a in plan.acc.get(t.name, ()))]


def _prologue(plan: _Plan, u: _Unit) -> List[str]:
    """Zero-fills before a unit's stages at its level: the current plane of
    each window of its multi-stage, and each masked plane it touches."""
    lines = []
    for t in _windows(plan, u.mi):
        lines.append(f"for (int p = tid; p < {_plane_elems(plan, t)}; p += NT) "
                     f"sp_{t.name}[gt_slot(k, {t.depth + 1}) * {_plane_elems(plan, t)} + p] = {t.ctype}(0);")
    for t in plan.temps.values():
        if t.kind == "plane" and t.masked and any((a.mi, a.ii) == (u.mi, u.ii) for a in plan.acc.get(t.name, ())):
            lines.append(f"for (int p = tid; p < {_plane_elems(plan, t)}; p += NT) sp_{t.name}[p] = {t.ctype}(0);")
    return lines


def _nest(fn: str, args: List[str]) -> str:
    return args[0] if len(args) == 1 else f"{fn}({args[0]}, {_nest(fn, args[1:])})"


def _emit_loop(em: Emitter, plan: _Plan, pr: _CPrinter, loop: _Loop) -> None:
    """One loop over k: a single interval plane by plane, or a walk, whose
    step ``t`` runs each unit at its level ``k = t + shift`` where its
    interval holds it."""
    if loop.pipe:
        _emit_pipeline(em, plan, pr, loop)
        return
    impl = plan.impl
    walk = loop.walk
    ivs = [impl.multi_stages[u.mi].intervals[u.ii].interval for u in loop.units]
    backward = impl.multi_stages[loop.units[0].mi].order == ir.IterationOrder.BACKWARD
    prefetch = plan.double_buffer and bool(loop.planes)
    pr.rings = loop.rings
    guards = None
    var, lo, hi = ("t", "t0", "t1") if walk else ("k", "k0", "k1")
    em.line("{")
    em.push()
    if walk:
        active = [f"k{_c(u.shift)} >= {bound_expr(iv.start)} && k{_c(u.shift)} < {bound_expr(iv.end)}"
                  for u, iv in zip(loop.units, ivs)]
        # a staged plane is copied at the steps where a unit reading it runs
        guards = {key: " || ".join(f"({active[ui]})" for ui in readers) for key, readers in loop.readers.items()}
        starts = [bound_expr(iv.start) + _c(-u.shift) for u, iv in zip(loop.units, ivs)]
        ends = [bound_expr(iv.end) + _c(-u.shift) for u, iv in zip(loop.units, ivs)]
        em.line(f"const int t0 = {_nest('min', starts)};")
        em.line(f"const int t1 = {_nest('max', ends)};")
        for n, ring in loop.rings.items():
            ct = plan.temps[n].ctype if n in plan.temps else _ctype(plan.api[n].dtype)
            em.line(f"{ct} " + ", ".join(f"r_{n}_{d} = {ct}(0)" for d in range(ring.depth + 1)) + ";")
    else:
        em.line(f"const int k0 = {bound_expr(ivs[0].start)}, k1 = {bound_expr(ivs[0].end)};")
    if not prefetch and set(loop.planes) & set(plan.ring_planes()):
        em.line("const int stg = 0;")  # a plane a pipelined loop also stages: its ring's first slot
    if prefetch:
        # the first plane's copy starts before the loop
        em.line("int stg = 0;")
        em.line(f"if ({lo} < {hi}) {{")
        em.push()
        em.line(f"const int k = {'k1 - 1' if backward else lo};")
        _emit_staging(em, plan, loop.planes, asynchronous=True, guards=guards)
        em.pop()
        em.line("}")
    if backward:
        em.line("for (int k = k1 - 1; k >= k0; --k) {")
    else:
        em.line(f"for (int {var} = {lo}; {var} < {hi}; ++{var}) {{")
    em.push()
    prologue = [] if walk else _prologue(plan, loop.units[0])
    for ln in prologue:
        em.line(ln)
    if prefetch:
        # this plane's copies (issued one iteration ago) have landed
        # for every thread; then the next plane's copy overlaps this
        # plane's stages (its buffer was last read before the barrier)
        em.line("gt_cp_async_wait_all();")
        em.line("__syncthreads();")
        em.line(f"if ({'k - 1 >= k0' if backward else f'{var} + 1 < {hi}'}) {{")
        em.push()
        em.line(f"const int k_next = {'k - 1' if backward else f'{var} + 1'}, stg_next = stg ^ 1;")
        em.line("{")
        em.push()
        em.line("const int k = k_next, stg = stg_next;")
        _emit_staging(em, plan, loop.planes, asynchronous=True, guards=guards)
        em.pop()
        em.line("}")
        em.pop()
        em.line("}")
    else:
        if loop.planes:
            if walk:
                em.line("{")
                em.push()
                em.line("const int k = t;")
            _emit_staging(em, plan, loop.planes, asynchronous=False, guards=guards)
            if walk:
                em.pop()
                em.line("}")
        if loop.planes or prologue:
            em.line("__syncthreads();")
    if walk:
        _emit_walk_step(em, plan, pr, loop, ivs)
    else:
        _emit_groups(em, plan, pr, loop.units[0], None)
    if prefetch:
        em.line("stg ^= 1;")
    em.pop()
    em.line("}")
    em.pop()
    em.line("}")


def _emit_pipeline(em: Emitter, plan: _Plan, pr: _CPrinter, loop: _Loop) -> None:
    """A loop that streams its inputs (``_Loop.pipe``): planes ``k0 .. k0 +
    D - 2`` are copied before it, each a group; at plane ``k`` one barrier,
    after this thread's group of plane ``k`` has landed, shows every thread
    its copies and frees the slot plane ``k - 1`` used, which plane ``k + D -
    1`` then fills while plane ``k``'s stages compute.  The stages' groups
    end without a barrier but between one another; one after the loop."""
    u = loop.units[0]
    iv = plan.impl.multi_stages[u.mi].intervals[u.ii].interval
    depth = plan.depth
    pr.rings = {}
    em.line("{")
    em.push()
    em.line(f"const int k0 = {bound_expr(iv.start)}, k1 = {bound_expr(iv.end)};")
    em.line(f"// the load pipeline: {depth} slots a staged plane, planes k + 1 .. k + {depth - 1} in flight")
    em.line(f"for (int d = 0; d < {depth - 1} && k0 + d < k1; ++d) {{")
    em.push()
    em.line("const int k = k0 + d, stg = d;")
    _emit_ring_copies(em, plan, loop.pipe)
    em.line("gt_cp_async_commit();")
    em.pop()
    em.line("}")
    em.line("int stg = 0;")
    em.line("for (int k = k0; k < k1; ++k) {")
    em.push()
    em.line(f"// plane k has landed: all but the newest {depth - 2} groups, every group in the last planes")
    em.line(f"if (k + {depth - 1} <= k1) gt_cp_async_wait<{depth - 2}>(); else gt_cp_async_wait_all();")
    em.line("__syncthreads();")
    em.line(f"if (k + {depth - 1} < k1) {{")
    em.push()
    em.line(f"// plane k + {depth - 1} into the slot plane k - 1 used")
    em.line(f"const int k_next = k + {depth - 1}, stg_next = stg == 0 ? {depth - 1} : stg - 1;")
    em.line("{")
    em.push()
    em.line("const int k = k_next, stg = stg_next;")
    _emit_ring_copies(em, plan, loop.pipe)
    em.pop()
    em.line("}")
    em.line("gt_cp_async_commit();")
    em.pop()
    em.line("}")
    prologue = _prologue(plan, u)
    for ln in prologue:
        em.line(ln)
    if prologue:
        em.line("__syncthreads();")
    _emit_groups(em, plan, pr, u, None, last_sync=False)
    em.line(f"stg = stg == {depth - 1} ? 0 : stg + 1;")
    em.pop()
    em.line("}")
    em.line("__syncthreads();")
    em.pop()
    em.line("}")


def _emit_ring_copies(em: Emitter, plan: _Plan, planes: List[Tuple[str, int]]) -> None:
    """Start the copies of plane ``k`` (plus each input's vertical offset) of
    ``planes``, tile plus extent, into slot ``stg`` of their rings: whole
    16-byte chunks where the input's copies are wide (the last of a row reads
    only the row), else one element a copy.  A thread's first chunk is the
    one ``_emit_ring_chunks`` placed; a loop places the others where the
    block's region can have more chunks than the block has threads."""
    nt = plan.bi * plan.bj
    for n, dk in planes:
        e = plan.impl.extent_of(n)
        rows, ec = plan.bi + e.i[1] - e.i[0], e.j[1] - e.j[0]
        isz = np.dtype(plan.api[n].dtype).itemsize
        per = _SMEM_ALIGN // isz
        tag = _dk_tag(dk)
        dst = f"ss_{n}_{tag} + stg * {_ring_slot_elems(plan, n)} + so_{n}"
        src = f"f_{n} + go_{n} + (long long)(ok_{n} + k + ({dk})) * st_{n}_2"
        em.line(f"// stage {n}[k{dk:+d}] plane, tile plus halo")
        em.line(f"if (tid < nq_{n}) {{")
        em.push()
        em.line(f"if (wide_{n}) gt_cp_async16({dst}, {src}, by_{n});")
        em.line(f"else gt_cp_async<{isz}>({dst}, {src});")
        em.pop()
        em.line("}")
        loops = []
        if plan.bj % per == 0 and rows * -(-(plan.bj + ec + per - 1) // per) > nt:
            loops.append((f"wide_{n}", [
                f"const int ii = p / nc_{n} + ({e.i[0]}), c = p % nc_{n} * {per}, jj = c - sh_{n} + ({e.j[0]});",
                f"gt_cp_async16(&S_{n}_{tag}(0, 0), &A_{n}(0, 0, {dk}), min({per}, sh_{n} + tj + {ec} - c) * {isz});"]))
        if rows * (plan.bj + ec) > nt:
            loops.append((f"!wide_{n}", [
                f"const int ii = p / nc_{n} + ({e.i[0]}), jj = p % nc_{n} + ({e.j[0]});",
                f"gt_cp_async<{isz}>(&S_{n}_{tag}(0, 0), &A_{n}(0, 0, {dk}));"]))
        for cond, body in loops:
            em.line(f"if ({cond}) {{")
            em.push()
            em.line(f"for (int p = tid + NT; p < nq_{n}; p += NT) {{")
            em.push()
            for ln in body:
                em.line(ln)
            em.pop()
            em.line("}")
            em.pop()
            em.line("}")


def _emit_ring_chunks(em: Emitter, plan: _Plan) -> None:
    """For each input a ring stages: whether its copies are wide, the shift
    ``sh_<n>`` of its rows in the slots, its region's chunks a row
    (``nc_<n>``: 16-byte chunks, or elements) and in all (``nq_<n>``), and
    this thread's first chunk: its offset in a slot (``so_<n>``), in the
    field but for the level (``go_<n>``) and the bytes it reads (``by_<n>``),
    the same at every plane."""
    for n in dict.fromkeys(n for n, _dk in plan.ring_planes()):
        e = plan.impl.extent_of(n)
        er, ec = e.i[1] - e.i[0], e.j[1] - e.j[0]
        isz = np.dtype(plan.api[n].dtype).itemsize
        per = _SMEM_ALIGN // isz
        w = plan.bj + _ring_cols(ec, isz)
        em.line(f"// {n}: 16-byte copies where its rows start 16-byte aligned, else one element a copy")
        if plan.bj % per:
            em.line(f"const bool wide_{n} = false;")
        else:
            em.line(f"const bool wide_{n} = st_{n}_1 == 1 && st_{n}_0 % {per} == 0 && st_{n}_2 % {per} == 0"
                    f" && ((unsigned long long)f_{n} & {_SMEM_ALIGN - 1}) == 0;")
        em.line(f"const int sh_{n} = wide_{n} ? (oj_{n} + j0 + ({e.j[0]})) % {per} : 0;")
        em.line(f"const int nc_{n} = wide_{n} ? (sh_{n} + tj + {ec + per - 1}) / {per} : tj + {ec}, "
                f"nq_{n} = (ti + {er}) * nc_{n};")
        em.line(f"int so_{n} = 0, by_{n} = 0;")
        em.line(f"long long go_{n} = 0;")
        em.line(f"if (tid < nq_{n}) {{")
        em.push()
        em.line(f"const int ii = tid / nc_{n} + ({e.i[0]}), c = tid % nc_{n} * (wide_{n} ? {per} : 1);")
        em.line(f"const int jj = c - sh_{n} + ({e.j[0]});")
        em.line(f"so_{n} = (ii - ({e.i[0]})) * {w} + c;")
        em.line(f"go_{n} = (long long)(oi_{n} + i0 + ii) * st_{n}_0 + (long long)(oj_{n} + j0 + jj) * st_{n}_1;")
        em.line(f"by_{n} = min({per}, sh_{n} + tj + {ec} - c) * {isz};")
        em.pop()
        em.line("}")


def _ring_slot_elems(plan: _Plan, name: str) -> int:
    """Elements of one slot of a ring (16-byte aligned)."""
    e = plan.impl.extent_of(name)
    isz = np.dtype(plan.api[name].dtype).itemsize
    w = plan.bj + _ring_cols(e.j[1] - e.j[0], isz)
    return _round_up((plan.bi + e.i[1] - e.i[0]) * w * isz, _SMEM_ALIGN) // isz


def _emit_walk_step(em: Emitter, plan: _Plan, pr: _CPrinter, loop: _Loop, ivs) -> None:
    """One step of a walk: each unit at its level, in the reference's order.
    A barrier parts two groups only where one writes what the other touches
    and a thread may reach a point another thread handles (a horizontal
    offset, or a stage computing beyond the tile).  Between units it stands
    outside their guards, which hold at some steps and not at others; the
    step ends with one, and the register rings move one level down."""
    pending: List[Tuple[bool, Dict[str, Tuple[bool, bool]]]] = []
    for u, iv in zip(loop.units, ivs):
        mine = [_group_touches(plan, u, stages) for stages in plan.groups[(u.mi, u.ii)]]
        prologue = _prologue(plan, u)
        if pending and (prologue or any(_hazard(p, g) for p in pending for g in mine)):
            em.line("__syncthreads();")
            pending = []
        em.line(f"// multi-stage {u.mi}, [{bound_expr(iv.start)}, {bound_expr(iv.end)}) at k = t{_c(u.shift)}")
        em.line("{")
        em.push()
        em.line(f"const int k = t{_c(u.shift)};")
        em.line(f"if (k >= {bound_expr(iv.start)} && k < {bound_expr(iv.end)}) {{")
        em.push()
        for ln in prologue:
            em.line(ln)
        if prologue:
            em.line("__syncthreads();")
        _emit_groups(em, plan, pr, u, [])
        em.pop()
        em.line("}")
        em.pop()
        em.line("}")
        pending += mine
    em.line("__syncthreads();")
    for n, ring in loop.rings.items():
        for d in range(ring.depth, 0, -1):
            em.line(f"r_{n}_{d} = r_{n}_{d - 1};")


def _group_touches(plan: _Plan, u: _Unit, stages: List[int]) -> Tuple[bool, Dict[str, Tuple[bool, bool]]]:
    """Whether a group computes on the tile alone, and each field it
    touches: (written, every access at its own column)."""
    ext = plan.impl.multi_stages[u.mi].intervals[u.ii].stages[stages[0]].compute_extent
    touched: Dict[str, Tuple[bool, bool]] = {}
    for n, accs in plan.acc.items():
        for a in accs:
            if (a.mi, a.ii) == (u.mi, u.ii) and a.si in stages:
                w, own = touched.get(n, (False, True))
                touched[n] = (w or a.write, own and a.offset[:2] == (0, 0))
    return (ext.i, ext.j) == ((0, 0), (0, 0)), touched


def _hazard(a, b) -> bool:
    """Whether two groups (``_group_touches``) need a barrier between them:
    one writes a field the other touches, and not both compute on the tile
    alone with every access at its own column."""
    (tile_a, ta), (tile_b, tb) = a, b
    return any((ta[n][0] or tb[n][0]) and not (tile_a and tile_b and ta[n][1] and tb[n][1])
               for n in ta.keys() & tb.keys())


def _emit_groups(em: Emitter, plan: _Plan, pr: _CPrinter, u: _Unit, pending, last_sync: bool = True) -> None:
    """A unit's groups of stages at level ``k``.  With ``pending`` None each
    group ends with a barrier (the last one only with ``last_sync``); else (a
    walk's unit) a barrier comes before a group only where ``_hazard`` says,
    against the unit's groups since the last one."""
    itv = plan.impl.multi_stages[u.mi].intervals[u.ii]
    pr.shift = u.shift
    pipe = plan.loop_of[(u.mi, u.ii)].pipe
    pr.staged = set(pipe) if pipe else {(n, dk + u.shift) for n, dk in plan.staged.get((u.mi, u.ii), [])}
    groups = plan.groups[(u.mi, u.ii)]
    for g, stages in enumerate(groups):
        ext = itv.stages[stages[0]].compute_extent
        if pending is not None:
            mine = _group_touches(plan, u, stages)
            if any(_hazard(p, mine) for p in pending):
                em.line("__syncthreads();")
                pending = []
        if pipe and (ext.i, ext.j) == ((0, 0), (0, 0)):
            # each thread's own point of the tile: no division, and the
            # point's addresses are the same at every plane
            em.line("{")
            em.push()
            em.line("if (threadIdx.y < ti && threadIdx.x < tj) {")
            em.push()
            em.line("const int ii = threadIdx.y, jj = threadIdx.x;")
        else:
            _region_loop(em, ext.i, ext.j)
        for t in plan.temps.values():
            if t.kind == "reg" and t.group == (u.mi, u.ii, g):
                em.line(f"{t.ctype} r_{t.name} = {t.ctype}(0);")
        for si in stages:
            pr.at = (u.mi, u.ii, si)
            for stmt in itv.stages[si].stmts:
                pr.stmt(em, stmt)
        _close_region_loop(em, sync=pending is None and (last_sync or g < len(groups) - 1))
        if pending is not None:
            pending.append(mine)


def _emit_staging(em: Emitter, plan: _Plan, staged, asynchronous: bool,
                  guards: Optional[Dict[Tuple[str, int], str]] = None) -> None:
    """Copy plane ``k`` (plus each input's vertical offset) of the staged
    inputs, tile plus halo, into their shared-memory planes (buffer ``stg``
    when double-buffered): by ``cp.async`` or by plain loads and stores.
    ``guards`` gives a walk's condition for each plane's copy."""
    for n, dk in staged:
        e = plan.impl.extent_of(n)
        em.line(f"// stage {n}[k{dk:+d}] plane, tile plus halo")
        em.line(f"if ({guards[(n, dk)]}) {{" if guards else "{")
        em.push()
        em.line(f"const int rh = ti + {e.i[1] - e.i[0]}, rw = tj + {e.j[1] - e.j[0]};")
        em.line("for (int p = tid; p < rh * rw; p += NT) {")
        em.push()
        em.line(f"const int ii = p / rw + ({e.i[0]}), jj = p % rw + ({e.j[0]});")
        if asynchronous:
            isz = np.dtype(plan.api[n].dtype).itemsize
            em.line(f"gt_cp_async<{isz}>(&S_{n}_{_dk_tag(dk)}(0, 0), &A_{n}(0, 0, {dk}));")
        else:
            em.line(f"S_{n}_{_dk_tag(dk)}(0, 0) = A_{n}(0, 0, {dk});")
        em.pop()
        em.line("}")
        em.pop()
        em.line("}")


def _staged_plane_elems(plan: _Plan, name: str) -> int:
    """Elements of one buffer of a staged plane (16-byte aligned)."""
    e = plan.impl.extent_of(name)
    isz = np.dtype(plan.api[name].dtype).itemsize
    h, w = plan.bi + e.i[1] - e.i[0], plan.bj + e.j[1] - e.j[0]
    return _round_up(h * w * isz, _SMEM_ALIGN) // isz


def _plane_elems(plan: _Plan, t: _Temp) -> int:
    h = plan.bi + t.rows_extra
    w = plan.bj + t.cols_extra
    return _round_up(h * w * t.itemsize, _SMEM_ALIGN) // t.itemsize


def _k_walks(plan: _Plan) -> List[Dict[str, Any]]:
    """Each walk: its units in order, as (multi-stage, interval, lead), and
    its lookahead, the largest lead."""
    return [{"units": [(u.mi, "[{}, {})".format(*(bound_expr(b) for b in (iv.start, iv.end))), u.shift)
                       for u in loop.units
                       for iv in (plan.impl.multi_stages[u.mi].intervals[u.ii].interval,)],
             "lookahead": loop.lookahead,
             "registers": {n: ring.depth for n, ring in loop.rings.items()}} for loop in plan.loops if loop.walk]


def _prefetch(plan: _Plan) -> List[Dict[str, Any]]:
    """Each pipelined loop: its multi-stage, interval (and its bounds as
    ``AxisBound.key()``), ring depth, copy width in bytes (one element where
    a field's rows do not start 16-byte aligned) and staged inputs, as (name,
    plane offset, (ilo, ihi, jlo, jhi) of the region copied)."""
    out = []
    for loop in plan.loops:
        if not loop.pipe:
            continue
        u = loop.units[0]
        iv = plan.impl.multi_stages[u.mi].intervals[u.ii].interval
        out.append({
            "ms": u.mi, "interval": "[{}, {})".format(bound_expr(iv.start), bound_expr(iv.end)),
            "bounds": (iv.start.key(), iv.end.key()), "depth": plan.depth, "width": _SMEM_ALIGN,
            "inputs": [(n, dk, tuple(x for ax in (plan.impl.extent_of(n).i, plan.impl.extent_of(n).j) for x in ax))
                       for n, dk in loop.pipe],
        })
    return out


def generate_cuda_module_source(
    impl: ir.StencilImplementation,
    block: Tuple[int, int] = DEFAULT_BLOCK,
    async_staging: bool = True,
    member_scalars: Optional[Tuple[str, ...]] = None,
) -> str:
    """The Python module of a ``cuda`` stencil: the CUDA source and the
    metadata the launcher and the autotuner read.  A PARALLEL loop streams
    its inputs through the load pipeline (module docstring); elsewhere the
    staged input planes are double-buffered and the next one is filled by
    ``cp.async`` while the current one computes.  ``async_staging=False``
    stages only the planes read beyond their column, with plain loads, and
    stores every plane temporary: a kernel that exists only so that
    ``chip_smoke.py`` can time the prefetch against it (no stencil option
    reaches it).

    ``member_scalars`` (a tuple, possibly empty) generates the member-batched
    kernel an ensemble launches once for all its members: a third grid axis
    over the members, a member stride for every field (0 for a shared one),
    and the named scalars read per member from a device array.  ``None``, the
    default, is the one-member kernel, whose source does not change."""
    source, plan = _generate(impl, block, async_staging, member_scalars)
    if "'''" in source:
        raise AssertionError("generated CUDA source may not contain triple quotes")
    schedule = _schedule(impl, plan.carry)
    schedule.update(
        block_default=(plan.bi, plan.bj),
        smem_bytes=plan.smem_bytes,
        temporaries={t.name: t.kind for t in plan.temps.values()},
        staged_inputs=sorted({f"{n}[k{dk:+d}]" for lst in plan.staged.values() for n, dk in lst}),
        async_staging=plan.async_staging,
        parallel_sweeps=dict(plan.sweeps),
        k_walks=_k_walks(plan),
        prefetch=_prefetch(plan),
    )
    em = Emitter()
    em.line(f'"""Auto-generated by repro_torch.core — stencil {impl.name!r}, backend \'cuda\'."""')
    em.line(f"CUDA_SOURCE = r'''{source}'''")
    em.line(f"KERNEL = 'launch_{_cname(impl.name)}'")
    em.line(f"BLOCK = {(plan.bi, plan.bj)!r}")
    em.line(f"SCHEDULE = {schedule!r}")
    em.line(f"SMEM_BYTES = {plan.smem_bytes!r}")
    em.line(f"_SMEM_TERMS = {plan.smem_terms!r}")
    # (name, axes, dtype, written, (ilo, ihi, jlo, jhi) of the region the kernel touches)
    fields = []
    for f in impl.api_fields:
        e = impl.extent_of(f.name)
        fields.append((f.name, f.axes, f.dtype, f.name in plan.written, (e.i[0], e.i[1], e.j[0], e.j[1])))
    em.line(f"FIELDS = {fields!r}")
    em.line(f"SCALARS = {[(s.name, s.dtype) for s in impl.scalars]!r}")
    em.line(f"SCRATCH = {[(t.name, impl.field(t.name).dtype, t.rows_extra, t.cols_extra, t.k_lo + t.k_hi) for t in plan.full_temps()]!r}")
    if member_scalars is not None:
        em.line(f"MEMBER_SCALARS = {tuple(member_scalars)!r}")
    em.line()
    em.line("def _smem_bytes(bi, bj):")
    em.push()
    em.line('"""Shared memory of one (bi, bj) thread block, in bytes."""')
    em.line("return sum(-(-(bi + er) * (bj + ec) * isz // 16) * 16 * planes for er, ec, planes, isz in _SMEM_TERMS)")
    em.pop()
    return em.source()


# ---------------------------------------------------------------------------
# build, load, launch
# ---------------------------------------------------------------------------

_build_lock = threading.Lock()

_CT_ARG = {
    "float64": ctypes.c_double,
    "float32": ctypes.c_float,
    "int64": ctypes.c_longlong,
    "int32": ctypes.c_int,
    "int16": ctypes.c_short,
    "int8": ctypes.c_byte,
    "bool": ctypes.c_bool,
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuda backend: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class NvccLibrary:
    """A CUDA source compiled by ``nvcc`` (``NVCC_FLAGS``: sm_90a, a shared
    library with a plain C interface) into ``lib_path``.

    ``start_build`` runs ``nvcc`` in the background, so that many libraries
    build in parallel; ``load`` builds on first use if nobody did and opens
    the library with ``ctypes``.  ``source``, when given, is written to
    ``src_path`` first (a generated kernel); else ``src_path`` is the file.
    ``flags`` are added to ``NVCC_FLAGS``; ``log`` holds the compiler's
    output of the last build in this process ("" when the library was cached).
    """

    def __init__(self, src_path: Path, lib_path: Path, source: Optional[str] = None, flags=()):
        self.src_path, self.lib_path, self.source = src_path, lib_path, source
        self.flags = tuple(flags)
        self.log = ""
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[Path] = None
        self._lib: Optional[ctypes.CDLL] = None

    def start_build(self) -> None:
        """Start compiling unless the library is built or being built."""
        with _build_lock:
            if self._proc is not None or self._lib is not None or self.lib_path.exists():
                return
            # unique per library object: two kernels with one source (a stencil
            # built twice) each compile into their own temporary file
            tag = f"{os.getpid()}.{threading.get_ident()}.{id(self)}"
            if self.source is not None:
                src_tmp = self.src_path.with_name(f"{self.src_path.name}.{tag}.tmp")
                src_tmp.write_text(self.source)
                os.replace(src_tmp, self.src_path)
            self._tmp = self.lib_path.with_name(f"{self.lib_path.name}.{tag}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *self.flags, "-o", str(self._tmp), str(self.src_path)]
            self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self) -> None:
        """Wait for ``nvcc`` and raise with its output if it failed."""
        with _build_lock:
            proc, self._proc = self._proc, None
        if proc is None:
            return
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.src_path}:\n{out}")
        self.log = out
        os.replace(self._tmp, self.lib_path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.start_build()
            self.finish_build()
            self._lib = ctypes.CDLL(str(self.lib_path))
        return self._lib


class CudaKernel(CountedKernel):
    """The compiled kernel of one ``cuda`` stencil module.

    ``start_build`` launches ``nvcc`` in the background (so that many kernels
    build in parallel); ``launch`` builds on first use if nobody did, loads
    the shared library with ``ctypes`` and launches on the current stream.
    ``launches`` counts the kernel's launches, and nothing else.
    """

    def __init__(self, module, key: str, cache: Path):
        self.module = module
        self.key = key
        # the library is named by its source's hash: a stale build is never loaded
        digest = hashlib.sha256(module.CUDA_SOURCE.encode()).hexdigest()[:12]
        self.library = NvccLibrary(cache / f"{key}.{digest}.cu", cache / f"{key}.{digest}.so", module.CUDA_SOURCE)
        self.launches = 0
        register_kernel(self)
        self._fn = None

    def start_build(self) -> None:
        self.library.start_build()

    def finish_build(self) -> None:
        self.library.finish_build()

    @property
    def member_scalars(self) -> Optional[Tuple[str, ...]]:
        """The per-member scalars of a member-batched kernel; None for the
        one-member kernel."""
        return getattr(self.module, "MEMBER_SCALARS", None)

    def _load(self):
        if self._fn is None:
            fn = getattr(self.library.load(), self.module.KERNEL)
            batched = self.member_scalars is not None
            argtypes: List[Any] = []
            for _name, axes, *_ in self.module.FIELDS:
                argtypes.append(ctypes.c_void_p)
                argtypes += [ctypes.c_longlong] * (len(axes) + batched)
                argtypes += [ctypes.c_int] * 3
            argtypes += [ctypes.c_int] * 3
            argtypes += [ctypes.c_void_p if batched and n in self.member_scalars else _CT_ARG[dt]
                         for n, dt in self.module.SCALARS]
            argtypes += [ctypes.c_void_p] * len(self.module.SCRATCH)
            if batched:
                argtypes.append(ctypes.c_int)
            argtypes.append(ctypes.c_void_p)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    # -- launch -------------------------------------------------------------------

    def launch(self, fields, scalars, domain, origins) -> None:
        self.prepare(fields, scalars, domain, origins)()

    def prepare(self, fields, scalars, domain, origins, members: Optional[int] = None,
                scratch_sets: Optional[Dict[Any, list]] = None):
        """Check the arguments, bind the scratch and return a callable that
        launches the kernel on them (each call is one launch).

        The launcher allocates its own scratch and holds it, unless the caller
        passes ``scratch_sets``: launchers prepared with one such dict share a
        set per (device, stream, size), which lives as long as the dict.
        Launches on one stream run in order, and each launch writes what it
        reads of the scratch first, so sharing is safe.

        A member-batched kernel takes ``members``: a field is then either
        batched, with a leading member axis of that length, or shared, without
        it (member stride 0; an output may not be shared), and each per-member
        scalar is a sequence of ``members`` values.  The one launch covers
        every member and counts once."""
        import torch

        if self.module.SMEM_BYTES > SMEM_MAX:
            raise RuntimeError(
                f"cuda backend: {self.key} needs {self.module.SMEM_BYTES} bytes of shared memory "
                f"per block, more than the {SMEM_MAX} a block may have; pick a smaller block="
            )
        per_member = self.member_scalars
        if (per_member is None) != (members is None):
            raise TypeError(f"cuda backend: {self.key} is {'not ' if per_member is None else ''}member-batched; "
                            f"members={members!r}")
        nm = 1 if members is None else int(members)
        if nm < 1:
            raise ValueError(f"cuda backend: members must be positive, got {members}")
        ni, nj, nk = (int(d) for d in domain)
        device = None
        args: List[Any] = []
        for name, axes, dt, written, (ilo, ihi, jlo, jhi) in self.module.FIELDS:
            t = fields[name]
            if not isinstance(t, torch.Tensor) or not t.is_cuda:
                raise TypeError(f"cuda backend: field {name!r} must be a CUDA tensor")
            if device is None:
                device = t.device
            elif t.device != device:
                raise ValueError(f"cuda backend: field {name!r} is on {t.device}, others on {device}")
            if t.dtype != getattr(torch, dt):
                raise TypeError(f"cuda backend: field {name!r} expects {dt}, got {t.dtype}")
            member_stride = 0
            if members is not None and t.dim() == len(axes) + 1:
                if t.shape[0] != nm:
                    raise ValueError(f"cuda backend: field {name!r} holds {t.shape[0]} members, not {nm}")
                member_stride = t.stride(0) if nm > 1 else 0
                if written and nm > 1 and member_stride == 0:
                    raise ValueError(f"cuda backend: output {name!r} has overlapping members (a stride of 0)")
                t = t[0]  # one member's (I, J, K) view: its shape and strides are every member's
            elif members is not None and written:
                raise ValueError(f"cuda backend: output {name!r} is shared by the members (no member axis)")
            if t.dim() != len(axes):
                raise ValueError(f"cuda backend: field {name!r} has {t.dim()} dims, expects {len(axes)}")
            # the kernel indexes without bounds checks: the region it touches must exist
            oi, oj, ok = (int(o) for o in origins[name])
            need = {"I": (oi + ilo, oi + ni + ihi), "J": (oj + jlo, oj + nj + jhi), "K": (ok, ok + nk)}
            for ax, size in zip(axes, t.shape):
                lo, hi = need[ax]
                if lo < 0 or hi > size:
                    raise ValueError(
                        f"cuda backend: field {name!r} spans [0, {size}) along {ax} but the kernel "
                        f"touches [{lo}, {hi})"
                    )
            if written and any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
                raise ValueError(f"cuda backend: output {name!r} has overlapping elements (a stride of 0)")
            args.append(ctypes.c_void_p(t.data_ptr()))
            args += [ctypes.c_longlong(s) for s in t.stride()]
            if members is not None:
                args.append(ctypes.c_longlong(member_stride))
            args += [ctypes.c_int(int(o)) for o in origins[name]]
        args += [ctypes.c_int(ni), ctypes.c_int(nj), ctypes.c_int(nk)]
        keep = []  # device copies of the per-member scalars, alive as long as the launcher
        for name, dt in self.module.SCALARS:
            v = scalars[name]
            if per_member is not None and name in per_member:
                vals = torch.as_tensor([float(x) for x in v], dtype=getattr(torch, dt)).to(device)
                if vals.numel() != nm:
                    raise ValueError(f"cuda backend: per-member scalar {name!r} has {vals.numel()} values, not {nm}")
                keep.append(vals)
                args.append(ctypes.c_void_p(vals.data_ptr()))
                continue
            v = v.item() if hasattr(v, "item") else v
            args.append(_CT_ARG[dt](v))
        bi, bj = self.module.BLOCK
        nblocks = -(-ni // bi) * -(-nj // bj) * nm
        stream = torch.cuda.current_stream(device)
        key = (str(device), stream.cuda_stream, nblocks, nk)
        scratch = None if scratch_sets is None else scratch_sets.get(key)
        if scratch is None:
            # the kernel zeroes what it may read before writing
            scratch = [torch.empty(numel, dtype=getattr(torch, dt), device=device)
                       for numel, dt in self._scratch_sizes(nblocks, nk)]
            if scratch_sets is not None:
                scratch_sets[key] = scratch
        args += [ctypes.c_void_p(buf.data_ptr()) for buf in scratch]
        if members is not None:
            args.append(ctypes.c_int(nm))
        fn = self._load()
        args.append(ctypes.c_void_p(stream.cuda_stream))
        scratch_bytes = sum(buf.numel() * buf.element_size() for buf in scratch)
        prefetch_bytes = self.prefetch_bytes(domain, nm)
        span_name = f"launch {self.key}"

        def _launch() -> None:
            if torch.cuda.current_stream(device) != stream:
                raise RuntimeError(f"cuda backend: {self.key} was prepared for another stream")
            with otrace.span(span_name):
                rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"cuda backend: launch of {self.key} failed with cudaError {rc}")
            self.count_launch(scratch_bytes, prefetch_bytes)

        _launch.scratch = scratch  # the buffers live as long as the launcher
        _launch.keep = keep
        return _launch

    def _scratch_sizes(self, nblocks: int, nk: int) -> List[Tuple[int, str]]:
        """(elements, dtype) of each full temporary's per-block scratch for
        ``nblocks`` blocks of ``nk`` levels."""
        bi, bj = self.module.BLOCK
        return [(nblocks * (bi + er) * (bj + ec) * (nk + ek), dt) for _name, dt, er, ec, ek in self.module.SCRATCH]

    def prefetch_bytes(self, domain, members: int = 1) -> int:
        """Bytes one launch over ``domain`` brings through its load
        pipeline's rings: each staged plane's region, tile plus extent clipped
        to the domain, over every block, once a level of its loop."""
        ni, nj, nk = (int(d) for d in domain)
        bi, bj = self.module.BLOCK
        nbi, nbj = -(-ni // bi), -(-nj // bj)
        isz = {name: np.dtype(dt).itemsize for name, _axes, dt, *_ in self.module.FIELDS}
        total = 0
        for entry in self.module.SCHEDULE["prefetch"]:
            k0, k1 = ((0 if level == 0 else nk) + off for level, off in entry["bounds"])
            total += max(0, k1 - k0) * sum((ni + nbi * (ihi - ilo)) * (nj + nbj * (jhi - jlo)) * isz[name]
                                           for name, _dk, (ilo, ihi, jlo, jhi) in entry["inputs"])
        return total * int(members)

    def scratch_bytes(self, domain, members: int = 1) -> int:
        """Bytes of per-block scratch one launch over ``domain`` writes."""
        ni, nj, nk = (int(d) for d in domain)
        bi, bj = self.module.BLOCK
        nblocks = -(-ni // bi) * -(-nj // bj) * int(members)
        return sum(numel * np.dtype(dt).itemsize for numel, dt in self._scratch_sizes(nblocks, nk))


class PreparedLaunches:
    """Launch one kernel through launchers prepared once per tensor binding.

    A call with the same tensors (pointers, shapes, strides), scalars, domain
    and origins on the same stream reuses the launcher that ``prepare`` made
    the first time: no argument checks, no scratch allocation.  A double-
    buffer rotation alternates between two bindings; at most ``CAPACITY``
    bindings are kept, the oldest dropped first.  The bindings share one
    scratch set per (device, stream, size), freed with this object.
    """

    CAPACITY = 8

    def __init__(self, kernel: CudaKernel, members: Optional[int] = None):
        self.kernel = kernel
        self.members = members
        self._launchers: Dict[Any, Any] = {}
        self._scratch_sets: Dict[Any, list] = {}

    def _key(self, fields, scalars, domain, origins):
        import torch

        parts = []
        device = None
        for name, *_ in self.kernel.module.FIELDS:
            t = fields[name]
            device = t.device
            parts.append((t.data_ptr(), tuple(t.shape), t.stride(), tuple(origins[name])))
        per_member = self.kernel.member_scalars or ()
        vals = []
        for name, _dt in self.kernel.module.SCALARS:
            v = scalars[name]
            vals.append(tuple(float(x) for x in v) if name in per_member else (v.item() if hasattr(v, "item") else v))
        stream = torch.cuda.current_stream(device).cuda_stream if device is not None else None
        return (str(device), stream, tuple(domain), tuple(parts), tuple(vals))

    def __call__(self, fields, scalars, domain, origins) -> None:
        key = self._key(fields, scalars, domain, origins)
        launch = self._launchers.get(key)
        if launch is None:
            launch = self.kernel.prepare(fields, scalars, domain, origins, members=self.members,
                                         scratch_sets=self._scratch_sets)
            if len(self._launchers) >= self.CAPACITY:
                self._launchers.pop(next(iter(self._launchers)))
            self._launchers[key] = launch
        launch()
