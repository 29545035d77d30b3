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
  cross intervals or multi-stages (the ``full`` carries, vadv's
  ``cp``/``dp``), in a per-block device scratch the wrapper allocates;
* ragged tiles are masked in the kernel and outputs are written in place, so
  inout, masked and partial-k outputs keep the caller's values.

What bounds it on an H100: hdiff and vadv do a few flops per byte, far below
the card's float64 ridge point, so they are bound by device-memory bytes.
``threadIdx.x`` walks J, and so does every loop over a tile, so a warp's
loads and stores are contiguous rows when J has stride 1: the card layout in
which ``storage`` allocates the ``cuda`` backend's fields (K slowest, then
I, then J).  Every field is read through the strides it is handed, so a
C-order field gives the same answer, with a warp's accesses ``nk`` elements
apart.

Limits, checked when the source is generated: a written API field may not be
read at a horizontal offset, or from a stage whose compute extent reaches
into a neighbouring tile (``GTScriptSemanticError``, as the reference); K-axis
outputs raise ``NotImplementedError`` (as the reference); a field written in
a PARALLEL interval may not be read there at a vertical offset, because
plane-by-plane order would differ from the reference's stage-by-stage order.

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
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from . import analysis, ir
from .codegen_common import Emitter, bound_expr, multistage_plan
from .gtscript import GTScriptSemanticError

# bump on any change to the generated source: it is part of the fingerprint
CODEGEN_VERSION = "cuda-2"
DEFAULT_BLOCK: Tuple[int, int] = (8, 32)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SMEM_DEFAULT_LIMIT = 48 * 1024  # above it the launcher raises the kernel's attribute
SMEM_MAX = 232448  # what one H100 block may use
_SMEM_ALIGN = 16

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
# ``kernels._build.HandKernel``s); the module-level launch counts are read from them
_KERNELS: weakref.WeakSet = weakref.WeakSet()


def register_kernel(kernel) -> None:
    """Let ``launch_counts()`` see a kernel with a ``key`` and a ``launches`` count."""
    _KERNELS.add(kernel)


def launch_counts() -> Dict[str, int]:
    """Launches by kernel key, summed over the live kernels of the process."""
    counts: Dict[str, int] = {}
    for k in list(_KERNELS):
        counts[k.key] = counts.get(k.key, 0) + k.launches
    return counts


def reset_launch_counts() -> None:
    """Set every live kernel's launch count to 0."""
    for k in list(_KERNELS):
        k.launches = 0


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


def _written_k_coverage_full(impl: ir.StencilImplementation, name: str) -> bool:
    intervals = [
        itv.interval
        for ms in impl.multi_stages
        for itv in ms.intervals
        if any(name in st.writes for st in itv.stages)
    ]
    if not intervals:
        return True
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


def _groups(itv: ir.MultiStageInterval) -> List[List[int]]:
    """Consecutive stages with one compute extent and no horizontal hazard:
    no stage reads, at a horizontal offset, a field an earlier stage of the
    group writes, nor writes a field an earlier stage read at one."""
    groups: List[List[int]] = []
    cur: List[int] = []
    written: Set[str] = set()
    read_off: Set[str] = set()
    for si, st in enumerate(itv.stages):
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


def _contiguous(ms: ir.MultiStage) -> bool:
    ivs = [itv.interval for itv in ms.intervals]
    if ms.order == ir.IterationOrder.BACKWARD:
        return all(a.start == b.end for a, b in zip(ivs, ivs[1:]))
    return all(a.end == b.start for a, b in zip(ivs, ivs[1:]))


@dataclasses.dataclass
class _Temp:
    name: str
    kind: str  # 'reg' | 'plane' | 'window' | 'full'
    ctype: str
    itemsize: int
    ext: ir.Extent
    depth: int = 0  # window: history planes
    k_lo: int = 0  # full: k margin below / above the domain
    k_hi: int = 0
    masked: bool = False
    group: Optional[Tuple[int, int, int]] = None  # reg: (mi, ii, group index)
    zero_all: bool = False  # full: unwritten points can be read, so zero it all

    @property
    def rows_extra(self) -> int:
        return self.ext.i[1] - self.ext.i[0]

    @property
    def cols_extra(self) -> int:
        return self.ext.j[1] - self.ext.j[0]


class _Plan:
    """Everything the emitter needs: storage classes, staged inputs, smem."""

    def __init__(self, impl: ir.StencilImplementation, block: Tuple[int, int], async_staging: bool = True):
        self.impl = impl
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
        self._check_parallel_vertical()
        self.temps = self._classify_temps()
        self.staged = self._staged_inputs()
        # staged planes double-buffered and filled by cp.async (4- and 8-byte elements)
        self.async_staging = async_staging and bool(self.staged) and all(
            np.dtype(self.api[n].dtype).itemsize in (4, 8) for lst in self.staged.values() for n, _ in lst)
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

    def _check_parallel_vertical(self) -> None:
        for mi, ms in enumerate(self.impl.multi_stages):
            if ms.order != ir.IterationOrder.PARALLEL:
                continue
            for ii, _itv in enumerate(ms.intervals):
                here = [(n, a) for n, lst in self.acc.items() for a in lst if (a.mi, a.ii) == (mi, ii)]
                written = {n for n, a in here if a.write}
                for n, a in here:
                    if not a.write and n in written and a.offset[2] != 0:
                        raise GTScriptSemanticError(
                            f"cuda backend: {n!r} is written and read at vertical offset "
                            f"{a.offset[2]} inside one PARALLEL interval (multi-stage {mi}); the "
                            "plane-by-plane schedule would not reproduce stage-by-stage order"
                        )

    # -- storage classes ------------------------------------------------------

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
            else:
                dks = [a.offset[2] for a in accs] or [0]
                temps[n] = _Temp(n, "full", ct, isz, ext,
                                 k_lo=max(0, -min(dks)), k_hi=max(0, max(dks)), masked=masked,
                                 zero_all=masked or not _written_k_coverage_full(impl, n))
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

    # -- shared memory ----------------------------------------------------------

    def _layout_smem(self) -> None:
        """Byte offsets of every shared-memory plane, and the estimate terms
        ``(extra_rows, extra_cols, planes, itemsize)`` of ``_smem_bytes``."""
        self.smem_terms: List[Tuple[int, int, int, int]] = []
        self.smem_off: Dict[str, int] = {}
        off = 0

        def add(key: str, er: int, ec: int, planes: int, isz: int) -> None:
            nonlocal off
            self.smem_off[key] = off
            self.smem_terms.append((er, ec, planes, isz))
            off += _round_up((self.bi + er) * (self.bj + ec) * isz, _SMEM_ALIGN) * planes

        seen: Set[Tuple[str, int]] = set()
        for lst in self.staged.values():
            for n, dk in lst:
                if (n, dk) in seen:
                    continue
                seen.add((n, dk))
                e = self.impl.extent_of(n)
                add(_staged_key(n, dk), e.i[1] - e.i[0], e.j[1] - e.j[0], 2 if self.async_staging else 1,
                    np.dtype(self.api[n].dtype).itemsize)
        for t in self.temps.values():
            if t.kind == "plane":
                add(t.name, t.rows_extra, t.cols_extra, 1, t.itemsize)
            elif t.kind == "window":
                add(t.name, t.rows_extra, t.cols_extra, t.depth + 1, t.itemsize)
        self.smem_bytes = off

    def full_temps(self) -> List[_Temp]:
        return [t for t in self.temps.values() if t.kind == "full"]


def _staged_key(name: str, dk: int) -> str:
    return f"{name}@{dk}"


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
        # the (input, dk) planes staged in shared memory for the current interval
        self.staged: Set[Tuple[str, int]] = set()

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
        n = fa.name
        di, dj, dk = fa.offset
        t = self.plan.temps.get(n)
        if t is not None:
            if t.kind == "reg":
                return f"r_{n}"
            if t.kind == "plane":
                return f"P_{n}({di}, {dj})"
            if t.kind == "window":
                return f"W_{n}({di}, {dj}, {dk})"
            return f"F_{n}({di}, {dj}, {dk})"
        axes = self.plan.api[n].axes
        if (n, dk) in self.staged:
            return f"S_{n}_{_dk_tag(dk)}({di}, {dj})"
        if axes == ir.AXES_IJK:
            return f"A_{n}({di}, {dj}, {dk})"
        if axes == ("I", "J"):
            return f"A_{n}({di}, {dj})"
        return f"A_{n}({dk})"

    def target(self, name: str) -> str:
        return self.read(ir.FieldAccess(name, (0, 0, 0)))

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
            em.line(f"{self.target(s.target.name)} = {self.expr(s.value)};")
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


def _close_region_loop(em: Emitter) -> None:
    em.pop()
    em.line("}")
    em.pop()
    em.line("}")
    em.line("__syncthreads();")


def _generate(impl: ir.StencilImplementation, block: Tuple[int, int], async_staging: bool = True,
              member_scalars: Optional[Tuple[str, ...]] = None):
    plan = _Plan(impl, block, async_staging)
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
    em.line("// written once, over the H100's 3.35 TB/s); a few flops per byte.")
    for mi, ms in enumerate(impl.multi_stages):
        em.line(f"// multi-stage {mi}: {multistage_plan(ms)}")
    for t in plan.temps.values():
        em.line(f"// temporary {t.name}: {t.kind}" + (f" (depth {t.depth})" if t.kind == "window" else ""))
    em.line(f"typedef {_ctype(float_dt)} real_t;")
    em.line(f"#define BI {plan.bi}")
    em.line(f"#define BJ {plan.bj}")
    em.line("#define NT (BI * BJ)")
    em.line(f"#define SMEM_BYTES {plan.smem_bytes}")
    if members:
        em.line("// member grid axis: blockIdx.z is the ensemble member; each field moves by its")
        em.line("// member stride (0 for a field the members share), scratch by a member's blocks")
    for ln in _PRELUDE.strip("\n").splitlines():
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
    seen: Set[Tuple[str, int]] = set()
    for lst in plan.staged.values():
        for n, dk in lst:
            if (n, dk) in seen:
                continue
            seen.add((n, dk))
            e = impl.extent_of(n)
            w = plan.bj + e.j[1] - e.j[0]
            # double-buffered: ``stg`` is the buffer of the plane being computed
            buf = f"stg * {_staged_plane_elems(plan, n)} + " if plan.async_staging else ""
            em.line(f"#define S_{n}_{_dk_tag(dk)}(di, dj) ss_{n}_{_dk_tag(dk)}"
                    f"[{buf}(ii + (di) - ({e.i[0]})) * {w} + (jj + (dj) - ({e.j[0]}))]")
    for t in plan.temps.values():
        w = plan.bj + t.cols_extra
        h = plan.bi + t.rows_extra
        ilo, jlo = t.ext.i[0], t.ext.j[0]
        idx = f"(ii + (di) - ({ilo})) * {w} + (jj + (dj) - ({jlo}))"
        if t.kind == "plane":
            em.line(f"#define P_{t.name}(di, dj) sp_{t.name}[{idx}]")
        elif t.kind == "window":
            stride = _round_up(h * w * t.itemsize, _SMEM_ALIGN) // t.itemsize
            em.line(f"#define W_{t.name}(di, dj, dk) sp_{t.name}[gt_slot(k + (dk), {t.depth + 1}) * {stride} + {idx}]")
        elif t.kind == "full":
            nkt = f"(nk + {t.k_lo + t.k_hi})"
            em.line(f"#define F_{t.name}(di, dj, dk) sc_{t.name}[blk * ((long long){h * w} * {nkt})"
                    f" + ((long long)(k + (dk) + {t.k_lo}) * {h} + (ii + (di) - ({ilo}))) * {w}"
                    f" + (jj + (dj) - ({jlo}))]")
    em.line()

    em.line(f"__global__ void __launch_bounds__(NT) k_{kname}({', '.join(params)}) {{")
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

    for mi, ms in enumerate(impl.multi_stages):
        em.line(f"// ---- multi-stage {mi}: {multistage_plan(ms)}")
        backward = ms.order == ir.IterationOrder.BACKWARD
        windows = [t for t in plan.temps.values() if t.kind == "window"
                   and any(a.mi == mi for a in plan.acc.get(t.name, ()))]
        if windows:
            # history planes start zeroed, like the zero-initialized temporary
            for t in windows:
                em.line(f"for (int p = tid; p < {(t.depth + 1)} * {_plane_elems(plan, t)}; p += NT) "
                        f"sp_{t.name}[p] = {t.ctype}(0);")
            em.line("__syncthreads();")
        for ii, itv in enumerate(ms.intervals):
            staged = plan.staged.get((mi, ii), [])
            pr.staged = set(staged)
            prefetch = plan.async_staging and bool(staged)
            em.line("{")
            em.push()
            em.line(f"const int k0 = {bound_expr(itv.interval.start)}, k1 = {bound_expr(itv.interval.end)};")
            if prefetch:
                # the first plane's copy starts before the loop
                em.line("int stg = 0;")
                em.line("if (k0 < k1) {")
                em.push()
                em.line(f"const int k = {'k1 - 1' if backward else 'k0'};")
                _emit_staging(em, plan, staged, asynchronous=True)
                em.pop()
                em.line("}")
            if backward:
                em.line("for (int k = k1 - 1; k >= k0; --k) {")
            else:
                em.line("for (int k = k0; k < k1; ++k) {")
            em.push()
            prologue = False
            for t in windows:
                # each iteration's current plane starts zeroed
                em.line(f"for (int p = tid; p < {_plane_elems(plan, t)}; p += NT) "
                        f"sp_{t.name}[gt_slot(k, {t.depth + 1}) * {_plane_elems(plan, t)} + p] = {t.ctype}(0);")
                prologue = True
            for t in plan.temps.values():
                if t.kind == "plane" and t.masked and any(
                    (a.mi, a.ii) == (mi, ii) for a in plan.acc.get(t.name, ())
                ):
                    em.line(f"for (int p = tid; p < {_plane_elems(plan, t)}; p += NT) sp_{t.name}[p] = {t.ctype}(0);")
                    prologue = True
            if prefetch:
                # this plane's copies (issued one iteration ago) have landed
                # for every thread; then the next plane's copy overlaps this
                # plane's stages (its buffer was last read before the barrier)
                em.line("gt_cp_async_wait_all();")
                em.line("__syncthreads();")
                em.line(f"if ({'k - 1 >= k0' if backward else 'k + 1 < k1'}) {{")
                em.push()
                em.line(f"const int k_next = {'k - 1' if backward else 'k + 1'}, stg_next = stg ^ 1;")
                em.line("{")
                em.push()
                em.line("const int k = k_next, stg = stg_next;")
                _emit_staging(em, plan, staged, asynchronous=True)
                em.pop()
                em.line("}")
                em.pop()
                em.line("}")
            else:
                if staged:
                    _emit_staging(em, plan, staged, asynchronous=False)
                    prologue = True
                if prologue:
                    em.line("__syncthreads();")
            for g, stages in enumerate(plan.groups[(mi, ii)]):
                ext = itv.stages[stages[0]].compute_extent
                _region_loop(em, ext.i, ext.j)
                for t in plan.temps.values():
                    if t.kind == "reg" and t.group == (mi, ii, g):
                        em.line(f"{t.ctype} r_{t.name} = {t.ctype}(0);")
                for si in stages:
                    for stmt in itv.stages[si].stmts:
                        pr.stmt(em, stmt)
                _close_region_loop(em)
            if prefetch:
                em.line("stg ^= 1;")
            em.pop()
            em.line("}")
            em.pop()
            em.line("}")
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
    em.line(f"if (SMEM_BYTES > {SMEM_DEFAULT_LIMIT}) {{")
    em.push()
    em.line(f"cudaError_t e = cudaFuncSetAttribute(k_{kname}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);")
    em.line("if (e != cudaSuccess) return (int)e;")
    em.pop()
    em.line("}")
    em.line(f"k_{kname}<<<grid, block, SMEM_BYTES, (cudaStream_t)stream>>>({', '.join(call_args)});")
    em.line("return (int)cudaGetLastError();")
    em.pop()
    em.line("}")
    return em.source(), plan


def _emit_staging(em: Emitter, plan: _Plan, staged, asynchronous: bool) -> None:
    """Copy plane ``k`` (plus each input's vertical offset) of the staged
    inputs, tile plus halo, into their shared-memory planes (buffer ``stg``
    when double-buffered): by ``cp.async`` or by plain loads and stores."""
    for n, dk in staged:
        e = plan.impl.extent_of(n)
        em.line(f"// stage {n}[k{dk:+d}] plane, tile plus halo")
        em.line("{")
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


def generate_cuda_module_source(
    impl: ir.StencilImplementation,
    block: Tuple[int, int] = DEFAULT_BLOCK,
    async_staging: bool = True,
    member_scalars: Optional[Tuple[str, ...]] = None,
) -> str:
    """The Python module of a ``cuda`` stencil: the CUDA source and the
    metadata the launcher and the autotuner read.  The staged input planes
    are double-buffered and the next one is filled by ``cp.async`` while the
    current one computes; ``async_staging=False`` stages them with plain
    loads instead, a kernel that exists only so that ``chip_smoke.py`` can
    time the prefetch against it (no stencil option reaches it).

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


class CudaKernel:
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

        def _launch() -> None:
            if torch.cuda.current_stream(device) != stream:
                raise RuntimeError(f"cuda backend: {self.key} was prepared for another stream")
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"cuda backend: launch of {self.key} failed with cudaError {rc}")
            self.launches += 1

        _launch.scratch = scratch  # the buffers live as long as the launcher
        _launch.keep = keep
        return _launch

    def _scratch_sizes(self, nblocks: int, nk: int) -> List[Tuple[int, str]]:
        """(elements, dtype) of each full temporary's per-block scratch for
        ``nblocks`` blocks of ``nk`` levels."""
        bi, bj = self.module.BLOCK
        return [(nblocks * (bi + er) * (bj + ec) * (nk + ek), dt) for _name, dt, er, ec, ek in self.module.SCRATCH]

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
