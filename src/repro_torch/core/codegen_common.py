"""Shared source-generation machinery for the array backends (numpy / torch).

Backends generate *actual Python source* (inspectable via
``StencilObject.generated_source``, cached on disk by ``caching.py``), in the
spirit of the paper's code-generating toolchain.

Conventions of generated ``run()`` functions
--------------------------------------------
* ``fields``  : dict name → array, full storage *including halo*
* ``scalars`` : dict name → python/np scalar
* ``domain``  : (ni, nj, nk) compute-domain size (python ints → static)
* ``origins`` : dict name → (oi, oj, ok) offset of the compute-domain origin
  inside each field's storage

Field reads at relative offset (di, dj, dk) from a stage with compute extent
((ilo, ihi), (jlo, jhi)) over vertical interval [k0, k1) become slices::

    arr[o_i + ilo + di : o_i + ni + ihi + di,
        o_j + jlo + dj : o_j + nj + jhi + dj,
        o_k + k0 + dk  : o_k + k1 + dk]          # PARALLEL (3D block)

or, in sequential (FORWARD/BACKWARD) multi-stages, 2D planes at a loop-
carried level ``k``.  Temporaries are allocated inside ``run`` extended by
their required extents, with origins shifted accordingly.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

from . import ir


def _c(off: int) -> str:
    """Format '+ n' / '- n' / '' for a constant offset inside a slice."""
    if off == 0:
        return ""
    return f" + {off}" if off > 0 else f" - {-off}"


def bound_expr(b: ir.AxisBound) -> str:
    if b.level == ir.LevelMarker.START:
        return str(b.offset)
    return f"nk{_c(b.offset)}" if b.offset else "nk"


class Emitter:
    def __init__(self) -> None:
        self._buf = io.StringIO()
        self._indent = 0

    def line(self, s: str = "") -> None:
        self._buf.write(("    " * self._indent) + s + "\n" if s else "\n")

    def push(self) -> None:
        self._indent += 1

    def pop(self) -> None:
        self._indent -= 1

    def source(self) -> str:
        return self._buf.getvalue()


class ArrayExprPrinter:
    """Prints ir.Expr as vectorized numpy source (``TorchExprPrinter``
    below is the torch flavour).

    ``mode`` is "block" (PARALLEL: 3D region over [k0, k1)) or "plane"
    (sequential: 2D region at level variable ``k``).
    """

    def __init__(
        self,
        impl: ir.StencilImplementation,
        lib: str,  # 'np' | 'torch'
        axes_of: Dict[str, Tuple[str, ...]],
        dtype_of: Dict[str, str],
    ):
        self.impl = impl
        self.lib = lib
        self.axes_of = axes_of
        self.dtype_of = dtype_of
        self.mode = "block"
        self.extent: ir.Extent = ir.Extent.zero()
        self.k0 = "_k0"
        self.k1 = "_k1"
        # horizontal sub-ranges of the compute domain: ("0", "ni") covers the
        # whole domain (the default); the numpy stage-tiling emitter rebinds
        # these to the current tile's bounds ("_t0", "_t1") so every slice is
        # evaluated tile-by-tile.
        self.irange: Tuple[str, str] = ("0", "ni")
        self.jrange: Tuple[str, str] = ("0", "nj")
        self.used_helpers: set = set()
        # demoted temporaries (ir.StencilImplementation.local_decls): bound as
        # plain block/plane variables — reads are the bare name (the demotion
        # pass guarantees zero offsets and shape-identical stage extents).
        self.locals_: set = {f.name for f in impl.local_decls}

    # -- region slices ---------------------------------------------------------

    @staticmethod
    def _hbound(origin: str, bound: str, off: int) -> str:
        if bound == "0":
            return f"{origin}{_c(off)}"
        return f"{origin} + {bound}{_c(off)}"

    def _hslices(self, name: str, di: int, dj: int) -> Tuple[str, str]:
        (ilo, ihi), (jlo, jhi), _ = self.extent.as_tuple()
        i0, i1 = self.irange
        j0, j1 = self.jrange
        si = (
            f"{self._hbound(f'_oi_{name}', i0, ilo + di)}"
            f":{self._hbound(f'_oi_{name}', i1, ihi + di)}"
        )
        sj = (
            f"{self._hbound(f'_oj_{name}', j0, jlo + dj)}"
            f":{self._hbound(f'_oj_{name}', j1, jhi + dj)}"
        )
        return si, sj

    def _kslice(self, name: str, dk: int) -> str:
        if self.mode == "block":
            return f"_ok_{name} + {self.k0}{_c(dk)}:_ok_{name} + {self.k1}{_c(dk)}"
        return f"_ok_{name} + k{_c(dk)}"

    def read(self, fa: ir.FieldAccess) -> str:
        name = fa.name
        if name in self.locals_:
            return name
        di, dj, dk = fa.offset
        axes = self.axes_of[name]
        if axes == ("I", "J", "K"):
            si, sj = self._hslices(name, di, dj)
            return f"{name}[{si}, {sj}, {self._kslice(name, dk)}]"
        if axes == ("I", "J"):
            si, sj = self._hslices(name, di, dj)
            if self.mode == "block":
                return f"{name}[{si}, {sj}, None]"
            return f"{name}[{si}, {sj}]"
        if axes == ("K",):
            if self.mode == "block":
                return f"{name}[None, None, {self._kslice(name, dk)}]"
            return f"{name}[{self._kslice(name, dk)}]"
        raise NotImplementedError(f"axes {axes}")

    def write_target(self, name: str) -> str:
        axes = self.axes_of[name]
        if axes == ("I", "J", "K"):
            si, sj = self._hslices(name, 0, 0)
            return f"{name}[{si}, {sj}, {self._kslice(name, 0)}]"
        if axes == ("I", "J"):
            si, sj = self._hslices(name, 0, 0)
            return f"{name}[{si}, {sj}]"
        if axes == ("K",):
            return f"{name}[{self._kslice(name, 0)}]"
        raise NotImplementedError(f"axes {axes}")

    # -- expressions -----------------------------------------------------------

    def expr(self, e: ir.Expr) -> str:
        lib = self.lib
        if isinstance(e, ir.Literal):
            if e.dtype == "bool":
                return "True" if e.value else "False"
            return repr(e.value)
        if isinstance(e, ir.ScalarRef):
            return e.name
        if isinstance(e, ir.FieldAccess):
            return self.read(e)
        if isinstance(e, ir.UnaryOp):
            if e.op == "not":
                return self.lnot(self.expr(e.operand))
            return f"({e.op}{self.expr(e.operand)})"
        if isinstance(e, ir.BinOp):
            if e.op == "and":
                return self.land(self.expr(e.left), self.expr(e.right))
            if e.op == "or":
                return self.lor(self.expr(e.left), self.expr(e.right))
            return f"({self.expr(e.left)} {e.op} {self.expr(e.right)})"
        if isinstance(e, ir.TernaryOp):
            return self.where(self.expr(e.cond), self.expr(e.true_expr), self.expr(e.false_expr))
        if isinstance(e, ir.NativeCall):
            return self._native(e)
        if isinstance(e, ir.Cast):
            self.used_helpers.add("cast")
            return f"_cast({self.expr(e.expr)}, '{e.dtype}')"
        raise NotImplementedError(f"expr {type(e)}")

    # -- masking primitives (overridden by the torch flavour, whose logical
    # ops and ``where`` need tensor operands)

    def where(self, cond: str, a: str, b: str) -> str:
        return f"{self.lib}.where({cond}, {a}, {b})"

    def land(self, a: str, b: str) -> str:
        return f"{self.lib}.logical_and({a}, {b})"

    def lor(self, a: str, b: str) -> str:
        return f"{self.lib}.logical_or({a}, {b})"

    def lnot(self, a: str) -> str:
        return f"{self.lib}.logical_not({a})"

    def _native(self, e: ir.NativeCall) -> str:
        lib = self.lib
        args = ", ".join(self.expr(a) for a in e.args)
        fn = e.func
        if fn == "min":
            return f"{lib}.minimum({args})"
        if fn == "max":
            return f"{lib}.maximum({args})"
        if fn == "abs":
            return f"{lib}.abs({args})"
        if fn == "mod":
            return f"{lib}.mod({args})"
        if fn == "pow":
            return f"{lib}.power({args})"
        if fn == "sigmoid":
            self.used_helpers.add("sigmoid")
            return f"_sigmoid({args})"
        if fn in ("erf", "erfc"):
            self.used_helpers.add(fn)
            return f"_{fn}({args})"
        if fn == "gamma":
            self.used_helpers.add("gamma")
            return f"_gamma({args})"
        return f"{lib}.{fn}({args})"


class ArrayStmtEmitter:
    """Emits statements for one (multi-stage, interval) context."""

    def __init__(self, printer: ArrayExprPrinter, em: Emitter):
        self.p = printer
        self.em = em
        # numpy and torch both mutate slices in place
        self._mask_counter = 0

    def assign(self, stmt: ir.Assign, mask: Optional[str]) -> None:
        p = self.p
        name = stmt.target.name
        value = p.expr(stmt.value)
        if mask is not None:
            old = p.read(ir.FieldAccess(name, (0, 0, 0)))
            value = p.where(mask, value, old)
        if name in p.locals_:
            # demoted temporary: direct variable binding, no field write
            self.em.line(f"{name} = {value}")
        else:
            tgt = p.write_target(name)
            self.em.line(f"{tgt} = {value}")

    def if_stmt(self, stmt: ir.If, mask: Optional[str]) -> None:
        p = self.p
        self._mask_counter += 1
        mv = f"_mask_{self._mask_counter}"
        cond = p.expr(stmt.cond)
        self.em.line(f"{mv} = {cond}")
        then_mask = mv if mask is None else p.land(mask, mv)
        if mask is not None:
            then_v = f"_mask_{self._mask_counter}_t"
            self.em.line(f"{then_v} = {then_mask}")
            then_mask = then_v
        for s in stmt.body:
            self.stmt(s, then_mask)
        if stmt.orelse:
            else_mask = p.lnot(mv)
            if mask is not None:
                else_mask = p.land(mask, else_mask)
            else_v = f"_mask_{self._mask_counter}_e"
            self.em.line(f"{else_v} = {else_mask}")
            for s in stmt.orelse:
                self.stmt(s, else_v)

    def stmt(self, stmt: ir.Stmt, mask: Optional[str] = None) -> None:
        if isinstance(stmt, ir.Assign):
            self.assign(stmt, mask)
        elif isinstance(stmt, ir.If):
            self.if_stmt(stmt, mask)
        else:
            raise NotImplementedError(type(stmt))


# ---------------------------------------------------------------------------
# Shared preamble / allocation helpers
# ---------------------------------------------------------------------------


def temp_alloc_shape(impl: ir.StencilImplementation, name: str) -> Tuple[str, Tuple[int, int, int]]:
    """Returns (shape_expr, origin) for a temporary field."""
    ext = impl.extent_of(name)
    (ilo, ihi), (jlo, jhi), (klo, khi) = ext.as_tuple()
    axes = impl.field(name).axes
    oi, oj, ok = -ilo, -jlo, -klo
    if axes == ("I", "J", "K"):
        shape = f"(ni{_c(ihi - ilo)}, nj{_c(jhi - jlo)}, nk{_c(khi - klo)})"
        return shape, (oi, oj, ok)
    if axes == ("I", "J"):
        shape = f"(ni{_c(ihi - ilo)}, nj{_c(jhi - jlo)})"
        return shape, (oi, oj, 0)
    if axes == ("K",):
        shape = f"(nk{_c(khi - klo)},)"
        return shape, (0, 0, ok)
    raise NotImplementedError(axes)


def emit_helpers(em: Emitter, used: set, lib: str) -> None:
    if lib == "torch":
        emit_torch_helpers(em)
        return
    if "cast" in used:
        em.line("def _cast(x, dt):")
        em.push()
        em.line("return np.asarray(x).astype(dt)")
        em.pop()
    if "sigmoid" in used:
        em.line("def _sigmoid(x):")
        em.push()
        em.line("return 1.0 / (1.0 + np.exp(-x))")
        em.pop()
    if "erf" in used or "erfc" in used:
        em.line("import math as _math")
        em.line("_erf = _np_vectorize_erf = __import__('numpy').vectorize(_math.erf)")
        em.line("def _erfc(x):")
        em.push()
        em.line("return 1.0 - _erf(x)")
        em.pop()


# Helpers of every generated torch module.  Python scalars stay Python
# scalars wherever torch accepts them (they are "weak" in torch's type
# promotion, so a float32 stencil stays float32); ``_T`` wraps one into a
# 0-d tensor of the stencil's float type ``_FDT`` only where an operator
# needs tensor operands (``where``, ``minimum``, logical ops, casts).
_TORCH_HELPERS = """\
def _T(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64)
    return torch.tensor(x, dtype=_FDT)
def _where(c, a, b):
    return torch.where(_T(c), _T(a), _T(b))
def _minimum(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return min(a, b)
    return torch.minimum(_T(a), _T(b))
def _maximum(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return max(a, b)
    return torch.maximum(_T(a), _T(b))
def _mod(a, b):
    # floored modulo (numpy's np.mod, python %), not torch.fmod's truncation
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return a % b
    return torch.remainder(_T(a), b)
def _pow(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return a ** b
    return torch.pow(_T(a), b)
def _cast(x, dt):
    return _T(x).to(getattr(torch, dt))
def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-_T(x)))
def _erf(x):
    return torch.special.erf(_T(x))
def _erfc(x):
    return 1.0 - torch.special.erf(_T(x))
"""


_TORCH_HELPER_CALLS = {
    "min": "_minimum",
    "max": "_maximum",
    "mod": "_mod",
    "pow": "_pow",
    "sigmoid": "_sigmoid",
    "erf": "_erf",
    "erfc": "_erfc",
}


def emit_torch_helpers(em: Emitter) -> None:
    for ln in _TORCH_HELPERS.splitlines():
        em.line(ln)


class TorchExprPrinter(ArrayExprPrinter):
    """The torch flavour of :class:`ArrayExprPrinter`: same slices, torch
    calls.  Operators that need tensor operands go through the helpers of
    ``_TORCH_HELPERS``; ``mod`` is floored (``torch.remainder``)."""

    def __init__(self, impl, axes_of, dtype_of):
        super().__init__(impl, "torch", axes_of, dtype_of)

    def where(self, cond: str, a: str, b: str) -> str:
        return f"_where({cond}, {a}, {b})"

    def land(self, a: str, b: str) -> str:
        return f"torch.logical_and(_T({a}), _T({b}))"

    def lor(self, a: str, b: str) -> str:
        return f"torch.logical_or(_T({a}), _T({b}))"

    def lnot(self, a: str) -> str:
        return f"torch.logical_not(_T({a}))"

    def _native(self, e: ir.NativeCall) -> str:
        args = ", ".join(self.expr(a) for a in e.args)
        fn = e.func
        if fn in _TORCH_HELPER_CALLS:
            return f"{_TORCH_HELPER_CALLS[fn]}({args})"
        return f"torch.{fn}(_T({args}))"

    def expr(self, e: ir.Expr) -> str:
        if isinstance(e, ir.Cast):
            return f"_cast({self.expr(e.expr)}, '{e.dtype}')"
        return super().expr(e)


def emit_parallel_block(
    impl: ir.StencilImplementation,
    printer: ArrayExprPrinter,
    em: Emitter,
    ms: ir.MultiStage,
    mi: int,
) -> None:
    """Emit a PARALLEL multi-stage: every statement fully vectorized over its
    3-D region, interval by interval (shared by numpy / torch)."""
    for ii, itv in enumerate(ms.intervals):
        k0, k1 = f"_k0_{mi}_{ii}", f"_k1_{mi}_{ii}"
        em.line(f"{k0} = {bound_expr(itv.interval.start)}")
        em.line(f"{k1} = {bound_expr(itv.interval.end)}")
        printer.mode = "block"
        printer.k0, printer.k1 = k0, k1
        emitter = ArrayStmtEmitter(printer, em)
        for st in itv.stages:
            printer.extent = st.compute_extent
            for stmt in st.stmts:
                emitter.stmt(stmt)


def multistage_plan(ms: ir.MultiStage) -> str:
    """Human-readable schedule line for the generated source header."""
    parts = []
    for itv in ms.intervals:
        parts.append(
            f"[{bound_expr(itv.interval.start)}, {bound_expr(itv.interval.end)}) × {len(itv.stages)} stages"
        )
    return f"{ms.order.name}: " + "; ".join(parts)
