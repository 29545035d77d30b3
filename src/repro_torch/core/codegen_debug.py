"""Debug backend: generated pure-Python triple loops (the paper's ``debug``).

The generated code is deliberately naive — scalar per-point evaluation with
real Python ``if`` statements — so it can be stepped through in a debugger
and serves as the semantics oracle for every other backend (including the
where-semantics used for conditionals in the vectorized backends).
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import ir
from .codegen_common import Emitter, _c, bound_expr, multistage_plan, temp_alloc_shape

_SCALAR_NATIVE = {
    "abs": "abs",
    "min": "min",
    "max": "max",
    "sqrt": "_m.sqrt",
    "exp": "_m.exp",
    "log": "_m.log",
    "log2": "_m.log2",
    "pow": "pow",
    "sin": "_m.sin",
    "cos": "_m.cos",
    "tan": "_m.tan",
    "arcsin": "_m.asin",
    "arccos": "_m.acos",
    "arctan": "_m.atan",
    "sinh": "_m.sinh",
    "cosh": "_m.cosh",
    "tanh": "_m.tanh",
    "erf": "_m.erf",
    "erfc": "_m.erfc",
    "floor": "_m.floor",
    "ceil": "_m.ceil",
    "trunc": "_m.trunc",
    "isfinite": "_m.isfinite",
    "isnan": "_m.isnan",
}


class ScalarExprPrinter:
    def __init__(self, axes_of: Dict[str, Tuple[str, ...]]):
        self.axes_of = axes_of

    def read(self, fa: ir.FieldAccess) -> str:
        n = fa.name
        di, dj, dk = fa.offset
        axes = self.axes_of[n]
        if axes == ("I", "J", "K"):
            return f"{n}[_oi_{n} + i{_c(di)}, _oj_{n} + j{_c(dj)}, _ok_{n} + k{_c(dk)}]"
        if axes == ("I", "J"):
            return f"{n}[_oi_{n} + i{_c(di)}, _oj_{n} + j{_c(dj)}]"
        if axes == ("K",):
            return f"{n}[_ok_{n} + k{_c(dk)}]"
        raise NotImplementedError(axes)

    def expr(self, e: ir.Expr) -> str:
        if isinstance(e, ir.Literal):
            return repr(e.value)
        if isinstance(e, ir.ScalarRef):
            return e.name
        if isinstance(e, ir.FieldAccess):
            return self.read(e)
        if isinstance(e, ir.UnaryOp):
            op = "not " if e.op == "not" else e.op
            return f"({op}{self.expr(e.operand)})"
        if isinstance(e, ir.BinOp):
            return f"({self.expr(e.left)} {e.op} {self.expr(e.right)})"
        if isinstance(e, ir.TernaryOp):
            return f"({self.expr(e.true_expr)} if {self.expr(e.cond)} else {self.expr(e.false_expr)})"
        if isinstance(e, ir.NativeCall):
            args = ", ".join(self.expr(a) for a in e.args)
            if e.func == "sigmoid":
                return f"(1.0 / (1.0 + _m.exp(-({args}))))"
            if e.func == "mod":
                # floored modulo (python %), matching np.mod/jnp.mod in the
                # vectorized backends — math.fmod truncates instead
                a, b = (self.expr(x) for x in e.args)
                return f"({a} % {b})"
            fn = _SCALAR_NATIVE.get(e.func)
            if fn is None:
                raise NotImplementedError(f"native {e.func} in debug backend")
            return f"{fn}({args})"
        if isinstance(e, ir.Cast):
            if e.dtype.startswith("int"):
                return f"int({self.expr(e.expr)})"
            return f"float({self.expr(e.expr)})"
        raise NotImplementedError(type(e))


def _emit_stmt(p: ScalarExprPrinter, em: Emitter, stmt: ir.Stmt) -> None:
    if isinstance(stmt, ir.Assign):
        em.line(f"{p.read(stmt.target)} = {p.expr(stmt.value)}")
    elif isinstance(stmt, ir.If):
        em.line(f"if {p.expr(stmt.cond)}:")
        em.push()
        for s in stmt.body:
            _emit_stmt(p, em, s)
        em.pop()
        if stmt.orelse:
            em.line("else:")
            em.push()
            for s in stmt.orelse:
                _emit_stmt(p, em, s)
            em.pop()
    else:
        raise NotImplementedError(type(stmt))


def _emit_ij_loops(em: Emitter, ext: ir.Extent) -> None:
    (ilo, ihi), (jlo, jhi), _ = ext.as_tuple()
    em.line(f"for i in range({ilo}, ni{_c(ihi)}):")
    em.push()
    em.line(f"for j in range({jlo}, nj{_c(jhi)}):")
    em.push()


def generate_debug_source(impl: ir.StencilImplementation) -> str:
    axes_of = {f.name: f.axes for f in impl.all_fields}
    p = ScalarExprPrinter(axes_of)

    em = Emitter()
    em.line(f'"""Auto-generated by repro_torch.core — stencil {impl.name!r}, backend \'debug\'."""')
    em.line("import math as _m")
    em.line("import numpy as np")
    em.line()
    em.line("def run(fields, scalars, domain, origins):")
    em.push()
    em.line("ni, nj, nk = domain")
    for f in impl.api_fields:
        em.line(f"{f.name} = fields['{f.name}']")
        em.line(f"_oi_{f.name}, _oj_{f.name}, _ok_{f.name} = origins['{f.name}']")
    for s in impl.scalars:
        em.line(f"{s.name} = scalars['{s.name}']")
    # demoted locals stay arrays here: debug is the semantics oracle, not an
    # optimization target — per-point loops need indexable storage anyway.
    for t in tuple(impl.temporaries) + tuple(impl.local_decls):
        shape, origin = temp_alloc_shape(impl, t.name)
        em.line(f"{t.name} = np.zeros({shape}, dtype='{t.dtype}')")
        em.line(f"_oi_{t.name}, _oj_{t.name}, _ok_{t.name} = {origin}")

    for mi, ms in enumerate(impl.multi_stages):
        em.line(f"# === multi-stage {mi}: {multistage_plan(ms)}")
        backward = ms.order == ir.IterationOrder.BACKWARD
        for ii, itv in enumerate(ms.intervals):
            k0, k1 = f"_k0_{mi}_{ii}", f"_k1_{mi}_{ii}"
            em.line(f"{k0} = {bound_expr(itv.interval.start)}")
            em.line(f"{k1} = {bound_expr(itv.interval.end)}")
            if ms.order == ir.IterationOrder.PARALLEL:
                # stage-by-stage: each stage completes over the interval first
                for st in itv.stages:
                    em.line(f"for k in range({k0}, {k1}):")
                    em.push()
                    _emit_ij_loops(em, st.compute_extent)
                    for stmt in st.stmts:
                        _emit_stmt(p, em, stmt)
                    em.pop()
                    em.pop()
                    em.pop()
            else:
                rng = f"range({k1} - 1, {k0} - 1, -1)" if backward else f"range({k0}, {k1})"
                em.line(f"for k in {rng}:")
                em.push()
                for st in itv.stages:
                    _emit_ij_loops(em, st.compute_extent)
                    for stmt in st.stmts:
                        _emit_stmt(p, em, stmt)
                    em.pop()
                    em.pop()
                em.pop()
    em.line("return None")
    return em.source()
