"""GTScript frontend: parse a definition function into the Definition IR.

Per the paper (§2.1–2.2): GTScript is a *strict subset* of Python syntax, so
the stock ``ast`` module is the lexer/parser; semantics differ from Python
(offsets are relative to the evaluation point, iteration is implicit,
assignments are whole-domain).  ``@gtscript.function`` calls are inlined here
with additive offset composition.
"""

from __future__ import annotations

import ast
import collections
import inspect
import numbers
import textwrap
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import ir
from .gtscript import (
    GTScriptFunction,
    GTScriptSemanticError,
    GTScriptSyntaxError,
    _FieldType,
)

_BINOPS = {
    ast.Add: "+",
    ast.Sub: "-",
    ast.Mult: "*",
    ast.Div: "/",
    ast.FloorDiv: "//",
    ast.Mod: "%",
    ast.Pow: "**",
}

_CMPOPS = {
    ast.Lt: "<",
    ast.Gt: ">",
    ast.LtE: "<=",
    ast.GtE: ">=",
    ast.Eq: "==",
    ast.NotEq: "!=",
}

_BOOLOPS = {ast.And: "and", ast.Or: "or"}

_UNARYOPS = {ast.USub: "-", ast.UAdd: "+", ast.Not: "not"}

_ORDERS = {
    "PARALLEL": ir.IterationOrder.PARALLEL,
    "FORWARD": ir.IterationOrder.FORWARD,
    "BACKWARD": ir.IterationOrder.BACKWARD,
}

# names that collide with generated-code locals
_RESERVED_NAMES = {
    "ni", "nj", "nk", "k", "i", "j", "domain", "fields", "scalars", "origins",
    "np", "jnp", "jax", "lax", "pl", "pltpu", "math", "run", "torch",
    "True", "False", "None",
}


def _check_symbol_name(name: str, kind: str, stencil: str) -> None:
    if name in _RESERVED_NAMES or name.startswith("_"):
        raise GTScriptSyntaxError(
            f"stencil {stencil}: {kind} name {name!r} is reserved (generated-code local)"
        )

# aliases accepted in GTScript source for native math calls
_NATIVE_ALIASES = {
    "fabs": "abs",
    "fmin": "min",
    "fmax": "max",
    "asin": "arcsin",
    "acos": "arccos",
    "atan": "arctan",
}


def _dtype_name(dtype: Any) -> str:
    return np.dtype(dtype).name


def _function_namespace(func) -> Mapping[str, Any]:
    """Module globals + closure cells of ``func`` (so gtscript.functions and
    constants defined in enclosing local scopes resolve, e.g. in tests).

    Returns a *live view* over the module dict rather than a copy: a snapshot
    would strongly capture every module global — including the parsed
    function object itself, which keeps ``_function_cache``'s weak keys alive
    forever (value → key cycle)."""
    closure = getattr(func, "__closure__", None)
    extras: Dict[str, Any] = {}
    if closure:
        for name, cell in zip(func.__code__.co_freevars, closure):
            try:
                extras[name] = cell.cell_contents
            except ValueError:  # unfilled cell
                pass
    if not extras:
        return func.__globals__
    return collections.ChainMap(extras, func.__globals__)


def _syntax_error(node: ast.AST, msg: str, source_name: str = "<stencil>") -> GTScriptSyntaxError:
    err = GTScriptSyntaxError(f"{msg} (line {getattr(node, 'lineno', '?')} of {source_name})")
    return err


# ---------------------------------------------------------------------------
# Parsed @gtscript.function representation
# ---------------------------------------------------------------------------


@dataclass
class ParsedFunction:
    name: str
    params: List[str]
    body: List[Tuple[str, ast.expr]]  # sequential local assignments (name, rhs AST)
    returns: List[ast.expr]  # one or more return expressions (AST)
    globals: Mapping[str, Any]
    source_name: str


# keyed weakly by the function object itself (identity hash): an id()-keyed
# cache collides when the interpreter reuses the address of a collected
# function, and a strong-ref dict would pin every parsed function forever
_function_cache = weakref.WeakKeyDictionary()


def parse_gts_function(func: GTScriptFunction) -> ParsedFunction:
    key = func
    if key in _function_cache:
        return _function_cache[key]
    tree = ast.parse(func.source)
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise GTScriptSyntaxError(f"cannot parse gtscript.function {func.__name__}")
    params = [a.arg for a in fdef.args.args] + [a.arg for a in fdef.args.kwonlyargs]
    body: List[Tuple[str, ast.expr]] = []
    returns: Optional[List[ast.expr]] = None
    for stmt in fdef.body:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant) and isinstance(stmt.value.value, str):
            continue  # docstring
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) != 1:
                raise _syntax_error(stmt, "chained assignment not supported in gtscript.function")
            tgt = stmt.targets[0]
            if isinstance(tgt, ast.Name):
                body.append((tgt.id, stmt.value))
            elif isinstance(tgt, ast.Tuple) and all(isinstance(e, ast.Name) for e in tgt.elts):
                if not isinstance(stmt.value, ast.Tuple) or len(stmt.value.elts) != len(tgt.elts):
                    raise _syntax_error(stmt, "tuple assignment in functions requires a literal tuple rhs")
                for t, v in zip(tgt.elts, stmt.value.elts):
                    body.append((t.id, v))
            else:
                raise _syntax_error(stmt, "unsupported assignment target in gtscript.function")
        elif isinstance(stmt, ast.Return):
            if stmt.value is None:
                raise _syntax_error(stmt, "gtscript.function must return a value")
            if isinstance(stmt.value, ast.Tuple):
                returns = list(stmt.value.elts)
            else:
                returns = [stmt.value]
            break
        else:
            raise _syntax_error(stmt, f"statement {type(stmt).__name__} not allowed in gtscript.function")
    if returns is None:
        raise GTScriptSyntaxError(f"gtscript.function {func.__name__} has no return statement")
    parsed = ParsedFunction(
        name=func.__name__,
        params=params,
        body=body,
        returns=returns,
        globals=_function_namespace(func.definition),
        source_name=func.__name__,
    )
    _function_cache[key] = parsed
    return parsed


# ---------------------------------------------------------------------------
# Expression parsing
# ---------------------------------------------------------------------------


class ExprParser:
    """Parses a Python ``ast.expr`` into an ``ir.Expr`` within a symbol context.

    ``env`` maps names to IR expressions (function params / locals during
    inlining).  Field/scalar/external resolution falls back to the stencil
    context when a name is not in ``env``.
    """

    def __init__(self, ctx: "StencilContext", env: Optional[Dict[str, ir.Expr]] = None,
                 globals_ns: Optional[Dict[str, Any]] = None, source_name: str = "<stencil>"):
        self.ctx = ctx
        self.env = env if env is not None else {}
        self.globals_ns = globals_ns if globals_ns is not None else ctx.globals_ns
        self.source_name = source_name

    # -- helpers ------------------------------------------------------------

    def _resolve_name(self, node: ast.Name) -> ir.Expr:
        name = node.id
        if name in self.env:
            return self.env[name]
        return self.ctx.resolve_symbol(name, node, self.globals_ns)

    def _const_offset(self, node: ast.expr) -> int:
        try:
            val = ast.literal_eval(node)
        except Exception:
            raise _syntax_error(node, "field offsets must be integer literals", self.source_name)
        if not isinstance(val, int) or isinstance(val, bool):
            raise _syntax_error(node, f"field offset must be an int, got {val!r}", self.source_name)
        return val

    def _parse_offsets(self, node: ast.expr) -> Tuple[int, ...]:
        if isinstance(node, ast.Tuple):
            return tuple(self._const_offset(e) for e in node.elts)
        return (self._const_offset(node),)

    def _subscript(self, base: ir.Expr, offsets: Tuple[int, ...], node: ast.AST) -> ir.Expr:
        """Apply relative offsets to an expression (shifting all its accesses)."""
        if len(offsets) == 1:
            off3 = (0, 0, offsets[0])  # K-field style single offset
        elif len(offsets) == 2:
            off3 = (offsets[0], offsets[1], 0)
        elif len(offsets) == 3:
            off3 = tuple(offsets)  # type: ignore[assignment]
        else:
            raise _syntax_error(node, f"expected 1-3 offsets, got {len(offsets)}", self.source_name)
        if isinstance(base, ir.FieldAccess):
            return ir.FieldAccess(
                base.name,
                (base.offset[0] + off3[0], base.offset[1] + off3[1], base.offset[2] + off3[2]),
            )
        if off3 == (0, 0, 0):
            return base
        return ir.shift_accesses(base, off3)

    # -- main dispatch -------------------------------------------------------

    def parse(self, node: ast.expr) -> ir.Expr:
        m = getattr(self, f"_p_{type(node).__name__}", None)
        if m is None:
            raise _syntax_error(node, f"expression {type(node).__name__} is outside the GTScript subset",
                                self.source_name)
        return m(node)

    def parse_multi(self, node: ast.expr) -> List[ir.Expr]:
        """Parse an expression that may yield a tuple (function call returns)."""
        if isinstance(node, ast.Tuple):
            return [self.parse(e) for e in node.elts]
        if isinstance(node, ast.Call):
            result = self._p_Call(node, allow_multi=True)
            return result if isinstance(result, list) else [result]
        return [self.parse(node)]

    # -- node handlers --------------------------------------------------------

    def _p_Constant(self, node: ast.Constant) -> ir.Expr:
        v = node.value
        if isinstance(v, bool):
            return ir.Literal(v, "bool")
        if isinstance(v, int):
            return ir.Literal(v, "int")
        if isinstance(v, float):
            return ir.Literal(v, "float")
        raise _syntax_error(node, f"constant {v!r} not allowed", self.source_name)

    def _p_Name(self, node: ast.Name) -> ir.Expr:
        return self._resolve_name(node)

    def _p_Subscript(self, node: ast.Subscript) -> ir.Expr:
        if not isinstance(node.value, (ast.Name, ast.Subscript)):
            raise _syntax_error(node, "only names can be subscripted with offsets", self.source_name)
        base = self.parse(node.value)
        offsets = self._parse_offsets(node.slice)
        return self._subscript(base, offsets, node)

    def _p_UnaryOp(self, node: ast.UnaryOp) -> ir.Expr:
        op = _UNARYOPS.get(type(node.op))
        if op is None:
            raise _syntax_error(node, f"unary operator {type(node.op).__name__} not supported", self.source_name)
        operand = self.parse(node.operand)
        if op == "+":
            return operand
        if op == "-" and isinstance(operand, ir.Literal) and operand.dtype in ("int", "float"):
            return ir.Literal(-operand.value, operand.dtype)
        return ir.UnaryOp(op, operand)

    def _p_BinOp(self, node: ast.BinOp) -> ir.Expr:
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise _syntax_error(node, f"operator {type(node.op).__name__} not supported", self.source_name)
        return ir.BinOp(op, self.parse(node.left), self.parse(node.right))

    def _p_Compare(self, node: ast.Compare) -> ir.Expr:
        if len(node.ops) != 1 or len(node.comparators) != 1:
            # a < b < c  → (a < b) and (b < c)
            result: Optional[ir.Expr] = None
            left = node.left
            for op_node, comp in zip(node.ops, node.comparators):
                op = _CMPOPS.get(type(op_node))
                if op is None:
                    raise _syntax_error(node, "comparison operator not supported", self.source_name)
                piece = ir.BinOp(op, self.parse(left), self.parse(comp))
                result = piece if result is None else ir.BinOp("and", result, piece)
                left = comp
            assert result is not None
            return result
        op = _CMPOPS.get(type(node.ops[0]))
        if op is None:
            raise _syntax_error(node, "comparison operator not supported", self.source_name)
        return ir.BinOp(op, self.parse(node.left), self.parse(node.comparators[0]))

    def _p_BoolOp(self, node: ast.BoolOp) -> ir.Expr:
        op = _BOOLOPS[type(node.op)]
        exprs = [self.parse(v) for v in node.values]
        result = exprs[0]
        for e in exprs[1:]:
            result = ir.BinOp(op, result, e)
        return result

    def _p_IfExp(self, node: ast.IfExp) -> ir.Expr:
        return ir.TernaryOp(self.parse(node.test), self.parse(node.body), self.parse(node.orelse))

    def _p_Attribute(self, node: ast.Attribute) -> ir.Expr:
        # allow things like np.pi / math.pi resolved from globals
        try:
            expr_src = ast.unparse(node)
            val = eval(expr_src, {"__builtins__": {}}, self.globals_ns)  # noqa: S307
        except Exception:
            raise _syntax_error(node, f"cannot resolve attribute {ast.unparse(node)!r}", self.source_name)
        if isinstance(val, numbers.Number):
            return _literal_from_value(val)
        raise _syntax_error(node, f"attribute {ast.unparse(node)!r} is not a numeric constant", self.source_name)

    def _p_Call(self, node: ast.Call, allow_multi: bool = False):
        fname = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr  # np.sqrt → sqrt
        if fname is None:
            raise _syntax_error(node, "unsupported call", self.source_name)
        fname = _NATIVE_ALIASES.get(fname, fname)

        # cast "functions"
        if fname in ("float", "float64", "float32", "bfloat16"):
            (arg,) = [self.parse(a) for a in node.args]
            return ir.Cast("float64" if fname == "float" else fname, arg)
        if fname in ("int", "int32", "int64"):
            (arg,) = [self.parse(a) for a in node.args]
            return ir.Cast("int32" if fname == "int" else fname, arg)

        # gtscript.function inlining?
        target = self.env.get(fname) or self.globals_ns.get(fname) or self.ctx.globals_ns.get(fname)
        if isinstance(target, GTScriptFunction):
            if node.keywords:
                kw = {k.arg: self.parse(k.value) for k in node.keywords}
            else:
                kw = {}
            args = [self.parse(a) for a in node.args]
            results = self.ctx.inline_function(target, args, kw, node)
            if len(results) == 1:
                return results[0]
            if allow_multi:
                return results
            raise _syntax_error(node, f"function {fname} returns {len(results)} values here; "
                                      "use tuple assignment", self.source_name)

        if fname in ir.NATIVE_FUNCTIONS:
            args = [self.parse(a) for a in node.args]
            if fname in ("min", "max") and len(args) > 2:  # fold n-ary
                result = args[0]
                for a in args[1:]:
                    result = ir.NativeCall(fname, (result, a))
                return result
            if len(args) != ir.NATIVE_FUNCTIONS[fname]:
                raise _syntax_error(node, f"{fname}() takes {ir.NATIVE_FUNCTIONS[fname]} args", self.source_name)
            return ir.NativeCall(fname, tuple(args))

        raise _syntax_error(node, f"call to unknown function {fname!r}", self.source_name)


def _literal_from_value(v: Any) -> ir.Literal:
    if isinstance(v, bool):
        return ir.Literal(bool(v), "bool")
    if isinstance(v, (int, np.integer)):
        return ir.Literal(int(v), "int")
    if isinstance(v, (float, np.floating)):
        return ir.Literal(float(v), "float")
    raise TypeError(f"external value {v!r} is not a scalar constant")


# ---------------------------------------------------------------------------
# Stencil body parsing
# ---------------------------------------------------------------------------


class StencilContext:
    """Symbol tables + function inliner shared by the whole definition."""

    def __init__(
        self,
        name: str,
        fields: Dict[str, ir.FieldDecl],
        scalars: Dict[str, ir.ScalarDecl],
        externals: Dict[str, Any],
        globals_ns: Dict[str, Any],
        default_dtype: str,
    ):
        self.name = name
        self.fields = fields
        self.scalars = scalars
        self.externals = externals
        self.imported_externals: set = set()
        self.globals_ns = globals_ns
        self.default_dtype = default_dtype
        self.temps: Dict[str, ir.FieldDecl] = {}
        self._tmp_counter = 0
        self._inline_depth = 0

    # -- symbols --------------------------------------------------------------

    def resolve_symbol(self, name: str, node: ast.AST, globals_ns: Dict[str, Any]) -> ir.Expr:
        if name in self.fields or name in self.temps:
            return ir.FieldAccess(name, (0, 0, 0))
        if name in self.scalars:
            return ir.ScalarRef(name)
        if name in self.imported_externals:
            return _literal_from_value(self.externals[name])
        if name in ("True", "False"):
            return ir.Literal(name == "True", "bool")
        val = globals_ns.get(name, self.globals_ns.get(name))
        if isinstance(val, numbers.Number):
            return _literal_from_value(val)
        raise _syntax_error(
            node,
            f"unknown symbol {name!r} (not a field, scalar parameter, imported external, "
            "or numeric module constant)",
            self.name,
        )

    def declare_temp(self, name: str, internal: bool = False) -> None:
        if name not in self.temps:
            if not internal:
                _check_symbol_name(name, "temporary", self.name)
            self.temps[name] = ir.FieldDecl(name=name, dtype=self.default_dtype, is_api=False)

    def fresh_temp(self, hint: str = "tmp") -> str:
        self._tmp_counter += 1
        name = f"gt__{hint}_{self._tmp_counter}"
        self.declare_temp(name, internal=True)
        return name

    # -- function inlining ------------------------------------------------------

    def inline_function(
        self,
        func: GTScriptFunction,
        args: List[ir.Expr],
        kwargs: Dict[str, ir.Expr],
        node: ast.AST,
    ) -> List[ir.Expr]:
        self._inline_depth += 1
        if self._inline_depth > 32:
            raise GTScriptSemanticError(f"gtscript.function inlining too deep (recursion?) at {func.__name__}")
        try:
            parsed = parse_gts_function(func)
            if len(args) > len(parsed.params):
                raise _syntax_error(node, f"{func.__name__}() takes {len(parsed.params)} args", self.name)
            env: Dict[str, ir.Expr] = {}
            for pname, arg in zip(parsed.params, args):
                env[pname] = arg
            for k, v in kwargs.items():
                if k not in parsed.params:
                    raise _syntax_error(node, f"{func.__name__}() got unexpected kwarg {k!r}", self.name)
                env[k] = v
            missing = [p for p in parsed.params if p not in env]
            if missing:
                raise _syntax_error(node, f"{func.__name__}() missing args {missing}", self.name)
            parser = ExprParser(self, env=env, globals_ns=parsed.globals, source_name=parsed.name)
            for lname, rhs in parsed.body:
                env[lname] = parser.parse(rhs)
            return [parser.parse(r) for r in parsed.returns]
        finally:
            self._inline_depth -= 1


class StmtParser:
    """Parses interval-body statements into ``ir.Stmt`` sequences."""

    def __init__(self, ctx: StencilContext):
        self.ctx = ctx
        self.expr_parser = ExprParser(ctx, env={}, globals_ns=ctx.globals_ns, source_name=ctx.name)

    def parse_body(self, stmts: Sequence[ast.stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            out.extend(self.parse_stmt(s))
        return out

    def parse_stmt(self, node: ast.stmt) -> List[ir.Stmt]:
        if isinstance(node, ast.Assign):
            return self._assign(node)
        if isinstance(node, ast.AugAssign):
            return self._aug_assign(node)
        if isinstance(node, ast.If):
            return self._if(node)
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
                return []  # docstring / comment string
            raise _syntax_error(node, "bare expressions have no effect in GTScript", self.ctx.name)
        if isinstance(node, ast.Pass):
            return []
        raise _syntax_error(node, f"statement {type(node).__name__} is outside the GTScript subset", self.ctx.name)

    # -- assignment ---------------------------------------------------------------

    def _target_access(self, tgt: ast.expr) -> ir.FieldAccess:
        if isinstance(tgt, ast.Name):
            name = tgt.id
        elif isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name):
            name = tgt.value.id
            offs = self.expr_parser._parse_offsets(tgt.slice)
            if any(o != 0 for o in offs):
                raise _syntax_error(tgt, "assignment offset must be zero (writes are at the evaluation point)",
                                    self.ctx.name)
        else:
            raise _syntax_error(tgt, "unsupported assignment target", self.ctx.name)
        if name in self.ctx.scalars:
            raise _syntax_error(tgt, f"cannot assign to scalar parameter {name!r}", self.ctx.name)
        if name in self.ctx.imported_externals:
            raise _syntax_error(tgt, f"cannot assign to external {name!r}", self.ctx.name)
        if name not in self.ctx.fields:
            self.ctx.declare_temp(name)
        return ir.FieldAccess(name, (0, 0, 0))

    def _assign(self, node: ast.Assign) -> List[ir.Stmt]:
        if len(node.targets) != 1:
            raise _syntax_error(node, "chained assignment not supported", self.ctx.name)
        tgt = node.targets[0]
        if isinstance(tgt, ast.Tuple):
            return self._tuple_assign(tgt, node)
        values = self.expr_parser.parse_multi(node.value)
        if len(values) != 1:
            raise _syntax_error(node, "multi-value rhs needs a tuple assignment target", self.ctx.name)
        target = self._target_access(tgt)
        return [ir.Assign(target, values[0])]

    def _tuple_assign(self, tgt: ast.Tuple, node: ast.Assign) -> List[ir.Stmt]:
        values = self.expr_parser.parse_multi(node.value)
        if len(values) != len(tgt.elts):
            raise _syntax_error(node, f"cannot unpack {len(values)} values into {len(tgt.elts)} targets",
                                self.ctx.name)
        targets = [self._target_access(t) for t in tgt.elts]
        target_names = {t.name for t in targets}
        # preserve simultaneous-assignment semantics: if any rhs reads a target,
        # stage through fresh temporaries.
        needs_temps = any(
            isinstance(e, ir.FieldAccess) and e.name in target_names
            for v in values
            for e in ir.walk_exprs(v)
        )
        stmts: List[ir.Stmt] = []
        if needs_temps:
            staged: List[ir.FieldAccess] = []
            for v in values:
                tname = self.ctx.fresh_temp("unpack")
                staged.append(ir.FieldAccess(tname, (0, 0, 0)))
                stmts.append(ir.Assign(ir.FieldAccess(tname, (0, 0, 0)), v))
            for t, s in zip(targets, staged):
                stmts.append(ir.Assign(t, s))
        else:
            for t, v in zip(targets, values):
                stmts.append(ir.Assign(t, v))
        return stmts

    def _aug_assign(self, node: ast.AugAssign) -> List[ir.Stmt]:
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise _syntax_error(node, "augmented operator not supported", self.ctx.name)
        target = self._target_access(node.target)
        if target.name in self.ctx.temps and target.name not in self._assigned_names():
            raise _syntax_error(node, f"augmented assignment to undefined temporary {target.name!r}", self.ctx.name)
        value = self.expr_parser.parse(node.value)
        return [ir.Assign(target, ir.BinOp(op, ir.FieldAccess(target.name, (0, 0, 0)), value))]

    def _assigned_names(self) -> set:
        return set(self.ctx.temps)  # conservative; refined by analysis

    # -- control flow ----------------------------------------------------------------

    def _if(self, node: ast.If) -> List[ir.Stmt]:
        cond = self.expr_parser.parse(node.test)
        body = tuple(self.parse_body(node.body))
        orelse = tuple(self.parse_body(node.orelse)) if node.orelse else ()
        # compile-time pruning for literal conditions (externals specialization)
        if isinstance(cond, ir.Literal):
            return list(body) if cond.value else list(orelse)
        return [ir.If(cond, body, orelse)]


# ---------------------------------------------------------------------------
# Top-level definition parsing
# ---------------------------------------------------------------------------


def _axis_bound_from_arg(node: ast.expr, is_start: bool, source_name: str) -> ir.AxisBound:
    try:
        val = ast.literal_eval(node)
    except Exception:
        raise _syntax_error(node, "interval bounds must be integer literals or None", source_name)
    if val is None:
        return ir.AxisBound(ir.LevelMarker.START, 0) if is_start else ir.AxisBound(ir.LevelMarker.END, 0)
    if not isinstance(val, int) or isinstance(val, bool):
        raise _syntax_error(node, f"interval bound must be int or None, got {val!r}", source_name)
    if is_start:
        return ir.AxisBound(ir.LevelMarker.START, val) if val >= 0 else ir.AxisBound(ir.LevelMarker.END, val)
    if val > 0:
        return ir.AxisBound(ir.LevelMarker.START, val)
    if val == 0:
        raise _syntax_error(node, "interval end of 0 would be empty; use None for the full axis", source_name)
    return ir.AxisBound(ir.LevelMarker.END, val)


def _parse_interval_call(call: ast.Call, source_name: str) -> ir.VerticalInterval:
    if len(call.args) == 1:
        if isinstance(call.args[0], ast.Constant) and call.args[0].value is Ellipsis:
            return ir.VerticalInterval.full()
        raise _syntax_error(call, "interval() takes (start, end) or (...)", source_name)
    if len(call.args) != 2:
        raise _syntax_error(call, "interval() takes (start, end) or (...)", source_name)
    start = _axis_bound_from_arg(call.args[0], True, source_name)
    end = _axis_bound_from_arg(call.args[1], False, source_name)
    return ir.VerticalInterval(start, end)


def _parse_order(node: ast.expr, source_name: str) -> ir.IterationOrder:
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    if name is None or name not in _ORDERS:
        raise _syntax_error(node, "computation() takes PARALLEL, FORWARD or BACKWARD", source_name)
    return _ORDERS[name]


def _classify_with_items(node: ast.With, source_name: str):
    """Return (order|None, interval|None) from a With's context items."""
    order = None
    itv = None
    for item in node.items:
        call = item.context_expr
        if not isinstance(call, ast.Call) or not isinstance(call.func, (ast.Name, ast.Attribute)):
            raise _syntax_error(node, "with items must be computation(...) / interval(...)", source_name)
        fname = call.func.id if isinstance(call.func, ast.Name) else call.func.attr
        if fname == "computation":
            if len(call.args) != 1:
                raise _syntax_error(call, "computation() takes exactly one iteration order", source_name)
            order = _parse_order(call.args[0], source_name)
        elif fname == "interval":
            itv = _parse_interval_call(call, source_name)
        else:
            raise _syntax_error(call, f"unknown context {fname!r}", source_name)
    return order, itv


def parse_stencil_definition(
    definition,
    *,
    externals: Dict[str, Any],
    name: Optional[str] = None,
    default_dtype: Optional[str] = None,
) -> ir.StencilDefinition:
    """Parse a stencil definition function into the Definition IR."""

    source = textwrap.dedent(inspect.getsource(definition))
    tree = ast.parse(source)
    fdef = next((n for n in tree.body if isinstance(n, ast.FunctionDef)), None)
    if fdef is None:
        raise GTScriptSyntaxError("could not find stencil definition function")
    stencil_name = name or definition.__name__

    # ---- signature → fields & scalars
    annotations = dict(getattr(definition, "__annotations__", {}))
    globals_ns = _function_namespace(definition)

    fields: Dict[str, ir.FieldDecl] = {}
    scalars: Dict[str, ir.ScalarDecl] = {}

    def _resolve_annotation(pname: str):
        ann = annotations.get(pname)
        if isinstance(ann, str):
            ann = eval(ann, globals_ns)  # noqa: S307  (from __future__ import annotations)
        return ann

    for arg in fdef.args.args:
        _check_symbol_name(arg.arg, "field/parameter", stencil_name)
        ann = _resolve_annotation(arg.arg)
        if isinstance(ann, _FieldType):
            fields[arg.arg] = ir.FieldDecl(
                name=arg.arg, dtype=_dtype_name(ann.dtype), axes=ann.axes, is_api=True
            )
        elif ann is None:
            raise GTScriptSyntaxError(
                f"field parameter {arg.arg!r} of {stencil_name} needs a Field[...] annotation"
            )
        else:  # positional scalar (allowed as an extension)
            scalars[arg.arg] = ir.ScalarDecl(name=arg.arg, dtype=_dtype_name(np.dtype(ann)))
    for arg in fdef.args.kwonlyargs:
        _check_symbol_name(arg.arg, "field/parameter", stencil_name)
        ann = _resolve_annotation(arg.arg)
        if isinstance(ann, _FieldType):
            fields[arg.arg] = ir.FieldDecl(
                name=arg.arg, dtype=_dtype_name(ann.dtype), axes=ann.axes, is_api=True
            )
        else:
            dt = _dtype_name(np.dtype(ann)) if ann is not None else "float64"
            scalars[arg.arg] = ir.ScalarDecl(name=arg.arg, dtype=dt)

    if not fields:
        raise GTScriptSyntaxError(f"stencil {stencil_name} has no field parameters")

    if default_dtype is None:
        default_dtype = next(iter(fields.values())).dtype

    ctx = StencilContext(
        name=stencil_name,
        fields=fields,
        scalars=scalars,
        externals=externals,
        globals_ns=globals_ns,
        default_dtype=default_dtype,
    )

    # ---- body
    docstring = ""
    computations: List[ir.ComputationBlock] = []
    stmt_parser = StmtParser(ctx)

    # hoist temporary declarations: every assigned name that is not an API
    # field/scalar is a temporary field, visible from anywhere in the body
    # (use-before-definition is then caught semantically by the analysis)
    for node in ast.walk(fdef):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for e in elts:
                tname = None
                if isinstance(e, ast.Name):
                    tname = e.id
                elif isinstance(e, ast.Subscript) and isinstance(e.value, ast.Name):
                    tname = e.value.id
                if tname and tname not in fields and tname not in scalars:
                    ctx.declare_temp(tname)

    body = list(fdef.body)
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        docstring = body[0].value.value
        body = body[1:]

    for node in body:
        if isinstance(node, ast.ImportFrom):
            if node.module != "__externals__":
                raise _syntax_error(node, "only 'from __externals__ import ...' is allowed", stencil_name)
            for alias in node.names:
                if alias.name not in externals:
                    raise GTScriptSemanticError(
                        f"stencil {stencil_name}: external {alias.name!r} imported but not provided "
                        f"(externals={sorted(externals)})"
                    )
                ctx.imported_externals.add(alias.asname or alias.name)
                if alias.asname:
                    ctx.externals[alias.asname] = externals[alias.name]
            continue
        if not isinstance(node, ast.With):
            raise _syntax_error(
                node, "stencil body must be 'with computation(...)' blocks", stencil_name
            )
        order, itv = _classify_with_items(node, stencil_name)
        if order is None:
            raise _syntax_error(node, "top-level with must include computation(...)", stencil_name)

        interval_blocks: List[ir.IntervalBlock] = []
        if itv is not None:
            # single combined 'with computation(...), interval(...):'
            stmts = stmt_parser.parse_body(node.body)
            interval_blocks.append(ir.IntervalBlock(itv, tuple(stmts)))
        else:
            # nested 'with interval(...):' blocks (or raw statements → full interval)
            raw: List[ast.stmt] = []
            for inner in node.body:
                if isinstance(inner, ast.With):
                    o2, itv2 = _classify_with_items(inner, stencil_name)
                    if o2 is not None:
                        raise _syntax_error(inner, "nested computation() not allowed", stencil_name)
                    if itv2 is None:
                        raise _syntax_error(inner, "nested with must be interval(...)", stencil_name)
                    stmts = stmt_parser.parse_body(inner.body)
                    interval_blocks.append(ir.IntervalBlock(itv2, tuple(stmts)))
                else:
                    raw.append(inner)
            if raw:
                if interval_blocks:
                    raise _syntax_error(node, "mix of raw statements and interval blocks", stencil_name)
                stmts = stmt_parser.parse_body(raw)
                interval_blocks.append(ir.IntervalBlock(ir.VerticalInterval.full(), tuple(stmts)))

        computations.append(ir.ComputationBlock(order=order, intervals=tuple(interval_blocks)))

    if not computations:
        raise GTScriptSyntaxError(f"stencil {stencil_name} has no computation blocks")

    externals_used = tuple(sorted((k, _literal_from_value(v).value) for k, v in externals.items()))

    return ir.StencilDefinition(
        name=stencil_name,
        api_fields=tuple(fields.values()) + tuple(ctx.temps.values()),
        scalars=tuple(scalars.values()),
        computations=tuple(computations),
        externals=externals_used,
        docstring=docstring,
    )
