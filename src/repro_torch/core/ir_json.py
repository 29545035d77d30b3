"""IR <-> JSON: the stencil corpus file format (``tests/corpus/prog_*.json``).

A copy of the reference's ``tests/corpus_gen.py`` serialization, so that the
port can load the corpus (and a later tool can ship Definition IR as JSON)
without importing the reference package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from . import ir


def _expr_to_json(e: ir.Expr):
    if isinstance(e, ir.Literal):
        return {"t": "lit", "v": e.value, "dtype": e.dtype}
    if isinstance(e, ir.ScalarRef):
        return {"t": "scalar", "name": e.name}
    if isinstance(e, ir.FieldAccess):
        return {"t": "fa", "name": e.name, "off": list(e.offset)}
    if isinstance(e, ir.UnaryOp):
        return {"t": "un", "op": e.op, "x": _expr_to_json(e.operand)}
    if isinstance(e, ir.BinOp):
        return {"t": "bin", "op": e.op, "l": _expr_to_json(e.left), "r": _expr_to_json(e.right)}
    if isinstance(e, ir.TernaryOp):
        return {
            "t": "tern",
            "c": _expr_to_json(e.cond),
            "a": _expr_to_json(e.true_expr),
            "b": _expr_to_json(e.false_expr),
        }
    if isinstance(e, ir.NativeCall):
        return {"t": "call", "f": e.func, "args": [_expr_to_json(a) for a in e.args]}
    raise TypeError(f"unserializable expr {type(e)}")


def _expr_from_json(d) -> ir.Expr:
    t = d["t"]
    if t == "lit":
        return ir.Literal(d["v"], d["dtype"])
    if t == "scalar":
        return ir.ScalarRef(d["name"])
    if t == "fa":
        return ir.FieldAccess(d["name"], tuple(d["off"]))
    if t == "un":
        return ir.UnaryOp(d["op"], _expr_from_json(d["x"]))
    if t == "bin":
        return ir.BinOp(d["op"], _expr_from_json(d["l"]), _expr_from_json(d["r"]))
    if t == "tern":
        return ir.TernaryOp(_expr_from_json(d["c"]), _expr_from_json(d["a"]), _expr_from_json(d["b"]))
    if t == "call":
        return ir.NativeCall(d["f"], tuple(_expr_from_json(a) for a in d["args"]))
    raise TypeError(f"unknown expr tag {t!r}")


def _stmt_to_json(s: ir.Stmt):
    if isinstance(s, ir.Assign):
        return {
            "t": "assign",
            "target": [s.target.name, list(s.target.offset)],
            "value": _expr_to_json(s.value),
        }
    if isinstance(s, ir.If):
        return {
            "t": "if",
            "cond": _expr_to_json(s.cond),
            "body": [_stmt_to_json(b) for b in s.body],
            "orelse": [_stmt_to_json(b) for b in s.orelse],
        }
    raise TypeError(f"unserializable stmt {type(s)}")


def _stmt_from_json(d) -> ir.Stmt:
    if d["t"] == "assign":
        name, off = d["target"]
        return ir.Assign(ir.FieldAccess(name, tuple(off)), _expr_from_json(d["value"]))
    if d["t"] == "if":
        return ir.If(
            _expr_from_json(d["cond"]),
            tuple(_stmt_from_json(b) for b in d["body"]),
            tuple(_stmt_from_json(b) for b in d["orelse"]),
        )
    raise TypeError(f"unknown stmt tag {d['t']!r}")


def _bound_to_json(b: ir.AxisBound):
    return [b.level.name, b.offset]


def _bound_from_json(d) -> ir.AxisBound:
    return ir.AxisBound(ir.LevelMarker[d[0]], d[1])


def definition_to_json(defn: ir.StencilDefinition) -> dict:
    return {
        "name": defn.name,
        "fields": [
            {"name": f.name, "dtype": f.dtype, "api": f.is_api} for f in defn.api_fields
        ],
        "scalars": [{"name": s.name, "dtype": s.dtype} for s in defn.scalars],
        "computations": [
            {
                "order": block.order.name,
                "intervals": [
                    {
                        "start": _bound_to_json(ib.interval.start),
                        "end": _bound_to_json(ib.interval.end),
                        "body": [_stmt_to_json(s) for s in ib.body],
                    }
                    for ib in block.intervals
                ],
            }
            for block in defn.computations
        ],
    }


def definition_from_json(d: dict) -> ir.StencilDefinition:
    return ir.StencilDefinition(
        name=d["name"],
        api_fields=tuple(
            ir.FieldDecl(f["name"], f["dtype"], ir.AXES_IJK, is_api=f["api"]) for f in d["fields"]
        ),
        scalars=tuple(ir.ScalarDecl(s["name"], s["dtype"]) for s in d["scalars"]),
        computations=tuple(
            ir.ComputationBlock(
                order=ir.IterationOrder[block["order"]],
                intervals=tuple(
                    ir.IntervalBlock(
                        ir.VerticalInterval(
                            _bound_from_json(ib["start"]), _bound_from_json(ib["end"])
                        ),
                        tuple(_stmt_from_json(s) for s in ib["body"]),
                    )
                    for ib in block["intervals"]
                ),
            )
            for block in d["computations"]
        ),
    )


def load_program(path: Path) -> ir.StencilDefinition:
    return definition_from_json(json.loads(Path(path).read_text()))


def pallas_compatible(defn: ir.StencilDefinition) -> bool:
    """False for a definition that reads a written API field at a nonzero
    horizontal offset: the reference's Pallas generator rejects it, and so
    does the ``cuda`` backend (a copy of ``corpus_gen.pallas_compatible``)."""
    api = {f.name for f in defn.api_fields if f.is_api}
    written: set = set()
    reads: Dict[str, set] = {}
    for block in defn.computations:
        for ib in block.intervals:
            for s in ib.body:
                written.update(w for w in ir.stmt_writes(s) if w in api)
                for rname, off in ir.stmt_reads(s):
                    reads.setdefault(rname, set()).add(off)
    return not any((off[0], off[1]) != (0, 0) for n in written for off in reads.get(n, ()))
