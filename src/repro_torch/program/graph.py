"""Inter-stencil dataflow graph over program buffers.

Built from a finished :class:`repro_torch.program.trace.Trace`, this layer answers
the structural questions the program passes and the compiler ask:

* per-node field *access extents* (pulled from each stencil's analyzed
  ``StencilImplementation`` — the same extents the single-stencil toolchain
  computed, reused unchanged at program scope);
* per-buffer classification into **inputs** (the incoming array is
  observable: first access is a read, or some read touches a halo/adjacent
  k-plane the in-program writes never define), **outputs** (named in the
  step function's return binding) and **internals** (write-before-read,
  zero-offset reads, full-K write coverage — the buffers the compiler may
  demote to stencil temporaries, i.e. the program-level *eliminated
  temporaries*);
* a stable structural hash for the program-level cache key.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import ir

from .trace import ExchangeNode, ProgramTraceError, StencilNode, Trace


# ---------------------------------------------------------------------------
# Stencil-level access summaries
# ---------------------------------------------------------------------------


def stencil_read_extents(impl: ir.StencilImplementation) -> Dict[str, Tuple[ir.Extent, Tuple[int, int]]]:
    """API fields the stencil reads, with their access extent and k-offsets."""
    api = {f.name for f in impl.api_fields}
    read: set = set()
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            for st in itv.stages:
                for stmt in st.stmts:
                    for rname, _off in ir.stmt_reads(stmt):
                        if rname in api:
                            read.add(rname)
    kext = dict(impl.k_extents)
    return {
        name: (impl.extent_of(name), kext.get(name, (0, 0)))
        for name in sorted(read)
    }


def stencil_written_fields(impl: ir.StencilImplementation) -> List[str]:
    return list(impl.written_api_fields())


def _write_intervals(impl: ir.StencilImplementation, field: str) -> List[ir.VerticalInterval]:
    out: List[ir.VerticalInterval] = []
    for ms in impl.multi_stages:
        for itv in ms.intervals:
            if any(field in st.writes for st in itv.stages):
                out.append(itv.interval)
    return out


def intervals_cover_full_k(intervals: List[ir.VerticalInterval]) -> bool:
    """True when the union of ``intervals`` is exactly the full vertical domain
    (checked structurally on axis bounds, so it is domain-size independent)."""
    if not intervals:
        return False
    ivs = sorted(intervals, key=lambda iv: iv.start.key())
    if ivs[0].start != ir.AxisBound(ir.LevelMarker.START, 0):
        return False
    cur = ivs[0]
    for nxt in ivs[1:]:
        if nxt.start.key() < cur.end.key():
            cur = ir.VerticalInterval(cur.start, max(cur.end, nxt.end, key=lambda b: b.key()))
            continue
        if not ir.intervals_adjacent(cur, nxt):
            return False
        cur = ir.interval_span(cur, nxt)
    return cur.end == ir.AxisBound(ir.LevelMarker.END, 0)


# ---------------------------------------------------------------------------
# Program graph
# ---------------------------------------------------------------------------


class BufferInfo:
    def __init__(self, name: str, shape, dtype, axes, origin=None):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = str(dtype)
        self.axes = tuple(axes)
        self.origin = tuple(origin) if origin is not None else None

    def __repr__(self) -> str:
        return f"BufferInfo({self.name}, shape={self.shape}, dtype={self.dtype}, axes={self.axes})"


class ProgramGraph:
    """The traced program as an explicit dataflow structure."""

    def __init__(self, trace: Trace):
        self.name = trace.name
        self.nodes: List = list(trace.nodes)
        self.outputs: Dict[str, Tuple[str, int]] = dict(trace.outputs)
        self.scalar_params: Dict[str, str] = {n: s.dtype for n, s in trace.scalars.items()}
        self.buffers: Dict[str, BufferInfo] = {}
        accessed = set()
        for node in self.nodes:
            if isinstance(node, StencilNode):
                accessed.update(node.field_bind.values())
            else:
                accessed.add(node.buffer)
        accessed.update(b for b, _v in self.outputs.values())
        for name, h in trace.fields.items():
            if name in accessed:
                self.buffers[name] = BufferInfo(name, h.shape, h.dtype, h.axes)
        self._check_consistency()

    # -- validation --------------------------------------------------------

    def _check_consistency(self) -> None:
        backends = sorted({n.stencil.backend for n in self.stencil_nodes()})
        if len(backends) > 1:
            raise ProgramTraceError(
                f"program {self.name!r} mixes stencil backends {backends}: all stencils "
                "inside one program must share a backend (compile per-backend programs "
                "and compose them on the host instead)."
            )
        for node in self.stencil_nodes():
            for param, buf in node.field_bind.items():
                info = node.stencil.field_info[param]
                bi = self.buffers[buf]
                if tuple(info.axes) != bi.axes:
                    raise ProgramTraceError(
                        f"program {self.name!r}: buffer {buf!r} (axes {bi.axes}) bound to "
                        f"field {param!r} of {node.stencil.name!r} with axes {tuple(info.axes)}"
                    )
                if str(info.dtype) != bi.dtype:
                    raise ProgramTraceError(
                        f"program {self.name!r}: buffer {buf!r} (dtype {bi.dtype}) bound to "
                        f"field {param!r} of {node.stencil.name!r} expecting {info.dtype}"
                    )

    # -- simple accessors --------------------------------------------------

    def stencil_nodes(self) -> List[StencilNode]:
        return [n for n in self.nodes if isinstance(n, StencilNode)]

    @property
    def backend(self) -> str:
        nodes = self.stencil_nodes()
        if not nodes:
            raise ProgramTraceError(f"program {self.name!r} recorded no stencil calls")
        return nodes[0].stencil.backend

    def node_reads(self, node: StencilNode) -> Dict[str, Tuple[ir.Extent, Tuple[int, int]]]:
        """buffer -> (access extent, k-offsets) for one node."""
        per_param = stencil_read_extents(node.stencil.implementation_ir)
        out: Dict[str, Tuple[ir.Extent, Tuple[int, int]]] = {}
        for param, (ext, krange) in per_param.items():
            buf = node.field_bind[param]
            if buf in out:  # aliased params: union
                pe, pk = out[buf]
                out[buf] = (pe.union(ext), (min(pk[0], krange[0]), max(pk[1], krange[1])))
            else:
                out[buf] = (ext, krange)
        return out

    def node_writes(self, node: StencilNode) -> List[str]:
        seen: List[str] = []
        for param in stencil_written_fields(node.stencil.implementation_ir):
            buf = node.field_bind[param]
            if buf not in seen:
                seen.append(buf)
        return seen

    def node_write_intervals(self, node: StencilNode, buf: str) -> List[ir.VerticalInterval]:
        out: List[ir.VerticalInterval] = []
        for param, b in node.field_bind.items():
            if b == buf:
                out.extend(_write_intervals(node.stencil.implementation_ir, param))
        return out

    # -- classification ----------------------------------------------------

    def classify(self) -> Tuple[List[str], List[str], List[str]]:
        """Returns (inputs, output buffers, internals).

        A buffer is **internal** — a program-level temporary the compiler may
        stop materializing — only when the incoming array is provably never
        observed: its first access is a write, every read is at zero offset
        (extent zero in I/J *and* no vertical offsets), and before every read
        the in-program writes cover the full vertical domain.  Everything
        else that is read, plus anything read before written, is an input.
        Output buffers are whatever the return binding names.
        """
        out_buffers = sorted({b for b, _v in self.outputs.values()})
        first_access: Dict[str, str] = {}
        offset_read: Dict[str, bool] = {}
        covered: Dict[str, List[ir.VerticalInterval]] = {}
        uncovered_read: Dict[str, bool] = {}
        for node in self.nodes:
            if isinstance(node, ExchangeNode):
                # an explicit exchange consumes the incoming halo
                first_access.setdefault(node.buffer, "read")
                offset_read[node.buffer] = True
                continue
            reads = self.node_reads(node)
            for buf, (ext, krange) in reads.items():
                first_access.setdefault(buf, "read")
                (ilo, ihi), (jlo, jhi), _k = ext.as_tuple()
                if (ilo, ihi, jlo, jhi) != (0, 0, 0, 0) or krange != (0, 0):
                    offset_read[buf] = True
                bi = self.buffers[buf]
                if "K" in bi.axes and not intervals_cover_full_k(covered.get(buf, [])):
                    uncovered_read[buf] = True
            for buf in self.node_writes(node):
                first_access.setdefault(buf, "write")
                covered.setdefault(buf, []).extend(self.node_write_intervals(node, buf))
        internals: List[str] = []
        for name in self.buffers:
            if (
                first_access.get(name) == "write"
                and name not in out_buffers
                and not offset_read.get(name, False)
                and not uncovered_read.get(name, False)
            ):
                internals.append(name)
        inputs = sorted(n for n in self.buffers if n not in internals)
        return inputs, out_buffers, sorted(internals)

    # -- hashing -----------------------------------------------------------

    def structural_repr(self) -> str:
        parts = [f"program|{self.name}"]
        for name in sorted(self.buffers):
            bi = self.buffers[name]
            parts.append(f"buffer|{name}|{bi.shape}|{bi.dtype}|{bi.axes}")
        for name in sorted(self.scalar_params):
            parts.append(f"scalar|{name}|{self.scalar_params[name]}")
        parts.extend(n.structural_repr() for n in self.nodes)
        parts.append(repr(sorted(self.outputs.items())))
        return "\n".join(parts)
