"""Program-level planning passes over the dataflow graph.

Three decisions are made here, each recorded in the program report that
``exec_info["program_report"]`` surfaces (mirroring the stencil-level
``pass_report``):

* **dead-store elimination** — nodes whose writes reach neither a later
  read nor the output binding are dropped.  Writes are modelled as
  read-modify-writes (a stencil writes only the compute domain, so the
  incoming halo of a written buffer still flows through), which makes the
  elimination conservative and therefore unconditionally safe.
* **grouping** — maximal runs of adjacent stencil nodes that one merged
  stencil can implement.  A node joins the open group when backends and
  domains match and every shared buffer keeps a consistent origin.  Under
  ``distributed=True`` a write→offset-read edge also closes the group: the
  reader needs a halo exchange of the crossing field, and exchanges can
  only happen between groups.
* **rotation detection** — output bindings that are untouched input
  versions (``{"phi": phi_new, "phi_new": phi}``) are pure buffer renames;
  the compiler implements them as in-graph aliasing (and they are what
  makes ``ProgramObject.iterate`` a loop of the same launches).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .graph import ProgramGraph
from .trace import ExchangeNode, ProgramTraceError, StencilNode


# ---------------------------------------------------------------------------
# Dead-store elimination
# ---------------------------------------------------------------------------


def eliminate_dead_stores(graph: ProgramGraph) -> Tuple[List, List[str]]:
    """Returns (live nodes in order, names of dropped stencil calls)."""
    live_versions = {tuple(bv) for bv in graph.outputs.values()}
    keep: List = []
    dropped: List[str] = []
    for node in reversed(graph.nodes):
        if isinstance(node, ExchangeNode):
            # an exchange refreshes (buffer, version): keep it only while that
            # version is still wanted downstream
            if (node.buffer, node.version) in live_versions:
                keep.append(node)
            else:
                dropped.append(f"exchange({node.buffer})")
            continue
        wanted = any((b, v) in live_versions for b, v in node.write_versions.items())
        if not wanted:
            dropped.append(node.stencil.name)
            continue
        keep.append(node)
        for b, v in node.read_versions.items():
            live_versions.add((b, v))
    keep.reverse()
    dropped.reverse()
    return keep, dropped


# ---------------------------------------------------------------------------
# Grouping (cross-stencil fusion planning)
# ---------------------------------------------------------------------------


class Group:
    """A maximal fusable run of stencil nodes (indices into the node list)."""

    def __init__(self, nodes: List[StencilNode]):
        self.nodes = list(nodes)

    @property
    def domain(self) -> Tuple[int, int, int]:
        return self.nodes[0].domain

    def buffers(self) -> List[str]:
        seen: List[str] = []
        for n in self.nodes:
            for b in n.field_bind.values():
                if b not in seen:
                    seen.append(b)
        return seen

    def origins(self) -> Dict[str, Tuple[int, int, int]]:
        out: Dict[str, Tuple[int, int, int]] = {}
        for n in self.nodes:
            out.update(n.origins)
        return out

    def __repr__(self) -> str:
        return f"Group({[n.stencil.name for n in self.nodes]})"


def _joinable(
    graph: ProgramGraph,
    group: List[StencilNode],
    written: set,
    node: StencilNode,
    distributed: bool,
    split_halo_crossing: bool,
) -> bool:
    if split_halo_crossing:
        # a crossing write→halo-read edge closes the group: distributed, the
        # reader needs a halo exchange first; on cuda, the generated kernel
        # cannot serve halo reads of fields it writes (other thread blocks
        # write the halo, with no order between blocks)
        for buf, (ext, _k) in graph.node_reads(node).items():
            (ilo, ihi), (jlo, jhi), _ = ext.as_tuple()
            if buf in written and (ilo, ihi, jlo, jhi) != (0, 0, 0, 0):
                return False
    if distributed:
        # geometry is planner-controlled on the mesh (per-field padding and a
        # uniform local domain): no further constraints
        return True
    head = group[0]
    if node.domain != head.domain:
        return False
    origins: Dict[str, Tuple[int, int, int]] = {}
    for n in group:
        origins.update(n.origins)
    for buf, org in node.origins.items():
        if buf in origins and origins[buf] != org:
            return False
    return True


def plan_groups(
    graph: ProgramGraph,
    nodes: List,
    *,
    distributed: bool = False,
    split_halo_crossing: Optional[bool] = None,
) -> Tuple[List[Group], List[ExchangeNode]]:
    """Partition live nodes into fusable groups.

    Returns (groups in execution order, the explicit exchange markers in
    order — each remembered with the index of the group it precedes via
    ``marker.before_group``)."""
    if split_halo_crossing is None:
        split_halo_crossing = distributed
    groups: List[Group] = []
    markers: List[ExchangeNode] = []
    current: List[StencilNode] = []
    written: set = set()

    def close():
        nonlocal current, written
        if current:
            groups.append(Group(current))
            current, written = [], set()

    for node in nodes:
        if isinstance(node, ExchangeNode):
            # an exchange is a real barrier only where exchanges execute
            # (distributed / halo-splitting backends); the single-device
            # compiler elides the marker, so splitting a fusable run on it
            # would cost fusion for no semantic reason
            if split_halo_crossing or distributed:
                close()
            node.before_group = len(groups) + (1 if current else 0)  # type: ignore[attr-defined]
            markers.append(node)
            continue
        if current and not _joinable(graph, current, written, node, distributed, split_halo_crossing):
            close()
        current.append(node)
        written.update(graph.node_writes(node))
    close()
    return groups, markers


# ---------------------------------------------------------------------------
# Rotation detection
# ---------------------------------------------------------------------------


def rotation_plan(graph: ProgramGraph, nodes: List) -> Dict[str, str]:
    """Output bindings that are pure renames of *untouched* program inputs:
    ``{output_name: source_buffer}`` where the source buffer's version at
    return time is its input version (0).  These never need a copy — the
    compiled step returns the input array under the new name."""
    out: Dict[str, str] = {}
    final_version: Dict[str, int] = {}
    for node in nodes:
        if isinstance(node, StencilNode):
            final_version.update(node.write_versions)
    for out_name, (buf, version) in graph.outputs.items():
        if version == 0 and final_version.get(buf, 0) == 0 and out_name != buf:
            out[out_name] = buf
    return out


def validate_iterable(graph: ProgramGraph) -> Optional[str]:
    """None when the program can be self-composed (``iterate``): every output
    name must be an input buffer of identical shape/dtype/axes.  Returns a
    human-readable reason otherwise."""
    for out_name, (buf, _v) in graph.outputs.items():
        if out_name not in graph.buffers:
            return (
                f"output {out_name!r} is not a program field argument — iterate() needs "
                "outputs that rebind the next step's inputs"
            )
        a, b = graph.buffers[out_name], graph.buffers[buf]
        if (a.shape, a.dtype, a.axes) != (b.shape, b.dtype, b.axes):
            return f"output {out_name!r} has a different shape/dtype than the buffer it rebinds"
    return None


def check_not_empty(nodes: List) -> None:
    if not any(isinstance(n, StencilNode) for n in nodes):
        raise ProgramTraceError("program records no live stencil calls after dead-store elimination")
