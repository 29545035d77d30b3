"""Halo planning: minimal exchange insertion for mesh-sharded programs.

The eager distributed path (``repro_torch.stencils.distributed``) exchanges every
field of every stencil call at the stencil's maximum halo depth.  At program
scope that is wasteful twice over: fields the stencil never reads off-center
need no exchange at all, and a field exchanged for one stencil is still
valid for the next unless something wrote it in between.

This module computes the minimal plan statically from the dataflow graph: a
halo-*validity* walk over the planned groups.  Validity is per buffer — the
depth up to which the current padded copy of the buffer agrees with the
neighbours.  A group that reads buffer ``b`` with access extent ``e > 0``
demands validity ``≥ e``; if the walk cannot prove it, an exchange of depth
exactly ``e`` (the union over the group's readers) is inserted *before* the
group.  Writes reset validity to zero (the neighbour's copy changed).
Explicit ``request_exchange`` markers force an exchange at the marked point
regardless of validity (an escape hatch for boundary-condition code).

Bit-identity with the eager chain follows from SPMD synchrony: if no shard
wrote ``b`` since its last exchange, no neighbour did either, so re-shipping
the stripes would reproduce the bytes already cached.

(The reference package's ``repro/program/halo.py``, copied as it is: the
planner is framework-free.)
"""

from __future__ import annotations

from typing import Dict, List

from .graph import ProgramGraph
from .passes import Group
from .trace import ExchangeNode, ProgramTraceError


class ExchangeOp:
    """One planned halo exchange: pad ``buffer`` to depth ``halo`` before
    group ``before_group`` runs."""

    def __init__(self, buffer: str, halo: int, before_group: int, forced: bool = False):
        self.buffer = buffer
        self.halo = int(halo)
        self.before_group = int(before_group)
        self.forced = forced

    def __repr__(self) -> str:
        kind = "forced" if self.forced else "auto"
        return f"ExchangeOp({self.buffer}, halo={self.halo}, before_group={self.before_group}, {kind})"


class HaloPlan:
    def __init__(
        self,
        exchanges: List[ExchangeOp],
        read_depth: List[Dict[str, int]],  # per group: buffer -> padded depth to read at
        baseline_exchanges: int,
    ):
        self.exchanges = list(exchanges)
        self.read_depth = [dict(d) for d in read_depth]
        self.baseline_exchanges = int(baseline_exchanges)

    def before_group(self, gi: int) -> List[ExchangeOp]:
        return [e for e in self.exchanges if e.before_group == gi]

    def summary(self) -> Dict[str, object]:
        return {
            "inserted": len(self.exchanges),
            "baseline_per_step": self.baseline_exchanges,
            "ops": [
                {"buffer": e.buffer, "halo": e.halo, "before_group": e.before_group, "forced": e.forced}
                for e in self.exchanges
            ],
        }


def _group_read_halos(graph: ProgramGraph, group: Group) -> Dict[str, int]:
    """Max horizontal read depth per buffer for one group, counting only
    reads of the *incoming* version (grouping already guarantees no
    write→offset-read edge stays inside a distributed group)."""
    out: Dict[str, int] = {}
    for node in group.nodes:
        for buf, (ext, _k) in graph.node_reads(node).items():
            h = max(ext.halo[0], ext.halo[1])
            if h > 0:
                out[buf] = max(out.get(buf, 0), h)
    return out


def plan_halo_exchanges(
    graph: ProgramGraph,
    groups: List[Group],
    markers: List[ExchangeNode],
) -> HaloPlan:
    """The minimal exchange schedule for the grouped program."""
    validity: Dict[str, int] = {}
    exchanges: List[ExchangeOp] = []
    read_depth: List[Dict[str, int]] = []

    forced_by_group: Dict[int, List[ExchangeNode]] = {}
    for m in markers:
        forced_by_group.setdefault(getattr(m, "before_group", 0), []).append(m)

    for gi, group in enumerate(groups):
        needs = _group_read_halos(graph, group)
        for m in forced_by_group.get(gi, ()):
            bi = graph.buffers.get(m.buffer)
            if bi is None or "I" not in bi.axes:
                raise ProgramTraceError(
                    f"request_exchange({m.buffer!r}): only horizontally decomposed fields "
                    "can be exchanged"
                )
            depth = m.halo if m.halo is not None else max(needs.get(m.buffer, 1), 1)
            exchanges.append(ExchangeOp(m.buffer, depth, gi, forced=True))
            validity[m.buffer] = depth
        for buf in sorted(needs):
            need = needs[buf]
            if validity.get(buf, 0) < need:
                exchanges.append(ExchangeOp(buf, need, gi))
                validity[buf] = need
        read_depth.append({b: validity[b] for b in needs})
        for buf in group.buffers():
            if buf in _written(graph, group):
                validity.pop(buf, None)

    # markers trailing the last group have no reader inside the program; the
    # runtime drops them (the outputs are interiors — padding would be lost)

    baseline = _eager_baseline(graph)
    return HaloPlan(exchanges, read_depth, baseline)


def _written(graph: ProgramGraph, group: Group) -> set:
    w: set = set()
    for node in group.nodes:
        w.update(graph.node_writes(node))
    return w


def _eager_baseline(graph: ProgramGraph) -> int:
    """Exchanges the eager per-stencil distributed path would issue per step:
    one per horizontally-decomposed field per stencil call with a nonzero
    stencil halo (``DistributedStencil`` pads every field it is given)."""
    count = 0
    for node in graph.stencil_nodes():
        impl = node.stencil.implementation_ir
        h = max(impl.max_halo[0], impl.max_halo[1])
        if h == 0:
            continue
        for param in node.field_bind:
            if "I" in node.stencil.field_info[param].axes:
                count += 1
    return count
