"""Collectives for ranks that share one card: gloo through host buffers.

NCCL refuses two ranks on one GPU, and gloo runs only all-reduce and
broadcast on CUDA tensors; DTensor's redistributions also need all-gather,
reduce-scatter and all-to-all.  ``install()`` routes the collectives
DTensor makes (the functional ``all_gather_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single`` and
DTensor's shard-to-shard all-to-all) for CUDA tensors on a gloo group
through host buffers (pinned up to ``PINNED_MAX`` bytes; larger ones
pageable, so that the host allocator's cache of pinned blocks stays small):
gloo only carries the bytes (all-gather, all-to-all), and every reduction
runs on the card, over the pieces in rank order.  An all-reduce is a
reduce-scatter (an all-to-all, the sum of the pieces on the card) and an
all-gather, so a rank stages about twice its tensor, not the world's
copies.  Nothing is computed on the host.  Other tensors and groups
take the original functions.  ``all_reduce`` here is the same staged
reduction for the port's own explicit collectives.

The ranks of ``launch.ranks.run_ranks(..., backend="gloo_staged")`` (a gloo
group) call ``install()`` before they run; ``install(force=True)`` stages
CPU tensors too, so the CPU tests exercise the same code.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

BACKEND = "gloo_staged"  # the name launch.ranks takes: a gloo group with install()
PINNED_MAX = 16 << 20  # staging buffers of up to this many bytes are pinned
_STATE = {"installed": False, "force": False}


def _group(group) -> "dist.ProcessGroup":
    """The process group behind a functional collective's ``group``: a
    ProcessGroup, a (DeviceMesh, dim) pair, a 1-D DeviceMesh or a name."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if isinstance(group, DeviceMesh):
        return group.get_group()
    if isinstance(group, str):
        return dist.distributed_c10d._resolve_process_group(group)
    return group if group is not None else dist.group.WORLD


def _staged(t: torch.Tensor, pg) -> bool:
    return (t.device.type == "cuda" or _STATE["force"]) and dist.get_backend(pg) == "gloo"


def _host_empty(shape, t: torch.Tensor) -> torch.Tensor:
    n = t.element_size()
    for s in shape:
        n *= s
    return torch.empty(shape, dtype=t.dtype, pin_memory=t.device.type == "cuda" and n <= PINNED_MAX)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``."""
    h = _host_empty(tuple(t.shape), t)
    h.copy_(t)
    return h


def _gathered(t: torch.Tensor, pg) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t``, in rank order, on t's device."""
    n = dist.get_world_size(pg)
    out = _host_empty((n * t.numel(),), t)
    dist.all_gather_into_tensor(out, _host(t).reshape(-1), group=pg)
    return out.to(t.device).view((n,) + tuple(t.shape))


def _reduced(t: torch.Tensor, op, pg) -> torch.Tensor:
    """Every rank's ``t`` reduced by ``op``: each rank reduces one piece of
    the flat tensor on the card (an all-to-all of the pieces), then the
    reduced pieces are gathered."""
    n = dist.get_world_size(pg)
    flat = t.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = _reduce(torch.stack(_alltoall_pieces(list(flat.chunk(n)), pg)), op)
    return _gathered(mine, pg).reshape(-1)[:t.numel()].view(t.shape)


def _reduce(stacked: torch.Tensor, op) -> torch.Tensor:
    """Reduce over the leading (rank) axis on the tensor's device."""
    op = str(op).lower().split(".")[-1]
    if op in ("sum", "avg"):
        r = stacked.sum(0)
        return r / stacked.shape[0] if op == "avg" else r
    if op == "max":
        return stacked.amax(0)
    if op == "min":
        return stacked.amin(0)
    if op in ("product", "prod"):
        return stacked.prod(0)
    raise ValueError(f"gloo_staged: no reduction {op!r}")


def _alltoall_pieces(pieces: List[torch.Tensor], pg) -> List[torch.Tensor]:
    """Send ``pieces[r]`` to rank r; returns what each rank sent here, in rank
    order (equal shapes), on the pieces' device."""
    dev = pieces[0].device
    send = _host(torch.stack(pieces))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=pg)
    return list(recv.to(dev).unbind(0))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """All-reduce ``t`` in place by ``op`` ("sum", "max", "min"; staged for
    CUDA tensors on gloo: gathered, reduced on the card); returns ``t``."""
    pg = _group(group)
    if not _staged(t, pg):
        dist.all_reduce(t, op=_OPS[op], group=pg)
        return t
    t.copy_(_reduced(t, op, pg))
    return t


def _wrap_all_gather(orig):
    def all_gather_tensor(self, gather_dim, group, tag=""):
        pg = _group(group)
        if not _staged(self, pg):
            return orig(self, gather_dim, group, tag)
        return torch.cat(_gathered(self.contiguous(), pg).unbind(0), dim=gather_dim)

    return all_gather_tensor


def _wrap_reduce_scatter(orig):
    def reduce_scatter_tensor(self, reduceOp, scatter_dim, group, tag=""):
        pg = _group(group)
        if not _staged(self, pg):
            return orig(self, reduceOp, scatter_dim, group, tag)
        n = dist.get_world_size(pg)
        pieces = [c.contiguous() for c in torch.chunk(self, n, dim=scatter_dim)]
        return _reduce(torch.stack(_alltoall_pieces(pieces, pg)), reduceOp)

    return reduce_scatter_tensor


def _wrap_all_reduce(orig):
    def all_reduce_fn(self, reduceOp, group, tag=""):
        pg = _group(group)
        if not _staged(self, pg):
            return orig(self, reduceOp, group, tag)
        return _reduced(self, reduceOp, pg)

    return all_reduce_fn


def _wrap_all_to_all(orig):
    def all_to_all_single(self, output_split_sizes, input_split_sizes, group, tag=""):
        pg = _group(group)
        if not _staged(self, pg):
            return orig(self, output_split_sizes, input_split_sizes, group, tag)
        if input_split_sizes is not None and len(set(input_split_sizes)) > 1:
            raise NotImplementedError("gloo_staged: all_to_all_single with uneven splits")
        n = dist.get_world_size(pg)
        return torch.cat(_alltoall_pieces(list(torch.chunk(self.contiguous(), n, dim=0)), pg), dim=0)

    return all_to_all_single


def _wrap_shard_dim_alltoall(orig):
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        pg = mesh.get_group(mesh_dim)
        if not _staged(input, pg):
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        n = mesh.size(mesh_dim)
        if input.shape[shard_dim] % n:
            raise NotImplementedError(f"gloo_staged: dim {shard_dim} of {tuple(input.shape)} does not split {n} ways")
        pieces = [c.contiguous() for c in torch.chunk(input, n, dim=shard_dim)]
        return torch.cat(_alltoall_pieces(pieces, pg), dim=gather_dim)

    return shard_dim_alltoall


def install(force: bool = False) -> None:
    """Route DTensor's collectives on gloo groups through host buffers (for
    CUDA tensors; ``force``: CPU tensors too).  Idempotent."""
    _STATE["force"] = _STATE["force"] or force
    if _STATE["installed"]:
        return
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    funcol.all_gather_tensor = _wrap_all_gather(funcol.all_gather_tensor)
    funcol.reduce_scatter_tensor = _wrap_reduce_scatter(funcol.reduce_scatter_tensor)
    funcol.all_reduce = _wrap_all_reduce(funcol.all_reduce)
    funcol.all_to_all_single = _wrap_all_to_all(funcol.all_to_all_single)
    placement_types.shard_dim_alltoall = _wrap_shard_dim_alltoall(placement_types.shard_dim_alltoall)
    _STATE["installed"] = True
