"""Gradient-norm utilities over trees of tensors (``models.layers.tree_leaves``)."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.layers import tree_leaves


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (float64 where a
    leaf is float64)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.promote_types(leaf.dtype, torch.float32))))
                          for _p, leaf in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped tree, pre-clip norm).  The leaves are scaled in place
    and ``tree`` itself is returned: a training step at full width has no
    room for a copy of every gradient (the reference returns a new tree)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    with torch.no_grad():
        for _p, leaf in tree_leaves(tree):
            if leaf.dtype in (torch.float32, torch.float64):
                leaf.mul_(scale.to(leaf.dtype))
            else:
                leaf.copy_((leaf.float() * scale).to(leaf.dtype))
    return tree, norm
