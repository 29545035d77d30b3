"""AdamW with decoupled weight decay and float32 moments.

The moments ``m`` and ``v`` are trees of float32 tensors shaped like the
parameters (the nested dicts and per-layer lists of
``ParamTree.to_tree()``).  ``adamw_update`` writes the parameters and the
moments in place under ``torch.no_grad()``: at RecurrentGemma-2B's width the
parameters, their gradients and the two moments take 42.5 GB, and there is no
room for a second copy.

Weight decay follows the reference, which decays every leaf of rank >= 2 and
holds each layer stack stacked along a leading axis ``(L, ...)``
(``repro/models/transformer.py::stack_specs``).  So the reference also decays
the norm scales, biases and RG-LRU gate vectors of every stacked layer, but
not those of the hybrid's unstacked ``tail_*`` layers nor ``final_norm``.
The port holds a stack as a list of per-layer trees, so it takes a leaf's
rank from the reference's leaf: its own rank plus one for each list it sits
in (``decays``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.layers import map_tree, tree_leaves


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # tree like the params' (float32)
    v: Any  # tree like the params' (float32)


def decays(path: str, leaf: torch.Tensor) -> bool:
    """Whether the leaf at ``path`` (a ``tree_leaves`` path) is decayed: the
    rank of the reference's leaf, the port's plus one for each list index on
    the path (a stacked layer), is at least 2."""
    return leaf.dim() + sum(part.isdigit() for part in path.split("/")) >= 2


def adamw_init(params: Any) -> OptState:
    """Zero moments for a ParamTree or a tree of tensors, on its device."""
    tree = params.to_tree() if hasattr(params, "to_tree") else params

    def zeros(_path, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(tree)[0][1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=map_tree(zeros, tree),
                    v=map_tree(zeros, tree))


def adamw_update(
    params: Any,
    grads: Any,
    state: OptState,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_scale: Optional[float] = None,
):
    """Returns (params, new_state); ``params`` (a ParamTree or a tree of
    tensors) and the moments are updated in place.  ``grads`` is a tree in the
    params' leaf order; ``lr`` a float or a 0-d tensor."""
    step = int(state.step) + 1
    # the bias corrections in float32, as the reference's traced scalars
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    lr = float(lr)
    flat_p = tree_leaves(params)
    flat_g = [g for _path, g in tree_leaves(grads)]
    flat_m = [m for _path, m in tree_leaves(state.m)]
    flat_v = [v for _path, v in tree_leaves(state.v)]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"adamw_update: {len(flat_p)} parameters, {len(flat_g)} gradients, "
                         f"{len(flat_m)} and {len(flat_v)} moments")
    with torch.no_grad():
        for (path, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = g.float()
            if grad_scale is not None:
                g32 = g32 * grad_scale
            m.mul_(b1).add_(g32, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
            delta = torch.div(m, c1).div_(torch.div(v, c2).sqrt_().add_(eps))
            if decays(path, p):
                delta.add_(p.float(), alpha=weight_decay)
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    return params, OptState(step=state.step + 1, m=state.m, v=state.v)
