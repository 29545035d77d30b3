"""Carry the reference package's weights and KV caches into the port.

The reference holds parameters as a nested dict of arrays, each layer stack
stacked along a leading axis (``decoder/blocks``, the hybrid's
``decoder/groups``, ``encoder/blocks``); the port holds a :class:`ParamTree`
with one subtree per layer (a hybrid group's three layers in one subtree, the
``tail_*`` layers as they are, MoE expert tensors (E, ...) per layer).
Caches keep the reference's stacked layout in both packages.  Pass ``np.asarray`` of every leaf (``jax.tree_util.tree_map(np.asarray,
params)``): this module imports neither JAX nor the reference.

Like every entry point of the port, these put what they carry on the card
unless the caller names another device (the CPU tests pass ``device="cpu"``);
without a GPU a call that names none raises instead of landing on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .layers import ParamTree

# the reference's stacked subtrees (``transformer.stack_specs``)
_STACKED = frozenset({"blocks", "groups"})


def to_tensor(a, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 included, as JAX hands it out) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    # a copy: JAX hands out read-only views of its own buffers, and the port
    # writes caches in place
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _leaf(tree: Any):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _convert(tree: Any, device) -> Any:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict) and k in _STACKED:
            n = np.asarray(_leaf(v)).shape[0]
            out[k] = [_convert(_unstack(v, i), device) for i in range(n)]
        elif isinstance(v, dict):
            out[k] = _convert(v, device)
        else:
            out[k] = to_tensor(v, device)
    return out


def params_from_reference(tree: Dict[str, Any], device="cuda") -> ParamTree:
    """The reference's parameter tree (numpy leaves) as the port's ParamTree."""
    return ParamTree(_convert(tree, device))


def _stack(layers: List[Any]) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers]) for k in layers[0]}
    return np.stack(layers)


def _restack(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):  # a stack of layers: each leaf along a new leading axis
        return _stack([_restack(x) for x in tree])
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_reference(tree: Any) -> Dict[str, Any]:
    """The inverse of ``params_from_reference``: a ParamTree, or a tree like
    its ``to_tree()`` (AdamW's moments), as the reference's nested dict of
    numpy arrays, each per-layer list restacked along a leading axis
    (bfloat16 leaves as float32: numpy has no bfloat16)."""
    return _restack(tree.to_tree() if isinstance(tree, ParamTree) else tree)


def cache_from_reference(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's serving cache (numpy leaves) as the port's, which keeps
    its layout: each layer stack's state (KV, conv tails, recurrent states)
    stacked along a leading axis, e.g. ``{'layers': {'k', 'v': (L, B, Smax,
    Kh, Dh)}, 'pos': ()}`` or the hybrid's ``{'groups': {...}, 'tail_*': {...},
    'pos': ()}``; 'pos' becomes a 0-d int32 tensor."""

    def carry(key: str, node: Any) -> Any:
        if key == "pos":
            return torch.tensor(int(np.asarray(node)), dtype=torch.int32, device=device)
        if isinstance(node, dict):
            return {k: carry(k, v) for k, v in node.items()}
        return to_tensor(node, device)

    return {k: carry(k, v) for k, v in tree.items()}
