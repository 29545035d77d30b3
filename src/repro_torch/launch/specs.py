"""Input specs and sharding trees for every (arch × shape) cell.

The reference package's ``repro/launch/specs.py``.  ``input_specs(arch,
shape_id)`` returns stand-ins for every model input as meta tensors (the
counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes, nothing
allocated): training batches for ``train_*`` shapes, (tokens, cache) for
prefill and decode shapes.  The ``*_shardings`` functions give trees of
:class:`~repro_torch.parallel.sharding.NamedSharding` by the logical rules,
leaf for leaf like the reference's (a stacked reference leaf ``(L, ...)`` is
the port's per-layer leaf, its layer axis unsharded), and
``distribute_tree`` turns a tree of full tensors into DTensors placed by
them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import build_model
from repro_torch.models.layers import ParamSpec, ParamTree, init_leaf, map_tree, tree_leaves
from repro_torch.optim.adamw import OptState, adamw_init
from repro_torch.parallel.sharding import NamedSharding, logical_spec
from repro_torch.runtime.loop import TrainState, abstract_train_state


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# per-arch serve batch specs
# ---------------------------------------------------------------------------


def serve_input_specs(cfg: ArchConfig, kind: str, seq_len: int, batch: int) -> Dict[str, Any]:
    """Model inputs for prefill (full prompt) or decode (1 token + cache).
    Enc-dec decode takes the cross K/V in the reference's layout, a pair of
    ``(L, B, S_enc, Kh, Dh)`` tensors (``LM`` takes a list of per-layer pairs:
    ``[(k[i], v[i]) for i in range(L)]``)."""
    s = seq_len if kind == "prefill" else 1
    if cfg.frontend == "vision" and kind == "prefill":
        # seq_len budgets the TOTAL sequence: image patch prefix + text prompt
        s = seq_len - cfg.encoder_seq
    specs: Dict[str, Any] = {"tokens": _meta((batch, s), torch.int32)}
    if cfg.frontend == "vision" and kind == "prefill":
        specs["patches"] = _meta((batch, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.is_encdec:
        if kind == "prefill":
            specs["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model), torch.float32)
        else:
            shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
            dt = getattr(torch, cfg.dtype)
            specs["enc_kv"] = (_meta(shape, dt), _meta(shape, dt))
    return specs


def cache_specs(model, batch: int, max_len: int) -> Any:
    """The serve cache as meta tensors (no allocation)."""
    return model.make_cache(batch, max_len, device="meta")


def input_specs(arch: str, shape_id: str) -> Dict[str, Any]:
    """Stand-ins for every model input of a cell (the dry run's contract)."""
    cfg = get_arch(arch).full
    shape = get_shape(shape_id)
    if shape.kind == "train":
        return {"batch": {k: _meta(s.shape, s.dtype) for k, s in make_batch_specs(cfg, shape).items()}}
    model = build_model(cfg)
    batch = serve_input_specs(cfg, shape.kind, shape.seq_len, shape.global_batch)
    return {"batch": batch, "cache": cache_specs(model, shape.global_batch, shape.seq_len)}


def train_state_specs(model) -> TrainState:
    """The train state as meta tensors: parameters in their dtypes, float32
    moments, int32 steps."""
    return abstract_train_state(model)


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------


def param_shardings(model, mesh) -> Any:
    """A tree like ``model.param_specs()`` of each leaf's NamedSharding."""
    return map_tree(lambda _path, s: spec_of(s, mesh), model.param_specs())


def state_shardings(model, mesh) -> TrainState:
    """TrainState shardings: the AdamW moments follow their parameters."""
    ps = param_shardings(model, mesh)
    scalar = NamedSharding(mesh, ())
    return TrainState(step=scalar, params=ps, opt=OptState(step=scalar, m=ps, v=ps))


def batch_shardings(mesh, batch_specs: Dict[str, Any]) -> Dict[str, Any]:
    """Every batch input sharded on its rows ('batch')."""
    def shard_one(_path, s):
        logical = ("batch",) + (None,) * (len(s.shape) - 1)
        return NamedSharding(mesh, logical_spec(logical, mesh, s.shape))

    return map_tree(shard_one, batch_specs)


_CACHE_LOGICAL_BY_KEY = {
    # stacked (L, B, S, Kh, Dh) attention caches
    "k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    # mamba2 (L, B, H, N, P) state + (L, B, K-1, C) conv tail
    "state": (None, "batch", "ssm_heads", None, None),
    "conv": (None, "batch", None, "mlp"),
    # rglru hidden state (L, B, Dr)
    "h": (None, "batch", "mlp"),
}


def _key_of(path: str):
    """The last dict key on a ``map_tree`` path (list indices skipped)."""
    keys = [p for p in path.split("/") if p and not p.isdigit()]
    return keys[-1] if keys else None


def cache_shardings(mesh, cache_tree: Any) -> Any:
    """Path-keyed shardings of a serve cache tree (stacked, or a hybrid's
    unstacked ``tail_*`` layers)."""

    def walk(path, leaf):
        key = _key_of(path)
        logical = _CACHE_LOGICAL_BY_KEY.get(key)
        if key == "pos" or logical is None:
            return NamedSharding(mesh, (None,) * leaf.dim())
        if any(p.startswith("tail_") for p in path.split("/")):  # one layer: no layer dim
            logical = logical[1:]
        logical = logical[: leaf.dim()] + (None,) * max(0, leaf.dim() - len(logical))
        return NamedSharding(mesh, logical_spec(logical, mesh, leaf.shape))

    return map_tree(walk, cache_tree)


def serve_batch_shardings(mesh, batch_specs: Dict[str, Any]) -> Dict[str, Any]:
    def shard_one(path, s):
        if _key_of(path) == "enc_kv" or len(s.shape) == 5:
            logical = (None, "batch", None, "kv_heads", "head_dim")
        else:
            logical = ("batch",) + (None,) * (len(s.shape) - 1)
        return NamedSharding(mesh, logical_spec(logical, mesh, s.shape))

    return map_tree(shard_one, batch_specs)


# ---------------------------------------------------------------------------
# placing and gathering trees
# ---------------------------------------------------------------------------


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over two trees of one structure (dicts, lists,
    NamedTuples, ParamTrees; a ParamTree comes back as one)."""
    if isinstance(tree, ParamTree):
        trainable = any(p.requires_grad for p in tree.parameters())
        return ParamTree(_zip_map(fn, tree.to_tree(), shardings)).trainable_(trainable)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, t, s) for t, s in zip(tree, shardings)))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, shardings))
    return fn(tree, shardings)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """A tree of full tensors (the same on every rank: weights drawn from one
    seed, or carried from the reference with ``models.convert``) as DTensors
    placed by ``shardings``; each rank keeps its own shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    def place(t: torch.Tensor, sh: NamedSharding):
        return distribute_tensor(t.detach(), sh.mesh, sh.placements(), src_data_rank=None)

    return _zip_map(place, tree, shardings)


def init_sharded_params(model, shardings: Any, generator: Optional[torch.Generator] = None,
                        device="cuda") -> ParamTree:
    """``model.init_params(generator, device)`` as DTensors placed by
    ``shardings``, drawn leaf by leaf: a rank holds one whole leaf at a
    time, never the whole tree (the same values on every rank, each keeping
    its shard)."""
    from torch.distributed.tensor import distribute_tensor

    base = 0 if generator is None else generator.initial_seed()
    flat = dict(tree_leaves(shardings))

    def leaf(path: str, spec: ParamSpec):
        sh = flat[path]
        return distribute_tensor(init_leaf(path, spec, base, torch.device(device)), sh.mesh, sh.placements(),
                                 src_data_rank=None)

    return ParamTree(map_tree(leaf, model._typed_specs()))


def init_sharded_state(model, shardings: TrainState, generator: Optional[torch.Generator] = None,
                       device="cuda") -> TrainState:
    """``runtime.loop.init_train_state`` placed by ``state_shardings``, the
    weights drawn leaf by leaf (``init_sharded_params``) and the moments
    zeros of each rank's shard."""
    from torch.distributed.tensor import distribute_tensor

    params = init_sharded_params(model, shardings.params, generator, device).trainable_()
    opt = adamw_init(params)
    step = distribute_tensor(torch.zeros((), dtype=torch.int32, device=device), shardings.step.mesh,
                             shardings.step.placements(), src_data_rank=None)
    return TrainState(step=step, params=params, opt=OptState(step=step.clone(), m=opt.m, v=opt.v))


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its full tensor (a collective: every
    rank calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return _zip_map(lambda t, _same: t.full_tensor() if isinstance(t, DTensor) else t, tree, tree)


def spec_of(param_spec: ParamSpec, mesh) -> NamedSharding:
    """One ParamSpec's sharding on ``mesh``."""
    return NamedSharding(mesh, logical_spec(param_spec.logical, mesh, param_spec.shape))
