"""Core NN layers on torch.

Parameters are described by a tree of :class:`ParamSpec` (nested dicts, and
lists for per-layer stacks) and held in a :class:`ParamTree`, an
``nn.Module`` that is indexed like the reference's nested dicts
(``params["attn"]["wq"]["kernel"]``).  The layers are plain functions of
``(params, x)``, as in the reference package.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import matmul, with_logical_constraint


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical sharding axes (parallel.sharding)
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def initializer(self, generator: torch.Generator, device) -> torch.Tensor:
        dtype = getattr(torch, self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        scale = self.scale
        if scale is None:
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            scale = 1.0 / np.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * scale).to(dtype)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module.

    ``tree[key]`` is a parameter or a child ``ParamTree``; a list in the
    source tree (a stack of layers) becomes an ``nn.ModuleList`` of trees.
    Parameters do not require grad, as serving wants them;
    ``trainable_()`` turns that on for training.
    """

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._names = list(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._names

    def to_tree(self, data: bool = True) -> Dict[str, Any]:
        """The nested dict (and lists) of tensors this tree holds: their
        ``.data``, or the parameters themselves when ``data`` is False."""
        out: Dict[str, Any] = {}
        for k in self._names:
            v = self[k]
            if isinstance(v, nn.ModuleList):
                out[k] = [x.to_tree(data) for x in v]
            elif isinstance(v, ParamTree):
                out[k] = v.to_tree(data)
            else:
                out[k] = v.data if data else v
        return out

    def leaves(self) -> List[Tuple[str, nn.Parameter]]:
        """(path, parameter) of every leaf in tree order (that of ``to_tree``
        and ``map_tree``), keys and list indices joined with '/'."""
        return tree_leaves(self.to_tree(data=False))

    def trainable_(self, flag: bool = True) -> "ParamTree":
        """Make every parameter require grad (or not); returns the tree."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self


def map_tree(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict/list tree;
    paths join keys and list indices with '/'."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a nested tree of dicts, lists, tuples
    (a NamedTuple by field name) and ParamTrees, in order; paths join keys,
    field names and list indices with '/'."""
    if isinstance(tree, ParamTree):
        tree = tree.to_tree(data=False)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    return [leaf for k, v in items for leaf in tree_leaves(v, f"{path}/{k}" if path else str(k))]


def init_param_tree(specs: Any, generator: Optional[torch.Generator] = None, device="cuda") -> ParamTree:
    """Materialize a ParamSpec tree.  Each leaf draws from its own generator,
    seeded from ``generator``'s seed and a stable hash (CRC-32) of its path, so
    a leaf's values do not depend on the other leaves or on the process."""
    device = torch.device(device)
    base = 0 if generator is None else generator.initial_seed()
    return ParamTree(map_tree(lambda path, spec: init_leaf(path, spec, base, device), specs))


def init_leaf(path: str, spec: ParamSpec, base_seed: int, device) -> torch.Tensor:
    """The leaf at ``path`` of ``init_param_tree`` with a generator seeded ``base_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((base_seed * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode())) % (1 << 63))
    return spec.initializer(g, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    # in float32 (float64 for float64 activations)
    dt, ct = x.dtype, torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(ct)).to(dt)


def layernorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def layernorm(params, x, eps: float = 1e-5):
    # in float32 (float64 for float64 activations)
    dt, ct = x.dtype, torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(ct) + params["bias"].to(ct)).to(dt)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_spec, rmsnorm
    if kind == "layernorm":
        return layernorm_spec, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Dense / embeddings
# ---------------------------------------------------------------------------


def dense_spec(d_in: int, d_out: int, logical: Tuple[Optional[str], Optional[str]],
               use_bias: bool = False) -> Dict[str, ParamSpec]:
    spec = {"kernel": ParamSpec((d_in, d_out), logical)}
    if use_bias:
        spec["bias"] = ParamSpec((d_out,), (logical[1],), init="zeros")
    return spec


def dense(params, x):
    # mixed precision: fp32 master weights cast to the activation dtype (a
    # no-op on weights already cast once for serving, LM.serving_params)
    y = matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def embedding_spec(vocab: int, d: int) -> Dict[str, ParamSpec]:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens, dtype):
    # gather, then cast: the same values as the reference's cast-then-gather
    # (an embedding lookup, which a vocab-sharded DTensor table also serves)
    return F.embedding(tokens.long(), params["embedding"]).to(dtype)


def unembed(params, x):
    """Logits head (optionally tied to the embedding)."""
    return matmul(x, params["embedding"].to(x.dtype).T)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def _act(kind: str, x):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    raise ValueError(kind)


def mlp_spec(d: int, d_ff: int, activation: str, use_bias: bool) -> Dict[str, Any]:
    if activation in ("swiglu", "geglu"):
        return {
            "wi": dense_spec(d, d_ff, ("embed", "mlp"), use_bias),
            "wg": dense_spec(d, d_ff, ("embed", "mlp"), use_bias),
            "wo": dense_spec(d_ff, d, ("mlp", "embed"), use_bias),
        }
    return {
        "wi": dense_spec(d, d_ff, ("embed", "mlp"), use_bias),
        "wo": dense_spec(d_ff, d, ("mlp", "embed"), use_bias),
    }


def mlp(params, x, activation: str):
    if activation in ("swiglu", "geglu"):
        act = "silu" if activation == "swiglu" else "gelu"
        h = _act(act, dense(params["wg"], x)) * dense(params["wi"], x)
    else:
        h = _act("gelu" if activation == "gelu" else "silu", dense(params["wi"], x))
    h = with_logical_constraint(h, ("batch",) + (None,) * (h.dim() - 2) + ("mlp",))
    return dense(params["wo"], h)


# ---------------------------------------------------------------------------
# Depthwise causal conv (the RG-LRU and Mamba-2 blocks)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over (B, S, C) with w: (K, C), after the K - 1
    rows of ``tail`` (zeros when None).  Returns (y, the new tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return y + b[None, None, :], xp[:, xp.shape[1] - (k - 1):, :]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
