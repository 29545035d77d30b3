"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Each sequence routes its own S·k assignments (row-local, as the reference):
a stable sort by expert id, a position within each expert's group, and a
capacity clamp; assignments past the capacity are dropped (they land in the
last slot with zero weight, as the reference's overflow slot).  The expert
products are batched matrix products over (B, E, C, D) buffers; the
reference's expert-parallel ``shard_map`` variant is the mesh path and is
not part of this single-device port.  Aux losses follow Switch/ST-MoE.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

from .layers import ParamSpec, mlp, mlp_spec


def moe_spec(d: int, cfg: MoEConfig, activation: str, use_bias: bool) -> Dict[str, Any]:
    e, f = cfg.n_experts, cfg.d_ff_expert
    mult_gated = activation in ("swiglu", "geglu")
    spec: Dict[str, Any] = {
        "router": {"kernel": ParamSpec((d, e), ("embed", "experts"), dtype="float32")},
        "wi": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }
    if mult_gated:
        spec["wg"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
    if cfg.shared_d_ff:
        spec["shared"] = mlp_spec(d, cfg.shared_d_ff, activation, use_bias)
    return spec


def _expert_ffn(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (B, E, C, D) → (B, E, C, D), each expert's FFN on its buffer."""
    h = torch.einsum("becd,edf->becf", x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.einsum("becd,edf->becf", x, params["wg"].to(x.dtype))
        h = (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))


def _dispatch_combine(params, x: torch.Tensor, expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                      capacity: int, e: int, activation: str) -> torch.Tensor:
    """Row-local dispatch → expert FFN → combine, in float32 (B, S, D)."""
    b, s, d = x.shape
    k = expert_idx.shape[-1]
    tk = s * k
    flat_expert = expert_idx.reshape(b, tk)
    flat_gate = gate_vals.reshape(b, tk)
    flat_token = torch.arange(s, device=x.device).repeat_interleave(k)[None].expand(b, tk)

    order = torch.argsort(flat_expert, dim=1, stable=True)  # (B, S·k)
    se = torch.gather(flat_expert, 1, order)
    sg = torch.gather(flat_gate, 1, order)
    stok = torch.gather(flat_token, 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device).scatter_add_(1, se, torch.ones_like(se))
    group_start = torch.cumsum(counts, dim=1) - counts  # (B, E)
    pos = torch.arange(tk, device=x.device)[None] - torch.gather(group_start, 1, se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, e * capacity - 1)
    x_tok = torch.gather(x, 1, stok[..., None].expand(b, tk, d))  # (B, S·k, D)
    # kept assignments own distinct slots; the dropped ones add zeros to the last
    buf = torch.zeros((b, e * capacity, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(b, tk, d), torch.where(keep[..., None], x_tok, 0))

    y = _expert_ffn(params, buf.reshape(b, e, capacity, d), activation).reshape(b, e * capacity, d)
    vals = torch.where(keep[..., None], torch.gather(y, 1, slot[..., None].expand(b, tk, d)), 0)
    contrib = vals.float() * sg[..., None]
    # back to (token, k) order, then each token's k contributions summed:
    # the same sums as the reference's scatter-add, in a fixed order on the card
    unsorted = torch.empty_like(contrib).scatter_(1, order[..., None].expand(b, tk, d), contrib)
    return unsorted.reshape(b, s, k, d).sum(dim=2)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's k most probable experts: (their probabilities, their ids).
    ``moe_layer`` looks it up at each call, so that a check can replay one
    run's discrete choices in another."""
    return torch.topk(probs, k, dim=-1)


def moe_layer(params, x: torch.Tensor, cfg: MoEConfig, activation: str, *,
              capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → (out (B, S, D), aux-loss dict)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k

    # ---- routing (float32 for numerics; the router is a float32 leaf)
    logits = x.float() @ params["router"]["kernel"]  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (Switch/ST-MoE)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = F.one_hot(expert_idx, e).float().sum(dim=2).mean(dim=(0, 1))
    load_balance = e * torch.sum(me * ce) / k
    router_z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {
        "load_balance_loss": cfg.load_balance_coef * load_balance,
        "router_z_loss": cfg.router_z_coef * router_z,
    }

    # ---- row-local sort-based dispatch with capacity clamp
    if capacity is None:
        capacity = int(cfg.capacity_factor * s * k / e + 1)
    capacity = min(capacity, s)
    out = _dispatch_combine(params, x, expert_idx, gate_vals, capacity, e, activation)
    if cfg.shared_d_ff:
        out = out + mlp(params["shared"], x, activation).float()
    return out.to(x.dtype), aux
