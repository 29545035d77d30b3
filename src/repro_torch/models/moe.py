"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Each sequence routes its own S·k assignments (row-local, as the reference):
a stable sort by expert id, a position within each expert's group, and a
capacity clamp; assignments past the capacity are dropped (they land in the
last slot with zero weight, as the reference's overflow slot).  The expert
products are batched matrix products over (B, E, C, D) buffers.  Aux
losses follow Switch/ST-MoE.

Under a mesh whose 'model' axis divides E and whose data axes divide B, the
dispatch is expert-parallel (``_dispatch_ffn_combine``, the reference's
``shard_map`` variant): x stays replicated over 'model', each model rank
dispatches its rows to its own E/ep experts only (``expert_offset``,
``e_local``) and the ranks' float32 partial outputs are summed over 'model'
(float64 ones for float64 activations).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.parallel.sharding import axis_size, is_dtensor, matmul, with_logical_constraint

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
    h = with_logical_constraint(h, ("batch", "experts", None, "mlp"))
    return torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))


def _dispatch_combine(params, x: torch.Tensor, expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                      capacity: int, e: int, activation: str, expert_offset=0,
                      e_local: Optional[int] = None) -> torch.Tensor:
    """Row-local dispatch → expert FFN → combine, in the gates' dtype
    (float32, float64 for float64 activations) (B, S, D).

    With ``expert_offset``/``e_local`` the weights are those of experts
    ``expert_offset ..`` only (``e_local`` of them): only they are buffered,
    computed and combined, and assignments to other experts land nowhere,
    so the result is this slice's partial output."""
    e_local = e if e_local is None else e_local
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
    se_loc = se - expert_offset
    keep = (pos < capacity) & (se_loc >= 0) & (se_loc < e_local)
    slot = torch.where(keep, se_loc * capacity + pos, e_local * capacity - 1)
    x_tok = torch.gather(x, 1, stok[..., None].expand(b, tk, d))  # (B, S·k, D)
    # kept assignments own distinct slots; the dropped ones add zeros to the last
    buf = torch.zeros((b, e_local * capacity, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(b, tk, d), torch.where(keep[..., None], x_tok, 0))

    y = _expert_ffn(params, buf.reshape(b, e_local, capacity, d), activation).reshape(b, e_local * capacity, d)
    vals = torch.where(keep[..., None], torch.gather(y, 1, slot[..., None].expand(b, tk, d)), 0)
    contrib = vals.to(sg.dtype) * sg[..., None]
    # back to (token, k) order, then each token's k contributions summed:
    # the same sums as the reference's scatter-add, in a fixed order on the card
    unsorted = torch.empty_like(contrib).scatter_(1, order[..., None].expand(b, tk, d), contrib)
    return unsorted.reshape(b, s, k, d).sum(dim=2)


def _dispatch_ffn_combine(params, x, expert_idx, gate_vals, capacity: int, e: int, activation: str):
    """The dispatch → FFN → combine of ``moe_layer``, expert-parallel on
    DTensors: in a ``local_map`` each model rank runs ``_dispatch_combine``
    on its batch rows (all of its sequence) and its E/ep experts (the
    weights ``Shard(0)`` over 'model'), and returns its partial output (in
    the gates' dtype, float32 or float64); the partials are summed over 'model' (the reference's ``psum``:
    an all-reduce).  Plain tensors take the local path."""
    if not is_dtensor(x):
        return _dispatch_combine(params, x, expert_idx, gate_vals, capacity, e, activation)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    ep = axis_size(mesh, "model")
    dp = 1
    for a in ("pod", "data"):
        dp *= axis_size(mesh, a)
    if ep <= 1 or e % ep or x.shape[0] % dp:
        raise NotImplementedError(
            f"moe under a mesh: expert parallelism needs 'model' ({ep}) to divide n_experts ({e}) and the data "
            f"axes ({dp}) to divide the batch ({x.shape[0]})")
    e_local = e // ep
    model_dim = names.index("model")
    rows = tuple(Shard(0) if a in ("pod", "data") else Replicate() for a in names)
    rows_grad = tuple(Partial() if a == "model" else p for a, p in zip(names, rows))
    w_pl = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    # each data rank's rows give a part of the weights' gradients
    w_grad = tuple(Shard(0) if a == "model" else Partial() for a in names)
    out_pl = tuple(Partial() if a == "model" else p for a, p in zip(names, rows))
    keys = [k for k in ("wi", "wg", "wo") if k in params]

    def body(xl, il, gl, *ws):
        offset = mesh.get_local_rank(model_dim) * e_local
        return _dispatch_combine(dict(zip(keys, ws)), xl, il, gl, capacity, e, activation,
                                 expert_offset=offset, e_local=e_local)

    fn = local_map(body, out_placements=list(out_pl), in_placements=(rows, rows, rows) + (w_pl,) * len(keys),
                   in_grad_placements=(rows_grad, rows, rows_grad) + (w_grad,) * len(keys),
                   device_mesh=mesh, redistribute_inputs=True)
    partial = fn(x, expert_idx, gate_vals, *(params[k] for k in keys))
    return partial.redistribute(mesh, rows)


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

    # ---- routing (float32 for numerics, float64 for float64 activations;
    # the router is a float32 leaf)
    ct = torch.promote_types(x.dtype, torch.float32)
    logits = matmul(x.to(ct), params["router"]["kernel"].to(ct))  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (Switch/ST-MoE)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = F.one_hot(expert_idx, e).to(ct).sum(dim=2).mean(dim=(0, 1))
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
    out = _dispatch_ffn_combine(params, x, expert_idx, gate_vals, capacity, e, activation)
    if cfg.shared_d_ff:
        out = out + mlp(params["shared"], x, activation).to(out.dtype)
    return out.to(x.dtype), aux
