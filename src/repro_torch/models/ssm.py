"""Mamba-2 (SSD, state-space duality) block in plain torch.

Chunked SSD (Dao & Gu 2024): the sequence is split into chunks of Q tokens;
within a chunk the output is a masked quadratic (attention-like) term;
across chunks a (H, N, P) state is carried by a loop over chunks (the
reference's ``lax.scan``).  The reference has no Pallas kernel here, so plain
torch is the port.

Under a mesh the SSD runs in a ``local_map`` on the rank's own batch rows
and heads (``_ssd_sharded``): its layout is put in place once, and the
chunk loop and einsums run on plain tensors.  DTensor would otherwise plan
every operation of the loop, and the einsums' flattened (batch, heads)
dimensions become strided shards whose planning alone took most of the dry
run's host time on the three-axis mesh.

Decode carries {conv tail (B, d_conv-1, d_xBC), state (B, H, N, P)}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.parallel.sharding import is_dtensor, matmul, with_logical_constraint

from .layers import ParamSpec, causal_conv


def ssd_spec(d_model: int, cfg: SSMConfig) -> Dict[str, Any]:
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    d_xbc = di + 2 * gn
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": {"kernel": ParamSpec((d_model, di + d_xbc + nh), ("embed", "mlp"))},
        "conv_w": ParamSpec((cfg.d_conv, d_xbc), (None, "conv_io")),
        "conv_b": ParamSpec((d_xbc,), ("conv_io",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "norm_scale": ParamSpec((di,), ("mlp",), init="ones"),
        "w_out": {"kernel": ParamSpec((di, d_model), ("mlp", "embed"))},
    }


def _ssd_chunked(x, dt, A, B, C, D, chunk: int, state0: Optional[torch.Tensor] = None,
                 head0: int = 0, n_heads: Optional[int] = None):
    """Core SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (softplus'd); A: (H,) (negative);
    B, C: (B, S, G, N); D: (H,).  Returns (y (B,S,H,P), final state (B,H,N,P)).
    ``x``'s H heads may be heads ``head0 ..`` of ``n_heads`` (a rank's own,
    under a mesh): head j then reads group (head0 + j) // (n_heads / G).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    # to chunks: (B, nc, Q, ...)
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    group = torch.arange(head0, head0 + h, device=x.device) // ((n_heads or h) // g)  # each head's group
    Bh = B.reshape(b, nc, q, g, n).index_select(3, group)  # (B,nc,Q,H,N)
    Ch = C.reshape(b, nc, q, g, n).index_select(3, group)

    da = dtc * A[None, None, None, :]          # (B, nc, Q, H) log-decay per step
    cum = torch.cumsum(da, dim=2)              # within-chunk cumulative
    seg_total = cum[:, :, -1, :]                # (B, nc, H)

    # The decays between two steps of a chunk are sums of the da between them,
    # never differences of ``cum``: the reference's exp(cum_i - cum_j) loses
    # about ulp(|cum|) (8e-6 in float32 at |cum| = 100) where the decay matters
    # most, a loss the decode step's exp(dt·A) does not have.
    # ---- intra-chunk (quadratic within Q): L[i,j] = exp(da_{j+1} + ... + da_i) · (i >= j)
    ii = torch.arange(q, device=x.device)
    after = (ii[:, None] > ii[None, :])[None, None, :, :, None]
    seg = torch.cumsum(torch.where(after, da[:, :, :, None, :], 0.0), dim=2)  # (B,nc,Q,Q,H)
    L = torch.where((ii[:, None] >= ii[None, :])[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)          # (B,nc,Q,Q,H)
    w = scores * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w, xc)

    # ---- chunk states: S_c = Σ_j exp(da_{j+1} + ... + da_{Q-1}) dt_j B_j ⊗ x_j
    to_end = torch.flip(torch.cumsum(torch.flip(da[:, :, 1:], dims=(2,)), dim=2), dims=(2,))
    to_end = torch.cat([to_end, torch.zeros_like(da[:, :, :1])], dim=2)
    decay_to_end = torch.exp(to_end)                            # (B,nc,Q,H)
    wB = Bh * (decay_to_end * dtc)[..., None]                   # (B,nc,Q,H,N)
    chunk_states = torch.einsum("bcqhn,bcqhp->bchnp", wB, xc)   # (B,nc,H,N,P)

    # ---- inter-chunk recurrence carrying (B,H,N,P): the state before each chunk
    state = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device) if state0 is None else state0
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(seg_total[:, c])[..., None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,nc,H,N,P)

    # ---- inter-chunk contribution: y_i += (C_i · S_prev) · exp(cum_i)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch, prev_states) * torch.exp(cum)[..., None]

    y = y_intra + y_inter + xc * D[None, None, None, :, None]
    return y.reshape(b, nc * q, h, p)[:, :s], state


def _ssd_sharded(x, dt, A, B, C, D, chunk: int, state0: Optional[torch.Tensor] = None):
    """``_ssd_chunked`` on DTensors: each rank scans its own batch rows (the
    mesh axes that shard ``x``'s batch) and heads (the axis that shards its
    heads) over the whole sequence; every other axis sees it replicated.
    The gradients of the leaves a rank reads whole (A and D across batch
    shards, B and C across head shards) are the sum of the ranks'."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    h = x.shape[2]
    x_pl, dt_pl, hv_pl, bc_pl, st_pl = [], [], [], [], []
    hv_grad, bc_grad = [], []
    head_dim = None
    for i, p in enumerate(x.placements):
        if p == Shard(0):  # batch rows
            x_pl.append(p), dt_pl.append(p), hv_pl.append(Replicate()), bc_pl.append(p), st_pl.append(p)
            hv_grad.append(Partial()), bc_grad.append(p)
        elif p == Shard(2):  # heads
            head_dim = i
            x_pl.append(p), dt_pl.append(p), hv_pl.append(Shard(0)), bc_pl.append(Replicate()), st_pl.append(Shard(1))
            hv_grad.append(Shard(0)), bc_grad.append(Partial())
        else:  # the sequence, head_dim or a partial sum: the scan needs it whole
            for pl in (x_pl, dt_pl, hv_pl, bc_pl, st_pl, hv_grad, bc_grad):
                pl.append(Replicate())

    def body(xl, dtl, al, bl, cl, dl, sl):
        head0 = 0 if head_dim is None else mesh.get_local_rank(head_dim) * xl.shape[2]
        return _ssd_chunked(xl, dtl, al, bl, cl, dl, chunk, state0=sl, head0=head0, n_heads=h)

    st_in = None if state0 is None else st_pl
    fn = local_map(body, out_placements=(x_pl, st_pl),
                   in_placements=(x_pl, dt_pl, hv_pl, bc_pl, bc_pl, hv_pl, st_in),
                   in_grad_placements=(x_pl, dt_pl, hv_grad, bc_grad, bc_grad, hv_grad, st_in),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, dt, A, B, C, D, state0)


def ssd_block(params, x: torch.Tensor, cfg: SSMConfig, *,
              cache: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba-2 block. x: (B, S, D). cache: {'conv', 'state'} for decode;
    the new conv tail and state are written into its tensors in place."""
    b, s, d_model = x.shape
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    d_xbc = di + 2 * gn

    proj = matmul(x, params["w_in"]["kernel"].to(x.dtype))  # (B, S, di + d_xbc + nh)
    z, xbc, dt_raw = torch.split(proj, [di, d_xbc, nh], dim=-1)

    conv_tail = cache["conv"] if cache is not None else None
    xbc, new_tail = causal_conv(xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype), conv_tail)
    xbc = F.silu(xbc)
    xs, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    xs = xs.reshape(b, s, nh, cfg.head_dim)
    xs = with_logical_constraint(xs, ("batch", "seq", "ssm_heads", None))
    B = B.reshape(b, s, cfg.n_groups, cfg.d_state)
    C = C.reshape(b, s, cfg.n_groups, cfg.d_state)
    # the SSD and its gated norm in float32, as the reference casts, or in
    # float64 for float64 activations
    ct = torch.promote_types(x.dtype, torch.float32)
    dt = F.softplus(dt_raw.to(ct) + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"].to(ct))  # (H,) negative

    state0 = cache["state"].to(ct) if cache is not None else None
    scan = _ssd_sharded if is_dtensor(xs) else _ssd_chunked
    y, final_state = scan(xs.to(ct), dt, A, B.to(ct), C.to(ct), params["D"].to(ct), cfg.chunk, state0=state0)
    y = y.reshape(b, s, di).to(x.dtype)

    # gated RMSNorm (Mamba-2)
    y32 = y.to(ct) * F.silu(z.to(ct))
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    y32 = y32 * torch.rsqrt(var + 1e-6) * params["norm_scale"].to(ct)
    out = matmul(y32.to(x.dtype), params["w_out"]["kernel"].to(x.dtype))
    if cache is None:
        return out, None
    cache["conv"].copy_(new_tail)
    cache["state"].copy_(final_state)
    return out, cache


def make_ssd_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * gn), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, cfg.d_state, cfg.head_dim), dtype=dtype, device=device),
    }
