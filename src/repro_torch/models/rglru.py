"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The recurrence h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t) runs, over a
prompt, through ``scan``: by default ``repro_torch.kernels.rglru.ops.rglru_scan``,
which launches the hand-written Hopper kernel on CUDA tensors and runs its
plain loop (``ref.rglru_scan_ref``) on CPU tensors.  A decode step (one
token) is ``rglru_step``, with no launch.  The reference folds the state with
an associative scan; the kernel is sequential, so float32 results agree to
the rounding of a different summation order (about 1e-5 of the largest
output).

Under a mesh the channels are sharded over 'model' (``("batch", "seq",
"mlp")``), and the scan, being per channel, runs in a ``local_map`` on each
rank's (B, S, D/m) slice, its gradient through the same ``scan``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.parallel.sharding import is_dtensor, logical_sharding, matmul, with_logical_constraint

from .layers import ParamSpec, causal_conv

_C = 8.0  # Griffin's fixed exponent scale

Scan = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def rglru_block_spec(d_model: int, cfg: RGLRUConfig) -> Dict[str, Any]:
    dr = cfg.d_rnn or int(1.5 * d_model)
    return {
        # two input branches (recurrent + gate), GeGLU-style
        "w_x": {"kernel": ParamSpec((d_model, dr), ("embed", "mlp"))},
        "w_gate": {"kernel": ParamSpec((d_model, dr), ("embed", "mlp"))},
        "conv_w": ParamSpec((cfg.d_conv, dr), (None, "conv_io")),
        "conv_b": ParamSpec((dr,), ("conv_io",), init="zeros"),
        # RG-LRU gates
        "w_input_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "b_input_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "w_rec_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "b_rec_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "lambda_param": ParamSpec((dr,), ("mlp",), init="ones"),
        "w_out": {"kernel": ParamSpec((dr, d_model), ("mlp", "embed"))},
    }


def _gates(params, x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, √(1−a²)·i_t·x_t) in float32; the gate vectors are float32 leaves."""
    gate_in = torch.sigmoid(x32 * params["w_input_gate"] + params["b_input_gate"])
    gate_rec = torch.sigmoid(x32 * params["w_rec_gate"] + params["b_rec_gate"])
    log_a = -_C * gate_rec * F.softplus(params["lambda_param"])
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * gate_in * x32


def rglru(params, x: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
          scan: Scan = rglru_ops.rglru_scan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core RG-LRU over (B, S, Dr). Returns (y, final h), in ``x``'s dtype."""
    a, gated = _gates(params, x.float())
    y = _scan_sharded(scan, a.contiguous(), gated.contiguous(), None if h0 is None else h0.float())
    return y.to(x.dtype), y[:, -1].to(x.dtype)


def _scan_sharded(scan: Scan, a, b, h0):
    """``scan`` on plain tensors, or in a ``local_map`` over the rank's
    batch rows and channels of DTensors (the time axis whole)."""
    if not is_dtensor(a):
        return scan(a, b, h0)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = a.device_mesh
    pl = logical_sharding(("batch", "seq", "mlp"), mesh, a.shape).placements()
    if h0 is None:
        fn = local_map(lambda al, bl: scan(al, bl, None), out_placements=list(pl), in_placements=(pl, pl),
                       device_mesh=mesh, redistribute_inputs=True)
        return fn(a, b)
    h_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)
    fn = local_map(scan, out_placements=list(pl), in_placements=(pl, pl, h_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(a, b, h0)


def rglru_step(params, x: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x, h: (B, Dr)."""
    a, gated = _gates(params, x.float())
    h_new = (a * h.float() + gated).to(x.dtype)
    return h_new, h_new


def rglru_block(params, x: torch.Tensor, cfg: RGLRUConfig, *, cache: Optional[Dict[str, torch.Tensor]] = None,
                scan: Scan = rglru_ops.rglru_scan) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full recurrent block: in-proj ∥ gate, conv1d, RG-LRU, gated out-proj.

    cache: {'conv': (B, d_conv−1, Dr), 'h': (B, Dr)} for decode, in the
    activation dtype (as the reference stores them); the new state is written
    into these tensors in place and the returned cache holds them.  A prompt
    (S > 1) runs the recurrence through ``scan``; one token through
    ``rglru_step``."""
    gate = F.gelu(matmul(x, params["w_gate"]["kernel"].to(x.dtype)), approximate="tanh")
    xr = matmul(x, params["w_x"]["kernel"].to(x.dtype))
    tail = cache["conv"] if cache is not None else None
    xr, new_tail = causal_conv(xr, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype), tail)
    xr = with_logical_constraint(xr, ("batch", "seq", "mlp"))
    h0 = cache["h"] if cache is not None else None
    if h0 is not None and xr.shape[1] == 1:
        y, h_last = rglru_step(params, xr[:, 0], h0)
        y = y[:, None]
    else:
        y, h_last = rglru(params, xr, h0=h0, scan=scan)
    out = matmul(y * gate, params["w_out"]["kernel"].to(x.dtype))
    if cache is None:
        return out, None
    cache["conv"].copy_(new_tail)
    cache["h"].copy_(h_last)
    return out, cache


def make_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    dr = cfg.d_rnn or int(1.5 * d_model)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, dr), dtype=dtype, device=device),
        "h": torch.zeros((batch, dr), dtype=dtype, device=device),
    }
