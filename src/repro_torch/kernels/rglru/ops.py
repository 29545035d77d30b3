"""The RG-LRU scan h_t = a_t · h_{t−1} + b_t over (B, S, D).

On CUDA tensors ``rglru_scan`` launches the hand-written Hopper kernel
``csrc/rglru_scan.cu``, the counterpart of the reference's Pallas TPU kernel
(``repro/kernels/rglru``); there is no padding, the kernel masks its ragged
edge.  On CPU tensors it runs the plain version (``ref.rglru_scan_ref``).
Anything else raises.

The scan is differentiable (:class:`RGLRUScan`).  It is linear, so its
gradient is the same recurrence run backwards in time,

    g_t = dy_t + a_{t+1}·g_{t+1},   db_t = g_t,   da_t = g_t·h_{t−1},   dh0 = a_0·g_0,

and the backward launches the same kernel (the plain loop on the CPU) on the
time-reversed cotangent, with the decays shifted by one step and reversed
(``a'_r = a_{S−r}``; ``a'_0`` meets the zero initial state).  The reversals
are plain ``torch.flip`` copies.  The reference differentiates its
associative scan instead; its Pallas kernel has no gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.kernels._build import HandKernel

from .ref import rglru_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = HandKernel(
    "rglru_scan",
    Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",
    "rglru_scan",
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def _scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    """One scan, no gradient: the kernel on CUDA tensors, the plain loop on CPU ones."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return prepare(a, b, h0)()


class RGLRUScan(torch.autograd.Function):
    """The scan with its gradient: one scan forward, one scan (over reversed
    time) backward, each a kernel launch on CUDA tensors."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
        y = _scan(a, b, h0)  # a fresh tensor each call: autograd may have saved the last one
        ctx.save_for_backward(a, y, h0)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        a, y, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_backward(a, y, h0, dy)
        need_a, need_b, need_h0 = ctx.needs_input_grad
        return da if need_a else None, db if need_b else None, dh0 if need_h0 else None


def rglru_scan_backward(a: torch.Tensor, y: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor):
    """(da, db, dh0) of y = scan(a, b, h0) for the cotangent ``dy``: one scan
    over reversed time (the kernel on CUDA tensors, the plain loop on CPU
    ones), the rest elementwise; dh0 is None without h0."""
    n, s, d = a.shape
    # the decays of the reversed recurrence: a'_0 = 0 (it meets a zero state), a'_r = a_{S-r}
    ar = torch.empty_like(a)
    ar[:, 0] = 0
    ar[:, 1:] = torch.flip(a[:, 1:], [1])
    g = torch.flip(_scan(ar, torch.flip(dy.to(a.dtype), [1]), None), [1]).float()
    h_prev = torch.empty((n, s, d), dtype=torch.float32, device=a.device)
    if h0 is None:
        h_prev[:, 0] = 0
    else:
        h_prev[:, 0] = h0
    h_prev[:, 1:] = y[:, :-1]
    dh0 = None if h0 is None else (a[:, 0].float() * g[:, 0]).to(h0.dtype)
    return (g * h_prev).to(a.dtype), g.to(a.dtype), dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (decay), b (input term): (B, S, D); h0: (B, D) or None (zeros).
    Returns y (B, S, D) in ``a``'s dtype; the state is carried in float32.
    Differentiable in a, b and h0 (:class:`RGLRUScan`)."""
    return RGLRUScan.apply(a, b, h0)


def prepare(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> Callable[[], torch.Tensor]:
    """Check CUDA arguments, allocate the output and return a callable that
    launches the kernel on them (each call one launch) and returns the output."""
    if not a.is_cuda:
        raise TypeError(f"rglru_scan: tensors on {a.device} are not supported (cpu or cuda)")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b must be (B, S, D) of one shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"rglru_scan: a and b must share a dtype in {tuple(_DTYPES)} and a device; got "
                        f"{a.dtype} on {a.device}, {b.dtype} on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    n, s, d = a.shape
    if h0 is not None:
        if h0.shape != (n, d) or h0.device != a.device:
            raise ValueError(f"rglru_scan: h0 must be ({n}, {d}) on {a.device}, got {tuple(h0.shape)} on {h0.device}")
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty_like(a)
    if a.numel() == 0:
        return lambda: y
    args = (_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), n, s, d, torch.cuda.current_stream(a.device).cuda_stream)

    def launch() -> torch.Tensor:
        KERNEL.launch(*args)
        return y

    launch.keep = (a, b, h0)  # the inputs live as long as the launcher
    return launch
