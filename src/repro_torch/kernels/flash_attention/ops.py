"""Flash attention in the model's (B, S, H, Dh) layout.

On CUDA tensors ``flash_attention`` launches a hand-written Hopper kernel,
the counterpart of the reference's Pallas TPU kernel
(``repro/kernels/flash_attention``), chosen by dtype:

* bfloat16: ``csrc/flash_fwd_sm90.cu`` (``KERNEL_BF16``), both products on
  the tensor cores (``wgmma``), P rounded to bfloat16 before P·V;
* float32: ``csrc/flash_fwd.cu`` (``KERNEL``), the scores summed in float64
  on the tensor cores (DMMA: a product of two float32 values is exact in
  float64), and P·V there too up to Dh 96 (on the CUDA cores from Dh 128),
  because TF32 tensor-core products (about three decimal digits) cannot
  meet the reference's float32 tolerance of 2e-6.

Both read the layout through strides, so there is no transpose and no padding
to block multiples.  On CPU tensors it runs the plain version
(``ref.flash_attention_ref``); that is how the CPU tests drive it.  Anything
else raises, and a CUDA tensor never takes another route than its dtype's
kernel: a failed build or launch raises.  Neither kernel has a backward
(nor has the reference's): on CUDA tensors that want a gradient
``flash_attention`` raises, and training attends with ``chunked`` or
``naive``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels._build import HandKernel

from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_CSRC = Path(__file__).resolve().parent / "csrc"
# (dh, q, k, v, o, 12 strides, b, sq, skv, h, kh, q_offset, kv_len, masks, cap, scale, stream)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

# -Xptxas -v reports registers and spills in the library's log
# float32 inputs: the float64 tensor cores
KERNEL = HandKernel("flash_fwd", _CSRC / "flash_fwd.cu", "flash_fwd", _ARGTYPES, flags=("-Xptxas", "-v"))
# bfloat16 inputs: wgmma on the tensor cores
KERNEL_BF16 = HandKernel("flash_fwd_sm90", _CSRC / "flash_fwd_sm90.cu", "flash_fwd_sm90", _ARGTYPES,
                         flags=("-Xptxas", "-v"))


def _scalar(x, name: str, device: torch.device):
    """(device pointer, value) of an int or a 0-d tensor; a tensor is read
    by the kernel on the card, never on the host."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0:
            raise ValueError(f"flash_attention: {name} must be an int or a 0-d tensor, got shape {tuple(x.shape)}")
        t = x.to(device=device, dtype=torch.int32)
        return t, ctypes.c_void_p(t.data_ptr()), 0
    return None, ctypes.c_void_p(None), int(x)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, Kh, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset=0,
    kv_len=None,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``scale`` multiplies the scores (default ``1/sqrt(Dh)``): a model that
    pads its heads to a width the kernels take keeps its own scale."""
    if is_fake(q):  # a dry run: the output's shape only
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                   window=window, cap=cap, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the flash kernel has no backward, in the reference (its Pallas kernel) or in this "
            "port, so it cannot run where a gradient is wanted; train with attention_impl='chunked' or 'naive'")
    return prepare(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, cap=cap,
                   scale=scale)()


def prepare(q, k, v, *, causal: bool = True, q_offset=0, kv_len=None, window: Optional[int] = None,
            cap: Optional[float] = None, scale: Optional[float] = None) -> Callable[[], torch.Tensor]:
    """Check CUDA arguments, allocate the output and return a callable that
    launches the kernel on them (each call one launch) and returns the output."""
    if not q.is_cuda:
        raise TypeError(f"flash_attention: tensors on {q.device} are not supported (cpu or cuda)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, S, H, Dh), k and v (B, Skv, Kh, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kh != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along head_dim")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {_DTYPES}")
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the tensor-core kernel copies 16-byte chunks of rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
                raise ValueError(f"flash_attention: bfloat16 {name} needs 16-byte aligned rows (a data pointer "
                                 f"aligned to 16 bytes and strides that are multiples of 8), got strides {t.stride()}")
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return lambda: o
    qoff_t, qoff_ptr, qoff = _scalar(q_offset, "q_offset", q.device)
    klen_t, klen_ptr, klen = _scalar(skv if kv_len is None else kv_len, "kv_len", q.device)
    args = (
        dh,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        b, sq, skv, h, kh,
        qoff_ptr, qoff, klen_ptr, klen,
        int(causal), int(window is not None), int(window or 0), int(cap is not None), float(cap or 0.0),
        float(1.0 / np.sqrt(dh)) if scale is None else float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel = KERNEL_BF16 if bf16 else KERNEL

    def launch() -> torch.Tensor:
        kernel.launch(*args)
        return o

    # the inputs and the device scalars live as long as the launcher
    launch.keep = (q, k, v, qoff_t, klen_t)
    return launch
