"""Vertical implicit (tridiagonal) solver — generated by the DSL's ``cuda``
backend from the FORWARD/BACKWARD GTScript definition (paper Fig. 3 right),
the counterpart of the reference's Pallas kernel ``repro/kernels/vadv/ops.py::vadv``.
On CUDA tensors it launches the generated kernel; on CPU tensors it runs the
plain torch module of the same stencil.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.codegen_cuda import DEFAULT_BLOCK
from repro_torch.core.storage import card_tensor
from repro_torch.stencils.vadv import build_vadv


def vadv(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
         block: Tuple[int, int] = DEFAULT_BLOCK) -> torch.Tensor:
    """Solve (a, b, c)·x = d along the last axis; all inputs (NI, NJ, NK), in
    any layout; the solution is in the card layout (storage.py)."""
    for n, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        if t.shape != b.shape or t.dtype != b.dtype or t.device != b.device:
            raise ValueError(f"vadv: {n} must match b in shape, dtype and device")
    st = build_vadv("cuda", dtype=str(b.dtype).replace("torch.", ""), block=tuple(block))
    out = card_tensor(d.shape, d.dtype, d.device, "zeros")
    st(a, b, c, d, out, domain=tuple(b.shape), origin=(0, 0, 0))
    return out


def stencil_object(dtype: str = "float64", block: Tuple[int, int] = DEFAULT_BLOCK):
    """The StencilObject ``vadv`` calls (its ``launches`` counts the kernel)."""
    return build_vadv("cuda", dtype=dtype, block=tuple(block))
