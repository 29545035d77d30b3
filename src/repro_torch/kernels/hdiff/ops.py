"""Horizontal-diffusion kernel — generated by the DSL's ``cuda`` backend.

The paper's flagship motif compiled end to end by the toolchain: GTScript
source → Definition IR → analysis (8 stages, halo 3) → one generated Hopper
kernel (``core/codegen_cuda.py``), the counterpart of the reference's Pallas
kernel ``repro/kernels/hdiff/ops.py::hdiff``.  On a CUDA tensor it launches
that kernel; on a CPU tensor it runs the plain torch module of the same
stencil.  The kernel source is ``build_hdiff('cuda').generated_source``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.codegen_cuda import DEFAULT_BLOCK
from repro_torch.core.storage import card_tensor
from repro_torch.stencils.hdiff import HALO, build_hdiff


def hdiff(in_phi: torch.Tensor, alpha, *, lim: float = 0.01,
          block: Tuple[int, int] = DEFAULT_BLOCK) -> torch.Tensor:
    """in_phi: (NI+6, NJ+6, NK) with a 3-deep halo, in any layout; returns a
    new tensor of the same shape, in the card layout, with the interior
    updated and the halo ring copied."""
    if in_phi.dim() != 3:
        raise ValueError(f"hdiff: expected a 3-d (NI+6, NJ+6, NK) tensor, got shape {tuple(in_phi.shape)}")
    ni, nj, nk = in_phi.shape[0] - 2 * HALO, in_phi.shape[1] - 2 * HALO, in_phi.shape[2]
    st = build_hdiff("cuda", lim=lim, dtype=str(in_phi.dtype).replace("torch.", ""), block=tuple(block))
    # seed the output with the input so the (unwritten) halo ring survives;
    # the output is in the card layout whatever the input's (storage.py)
    out = card_tensor(in_phi.shape, in_phi.dtype, in_phi.device)
    out.copy_(in_phi)
    st(in_phi, out, alpha=alpha, domain=(ni, nj, nk), origin=(HALO, HALO, 0))
    return out


def stencil_object(dtype: str = "float64", lim: float = 0.01, block: Tuple[int, int] = DEFAULT_BLOCK):
    """The StencilObject ``hdiff`` calls (its ``launches`` counts the kernel)."""
    return build_hdiff("cuda", lim=lim, dtype=dtype, block=tuple(block))
