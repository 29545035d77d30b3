"""Plain torch oracle for the flash-attention kernel: the whole (Sq, Skv)
score matrix, masked, then a softmax (a copy of the reference package's
``flash_attention_ref``).  It computes in float32, as the reference, and in
float64 for float64 inputs (a tighter oracle for the kernel's float32 path)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, Skv, Kh, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset=0,
    kv_len=None,
    window: Optional[int] = None,
    cap: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, dh = q.shape
    kh, skv = k.shape[2], k.shape[1]
    work = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kh, h // kh, dh).to(work)
    scale = float(1.0 / np.sqrt(dh))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(work)) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(work))
    return o.reshape(b, sq, h, dh).to(q.dtype)
