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
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, dh = q.shape
    kh, skv = k.shape[2], k.shape[1]
    work = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kh, h // kh, dh).to(work)
    scale = float(1.0 / np.sqrt(dh)) if scale is None else float(scale)
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


LOG2E = 1.4426950408889634


def tile_keys(dh: int) -> int:
    """BK of the bfloat16 tensor-core kernel (``csrc/flash_fwd_sm90.cu``) for a head dim."""
    return 64 if dh > 128 else 128


def flash_attention_sm90_model(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, Skv, Kh, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    bk: Optional[int] = None,
) -> torch.Tensor:
    """The arithmetic of the bfloat16 tensor-core kernel, in plain torch: the
    kernel's tiles (blocks of 128 query rows, 64 per warpgroup; kv tiles of
    ``bk`` keys, skipped where the kernel skips them), the online softmax in
    log2 units in float32, P rounded to bfloat16 before P·V, float32 sums.
    It shows on the CPU what rounding P costs against the reference; the
    kernel's own sums run in another order."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    bk = bk or tile_keys(dh)
    kv_len = skv if kv_len is None else min(int(kv_len), skv)
    scale = float(1.0 / np.sqrt(dh))
    qf = q.float().reshape(b, sq, kh, h // kh, dh)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, sq, kh, h // kh, dh), dtype=torch.float32)
    for q0 in range(0, sq, 128):  # one block
        last = q_offset + min(q0 + 128, sq) - 1
        k_end = min(kv_len, last + 1) if causal else kv_len
        k_begin = max(0, q_offset + q0 - window + 1) if window is not None else 0
        k_begin -= k_begin % bk
        for w0 in range(q0, min(q0 + 128, sq), 64):  # one warpgroup
            rows = torch.arange(w0, min(w0 + 64, sq))
            first, wlast = q_offset + w0, q_offset + int(rows[-1])
            qpos = rows + q_offset
            acc = torch.zeros((b, len(rows), kh, h // kh, dh))
            m = torch.full((b, len(rows), kh, h // kh), NEG_INF)
            lsum = torch.zeros_like(m)
            for k0 in range(k_begin, k_end, bk):
                if (causal and k0 > wlast) or (window is not None and k0 + bk - 1 <= first - window):
                    continue
                kpos = torch.arange(k0, min(k0 + bk, skv))
                s = torch.einsum("bqkgd,bskd->bqkgs", qf[:, rows], kf[:, kpos]) * scale
                if cap is not None:
                    s = cap * torch.tanh(s / cap)
                s = s * LOG2E
                ok = kpos[None, :] < kv_len
                if causal:
                    ok = ok & (kpos[None, :] <= qpos[:, None])
                if window is not None:
                    ok = ok & (kpos[None, :] > qpos[:, None] - window)
                s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                lsum = lsum * alpha + p.sum(dim=-1)
                pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(torch.bfloat16).float(), vf[:, kpos])
                acc = acc * alpha[..., None] + pv
                m = m_new
            out[:, rows] = acc / torch.clamp_min(lsum, 1e-37)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


# (BQ query rows, BK keys a tile, P·V on the float64 tensor cores) of the
# float32 kernel (csrc/flash_fwd.cu's dispatch table)
F32_TILES = {16: (128, 32, True), 32: (128, 32, True), 64: (128, 32, True), 96: (128, 32, True),
             128: (64, 32, False), 160: (64, 32, False), 256: (32, 16, False)}


def flash_attention_f32_model(
    q: torch.Tensor,  # (B, S, H, Dh) float32
    k: torch.Tensor,  # (B, Skv, Kh, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    window: Optional[int] = None,
    cap: Optional[float] = None,
) -> torch.Tensor:
    """The arithmetic of the float32 kernel (``csrc/flash_fwd.cu``) in plain
    torch: blocks of BQ query rows, kv tiles of BK keys from the block's first
    visible tile to its last, the scores summed in float64 (the tensor cores'
    DMMA) and then rounded to float32, scaled and taken to log2 units, the
    online softmax in float32 with exp2, each tile's p and p·v summed on their
    own (p·v in float64 where the kernel runs P·V on DMMA, else in float32)
    and added to the float32 (l, acc).  Only the order of the sums inside a
    tile differs from the kernel's."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    bq, bk, pv_dmma = F32_TILES[dh]
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    kv_len = skv if kv_len is None else min(int(kv_len), skv)
    scale = torch.tensor(1.0 / np.sqrt(dh), dtype=torch.float32)
    q64 = q.double().reshape(b, sq, kh, h // kh, dh)
    k64, vf = k.double(), v.float()
    out = torch.zeros((b, sq, kh, h // kh, dh), dtype=torch.float32)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        qpos = rows + q_offset
        last = q_offset + int(rows[-1])
        k_end = min(kv_len, last + 1) if causal else kv_len
        k_begin = max(0, q_offset + q0 - window + 1) if window is not None else 0
        k_begin -= k_begin % bk
        acc = torch.zeros((b, len(rows), kh, h // kh, dh))
        m = torch.full((b, len(rows), kh, h // kh), NEG_INF)
        lsum = torch.zeros_like(m)
        for k0 in range(k_begin, k_end, bk):
            kpos = torch.arange(k0, min(k0 + bk, skv))
            s = torch.einsum("bqkgd,bskd->bqkgs", q64[:, rows], k64[:, kpos]).float()
            if cap is not None:
                s = cap * torch.tanh(s * scale / cap) * log2e
            else:
                s = s * (scale * log2e)
            ok = kpos[None, :] < kv_len
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                ok = ok & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            lsum = lsum * alpha + p.sum(dim=-1)
            if pv_dmma:  # summed in float64, then rounded
                pv = torch.einsum("bqkgs,bskd->bqkgd", p.double(), vf[:, kpos].double()).float()
            else:
                pv = torch.einsum("bqkgs,bskd->bqkgd", p, vf[:, kpos])
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, rows] = acc / torch.clamp_min(lsum, 1e-37)[..., None]
    return out.reshape(b, sq, h, dh)
