"""The plain absorbed decode over the latent cache: the function the kernel
computes, the path of CPU tensors, and the decode path of the models whose
``attention_impl`` is ``"naive"`` or ``"chunked"`` on any device."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attend_latent_ref(q_lat, q_pe, ckv, kpe, pos, scale: float) -> torch.Tensor:
    """One decode step's attention in the absorbed form, over the latent
    cache: q_lat (B, H, latent) is each head's no-rope query taken through
    its key up-projection, q_pe (B, H, rope) its rotated query; ckv (B, S,
    latent) and kpe (B, S, rope) the cache, rows up to ``pos`` (a 0-d
    tensor, read on the device) valid.  The scores are summed in float32
    (float64 for float64 inputs); returns the softmax-weighted latent (B, H,
    latent).  Every allocated row is read (the rows past ``pos`` masked), the
    latent twice: once for the scores, once for the weighted sum."""
    ct = torch.promote_types(ckv.dtype, torch.float32)
    s = torch.bmm(q_lat, ckv.transpose(1, 2)).to(ct) + torch.bmm(q_pe, kpe.transpose(1, 2)).to(ct)
    valid = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    p = torch.softmax(torch.where(valid, s * scale, NEG_INF), dim=-1)
    return torch.bmm(p.to(ckv.dtype), ckv)


def bytes_read(ckv: torch.Tensor, kpe: torch.Tensor) -> int:
    """Bytes of cache ``attend_latent_ref`` reads: every allocated row of
    every sequence, the latent twice and the rope key once."""
    b, s = ckv.shape[:2]
    return b * s * (2 * ckv.shape[-1] * ckv.element_size() + kpe.shape[-1] * kpe.element_size())
