"""Plain torch oracle for the RG-LRU scan: a sequential loop over time in
float32, each update a multiply then an add (so each is rounded once)."""

from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t · h_{t−1} + b_t over axis 1; a, b (B, S, D); h0 (B, D), zeros
    when absent.  The state is float32; the output is in ``a``'s dtype."""
    n, s, d = a.shape
    h = torch.zeros((n, d), dtype=torch.float32, device=a.device) if h0 is None else h0.float()
    a32, b32 = a.float(), b.float()
    y = torch.empty((n, s, d), dtype=a.dtype, device=a.device)
    for t in range(s):
        h = a32[:, t] * h + b32[:, t]
        y[:, t] = h
    return y
