"""Plain torch Thomas-algorithm oracle (a k-loop, independent of the DSL)."""

from __future__ import annotations

import torch


def vadv_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve (a, b, c)·x = d along the last axis (tridiagonal, Thomas)."""
    nk = b.shape[-1]
    cp = torch.zeros_like(b)
    dp = torch.zeros_like(b)
    cp_prev = torch.zeros_like(b[..., 0])
    dp_prev = torch.zeros_like(b[..., 0])
    for k in range(nk):
        denom = b[..., k] - a[..., k] * cp_prev
        cp[..., k] = c[..., k] / denom
        dp[..., k] = (d[..., k] - a[..., k] * dp_prev) / denom
        cp_prev, dp_prev = cp[..., k], dp[..., k]
    x = torch.zeros_like(b)
    x_next = torch.zeros_like(b[..., 0])
    for k in range(nk - 1, -1, -1):
        x[..., k] = dp[..., k] - cp[..., k] * x_next
        x_next = x[..., k]
    return x
