"""Plain torch oracle for hdiff (hand-vectorized, independent of the DSL)."""

from __future__ import annotations

import torch


def hdiff_ref(in_phi: torch.Tensor, alpha, *, lim: float = 0.01) -> torch.Tensor:
    """in_phi: (NI+6, NJ+6, NK); returns the full array with the interior updated."""

    def lap(a):
        out = torch.zeros_like(a)
        out[1:-1, 1:-1, :] = (
            -4.0 * a[1:-1, 1:-1, :] + a[:-2, 1:-1, :] + a[2:, 1:-1, :]
            + a[1:-1, :-2, :] + a[1:-1, 2:, :]
        )
        return out

    def gx(a):
        out = torch.zeros_like(a)
        out[:-1, :, :] = a[1:, :, :] - a[:-1, :, :]
        return out

    def gy(a):
        out = torch.zeros_like(a)
        out[:, :-1, :] = a[:, 1:, :] - a[:, :-1, :]
        return out

    x = in_phi
    bilap = lap(lap(x))
    fx = gx(bilap)
    fy = gy(bilap)
    limit = torch.tensor(lim, dtype=x.dtype, device=x.device)
    fx = torch.where(fx * gx(x) > lim, fx, limit)
    fy = torch.where(fy * gy(x) > lim, fy, limit)
    upd = x[3:-3, 3:-3, :] + alpha * (
        (fx[3:-3, 3:-3, :] - fx[2:-4, 3:-3, :]) + (fy[3:-3, 3:-3, :] - fy[3:-3, 2:-4, :])
    )
    out = x.clone()
    out[3:-3, 3:-3, :] = upd
    return out
