"""The climate step in plain torch: the five definitions of the port's
``stencils/forecast.py`` (advect, euler, diffuse) and ``stencils/vadv.py``
(vadv_system, vadv) written out as slicing and a Thomas solve.

Fields are interiors laid out (M, K, I, J): members, levels, then the
horizontal plane, so that a level is one contiguous plane.  Every halo is
zero (a Dirichlet boundary), which is what the benchmark's fields hold in the
single-domain cells and what the outer rims hold on a decomposed domain.
``u``, ``v`` and ``w`` are (K, I, J), shared by every member, or (M, K, I, J).
``start`` and ``advance`` are what the check (``bench/checks/state_gap.py``)
calls: the state is ``{"phi": (M, K, I, J)}``.

This module imports torch alone: nothing of the program, its kernels or its
generated modules.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def _pad(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one ring of zeros around the (I, J) plane."""
    out = x.new_zeros(x.shape[:-2] + (x.shape[-2] + 2, x.shape[-1] + 2))
    out[..., 1:-1, 1:-1] = x
    return out


def step(phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         s: Dict[str, float]) -> torch.Tensor:
    """One step: the new ``phi`` (M, K, I, J) from ``phi``."""
    dt, dx, dy, dz, alpha = (s[k] for k in ("dt", "dx", "dy", "dz", "alpha"))
    p = _pad(phi)
    c = p[..., 1:-1, 1:-1]
    # advect: upwind differences
    fx = torch.where(u > 0.0, (c - p[..., :-2, 1:-1]) / dx, (p[..., 2:, 1:-1] - c) / dx)
    fy = torch.where(v > 0.0, (c - p[..., 1:-1, :-2]) / dy, (p[..., 1:-1, 2:] - c) / dy)
    adv = -(u * fx + v * fy)
    del p, c, fx, fy
    # euler
    star = phi + dt * adv
    del adv
    # diffuse: 5-point Laplacian
    q = _pad(star)
    lap = -4.0 * star + (q[..., :-2, 1:-1] + q[..., 2:, 1:-1] + q[..., 1:-1, :-2] + q[..., 1:-1, 2:])
    ph = star + alpha * lap
    del q, lap, star
    # vadv_system: the Crank-Nicolson system; g[k] couples levels k and k + 1
    nk = phi.shape[-3]
    g = 0.25 * (w[..., 1:, :, :] + w[..., :-1, :, :]) * dt / dz
    a = torch.empty_like(ph)
    b = torch.empty_like(ph)
    cc = torch.empty_like(ph)
    d = torch.empty_like(ph)
    gk, gm = g[..., 1:, :, :], g[..., :-1, :, :]  # gcv and gcv_m on levels 1 .. nk-2
    mid = slice(1, nk - 1)
    a[..., mid, :, :] = -gm
    cc[..., mid, :, :] = gk
    b[..., mid, :, :] = 1.0 + gk - gm
    d[..., mid, :, :] = (ph[..., mid, :, :] - gk * (ph[..., 2:, :, :] - ph[..., mid, :, :])
                         + gm * (ph[..., mid, :, :] - ph[..., :-2, :, :]))
    g0 = g[..., 0, :, :]
    a[..., 0, :, :] = 0.0
    cc[..., 0, :, :] = g0
    b[..., 0, :, :] = 1.0 + g0
    d[..., 0, :, :] = ph[..., 0, :, :] - g0 * (ph[..., 1, :, :] - ph[..., 0, :, :])
    gt = g[..., nk - 2, :, :]
    a[..., nk - 1, :, :] = -gt
    cc[..., nk - 1, :, :] = 0.0
    b[..., nk - 1, :, :] = 1.0 - gt
    d[..., nk - 1, :, :] = ph[..., nk - 1, :, :] + gt * (ph[..., nk - 1, :, :] - ph[..., nk - 2, :, :])
    del ph, g
    # vadv: the Thomas solve, forward elimination then back substitution
    cp, dp = cc, d  # overwritten level by level: cp[k] and dp[k] need only level k - 1
    cp[..., 0, :, :] = cc[..., 0, :, :] / b[..., 0, :, :]
    dp[..., 0, :, :] = d[..., 0, :, :] / b[..., 0, :, :]
    for k in range(1, nk):
        denom = b[..., k, :, :] - a[..., k, :, :] * cp[..., k - 1, :, :]
        cp[..., k, :, :] = cc[..., k, :, :] / denom
        dp[..., k, :, :] = (d[..., k, :, :] - a[..., k, :, :] * dp[..., k - 1, :, :]) / denom
    del a, b
    out = dp  # back substitution in place: out[k] needs dp[k] and out[k + 1]
    for k in range(nk - 2, -1, -1):
        out[..., k, :, :] = dp[..., k, :, :] - cp[..., k, :, :] * out[..., k + 1, :, :]
    return out


def run(phi: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, s: Dict[str, float],
        steps: int) -> torch.Tensor:
    """``steps`` steps from ``phi`` (M, K, I, J); returns the last ``phi``."""
    for _ in range(int(steps)):
        phi = step(phi, u, v, w, s)
    return phi


def start(inputs, members: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The seeded state of ``members``, from the benchmark's inputs."""
    return {"phi": torch.stack([inputs.phi(m) for m in members])}


def advance(state: Dict[str, torch.Tensor], inputs, s: Dict[str, float],
            steps: int) -> Dict[str, torch.Tensor]:
    """``state`` ``steps`` steps on, under the inputs' winds."""
    return {"phi": run(state["phi"], inputs.u(), inputs.v(), inputs.w(), s, steps)}
