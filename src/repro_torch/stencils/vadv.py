# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""Implicit vertical advection (Thomas solver) — the paper's Fig. 3 (right).

A sequential-vertical motif: a FORWARD elimination sweep followed by a
BACKWARD substitution sweep, with per-interval specialization at the domain
boundaries — exactly the pattern the paper uses to motivate
``computation(FORWARD/BACKWARD)`` + ``interval``.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.gtscript import Field, BACKWARD, FORWARD, PARALLEL, computation, interval
from repro_torch.core.stencil import build_retyped


def vadv_defs(
    a: Field[np.float64],
    b: Field[np.float64],
    c: Field[np.float64],
    d: Field[np.float64],
    out: Field[np.float64],
):
    """Solve the tridiagonal system (a, b, c)·out = d along each column."""
    with computation(FORWARD):
        with interval(0, 1):
            cp = c / b
            dp = d / b
        with interval(1, None):
            denom = b - a * cp[0, 0, -1]
            cp = c / denom
            dp = (d - a * dp[0, 0, -1]) / denom
    with computation(BACKWARD):
        with interval(-1, None):
            out = dp
        with interval(0, -1):
            out = dp - cp * out[0, 0, 1]


def vadv_system_defs(
    w: Field[np.float64],
    phi: Field[np.float64],
    a: Field[np.float64],
    b: Field[np.float64],
    c: Field[np.float64],
    d: Field[np.float64],
    *,
    dt: np.float64,
    dz: np.float64,
):
    """Assemble the implicit vertical-advection system for velocity ``w``
    acting on ``phi`` (Crank–Nicolson), producing tridiagonal coefficients.
    """
    with computation(PARALLEL), interval(1, -1):
        gcv = 0.25 * (w[0, 0, 1] + w[0, 0, 0]) * dt / dz
        gcv_m = 0.25 * (w[0, 0, 0] + w[0, 0, -1]) * dt / dz
        a = -gcv_m
        c = gcv
        b = 1.0 + gcv - gcv_m
        d = phi[0, 0, 0] - gcv * (phi[0, 0, 1] - phi[0, 0, 0]) + gcv_m * (phi[0, 0, 0] - phi[0, 0, -1])
    with computation(PARALLEL), interval(0, 1):
        gcv = 0.25 * (w[0, 0, 1] + w[0, 0, 0]) * dt / dz
        a = 0.0
        c = gcv
        b = 1.0 + gcv
        d = phi[0, 0, 0] - gcv * (phi[0, 0, 1] - phi[0, 0, 0])
    with computation(PARALLEL), interval(-1, None):
        gcv_m = 0.25 * (w[0, 0, 0] + w[0, 0, -1]) * dt / dz
        a = -gcv_m
        c = 0.0
        b = 1.0 - gcv_m
        d = phi[0, 0, 0] + gcv_m * (phi[0, 0, 0] - phi[0, 0, -1])


def vadv_boundary_defs(
    wcon: Field[np.float64],
    phi: Field[np.float64],
    flux_bot: Field[np.float64],
    flux_top: Field[np.float64],
    acc: Field[np.float64],
    res: Field[np.float64],
    *,
    weight: np.float64,
):
    """Boundary-specialized vertical sweep pair — the interval-splitting
    motif: both sweeps seed/close at a domain boundary with carry-free
    bodies (and boundary-only flux outputs), so ``interval_splitting`` peels
    them into vectorized PARALLEL blocks and the interior ``fori_loop``
    stops carrying the boundary fluxes.  The PARALLEL assembly deliberately
    spells the same product two ways (``phi * wcon`` / ``wcon * phi``) —
    the reassociation → CSE motif.
    """
    with computation(PARALLEL), interval(...):
        p = phi * wcon + phi
        q = wcon * phi + phi[1, 0, 0]
        src = 0.5 * (p + q)
    with computation(FORWARD):
        with interval(0, 1):
            flux_bot = 0.25 * (wcon[0, 0, 1] + wcon[0, 0, 0]) * src
            acc = src + flux_bot
        with interval(1, None):
            acc = src + weight * acc[0, 0, -1]
    with computation(BACKWARD):
        with interval(-1, None):
            flux_top = 0.25 * (wcon[0, 0, 0] + wcon[0, 0, -1]) * acc
            res = acc + flux_top
        with interval(0, -1):
            res = acc + weight * res[0, 0, 1]


@functools.lru_cache(maxsize=None)
def build_vadv(backend: str = "cuda", dtype: str = "float64", **opts):
    return build_retyped(vadv_defs, backend, dtype, **opts)


@functools.lru_cache(maxsize=None)
def build_vadv_boundary(backend: str = "cuda", dtype: str = "float64", **opts):
    return build_retyped(vadv_boundary_defs, backend, dtype, **opts)


@functools.lru_cache(maxsize=None)
def build_vadv_system(backend: str = "cuda", dtype: str = "float64", **opts):
    return build_retyped(vadv_system_defs, backend, dtype, **opts)
