# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""The forecast step's three stencils: upwind advection, Euler update and
diffusive smoothing (the reference's ``stencils/forecast.py`` definitions).

The reference wires them into a rotation-closed ``@program``
(``build_forecast_step``); programs are not ported yet, so the port keeps
the definitions, which the eager climate step composes.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.gtscript import PARALLEL, Field, computation, interval

from .library import laplacian

HALO = 1


def advect_defs(
    phi: Field[np.float64],
    u: Field[np.float64],
    v: Field[np.float64],
    adv: Field[np.float64],
    *,
    dx: np.float64,
    dy: np.float64,
):
    with computation(PARALLEL), interval(...):
        fx = (phi[0, 0, 0] - phi[-1, 0, 0]) / dx if u > 0.0 else (phi[1, 0, 0] - phi[0, 0, 0]) / dx
        fy = (phi[0, 0, 0] - phi[0, -1, 0]) / dy if v > 0.0 else (phi[0, 1, 0] - phi[0, 0, 0]) / dy
        adv = -(u * fx + v * fy)


def euler_defs(phi: Field[np.float64], adv: Field[np.float64], out: Field[np.float64], *, dt: np.float64):
    with computation(PARALLEL), interval(...):
        out = phi + dt * adv


def diffuse_defs(phi: Field[np.float64], out: Field[np.float64], *, alpha: np.float64):
    with computation(PARALLEL), interval(...):
        out = phi + alpha * laplacian(phi)
