# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""A compact forecast step for the serving path: upwind advection + Euler
update + diffusive smoothing, wired into one rotation-closed ``@program``
(the reference's ``stencils/forecast.py``).

``build_forecast_step`` is the program the forecast server registers: its
output binding rotates ``phi``/``phi_new``, so ``iterate(n)`` runs n steps
and an :class:`~repro_torch.ensemble.Ensemble` batches concurrent requests
over the member axis.  The three definitions also make the eager climate
step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import gtscript, storage
from repro_torch.core.gtscript import PARALLEL, Field, computation, interval
from repro_torch.core.storage import Storage
from repro_torch.program import program

from .library import laplacian

HALO = 1
FIELD_NAMES = ("phi", "u", "v", "adv", "phi_star", "phi_new")
REQUEST_FIELDS = ("phi",)
DEFAULT_SCALARS: Dict[str, float] = {"dx": 1.0, "dy": 1.0, "dt": 0.1, "alpha": 0.05}


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


def build_forecast_step(backend: str, domain: Tuple[int, int, int], *, name: str = "forecast_step", **opts):
    """The three-stencil step as a rotation-closed ``@program`` object.
    ``opts`` (e.g. ``autotune=True``) go to the three stencils and to the
    program, whose fused groups are stencils of their own."""
    build = gtscript.stencil(backend=backend, **opts)
    advect, euler, diffuse = build(advect_defs), build(euler_defs), build(diffuse_defs)
    dom = tuple(int(d) for d in domain)

    @program(backend=backend, name=name, **opts)
    def forecast_step(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
        advect(phi, u, v, adv, dx=dx, dy=dy, domain=dom)
        euler(phi, adv, phi_star, dt=dt, domain=dom)
        diffuse(phi_star, phi_new, alpha=alpha, domain=dom)
        return {"phi": phi_new, "phi_new": phi}

    return forecast_step


def make_forecast_fields(
    backend: str, domain: Tuple[int, int, int], *, seed: int = 0, device=None
) -> Tuple[Dict[str, Storage], Dict[str, float]]:
    """Template fields (gaussian tracer blob + steady winds + workspace) and
    default scalars, shaped ``domain + 2·HALO`` horizontally.  The tracer's
    noise comes from numpy's generator, so the reference and the port make
    the same fields from one seed; torch-backed fields go on ``device`` (the
    card unless named)."""
    ni, nj, nk = (int(d) for d in domain)
    shape = (ni + 2 * HALO, nj + 2 * HALO, nk)
    x = np.linspace(-1.0, 1.0, shape[0])[:, None, None]
    y = np.linspace(-1.0, 1.0, shape[1])[None, :, None]
    z = np.linspace(0.0, 1.0, shape[2])[None, None, :]
    rng = np.random.default_rng(seed)
    blob = np.exp(-8.0 * (x**2 + y**2)) * (1.0 + 0.1 * z)
    phi = blob + 1e-3 * rng.normal(size=shape)
    kw = {} if backend in ("debug", "numpy") else {"device": device}

    def mk(a):
        return storage.from_array(np.ascontiguousarray(a), backend=backend, default_origin=(HALO, HALO, 0), **kw)

    fields = {
        "phi": mk(phi),
        "u": mk(np.full(shape, 0.8)),
        "v": mk(np.full(shape, -0.4)),
        "adv": mk(np.zeros(shape)),
        "phi_star": mk(np.zeros(shape)),
        "phi_new": mk(np.zeros(shape)),
    }
    return fields, dict(DEFAULT_SCALARS)


def request_state(domain: Tuple[int, int, int], *, seed: int) -> np.ndarray:
    """A per-request initial ``phi`` (perturbed blob) shaped like the template
    — what a serving client ships in its ``forecast`` message."""
    fields, _ = make_forecast_fields("numpy", domain, seed=seed)
    return np.asarray(fields["phi"].data).copy()
