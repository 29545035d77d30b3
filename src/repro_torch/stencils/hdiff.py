# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""Horizontal diffusion with flux limiter — the paper's Fig. 1 / Fig. 3 (left).

A multi-stage PARALLEL stencil: laplacian-of-laplacian, limited fluxes, and
the field update — the classic COSMO hdiff motif.  All eight intermediate
stages are temporaries; on the cuda backend the whole pipeline fuses into
one kernel whose temporaries stay in shared memory (halo 3).
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.gtscript import Field, PARALLEL, computation, interval
from repro_torch.core.stencil import build_retyped

from .library import gradx, grady, laplacian, smagorinsky_factor

DEFAULT_LIM = 0.01


def hdiff_defs(in_phi: Field[np.float64], out_phi: Field[np.float64], *, alpha: np.float64):
    from __externals__ import LIM

    with computation(PARALLEL), interval(...):
        # laplacian-of-laplacian
        lap = laplacian(in_phi)
        bilap = laplacian(lap)
        # x- and y-fluxes of the biharmonic term
        flux_x = gradx(bilap)
        flux_y = grady(bilap)
        # gradient of the input field
        grad_x = gradx(in_phi)
        grad_y = grady(in_phi)
        # simple flux limiter
        fx = flux_x if flux_x * grad_x > LIM else LIM
        fy = flux_y if flux_y * grad_y > LIM else LIM
        # update
        out_phi = in_phi + alpha * (gradx(fx[-1, 0, 0]) + grady(fy[0, -1, 0]))


HALO = 3  # compile-time known read extent of in_phi


def hdiff_smag_defs(
    u: Field[np.float64],
    v: Field[np.float64],
    out_u: Field[np.float64],
    out_v: Field[np.float64],
    *,
    dt: np.float64,
):
    """Horizontal diffusion with a Smagorinsky coefficient (COSMO motif).

    The deformation factor inlines with its ``stretch`` / ``shear`` chains
    each appearing twice (``stretch * stretch + shear * shear``) — the
    repeated-subexpression shape the ``cross_stage_cse`` pass eliminates.
    """
    from __externals__ import CS

    with computation(PARALLEL), interval(...):
        smag = CS * smagorinsky_factor(u, v)
        lap_u = laplacian(u)
        lap_v = laplacian(v)
        out_u = u + dt * smag * lap_u
        out_v = v + dt * smag * lap_v


DEFAULT_CS = 0.15


@functools.lru_cache(maxsize=None)
def build_hdiff(backend: str = "cuda", lim: float = DEFAULT_LIM, dtype: str = "float64", **opts):
    return build_retyped(hdiff_defs, backend, dtype, externals={"LIM": lim}, **opts)


@functools.lru_cache(maxsize=None)
def build_hdiff_smag(backend: str = "cuda", cs: float = DEFAULT_CS, dtype: str = "float64", **opts):
    return build_retyped(hdiff_smag_defs, backend, dtype, externals={"CS": cs}, **opts)
