# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""Reusable GTScript functions (inlined at compile time, paper Fig. 1 line 3)."""

from __future__ import annotations

from repro_torch.core import gtscript


@gtscript.function
def laplacian(phi):
    """5-point horizontal Laplacian."""
    return -4.0 * phi[0, 0, 0] + (phi[-1, 0, 0] + phi[1, 0, 0] + phi[0, -1, 0] + phi[0, 1, 0])


@gtscript.function
def gradx(phi):
    """Forward difference along I."""
    return phi[1, 0, 0] - phi[0, 0, 0]


@gtscript.function
def grady(phi):
    """Forward difference along J."""
    return phi[0, 1, 0] - phi[0, 0, 0]


@gtscript.function
def gradx_c(phi):
    """Centered difference along I."""
    return 0.5 * (phi[1, 0, 0] - phi[-1, 0, 0])


@gtscript.function
def grady_c(phi):
    """Centered difference along J."""
    return 0.5 * (phi[0, 1, 0] - phi[0, -1, 0])


@gtscript.function
def avg_x(phi):
    return 0.5 * (phi[1, 0, 0] + phi[0, 0, 0])


@gtscript.function
def avg_y(phi):
    return 0.5 * (phi[0, 1, 0] + phi[0, 0, 0])


@gtscript.function
def fwd_avg_z(phi):
    return 0.5 * (phi[0, 0, 1] + phi[0, 0, 0])


@gtscript.function
def upwind_flux_x(phi, vel):
    """First-order upwind flux along I."""
    return vel * (phi[0, 0, 0] if vel > 0.0 else phi[1, 0, 0])


@gtscript.function
def upwind_flux_y(phi, vel):
    return vel * (phi[0, 0, 0] if vel > 0.0 else phi[0, 1, 0])


@gtscript.function
def smagorinsky_factor(u, v):
    """Deformation-based Smagorinsky diffusion factor (squared strain)."""
    du_dx = 0.5 * (u[1, 0, 0] - u[-1, 0, 0])
    dv_dy = 0.5 * (v[0, 1, 0] - v[0, -1, 0])
    du_dy = 0.5 * (u[0, 1, 0] - u[0, -1, 0])
    dv_dx = 0.5 * (v[1, 0, 0] - v[-1, 0, 0])
    shear = du_dy + dv_dx
    stretch = du_dx - dv_dy
    return sqrt(stretch * stretch + shear * shear)  # noqa: F821  (gtscript native)
