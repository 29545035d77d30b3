"""Stencil application library, written in the GTScript DSL.

The paper's two evaluation motifs (horizontal diffusion with flux limiter,
implicit vertical advection), the column integrals, the forecast step and
the climate step (each also as a ``@program``), and a library of reusable
operators.
"""

from . import climate, forecast, hdiff, library, vadv, vintg
from .hdiff import build_hdiff, hdiff_defs
from .library import (
    avg_x,
    avg_y,
    fwd_avg_z,
    gradx,
    grady,
    laplacian,
)
from .vadv import build_vadv, vadv_defs

__all__ = [
    "library",
    "climate",
    "forecast",
    "hdiff",
    "vadv",
    "vintg",
    "laplacian",
    "gradx",
    "grady",
    "avg_x",
    "avg_y",
    "fwd_avg_z",
    "build_hdiff",
    "build_vadv",
    "hdiff_defs",
    "vadv_defs",
]
