"""Stencil application library, written in the GTScript DSL.

The paper's two evaluation motifs (horizontal diffusion with flux limiter,
implicit vertical advection), the column integrals, the forecast step's
stencils, and a library of reusable operators.  Nothing here needs the
``@program`` layer, which is not ported yet.
"""

from . import forecast, hdiff, library, vadv, vintg
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
