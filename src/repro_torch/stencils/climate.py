"""The miniature climate step of ``examples/climate_model.py``, on the port:
upwind advection → Euler update → horizontal diffusion → implicit vertical
transport (``vadv_system``) → Thomas solve (``vadv``), with a ``phi`` /
``phi_new`` double-buffer rotation.

``eager_step`` calls the five stencils one after the other;
``build_program`` traces the same calls into a ``@program``, which the
``cuda`` backend fuses into two generated kernels, ``[advect, euler]`` and
``[diffuse, vadv_system, vadv]`` (diffuse reads ``phi_star`` at horizontal
offsets, which the first group writes).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core import gtscript
from repro_torch.program import program

from . import forecast, vadv

HALO = 3
FIELD_NAMES = ("phi", "u", "v", "w", "adv", "phi_star", "phi_h", "a", "b", "c", "d", "phi_new")
DEFAULT_SCALARS: Dict[str, float] = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 1.0, "alpha": 0.05}
DEFINITIONS = {
    "advect": forecast.advect_defs,
    "euler": forecast.euler_defs,
    "diffuse": forecast.diffuse_defs,
    "vadv_system": vadv.vadv_system_defs,
    "vadv": vadv.vadv_defs,
}


def build_stencils(backend: str, **opts) -> Dict[str, Any]:
    """The five stencils of the step, by name."""
    build = gtscript.stencil(backend=backend, **opts)
    return {n: build(d) for n, d in DEFINITIONS.items()}


def eager_step(st: Dict[str, Any], f: Dict[str, Any], domain: Tuple[int, int, int], scalars: Dict[str, float]) -> None:
    """One step, one stencil call after the other, on the field dict ``f``
    (rotated in place: ``phi`` and ``phi_new`` swap)."""
    st["advect"](f["phi"], f["u"], f["v"], f["adv"], dx=scalars["dx"], dy=scalars["dy"], domain=domain)
    st["euler"](f["phi"], f["adv"], f["phi_star"], dt=scalars["dt"], domain=domain)
    st["diffuse"](f["phi_star"], f["phi_h"], alpha=scalars["alpha"], domain=domain)
    st["vadv_system"](f["w"], f["phi_h"], f["a"], f["b"], f["c"], f["d"],
                      dt=scalars["dt"], dz=scalars["dz"], domain=domain)
    st["vadv"](f["a"], f["b"], f["c"], f["d"], f["phi_new"], domain=domain)
    f["phi"], f["phi_new"] = f["phi_new"], f["phi"]


def build_program(backend: str, domain: Tuple[int, int, int], *, stencils: Optional[Dict[str, Any]] = None,
                  name: str = "climate_step", **backend_opts):
    """The step as a rotation-closed ``@program`` over ``stencils`` (built
    for ``backend`` unless given)."""
    st = stencils if stencils is not None else build_stencils(backend)
    dom = tuple(int(d) for d in domain)

    @program(backend=backend, name=name, **backend_opts)
    def climate_step(phi, u, v, w, adv, phi_star, phi_h, a, b, c, d, phi_new, *, dt, dx, dy, dz, alpha):
        st["advect"](phi, u, v, adv, dx=dx, dy=dy, domain=dom)
        st["euler"](phi, adv, phi_star, dt=dt, domain=dom)
        st["diffuse"](phi_star, phi_h, alpha=alpha, domain=dom)
        st["vadv_system"](w, phi_h, a, b, c, d, dt=dt, dz=dz, domain=dom)
        st["vadv"](a, b, c, d, phi_new, domain=dom)
        return {"phi": phi_new, "phi_new": phi}

    return climate_step
