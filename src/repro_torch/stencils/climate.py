"""The miniature climate step of ``examples/climate_model.py``, on the port:
upwind advection → Euler update → horizontal diffusion → implicit vertical
transport (``vadv_system``) → Thomas solve (``vadv``), with a ``phi`` /
``phi_new`` double-buffer rotation.

``eager_step`` calls the five stencils one after the other (on a device mesh:
``distributed_eager_step``, one ``DistributedStencil`` a stencil);
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


# the step's stencil calls in order: (stencil, the fields it takes, in its
# parameter order, and its scalars)
CALLS = (
    ("advect", ("phi", "u", "v", "adv"), ("dx", "dy")),
    ("euler", ("phi", "adv", "phi_star"), ("dt",)),
    ("diffuse", ("phi_star", "phi_h"), ("alpha",)),
    ("vadv_system", ("w", "phi_h", "a", "b", "c", "d"), ("dt", "dz")),
    ("vadv", ("a", "b", "c", "d", "phi_new"), ()),
)


def eager_step(st: Dict[str, Any], f: Dict[str, Any], domain: Tuple[int, int, int], scalars: Dict[str, float]) -> None:
    """One step, one stencil call after the other, on the field dict ``f``
    (rotated in place: ``phi`` and ``phi_new`` swap)."""
    for name, fields, scals in CALLS:
        st[name](*(f[b] for b in fields), **{s: scalars[s] for s in scals}, domain=domain)
    f["phi"], f["phi_new"] = f["phi_new"], f["phi"]


def distributed_eager_step(dst: Dict[str, Any], f: Dict[str, Any], scalars: Dict[str, float]) -> None:
    """One step on this rank's local blocks ``f``, one
    ``stencils.distributed.DistributedStencil`` (``dst``, by stencil name)
    call after the other, each exchanging every field it takes; the written
    fields are rebound to the returned blocks, then ``phi`` and ``phi_new``
    swap."""
    for name, fields, scals in CALLS:
        params = list(dst[name].stencil.field_info)
        written = dst[name](dict(zip(params, (f[b] for b in fields))), {s: scalars[s] for s in scals})
        for p, block in written.items():
            f[fields[params.index(p)]] = block
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
