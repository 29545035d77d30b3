"""The port's first slice end to end on the CPU: the eager climate step.

advect → euler → diffuse → vadv_system → vadv, the per-stencil sequence of
``examples/climate_model.py:run_eager`` built from the port's own
definitions, on ``storage`` fields: the port's ``cuda`` backend on CPU
tensors (so through the plain torch modules) against the reference ``numpy``
backend on the same state, which crosses from the reference into the port
through ``to_numpy()`` and ``default_origin``.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

from repro.core import gtscript as r_gtscript
from repro.core import storage as r_storage
from repro.stencils import forecast as r_forecast
from repro.stencils import vadv as r_vadv
from repro_torch.core import gtscript, storage
from repro_torch.stencils import forecast, vadv

H = 3
DOMAIN = (12, 10, 8)
NAMES = ("phi", "u", "v", "w", "adv", "phi_star", "phi_h", "a", "b", "c", "d", "phi_new")
SCALARS = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 1.0, "alpha": 0.05}


def _stencils(stencil, mod_forecast, mod_vadv, backend):
    build = stencil(backend=backend)
    return {
        "advect": build(mod_forecast.advect_defs),
        "euler": build(mod_forecast.euler_defs),
        "diffuse": build(mod_forecast.diffuse_defs),
        "vadv_system": build(mod_vadv.vadv_system_defs),
        "vadv": build(mod_vadv.vadv_defs),
    }


def _step(st, f, domain):
    st["advect"](f["phi"], f["u"], f["v"], f["adv"], dx=SCALARS["dx"], dy=SCALARS["dy"], domain=domain)
    st["euler"](f["phi"], f["adv"], f["phi_star"], dt=SCALARS["dt"], domain=domain)
    st["diffuse"](f["phi_star"], f["phi_h"], alpha=SCALARS["alpha"], domain=domain)
    st["vadv_system"](f["w"], f["phi_h"], f["a"], f["b"], f["c"], f["d"],
                      dt=SCALARS["dt"], dz=SCALARS["dz"], domain=domain)
    st["vadv"](f["a"], f["b"], f["c"], f["d"], f["phi_new"], domain=domain)
    f["phi"], f["phi_new"] = f["phi_new"], f["phi"]


def _reference_state(domain, seed=0):
    ni, nj, nk = domain
    shape = (ni + 2 * H, nj + 2 * H, nk)
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(-2, 2, shape[0]), np.linspace(-2, 2, shape[1]), indexing="ij")
    arrays = {n: np.zeros(shape) for n in NAMES}
    arrays["phi"] = np.exp(-(xx**2 + yy**2))[:, :, None] * (1.0 + 0.1 * rng.random((1, 1, nk)))
    arrays["u"] = np.full(shape, 0.8)
    arrays["v"] = np.full(shape, -0.4)
    arrays["w"] = 0.2 * rng.random(shape)
    return {n: r_storage.from_array(a.copy(), backend="numpy", default_origin=(H, H, 0)) for n, a in arrays.items()}


def _carry_to_port(ref_fields):
    """Reference fields → port fields: the state crosses as NumPy arrays."""
    return {
        n: storage.from_array(f.to_numpy(), backend="cuda", default_origin=f.default_origin, device="cpu")
        for n, f in ref_fields.items()
    }


@pytest.mark.parametrize("nsteps", [1, 3])
def test_climate_step_matches_reference(nsteps):
    ref = _reference_state(DOMAIN)
    port = _carry_to_port(ref)
    for n in NAMES:
        np.testing.assert_array_equal(port[n].to_numpy(), ref[n].to_numpy())
        assert port[n].default_origin == (H, H, 0) and port[n].backend == "cuda"
    ref_st = _stencils(r_gtscript.stencil, r_forecast, r_vadv, "numpy")
    port_st = _stencils(gtscript.stencil, forecast, vadv, "cuda")
    for _ in range(nsteps):
        _step(ref_st, ref, DOMAIN)
        _step(port_st, port, DOMAIN)
    for n in NAMES:
        np.testing.assert_allclose(port[n].to_numpy(), ref[n].to_numpy(), rtol=1e-12, atol=1e-12, err_msg=n)
    phi = port["phi"].to_numpy()
    assert np.isfinite(phi).all() and phi.shape == (DOMAIN[0] + 2 * H, DOMAIN[1] + 2 * H, DOMAIN[2])
    assert all(s.launches == 0 for s in port_st.values())  # CPU tensors: the plain modules ran


def test_state_round_trips_reference_to_port_to_numpy():
    ref = _reference_state((5, 4, 3), seed=3)
    port = _carry_to_port(ref)
    back = {n: r_storage.from_array(f.to_numpy(), backend="numpy", default_origin=f.default_origin)
            for n, f in port.items()}
    for n in NAMES:
        np.testing.assert_array_equal(back[n].to_numpy(), ref[n].to_numpy())
        assert back[n].default_origin == ref[n].default_origin
        assert np.asarray(port[n]).dtype == np.float64
