"""The card layout of the port's ``cuda`` storages, on the CPU.

``storage`` lays ``cuda`` fields out for the card: logical shape and
indexing (I, J, K) as the reference, physical order K slowest, then I, then
J with stride 1 (member-batched fields keep N outermost); the other backends
keep C order.  The ``cuda`` backend's stencils and kernel entry points give
the reference ``numpy`` backend's answers on fields in either layout (on CPU
tensors they run the plain torch module; ``test_torch_gpu.py`` launches the
kernels on both layouts on a card).
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import gtscript as r_gtscript
from repro.kernels.hdiff.ops import hdiff as r_hdiff_op
from repro.kernels.vadv.ops import vadv as r_vadv_op
from repro.stencils import forecast as r_forecast
from repro.stencils import hdiff as r_hdiff
from repro.stencils import vadv as r_vadv
from repro_torch.core import gtscript, storage
from repro_torch.kernels.hdiff.ops import hdiff
from repro_torch.kernels.vadv.ops import vadv
from repro_torch.stencils import forecast as t_forecast
from repro_torch.stencils import hdiff as t_hdiff
from repro_torch.stencils import vadv as t_vadv

RTOL = 1e-12  # the bound the reference uses between its backends
NI, NJ, NK = 6, 7, 5


def _card_strides(ni, nj, nk):
    return (nj, 1, ni * nj)


@pytest.mark.parametrize("alloc", ["zeros", "ones", "empty", "from_array", "storage_for_domain"])
def test_cuda_storage_has_the_card_layout(alloc):
    if alloc == "from_array":
        s = storage.from_array(np.zeros((NI, NJ, NK)), backend="cuda", device="cpu")
    elif alloc == "storage_for_domain":
        s = storage.storage_for_domain((NI - 4, NJ - 4, NK), (2, 2, 0), backend="cuda", device="cpu")
    else:
        s = getattr(storage, alloc)((NI, NJ, NK), backend="cuda", device="cpu")
    assert s.shape == (NI, NJ, NK)
    assert s.data.stride() == _card_strides(NI, NJ, NK)
    assert storage.is_card_layout(s.data) and not s.data.is_contiguous()


@pytest.mark.parametrize("backend", ["torch", "numpy", "debug"])
def test_other_backends_keep_c_order(backend):
    device = "cpu" if backend == "torch" else None
    for s in (storage.zeros((NI, NJ, NK), backend=backend, device=device),
              storage.from_array(np.ones((NI, NJ, NK)), backend=backend, device=device)):
        if backend == "torch":
            assert s.data.is_contiguous() and not storage.is_card_layout(s.data)
        else:
            assert s.data.flags["C_CONTIGUOUS"]


def test_member_batched_fields_keep_n_outermost():
    s = storage.storage_for_domain((NI, NJ, NK), (0, 0, 0), backend="cuda", members=3, device="cpu")
    assert s.shape == (3, NI, NJ, NK) and s.axes == ("N", "I", "J", "K")
    assert s.data.stride() == (NK * NI * NJ, NJ, 1, NI * NJ)
    m = s.member(1)
    assert m.data.stride() == _card_strides(NI, NJ, NK) and storage.is_card_layout(m.data)
    m[2, 3, 4] = 7.0  # a view: writes reach the batched storage
    assert s.to_numpy()[1, 2, 3, 4] == 7.0
    # (I, J) and K fields are the same in both orders
    assert storage.zeros((NI, NJ), backend="cuda", device="cpu").data.is_contiguous()
    assert storage.zeros((NK,), backend="cuda", device="cpu", axes=("K",)).data.is_contiguous()


@pytest.mark.parametrize("axes,shape", [(("I", "J", "K"), (NI, NJ, NK)), (("N", "I", "J", "K"), (2, NI, NJ, NK))])
def test_round_trip_through_from_array_and_to_numpy(axes, shape):
    arr = np.random.default_rng(4).normal(size=shape)
    s = storage.from_array(arr, backend="cuda", device="cpu", axes=axes, default_origin=(0,) * len(shape))
    assert storage.is_card_layout(s.data)
    back = s.to_numpy()
    np.testing.assert_array_equal(back, arr)
    assert back.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(np.asarray(s), arr)
    # a storage made from a card-layout tensor holds the same logical array
    np.testing.assert_array_equal(storage.from_array(s.data, backend="cuda", device="cpu").to_numpy(), arr)


# (name, the reference's build on the numpy backend, the port's build on the cuda backend)
STENCILS = {
    "hdiff": (lambda: r_hdiff.build_hdiff("numpy"), lambda: t_hdiff.build_hdiff("cuda")),
    "vadv": (lambda: r_vadv.build_vadv("numpy"), lambda: t_vadv.build_vadv("cuda")),
    "climate.advect": (lambda: r_gtscript.stencil("numpy")(r_forecast.advect_defs),
                       lambda: gtscript.stencil("cuda")(t_forecast.advect_defs)),
    "climate.euler": (lambda: r_gtscript.stencil("numpy")(r_forecast.euler_defs),
                      lambda: gtscript.stencil("cuda")(t_forecast.euler_defs)),
    "climate.diffuse": (lambda: r_gtscript.stencil("numpy")(r_forecast.diffuse_defs),
                        lambda: gtscript.stencil("cuda")(t_forecast.diffuse_defs)),
    "climate.vadv_system": (lambda: r_gtscript.stencil("numpy")(r_vadv.vadv_system_defs),
                            lambda: gtscript.stencil("cuda")(t_vadv.vadv_system_defs)),
    "climate.vadv": (lambda: r_gtscript.stencil("numpy")(r_vadv.vadv_defs),
                     lambda: gtscript.stencil("cuda")(t_vadv.vadv_defs)),
}
SCALARS = {"alpha": 0.05, "dt": 0.1, "dz": 0.7, "dx": 1.1, "dy": 0.9}


@pytest.mark.parametrize("layout", ["card", "c_order"])
@pytest.mark.parametrize("name", sorted(STENCILS))
def test_cuda_stencils_match_the_reference_in_both_layouts(name, layout):
    r_st, t_st = (build() for build in STENCILS[name])
    h, domain = 3, (9, 11, 6)
    rng = np.random.default_rng(len(name))
    shape = (domain[0] + 2 * h, domain[1] + 2 * h, domain[2])
    data = {n: rng.normal(size=shape) for n in t_st.field_info}
    if "b" in data:
        data["b"] = np.abs(data["b"]) + 2.0
    scalars = {s.name: SCALARS[s.name] for s in t_st.implementation_ir.scalars}
    ref = {n: a.copy() for n, a in data.items()}
    r_st(**ref, **scalars, domain=domain, origin=(h, h, 0))
    if layout == "card":
        port = {n: storage.from_array(a, backend="cuda", device="cpu").data for n, a in data.items()}
        assert all(storage.is_card_layout(t) for t in port.values())
    else:
        port = {n: torch.from_numpy(a.copy()) for n, a in data.items()}
    t_st(**port, **scalars, domain=domain, origin=(h, h, 0))
    assert t_st.launches == 0  # CPU tensors: the plain module ran
    for n in t_st.implementation_ir.written_api_fields():
        np.testing.assert_allclose(port[n].numpy(), ref[n], rtol=RTOL, atol=RTOL, err_msg=n)
        assert storage.is_card_layout(port[n]) == (layout == "card")  # written in place


@pytest.mark.parametrize("layout", ["card", "c_order"])
def test_kernel_entry_points_match_the_reference_kernels_in_both_layouts(layout):
    def put(a):
        return storage.card_tensor(a.shape, torch.float64, "cpu").copy_(torch.from_numpy(a)) \
            if layout == "card" else torch.from_numpy(a.copy())

    rng = np.random.default_rng(12)
    x = rng.normal(size=(13 + 6, 10 + 6, 5))
    got = hdiff(put(x), 0.05)
    assert storage.is_card_layout(got)  # the output is in the card layout whatever the input's
    np.testing.assert_allclose(got.numpy(), np.asarray(r_hdiff_op(jnp.asarray(x), 0.05, block=(4, 8))), atol=1e-12)
    shape = (7, 9, 6)
    a, c, d = (rng.normal(size=shape) * s for s in (0.1, 0.1, 1.0))
    b = 2.0 + rng.random(shape)
    got = vadv(*(put(v) for v in (a, b, c, d)))
    assert storage.is_card_layout(got)
    ref = np.asarray(r_vadv_op(*(jnp.asarray(v) for v in (a, b, c, d)), block=(4, 8)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-10)
