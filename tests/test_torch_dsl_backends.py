"""The port's backends against the reference's oracle: the mirror of the
tests of ``tests/test_dsl_backends.py`` that ``test_torch_backends.py``
does not already hold.

The reference runs its ``numpy``, ``jax`` and ``pallas`` (``block=(4, 4)``)
backends against its ``debug`` oracle within 1e-13; here the port's
``debug``, ``numpy``, ``torch`` and ``cuda`` (its plain module on CPU
tensors, at the same block) run against the reference's ``debug`` backend at
``opt_level=0`` on the same NumPy inputs.  The argument checks, domain
deduction and ``exec_info`` timings are ``core/stencil.py``'s.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

import torch_stencil_cases as cases
from repro_torch.core import gtscript, storage
from repro_torch.core.gtscript import PARALLEL, Field, computation, interval
from repro_torch.stencils.hdiff import hdiff_defs
from repro_torch.stencils.vadv import vadv_defs, vadv_system_defs
from torch_mirror import run_case, run_differential

# the reference's run_all_backends: each backend at its default opt level
BACKENDS = (
    ("debug", "debug", {}),
    ("numpy", "numpy", {}),
    ("torch", "torch", {}),
    ("cuda", "cuda", {"block": cases.BLOCK}),
)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def test_hdiff_all_backends():
    NI, NJ, NK, H = 11, 13, 5, 3
    x = _rand((NI + 2 * H, NJ + 2 * H, NK))
    run_differential(hdiff_defs, {"in_phi": (x, (H, H, 0)), "out_phi": (np.zeros_like(x), (H, H, 0))},
                     {"alpha": np.float64(0.07)}, (NI, NJ, NK), externals={"LIM": 0.01}, variants=BACKENDS)


def test_vadv_all_backends_and_oracle():
    NI, NJ, NK = 6, 7, 11
    rng = np.random.default_rng(3)
    a = rng.normal(size=(NI, NJ, NK)) * 0.1
    b = 2.0 + rng.random((NI, NJ, NK))
    c = rng.normal(size=(NI, NJ, NK)) * 0.1
    d = rng.normal(size=(NI, NJ, NK))
    results = run_differential(
        vadv_defs,
        {"a": (a, (0, 0, 0)), "b": (b, (0, 0, 0)), "c": (c, (0, 0, 0)), "d": (d, (0, 0, 0)),
         "out": (np.zeros_like(d), (0, 0, 0))},
        {}, (NI, NJ, NK), variants=BACKENDS,
    )
    # the dense solve
    out = results["torch"]["out"]
    for i in range(0, NI, 3):
        for j in range(0, NJ, 3):
            M = np.diag(b[i, j])
            for k in range(1, NK):
                M[k, k - 1] = a[i, j, k]
            for k in range(NK - 1):
                M[k, k + 1] = c[i, j, k]
            np.testing.assert_allclose(M @ out[i, j], d[i, j], atol=1e-10)


def test_vadv_system_assembly():
    NI, NJ, NK = 5, 4, 8
    rng = np.random.default_rng(1)
    w = rng.normal(size=(NI, NJ, NK))
    phi = rng.normal(size=(NI, NJ, NK))
    zeros = {n: (np.zeros((NI, NJ, NK)), (0, 0, 0)) for n in "abcd"}
    results = run_differential(vadv_system_defs, {"w": (w, (0, 0, 0)), "phi": (phi, (0, 0, 0)), **zeros},
                               {"dt": np.float64(0.5), "dz": np.float64(1.5)}, (NI, NJ, NK), variants=BACKENDS)
    # boundary specialization happened
    assert np.all(results["cuda"]["a"][:, :, 0] == 0.0)
    assert np.all(results["cuda"]["c"][:, :, -1] == 0.0)


def test_conditional_with_else_and_nesting():
    case = cases.BY_NAME["nested_conditional"]
    results = run_case(case, BACKENDS)
    x = case.arrays()["a"][0]
    np.testing.assert_allclose(results["torch"]["o"], np.where(x > 0.3, np.where(x > 0.6, x * 4.0, x * 2.0), -x))


def test_ij_and_k_fields():
    case = cases.BY_NAME["ij_k_fields"]
    results = run_case(case, BACKENDS)
    arrays = case.arrays()
    a, sfc, prof = arrays["a"][0], arrays["sfc"][0], arrays["prof"][0]
    np.testing.assert_allclose(results["cuda"]["o"], a * prof[None, None, :] + sfc[:, :, None])


def test_forward_accumulation_with_interval_specialization():
    case = cases.BY_NAME["column_sum"]
    results = run_case(case, BACKENDS)
    np.testing.assert_allclose(results["torch"]["colsum"], np.cumsum(case.arrays()["rho"][0], axis=2))


def test_swap_numerics():
    case = cases.BY_NAME["swap"]
    results = run_case(case, BACKENDS)
    np.testing.assert_allclose(results["cuda"]["o"], case.arrays()["a"][0])


def test_native_functions():
    case = cases.BY_NAME["natives"]
    results = run_case(case, BACKENDS)
    x = case.arrays()["a"][0]
    np.testing.assert_allclose(results["torch"]["o"],
                               np.minimum(np.maximum(np.sqrt(np.abs(x)), 0.1), np.exp(x) + np.tanh(x)))


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_validate_args_errors(backend):
    from repro_torch.stencils.hdiff import build_hdiff

    hd = build_hdiff(backend)
    dev = None if backend == "numpy" else "cpu"
    NI = NJ = 8
    NK = 4
    ok_in = storage.from_array(_rand((NI + 6, NJ + 6, NK)), backend=backend, default_origin=(3, 3, 0), device=dev)
    ok_out = storage.zeros((NI + 6, NJ + 6, NK), backend=backend, default_origin=(3, 3, 0), device=dev)

    # halo too small
    bad_in = storage.from_array(_rand((NI + 2, NJ + 2, NK)), backend=backend, default_origin=(1, 1, 0), device=dev)
    with pytest.raises(ValueError, match="halo"):
        hd(bad_in, ok_out, alpha=np.float64(0.1), domain=(NI, NJ, NK))

    # wrong dtype
    bad_dtype = storage.from_array(_rand((NI + 6, NJ + 6, NK)).astype(np.float32), backend=backend,
                                   default_origin=(3, 3, 0), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        hd(bad_dtype, ok_out, alpha=np.float64(0.1), domain=(NI, NJ, NK))

    # missing scalar
    with pytest.raises(TypeError, match="missing scalar"):
        hd(ok_in, ok_out, domain=(NI, NJ, NK))


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_domain_deduction_from_smallest_field(backend):
    def defs(a: Field[np.float64], o: Field[np.float64]):
        with computation(PARALLEL), interval(...):
            o = a[1, 0, 0] - a[-1, 0, 0]

    dev = None if backend == "numpy" else "cpu"
    a = storage.from_array(_rand((12, 10, 4)), backend=backend, default_origin=(1, 0, 0), device=dev)
    o = storage.zeros((10, 10, 4), backend=backend, default_origin=(0, 0, 0), device=dev)
    st = gtscript.stencil(backend=backend)(defs)
    st(a, o)  # deduced domain = (10, 10, 4)
    x = a.to_numpy()
    np.testing.assert_allclose(o.to_numpy(), x[2:, :, :] - x[:-2, :, :])


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_exec_info_timings(backend):
    from repro_torch.stencils.hdiff import build_hdiff

    hd = build_hdiff(backend)
    H = 3
    dev = None if backend == "numpy" else "cpu"
    i = storage.from_array(_rand((14, 14, 3)), backend=backend, default_origin=(H, H, 0), device=dev)
    o = storage.zeros((14, 14, 3), backend=backend, default_origin=(H, H, 0), device=dev)
    info = {}
    hd(i, o, alpha=np.float64(0.1), exec_info=info)
    assert info["call_start_time"] <= info["run_start_time"] <= info["run_end_time"]
