"""The port's generated kernels on a CUDA card, against their plain versions.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.kernels.hdiff.ops import hdiff  # noqa: E402
from repro_torch.kernels.hdiff.ref import hdiff_ref  # noqa: E402
from repro_torch.kernels.vadv.ops import vadv  # noqa: E402
from repro_torch.kernels.vadv.ref import vadv_ref  # noqa: E402
from repro_torch.stencils import hdiff as t_hdiff  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    return torch.device("cuda")


def _tridiagonal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.1, 2.0 + rng.random(shape), rng.normal(size=shape) * 0.1,
            rng.normal(size=shape))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_kernels_match_plain_on_the_card(card, dtype, tol):
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(43, 59, 17))).to(card, tdt)
    st = t_hdiff.build_hdiff("cuda", lim=-1e30, dtype=dtype)
    plain = t_hdiff.build_hdiff("torch", lim=-1e30, dtype=dtype)
    outs = []
    for s in (st, plain):
        out = x.clone()
        s(x, out, alpha=0.05, origin=(3, 3, 0))
        outs.append(out)
    assert st.launches >= 1 and plain.launches == 0
    torch.testing.assert_close(outs[0], outs[1], rtol=tol, atol=tol)
    torch.testing.assert_close(hdiff(x, 0.05), hdiff_ref(x, 0.05), rtol=tol, atol=tol)
    a, b, c, d = (torch.from_numpy(v).to(card, tdt) for v in _tridiagonal((37, 53, 17), 1))
    torch.testing.assert_close(vadv(a, b, c, d), vadv_ref(a, b, c, d), rtol=tol, atol=tol)


def test_kernel_wrapper_refuses_out_of_bounds_fields(card):
    x = torch.zeros(43, 59, 17, dtype=torch.float64, device=card)
    st = t_hdiff.build_hdiff("cuda")
    with pytest.raises(ValueError, match="touches"):
        st(x[:-1], x.clone(), alpha=0.05, origin=(3, 3, 0), domain=(37, 53, 17), validate_args=False)
