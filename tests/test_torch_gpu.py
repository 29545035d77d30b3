"""The port's kernels on a CUDA card, against their plain versions: the
generated stencil kernels, and the hand-written flash-attention and RG-LRU
kernels.  A failed build or launch fails the test.

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


# ---------------------------------------------------------------------------
# the hand-written LM kernels: flash attention and the RG-LRU scan
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402

_FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def _normal(shape, seed, device, dtype):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("b,s,h,kh,dh", [
    (1, 32, 4, 4, 32), (2, 64, 8, 2, 64), (1, 48, 6, 1, 128), (2, 16, 4, 2, 96),
    (1, 100, 4, 4, 16), (2, 130, 4, 1, 160), (1, 70, 2, 2, 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_the_card(card, b, s, h, kh, dh, dtype):
    q = _normal((b, s, h, dh), 1, card, dtype)
    k = _normal((b, s, kh, dh), 2, card, dtype)
    v = _normal((b, s, kh, dh), 3, card, dtype)
    before = flash_ops.KERNEL.launches
    o = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), flash_attention_ref(q, k, v, causal=True).float(), rtol=tol, atol=tol)


def test_flash_kernel_window_cap_noncausal_and_strided_inputs(card):
    qkv = _normal((2, 64, 12, 32), 4, card, torch.float32)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]  # strided views, head_dim contiguous
    for kw in ({"causal": True, "window": 16, "cap": 20.0}, {"causal": False}, {"causal": False, "window": 9}):
        torch.testing.assert_close(flash_ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw),
                                   rtol=2e-6, atol=2e-6)


def test_flash_kernel_decode_rows_with_device_offsets(card):
    q = _normal((1, 32, 4, 32), 5, card, torch.float32)
    k = _normal((1, 40, 2, 32), 6, card, torch.float32)
    v = _normal((1, 40, 2, 32), 7, card, torch.float32)
    full = flash_attention_ref(q, k[:, :32], v[:, :32], causal=True)
    for t in (0, 13, 31):
        pos = torch.tensor(t, dtype=torch.int32, device=card)
        for off, klen in ((t, t + 1), (pos, pos + 1)):
            o = flash_ops.flash_attention(q[:, t:t + 1], k, v, causal=True, q_offset=off, kv_len=klen)
            torch.testing.assert_close(o[:, 0], full[:, t], rtol=2e-6, atol=2e-6)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        flash_ops.flash_attention(q, q, q)


@pytest.mark.parametrize("b,s,d", [(1, 16, 8), (2, 64, 32), (3, 100, 48), (2, 37, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_on_the_card(card, b, s, d, dtype):
    rng = np.random.default_rng(b * 100 + s)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, size=(b, s, d)).astype(np.float32)).to(card, dtype)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(card, dtype)
    h0 = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(card, dtype)
    before = rglru_ops.KERNEL.launches
    y = rglru_ops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rglru_ops.KERNEL.launches == before + 1
    # the kernel rounds each multiply and add as the plain loop does: equal bits
    torch.testing.assert_close(y, rglru_scan_ref(a, x, h0), rtol=0, atol=0)
    torch.testing.assert_close(rglru_ops.rglru_scan(a, x), rglru_scan_ref(a, x), rtol=0, atol=0)


def test_rglru_kernel_zero_decay_is_identity(card):
    x = _normal((2, 16, 8), 9, card, torch.float32)
    assert torch.equal(rglru_ops.rglru_scan(torch.zeros_like(x), x), x)
