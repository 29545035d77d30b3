"""The port's LM kernels' plain versions on the CPU, against the reference.

``ops.flash_attention`` and ``ops.rglru_scan`` on CPU tensors run their
plain torch versions (``ref.py``); they are held against the reference's
Pallas kernels, run as ``tests/test_kernels.py`` runs them (interpret mode,
small blocks), and against its pure-jnp oracles, at that file's tolerances.
The CUDA kernels themselves run only on a card (``test_torch_gpu.py``).
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as r_flash_ref
from repro.kernels.rglru.ops import rglru_scan as r_rglru
from repro.kernels.rglru.ref import rglru_scan_ref as r_rglru_ref
from repro_torch.core import codegen_cuda
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import attention as t_attn

_TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values for both packages: float32 data cast to ``dtype``
    (exact for bfloat16 both ways)."""
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,kh,dh", [
    (1, 32, 4, 4, 32),    # MHA
    (2, 64, 8, 2, 64),    # GQA 4:1
    (1, 48, 6, 1, 128),   # MQA, ragged seq
    (2, 16, 4, 2, 96),    # non-128 head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_kernel(b, s, h, kh, dh, dtype):
    (rq, q), (rk, k), (rv, v) = (_pair(_rand(shape, seed), dtype) for shape, seed in (
        ((b, s, h, dh), 1), ((b, s, kh, dh), 2), ((b, s, kh, dh), 3)))
    got = flash_ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(r_flash(rq, rk, rv, causal=True, bq=16, bk=16)), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(r_flash_ref(rq, rk, rv, causal=True)), atol=tol, rtol=tol)


def test_flash_plain_window_and_cap():
    (rq, q), (rk, k), (rv, v) = (_pair(_rand((2, 64, 4, 32), i), "float32") for i in range(3))
    got = flash_ops.flash_attention(q, k, v, causal=True, window=16, cap=20.0)
    ref = r_flash(rq, rk, rv, causal=True, window=16, cap=20.0, bq=16, bk=16)
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-6)
    np.testing.assert_allclose(_np(got), _np(r_flash_ref(rq, rk, rv, causal=True, window=16, cap=20.0)), atol=2e-6)


@pytest.mark.parametrize("t", [0, 13, 31])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_flash_plain_decode_rows_against_prefill(t, as_tensor):
    """Decoding position t equals row t of the full prefill attention, and
    the reference kernel's decode row; offsets as ints or 0-d tensors."""
    (rq, q), (rk, k), (rv, v) = (_pair(_rand(shape, seed), "float32") for shape, seed in (
        ((1, 32, 4, 32), 5), ((1, 32, 2, 32), 6), ((1, 32, 2, 32), 7)))
    full = flash_attention_ref(q, k, v, causal=True)
    off = torch.tensor(t, dtype=torch.int32) if as_tensor else t
    o = flash_ops.flash_attention(q[:, t:t + 1], k, v, causal=True, q_offset=off, kv_len=off + 1)
    np.testing.assert_allclose(o[:, 0].numpy(), full[:, t].numpy(), atol=2e-6)
    ref = r_flash(rq[:, t:t + 1], rk, rv, causal=True, q_offset=t, kv_len=t + 1, bq=8, bk=16)
    np.testing.assert_allclose(o.numpy(), _np(ref), atol=2e-6)


def test_flash_impl_on_cpu_tensors_launches_nothing():
    q = torch.from_numpy(_rand((1, 16, 4, 32), 1))
    before = dict(codegen_cuda.launch_counts())
    o = t_attn.attend(q, q[:, :, :2], q[:, :, 2:], impl="flash", causal=True)
    assert o.shape == q.shape
    assert flash_ops.KERNEL.launches == 0 and rglru_ops.KERNEL.launches == 0
    assert flash_ops.KERNEL_BF16.launches == 0
    assert codegen_cuda.launch_counts() == before
    assert before.get("flash_fwd") == 0 and before.get("rglru_scan") == 0 and before.get("flash_fwd_sm90") == 0


def test_flash_wrapper_refuses_other_devices():
    q = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(TypeError, match="not supported"):
        flash_ops.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# rglru scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,d", [(1, 16, 8), (2, 64, 32), (3, 100, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_matches_reference_kernel(b, s, d, dtype):
    rng = np.random.default_rng(b * 100 + s)
    (ra, a), (rx, x), (rh, h0) = (_pair(v.astype(np.float32), dtype) for v in (
        rng.uniform(0.5, 0.999, size=(b, s, d)), rng.normal(size=(b, s, d)), rng.normal(size=(b, d))))
    got = rglru_ops.rglru_scan(a, x, h0)
    assert got.dtype == a.dtype and got.shape == a.shape
    tol = 5e-6 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(r_rglru(ra, rx, rh, bb=2, bd=16, chunk=16)), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(r_rglru_ref(ra, rx, rh)), atol=tol, rtol=tol)


def test_rglru_plain_zero_decay_is_identity():
    """a ≡ 0 ⇒ h_t = b_t exactly, with and without h0."""
    x = torch.from_numpy(_rand((2, 16, 8), 9))
    assert torch.equal(rglru_ops.rglru_scan(torch.zeros_like(x), x), x)
    assert torch.equal(rglru_scan_ref(torch.zeros_like(x), x, torch.ones(2, 8)), x)
    np.testing.assert_array_equal(np.asarray(r_rglru(jnp.zeros_like(jnp.asarray(x.numpy())), jnp.asarray(x.numpy()))),
                                  x.numpy())


def test_rglru_plain_default_state_is_zero():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, size=(2, 20, 6)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 20, 6)).astype(np.float32))
    assert torch.equal(rglru_ops.rglru_scan(a, x), rglru_ops.rglru_scan(a, x, torch.zeros(2, 6)))
