"""The arithmetic of the bfloat16 tensor-core flash kernel, on the CPU.

``csrc/flash_fwd_sm90.cu`` rounds P to bfloat16 before the P·V product (the
tensor cores' operand type), where the reference keeps P in float32.  Its
plain model (``ref.flash_attention_sm90_model``: the kernel's tiles, online
softmax in log2 units, P in bfloat16, float32 sums) is held against the
reference package's oracle and its Pallas kernel in interpret mode, at the
reference's bfloat16 tolerance of 2e-2, on the cases of the reference's
kernel tests and at the head dims 96, 160 and 256, so that the rounding is
shown to fit before any chip run.  The kernel itself runs only on a card
(``test_torch_gpu.py``).
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as r_flash_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_sm90_model, tile_keys

TOL = 2e-2  # the reference's bfloat16 tolerance


def _inputs(q_shape, kv_shape, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    # the same bfloat16 values for both packages
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _check(q_shape, kv_shape, seed, pallas=True, **kw):
    (rq, rk, rv), (q, k, v) = _inputs(q_shape, kv_shape, seed)
    got = flash_attention_sm90_model(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    got = got.float().numpy()
    ref = np.asarray(r_flash_ref(rq, rk, rv, **kw).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    if pallas:
        ker = np.asarray(r_flash(rq, rk, rv, bq=16, bk=16, **kw).astype(jnp.float32))
        np.testing.assert_allclose(got, ker, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,h,kh,dh", [
    (1, 32, 4, 4, 32),    # MHA
    (2, 64, 8, 2, 64),    # GQA 4:1
    (1, 48, 6, 1, 128),   # MQA, ragged seq
    (2, 16, 4, 2, 96),    # non-128 head dim
])
def test_model_matches_reference_on_its_kernel_cases(b, s, h, kh, dh):
    _check((b, s, h, dh), (b, s, kh, dh), seed=b * s + dh, causal=True)


@pytest.mark.parametrize("dh", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_model_matches_reference_at_wide_head_dims_over_many_tiles(dh, causal):
    # 300 keys: several kv tiles of 64 or 128 and a ragged last one; 2 q blocks
    _check((1, 300, 4, dh), (1, 300, 2, dh), seed=dh, pallas=False, causal=causal)


def test_model_matches_reference_with_window_and_cap():
    _check((2, 64, 4, 32), (2, 64, 4, 32), seed=3, causal=True, window=16, cap=20.0)
    _check((1, 400, 2, 64), (1, 400, 1, 64), seed=4, pallas=False, causal=True, window=150, cap=30.0)


@pytest.mark.parametrize("t", [0, 13, 31, 200])
def test_model_decode_rows_match_reference(t):
    _check((1, 1, 4, 32), (1, 256, 2, 32), seed=t, pallas=False, causal=True, q_offset=t, kv_len=t + 1)


@pytest.mark.parametrize("s,skv,h,kh,dh,causal", [
    (8, 96, 4, 4, 16, False), (80, 80, 4, 2, 32, True), (33, 90, 6, 2, 64, False), (70, 70, 8, 1, 16, True),
])
def test_model_matches_reference_on_property_cases(s, skv, h, kh, dh, causal):
    _check((1, s, h, dh), (1, skv, kh, dh), seed=s + skv, causal=causal)


def test_model_gives_zero_for_a_row_with_no_key():
    (_, _, _), (q, k, v) = _inputs((1, 4, 2, 32), (1, 16, 2, 32), seed=9)
    assert torch.equal(flash_attention_sm90_model(q, k, v, causal=False, kv_len=0), torch.zeros_like(q))


def test_tile_keys_and_the_routes():
    assert [tile_keys(d) for d in flash_ops.HEAD_DIMS] == [128, 128, 128, 128, 128, 64, 64]
    assert flash_ops.KERNEL_BF16.source.name == "flash_fwd_sm90.cu"
    assert flash_ops.KERNEL.source.name == "flash_fwd.cu"
    # bfloat16 on the CPU runs the plain version and launches nothing
    (_, _, _), (q, k, v) = _inputs((1, 16, 2, 32), (1, 16, 2, 32), seed=1)
    o = flash_ops.flash_attention(q, k, v)
    assert o.dtype == torch.bfloat16 and flash_ops.KERNEL_BF16.launches == 0 and flash_ops.KERNEL.launches == 0
