"""The arithmetic of the float32 flash kernel, on the CPU.

``csrc/flash_fwd.cu`` sums the scores in float64 on the tensor cores (DMMA),
and P·V there too up to Dh 96 (in float32 on the CUDA cores from Dh 128 on),
tile by tile (blocks of BQ query rows, kv tiles of BK keys), each tile's p
and p·v summed on their own before the online softmax adds them in.  Its plain model
(``ref.flash_attention_f32_model``) is held against the reference package's
oracle and its Pallas kernel in interpret mode at the reference's float32
tolerance of 2e-6: on the cases of the reference's kernel tests, with GQA,
window, cap and decode rows, at every head dim the kernel takes, and at one
long sequence (2048 rows, one head, Dh 96), where float32 sums drift most.
The kernel itself runs only on a card (``test_torch_gpu.py``).
"""

import re

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as r_flash_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import F32_TILES, flash_attention_f32_model, flash_attention_ref

TOL = 2e-6  # the reference's float32 tolerance


def _inputs(q_shape, kv_shape, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _check(q_shape, kv_shape, seed, pallas=True, blocks=(16, 16), **kw):
    (rq, rk, rv), (q, k, v) = _inputs(q_shape, kv_shape, seed)
    got = flash_attention_f32_model(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(r_flash_ref(rq, rk, rv, **kw)), atol=TOL, rtol=TOL)
    if pallas:
        ker = np.asarray(r_flash(rq, rk, rv, bq=blocks[0], bk=blocks[1], **kw))
        np.testing.assert_allclose(got, ker, atol=TOL, rtol=TOL)
    return got


@pytest.mark.parametrize("b,s,h,kh,dh", [
    (1, 32, 4, 4, 32),    # MHA
    (2, 64, 8, 2, 64),    # GQA 4:1
    (1, 48, 6, 1, 128),   # MQA, ragged seq
    (2, 16, 4, 2, 96),    # non-128 head dim
])
def test_model_matches_reference_on_its_kernel_cases(b, s, h, kh, dh):
    _check((b, s, h, dh), (b, s, kh, dh), seed=b * s + dh, causal=True)


@pytest.mark.parametrize("dh", sorted(F32_TILES))
def test_model_matches_reference_at_every_head_dim_over_many_tiles(dh):
    # 150 rows: two q blocks of 128 or more of 64 and 32, a ragged last kv tile
    _check((1, 150, 8, dh), (1, 150, 2, dh), seed=dh, pallas=False, causal=True)


def test_model_matches_reference_with_gqa_window_and_cap():
    _check((2, 64, 4, 32), (2, 64, 4, 32), seed=3, causal=True, window=16, cap=20.0)
    _check((1, 300, 8, 64), (1, 300, 2, 64), seed=4, pallas=False, causal=True, window=100, cap=30.0)
    _check((1, 77, 6, 96), (1, 200, 1, 96), seed=5, pallas=False, causal=False, window=50)


@pytest.mark.parametrize("t", [0, 13, 31, 200])
def test_model_decode_rows_match_prefill(t):
    (rq, rk, rv), (q, k, v) = _inputs((1, 256, 4, 32), (1, 256, 2, 32), seed=6)
    full = np.asarray(r_flash_ref(rq, rk, rv, causal=True))
    row = flash_attention_f32_model(q[:, t:t + 1], k, v, causal=True, q_offset=t, kv_len=t + 1)
    np.testing.assert_allclose(row[:, 0].numpy(), full[:, t], atol=TOL, rtol=TOL)
    ker = np.asarray(r_flash(rq[:, t:t + 1], rk, rv, causal=True, q_offset=t, kv_len=t + 1, bq=8, bk=16))
    np.testing.assert_allclose(row.numpy(), ker, atol=TOL, rtol=TOL)


def test_model_holds_over_a_long_sequence():
    # 2048 keys for the last rows: 64 kv tiles summed into (l, acc)
    got = _check((1, 2048, 1, 96), (1, 2048, 1, 96), seed=7, blocks=(256, 256), causal=True)
    (_, _, _), (q, k, v) = _inputs((1, 2048, 1, 96), (1, 2048, 1, 96), seed=7)
    exact = flash_attention_ref(q.double(), k.double(), v.double(), causal=True).numpy()
    np.testing.assert_allclose(got, exact, atol=TOL, rtol=TOL)


def test_model_gives_zero_for_a_row_with_no_key():
    (_, _, _), (q, k, v) = _inputs((1, 4, 2, 32), (1, 16, 2, 32), seed=9)
    assert torch.equal(flash_attention_f32_model(q, k, v, causal=False, kv_len=0), torch.zeros_like(q))


def test_tiles_are_the_kernels_and_float32_cpu_tensors_take_the_plain_version():
    src = flash_ops.KERNEL.source.read_text()
    bq_dmma = int(re.search(r"struct DmmaSmem \{\s*static constexpr int BQ = (\d+)", src).group(1))
    table = {int(dh): (bq_dmma, int(bk), True) for dh, bk in re.findall(r"case (\d+): return run_dmma<\d+, (\d+)>", src)}
    table.update({int(dh): (int(bq), int(bk), False) for dh, bq, bk in
                  re.findall(r"case (\d+): return run_cc<\d+, (\d+), (\d+), \d+>", src)})
    assert table == F32_TILES and sorted(table) == list(flash_ops.HEAD_DIMS)
    (_, _, _), (q, k, v) = _inputs((1, 16, 2, 32), (1, 16, 2, 32), seed=1)
    before = flash_ops.KERNEL.launches
    o = flash_ops.flash_attention(q, k, v)
    assert o.dtype == torch.float32 and flash_ops.KERNEL.launches == before
    torch.testing.assert_close(o, flash_attention_ref(q, k, v), rtol=0, atol=0)
