"""The port's int8-compressed data-parallel all-reduce on 8 gloo CPU ranks.

``runtime.compression.dp_allreduce_compressed`` mean-reduces a gradient tree
over a ``torch.distributed`` group with int8 payloads and one shared scale.
It is held against the exact mean within ``rel < 0.05`` of the largest
entry, the bound of the reference's own
``tests/test_distributed.py::test_compressed_dp_allreduce_close_to_exact``
(on the same (8, 64, 32) seeded inputs); it is not held against the
reference's output, which fails that test (ROADMAP Queue 3).  The
error-feedback variant's residuals must equal ``g − dequant(q)`` computed
here in numpy float32 with the shared scale, bit for bit.  The rank code is
``tests/torch_dist_ranks.py::compressed_allreduce``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_dist_ranks as ranks  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

WORLD = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(WORLD, 64, 32)).astype(np.float32)
    e = (rng.normal(size=(WORLD, 64, 32)) * 0.01).astype(np.float32)
    out = run_ranks(ranks.compressed_allreduce, WORLD, (g, e), store_dir=tmp_path_factory.mktemp("compression"),
                    timeout=120)
    return out, g, e


def _rel(got, exact):
    return float(np.abs(got - exact).max() / (np.abs(exact).max() + 1e-9))


def test_compressed_allreduce_close_to_exact_mean(runs):
    out, g, _e = runs
    exact = g.mean(axis=0)
    for r in out:
        assert _rel(r["mean"], exact) < 0.05  # int8 quantization error bound
        np.testing.assert_array_equal(r["mean"], out[0]["mean"])  # every rank holds the same mean
        assert r["bf16_dtype"] == "torch.bfloat16"
        assert _rel(r["bf16"], g[:, :3].astype(np.float32).mean(axis=0)) < 0.05


def test_error_feedback_residuals_are_what_quantization_dropped(runs):
    out, g, e = runs
    g32 = g + e
    scale = np.maximum(np.abs(g32).max(), np.float32(1e-12)) / np.float32(127.0)
    q = np.clip(np.rint(g32 / scale), -127, 127).astype(np.int8)
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["residual"], g32[rank] - q[rank].astype(np.float32) * scale)
        assert _rel(r["ef_mean"], g32.mean(axis=0)) < 0.05
