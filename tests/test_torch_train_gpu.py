"""The port's training path on a CUDA card: the RG-LRU kernel's gradient
against the plain loop's, the model's gradients through the kernel against
the plain scan's, flash refusing a gradient, the training entry points'
default device, and a bit-exact restart under deterministic algorithms.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import codegen_cuda  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.loop import Trainer, init_train_state, make_train_step  # noqa: E402

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _loop64(a, b, h0):
    """The scan as a plain float64 loop, differentiated by autograd."""
    h, ys = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)


def test_rglru_scan_gradient_on_the_card(card):
    """Forward and backward launch the kernel once each; (da, db, dh0)
    within 1e-5 of the largest float64 gradient; a ≡ 0 gives db = dy and
    dh0 = 0 exactly."""
    g = torch.Generator(device=card).manual_seed(0)
    shape = (2, 300, 96)
    a = (0.001 + 0.998 * torch.rand(shape, generator=g, device=card)).requires_grad_()
    b = torch.randn(shape, generator=g, device=card).requires_grad_()
    h0 = torch.randn(shape[::2], generator=g, device=card).requires_grad_()
    dy = torch.randn(shape, generator=g, device=card)
    codegen_cuda.reset_launch_counts()
    y = rglru_ops.rglru_scan(a, b, h0)
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert rglru_ops.KERNEL.launches == 2
    ref = [t.detach().double().requires_grad_() for t in (a, b, h0)]
    _loop64(*ref).backward(dy.double())
    for got, want in zip((a.grad, b.grad, h0.grad), ref):
        assert float((got.double() - want.grad).abs().max()) <= 1e-5 * float(want.grad.abs().max())
    z = torch.zeros(shape, device=card, requires_grad=True)
    b.grad = h0.grad = None
    rglru_ops.rglru_scan(z, b, h0).backward(dy)
    assert torch.equal(b.grad, dy) and torch.equal(h0.grad, torch.zeros_like(h0))


def test_model_gradients_through_the_kernel_match_the_plain_scan(card):
    """The reduced RecurrentGemma's loss and every leaf's gradient through
    the kernel (remat on: forward, recompute and backward launches) against
    ``build_model(cfg, rglru_scan_ref)``."""
    cfg = get_arch("recurrentgemma-2b").reduced
    batch = {k: torch.from_numpy(v).to(card) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=40, global_batch=2, seed=1).batch_at(0).items()}
    grads = []
    for model in (build_model(cfg), build_model(cfg, rglru_scan_ref)):
        params = model.init_params(torch.Generator().manual_seed(2), device=card).trainable_()
        codegen_cuda.reset_launch_counts()
        loss, _ = model.loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        grads.append((loss.detach(), [p.grad for _path, p in params.leaves()], rglru_ops.KERNEL.launches))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = grads
    # 1 group of (rglru, rglru, attn) rematted and 1 tail rglru: 2·3 + 1·2 launches
    assert (n_k, n_p) == (8, 0)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-6, atol=0)
    for a, b in zip(g_k, g_p):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-7


def test_flash_attention_refuses_a_gradient(card):
    """Neither flash kernel has a backward: under grad it raises, with no
    grad it runs."""
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((1, 64, 4, 64), generator=g, device=card) for _ in range(3))
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_ops.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flash_ops.flash_attention(q, k, v).shape == q.shape


def test_training_entry_points_default_to_the_card(card, tmp_path):
    cfg = get_arch("phi3-mini-3.8b").reduced
    model = build_model(cfg)
    state = init_train_state(model)
    assert state.step.is_cuda and all(p.is_cuda and p.requires_grad for _path, p in state.params.leaves())
    save_checkpoint(tmp_path / "c", 1, {"w": torch.ones(3)})
    assert load_checkpoint(tmp_path / "c", {"w": torch.empty(3, device="meta")})[1]["w"].is_cuda
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    trainer = Trainer(model, ds, str(tmp_path / "t"), train_step=make_train_step(model, warmup_steps=1), ckpt_every=2)
    state = trainer.run(2)
    assert state.step.is_cuda and int(state.step) == 2
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "phi3-mini-3.8b", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path / "l")],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("step ") == 2 and "done: 2 steps" in out.stdout


def test_restart_is_bit_exact_on_the_card(card, tmp_path):
    """8 steps straight against a crash at step 6 and a restart from the
    step-4 checkpoint, bit for bit, under ``torch.use_deterministic_algorithms``
    (cuBLAS and the embedding backward are not deterministic by default).
    The program is ``chip_smoke.py``'s restart phase, in a child process,
    because ``CUBLAS_WORKSPACE_CONFIG`` must be set before CUDA initialises."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--path-j-restart", str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    assert out.returncode == 0, out.stderr[-3000:]
    restart = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(restart) == ["phi3-mini-3.8b", "recurrentgemma-2b"]
    for arch, r in restart.items():
        assert r["bit_exact"] and r["device"].startswith("cuda"), (arch, r)
