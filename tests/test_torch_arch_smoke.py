"""The port's mirror of ``tests/test_arch_smoke.py``: every architecture at
its reduced config on the CPU — forward and loss, one train step through
``runtime.loop.make_train_step``, prefill and token-by-token decode against
the full forward, the parameter counts against the spec tree and against
the reference's integers (exact and active per token), and the documented
shape skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models.model import active_param_count as r_active_param_count  # noqa: E402
from repro.models.model import exact_param_count as r_exact_param_count  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.models import active_param_count, build_model, exact_param_count  # noqa: E402
from repro_torch.models.layers import spec_tree_shapes, tree_leaves  # noqa: E402
from repro_torch.runtime.loop import init_train_state, make_train_step  # noqa: E402

ARCHS = list(list_archs())


def _batch_for(cfg, batch=2, seq=16, rng=None):
    rng = rng or np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _model_and_params(arch, seed):
    cfg = get_arch(arch).reduced
    model = build_model(cfg)
    return cfg, model, model.init_params(torch.Generator().manual_seed(seed), device="cpu")


def test_all_ten_archs_registered():
    assert len(ARCHS) == 10
    assert sorted(ARCHS) == sorted(r_get_arch(a).full.name for a in ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    cfg, model, params = _model_and_params(arch, 0)
    batch = _batch_for(cfg)
    with torch.no_grad():
        logits, _ = model.forward(params, batch, remat=False)
        extra = cfg.encoder_seq if cfg.frontend == "vision" else 0
        assert tuple(logits.shape) == (2, 16 + extra, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        loss, metrics = model.loss(params, batch)
    assert np.isfinite(float(loss))
    assert float(metrics["ce_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss_direction(arch):
    """One step of the port's ``make_train_step`` on the smoke batch: a finite
    loss, a finite first moment of every leaf's shape (the clipped gradient,
    scaled), finite parameters of unchanged shapes, and the step descends:
    the loss on the same batch falls (no weight decay, a small rate)."""
    cfg = get_arch(arch).reduced
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(1), device="cpu")
    shapes = {p: tuple(t.shape) for p, t in state.params.leaves()}
    batch = _batch_for(cfg)
    step = make_train_step(model, base_lr=1e-4, warmup_steps=1, total_steps=10, weight_decay=0.0)
    state, metrics = step(state, batch)
    before = float(metrics["loss"])
    assert np.isfinite(before) and np.isfinite(float(metrics["grad_norm"]))
    moments = dict(tree_leaves(state.opt.m))
    for path, p in state.params.leaves():
        assert tuple(p.shape) == shapes[path] == tuple(moments[path].shape), path
        assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(moments[path]).all()), path
    assert float(metrics["grad_norm"]) > 0
    with torch.no_grad():
        after = float(model.loss(state.params, batch)[0])
    assert after < before, (before, after)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Greedy decode path equals teacher-forced forward logits."""
    cfg, model, params = _model_and_params(arch, 2)
    B, S = 2, 12
    batch = _batch_for(cfg, batch=B, seq=S)
    with torch.no_grad():
        full_logits, _ = model.forward(params, batch, remat=False)
        cache = model.make_cache(batch=B, max_len=32, device="cpu")
        prompt_len = 8
        prefill_batch = dict(batch)
        prefill_batch["tokens"] = batch["tokens"][:, :prompt_len]
        logits_p, cache = model.prefill(params, prefill_batch, cache)
        extra = cfg.encoder_seq if cfg.frontend == "vision" else 0
        np.testing.assert_allclose(logits_p.numpy(), full_logits[:, extra + prompt_len - 1].numpy(),
                                   rtol=2e-2, atol=2e-3)
        for t in range(prompt_len, S):
            step_batch = {"tokens": batch["tokens"][:, t:t + 1]}
            if cfg.is_encdec:
                step_batch["frames"] = batch["frames"]
            logits_d, cache = model.decode_step(params, step_batch, cache)
            np.testing.assert_allclose(logits_d.numpy(), full_logits[:, extra + t].numpy(), rtol=2e-2, atol=2e-3,
                                       err_msg=f"{arch}: decode step {t} diverged from forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_param_count_matches_spec(arch):
    """Materialized params match the spec tree exactly (reduced config), as
    do ``LM.param_shapes`` and ``spec_tree_shapes`` (meta tensors of each
    leaf's shape and dtype), and the reference's count."""
    cfg, model, params = _model_and_params(arch, 0)
    actual = sum(p.numel() for _path, p in params.leaves())
    assert actual == exact_param_count(cfg) == r_exact_param_count(r_get_arch(arch).reduced)
    shapes = model.param_shapes()
    specs = dict(tree_leaves(model.param_specs()))
    assert spec_tree_shapes(model.param_specs()).keys() == shapes.keys()
    for path, t in tree_leaves(shapes):
        assert t.device.type == "meta" and tuple(t.shape) == specs[path].shape
        assert t.dtype == getattr(torch, specs[path].dtype)
    assert sum(t.numel() for _p, t in tree_leaves(shapes)) == actual


# Expected parameter counts for the FULL configs: the reference test's table
# (published sizes, or derived from the assignment table where it pins another
# layout), and the reference's exact and active counts to the parameter.
_EXPECTED_FULL_PARAMS = {
    "deepseek-coder-33b": (33.3e9, 0.10),
    "stablelm-12b": (12.1e9, 0.12),
    "phi3-mini-3.8b": (3.8e9, 0.10),
    "command-r-35b": (30.3e9, 0.05),
    "phi3.5-moe-42b-a6.6b": (41.9e9, 0.12),
    "moonshot-v1-16b-a3b": (28.9e9, 0.05),
    "mamba2-370m": (370e6, 0.15),
    "recurrentgemma-2b": (2.7e9, 0.15),
    "internvl2-1b": (0.63e9, 0.35),
    "whisper-medium": (0.769e9, 0.20),
}
_ACTIVE_MOE = {"moonshot-v1-16b-a3b": 4_804_773_888, "phi3.5-moe-42b-a6.6b": 6_642_212_864}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_matches_published(arch):
    entry = get_arch(arch)
    n = exact_param_count(entry.full)
    expected, tol = _EXPECTED_FULL_PARAMS[arch]
    assert abs(n - expected) / expected < tol, f"{arch}: {n/1e9:.2f}B vs {expected/1e9:.2f}B"
    r_full = r_get_arch(arch).full
    assert n == r_exact_param_count(r_full)
    active = active_param_count(entry.full)
    assert active == r_active_param_count(r_full)
    if entry.full.family == "moe":
        assert active == _ACTIVE_MOE[arch] < n
    else:
        assert active == n


def test_shape_skips_documented():
    """Every full-attention arch skips long_500k with a reason; ssm/hybrid run
    it; the port's shape lists and skips are the reference's."""
    for arch in ARCHS:
        entry = get_arch(arch)
        skip_ids = {s for s, _ in entry.skips}
        if entry.full.quadratic_attention:
            assert "long_500k" in skip_ids, arch
            assert "long_500k" not in entry.shapes, arch
        else:
            assert "long_500k" in entry.shapes, arch
        r_entry = r_get_arch(arch)
        assert tuple(entry.shapes) == tuple(r_entry.shapes)
        assert tuple(entry.skips) == tuple(r_entry.skips)
