"""The port's training substrate on the CPU, against the reference.

Mirrors of ``tests/test_substrates.py`` (optimizer, schedule, clipping,
checkpoint store, data pipeline, int8 compression), each also held against
the reference's function on the same numpy inputs; the weight-decay rank
rule on stacked and ``tail_*`` leaves; checkpoints read across the two
packages; the async snapshot against an in-place update; mirrors of all six
``tests/test_runtime_faults.py`` tests with ``device="cpu"``; and the
training launcher.  Tolerances: float32 results of the same formula at
1e-6 relative (different summation orders), the data pipeline, int8 codes
and checkpoints bit for bit.
"""

import dataclasses
import inspect
import json

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import load_checkpoint as r_load_checkpoint
from repro.checkpoint import save_checkpoint as r_save_checkpoint
from repro.data.pipeline import SyntheticLMDataset as RSyntheticLMDataset
from repro.data.pipeline import make_batch_specs as r_make_batch_specs
from repro.configs import get_arch as r_get_arch
from repro.configs.shapes import SHAPES
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import clip_by_global_norm as r_clip_by_global_norm
from repro.optim import linear_warmup_cosine as r_linear_warmup_cosine
from repro.runtime.compression import int8_compress as r_int8_compress
from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMDataset, make_batch_specs
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import params_to_reference
from repro_torch.models.layers import ParamTree
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, decays, global_norm, linear_warmup_cosine
from repro_torch.runtime import loop
from repro_torch.runtime.compression import compress_tree, int8_compress, int8_decompress
from repro_torch.runtime.loop import (
    StragglerWatchdog,
    Trainer,
    _InjectedFault,
    abstract_train_state,
    init_train_state,
    make_train_step,
)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    target = np.asarray([1.5, -2.0, 0.5], np.float32)
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    r_params = {"w": jnp.zeros(3, jnp.float32)}  # the reference process runs with x64 on
    r_state = r_adamw_init(r_params)
    r_step = jax.jit(lambda p, s: r_adamw_update(
        p, jax.grad(lambda q: jnp.sum((q["w"] - target) ** 2))(p), s, lr=0.05, weight_decay=0.0))
    for i in range(300):
        grads = {"w": 2 * (params["w"] - torch.from_numpy(target))}
        params, state = adamw_update(params, grads, state, lr=0.05, weight_decay=0.0)
        r_params, r_state = r_step(r_params, r_state)
        if i < 20:  # near the optimum Adam oscillates by about lr and roundings part the paths
            np.testing.assert_allclose(_np(params["w"]), np.asarray(r_params["w"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(params["w"]), target, atol=1e-2)
    np.testing.assert_allclose(np.asarray(r_params["w"]), target, atol=1e-2)
    assert int(state.step) == int(r_state.step) == 300


def test_adamw_weight_decay_only_on_matrices():
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new_params, _ = adamw_update(params, grads, adamw_init(params), lr=0.1, weight_decay=0.5)
    assert float(new_params["w"].abs().max()) < 1.0  # decayed
    np.testing.assert_allclose(_np(new_params["b"]), 1.0)  # not decayed
    r_params = {"w": jnp.ones((4, 4)), "b": jnp.ones((4,))}
    r_new, _ = r_adamw_update(r_params, jax.tree_util.tree_map(jnp.zeros_like, r_params), r_adamw_init(r_params),
                              lr=0.1, weight_decay=0.5)
    for k in params:
        np.testing.assert_allclose(_np(new_params[k]), np.asarray(r_new[k]), rtol=1e-6)


def test_weight_decay_rank_is_the_stacked_leafs():
    """The reference stacks a layer stack (L, ...) and decays every leaf of
    rank >= 2, so it decays the vectors of stacked layers but not those of
    the hybrid's unstacked tail layers nor the final norm; the port holds a
    stack as a list and counts each list as a leading axis."""
    def layer():
        return {"ln": {"scale": torch.ones(4)}, "w": {"kernel": torch.ones((4, 4))}}

    params = ParamTree({"decoder": {"groups": [layer(), layer()], "tail_0_rglru": layer()},
                        "final_norm": {"scale": torch.ones(4)}})
    assert [decays(p, x) for p, x in params.leaves()] == [True, True, True, True, False, True, False]
    grads = {"decoder": {"groups": [{"ln": {"scale": torch.zeros(4)}, "w": {"kernel": torch.zeros((4, 4))}}] * 2,
                         "tail_0_rglru": {"ln": {"scale": torch.zeros(4)}, "w": {"kernel": torch.zeros((4, 4))}}},
             "final_norm": {"scale": torch.zeros(4)}}
    adamw_update(params, grads, adamw_init(params), lr=0.1, weight_decay=0.5)

    r_params = jax.tree_util.tree_map(jnp.asarray, params_to_reference(ParamTree(
        {"decoder": {"groups": [layer(), layer()], "tail_0_rglru": layer()}, "final_norm": {"scale": torch.ones(4)}})))
    r_new, _ = r_adamw_update(r_params, jax.tree_util.tree_map(jnp.zeros_like, r_params), r_adamw_init(r_params),
                              lr=0.1, weight_decay=0.5)
    got = params_to_reference(params)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6), got, r_new)
    assert float(got["decoder"]["groups"]["ln"]["scale"].max()) < 1.0
    assert float(got["decoder"]["tail_0_rglru"]["ln"]["scale"].min()) == 1.0 == float(got["final_norm"]["scale"].min())


def test_schedule_warmup_and_decay():
    lrs = [float(linear_warmup_cosine(s, 1e-3, 10, 100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[-1] < lrs[20]
    assert all(lr > 0 for lr in lrs)
    ref = [float(r_linear_warmup_cosine(jnp.asarray(s), 1e-3, 10, 100)) for s in range(100)]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6)


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(10 * 9 + 10 * 16), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    rng = np.random.default_rng(0)
    raw = {"a": rng.normal(size=(7, 5)).astype(np.float32), "b": rng.normal(size=(11,)).astype(np.float32)}
    r_clipped, r_norm = r_clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, raw), 0.5)
    t_tree = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
    clipped, norm = clip_by_global_norm(t_tree, 0.5)
    np.testing.assert_allclose(float(norm), float(r_norm), rtol=1e-6)
    for k in raw:
        np.testing.assert_allclose(_np(clipped[k]), np.asarray(r_clipped[k]), rtol=1e-6)
    assert clipped is t_tree  # the leaves themselves were scaled


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _tree():
    return {
        "layer": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4), "b": torch.ones(4)},
        "step_count": torch.tensor(7, dtype=torch.int32),
    }


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 42, tree)
    step, restored = load_checkpoint(tmp_path, _meta(tree), device="cpu")
    assert step == 42
    _assert_trees_equal(tree, restored)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_reads_across_packages(tmp_path, writer):
    """The same format: a plain dict tree written by one package is read
    back by the other, bit for bit."""
    tree = _tree()
    r_tree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    if writer == "port":
        save_checkpoint(tmp_path, 3, tree)
        step, restored = r_load_checkpoint(tmp_path, jax.eval_shape(lambda: r_tree))
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                               r_tree, restored)
        assert restored["step_count"].dtype == np.int32
    else:
        r_save_checkpoint(tmp_path, 3, r_tree)
        step, restored = load_checkpoint(tmp_path, _meta(tree), device="cpu")
        _assert_trees_equal(tree, restored)
    assert step == 3


def test_checkpoint_atomicity_ignores_uncommitted(tmp_path):
    save_checkpoint(tmp_path, 10, _tree())
    # fake a partial (crashed) checkpoint at step 20: no COMMIT
    bad = tmp_path / "step_000000020"
    bad.mkdir()
    (bad / "meta.json").write_text(json.dumps({"step": 20, "leaves": []}))
    assert latest_step(tmp_path) == 10


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, _tree(), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_000000004", "step_000000005"]


def test_async_manager(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save_async(5, tree)
    mgr.wait()
    step, restored = mgr.restore_or_init(_meta(tree), lambda: tree, device="cpu")
    assert step == 5
    assert torch.equal(restored["layer"]["w"], tree["layer"]["w"])


def test_async_snapshot_survives_an_in_place_update(tmp_path):
    """``save_async`` copies every leaf before it returns: AdamW's in-place
    update of step N+1 must not reach step N's checkpoint."""
    tree = _tree()
    want = tree["layer"]["w"].clone()
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, tree)
    tree["layer"]["w"].add_(100.0)  # what the next optimizer step does to a parameter
    mgr.wait()
    _, restored = load_checkpoint(tmp_path, _meta(tree), device="cpu")
    assert torch.equal(restored["layer"]["w"], want)


def test_restore_template_dtype_respected(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(4)})
    _, restored = load_checkpoint(tmp_path, {"w": torch.empty(4, dtype=torch.bfloat16, device="meta")}, device="cpu")
    assert restored["w"].dtype == torch.bfloat16 and restored["w"].device.type == "cpu"
    r_restored = r_load_checkpoint(tmp_path, {"w": jax.ShapeDtypeStruct((4,), jnp.bfloat16)})[1]
    assert r_restored["w"].dtype == jnp.bfloat16


def test_train_state_roundtrip_from_a_template_of_no_weights(tmp_path):
    """The trainer's restore template is meta tensors (nothing drawn); the
    restored state is trainable and equal to what was saved, bf16 leaves
    included."""
    model = build_model(get_arch("recurrentgemma-2b").reduced)
    state = init_train_state(model, torch.Generator().manual_seed(1), device="cpu")
    state.opt.m["final_norm"]["scale"].fill_(0.25)
    save_checkpoint(tmp_path, 4, state)
    template = abstract_train_state(model)
    assert all(x.is_meta for _p, x in template.params.leaves())
    step, restored = load_checkpoint(tmp_path, template, device="cpu")
    assert step == 4 and type(restored).__name__ == "TrainState"
    for (pa, a), (pb, b) in zip(state.params.leaves(), restored.params.leaves()):
        assert pa == pb and b.requires_grad and torch.equal(a, b)
    assert torch.equal(restored.opt.m["final_norm"]["scale"], state.opt.m["final_norm"]["scale"])
    save_checkpoint(tmp_path, 5, {"h": torch.randn(3, generator=torch.Generator().manual_seed(0)).bfloat16()})
    h = load_checkpoint(tmp_path, {"h": torch.empty(3, dtype=torch.bfloat16, device="meta")}, device="cpu")[1]["h"]
    assert torch.equal(h, torch.randn(3, generator=torch.Generator().manual_seed(0)).bfloat16())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_deterministic_per_step():
    ds = SyntheticLMDataset(vocab=512, seq_len=64, global_batch=8, seed=3)
    a, b = ds.batch_at(17), ds.batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], ds.batch_at(18)["tokens"])


def test_data_shards_disjoint_and_partition():
    s0 = SyntheticLMDataset(vocab=512, seq_len=32, global_batch=8, seed=1, shard_index=0, shard_count=2)
    s1 = SyntheticLMDataset(vocab=512, seq_len=32, global_batch=8, seed=1, shard_index=1, shard_count=2)
    assert s0.local_batch == s1.local_batch == 4
    assert not np.array_equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])


def test_data_labels_shifted():
    batch = SyntheticLMDataset(vocab=512, seq_len=32, global_batch=2, seed=0).batch_at(0)
    np.testing.assert_array_equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    assert np.all(batch["labels"][:, -1] == -1)


@pytest.mark.parametrize("extra", [{}, {"frames_shape": (6, 8)}, {"patches_shape": (5, 8)},
                                   {"shard_index": 1, "shard_count": 2}])
def test_data_batches_are_the_references(extra):
    kw = dict(vocab=1000, seq_len=96, global_batch=4, seed=7, **extra)
    for step in (0, 5):
        got, ref = SyntheticLMDataset(**kw).batch_at(step), RSyntheticLMDataset(**kw).batch_at(step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "whisper-medium", "internvl2-1b"])
def test_batch_specs_are_the_references(arch):
    got = make_batch_specs(get_arch(arch).full, SHAPES["train_4k"])
    ref = r_make_batch_specs(r_get_arch(arch).full, SHAPES["train_4k"])
    assert sorted(got) == sorted(ref)
    for k, spec in got.items():
        assert spec.shape == ref[k].shape and str(spec.dtype).removeprefix("torch.") == str(ref[k].dtype)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32))
    q, scale = int8_compress(x)
    y = int8_decompress(q, scale)
    assert float((x - y).abs().max()) <= float(scale) * 0.5 + 1e-7
    assert q.dtype == torch.int8


def test_int8_preserves_zero_and_extremes():
    x = torch.tensor([0.0, 1.0, -1.0, 0.5])
    q, scale = int8_compress(x)
    y = int8_decompress(q, scale)
    assert float(y[0]) == 0.0
    np.testing.assert_allclose(_np(y), _np(x), atol=float(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_codes_are_the_references(dtype):
    """Same codes and scale bit for bit, ties rounded half to even as ``jnp.round``."""
    x = np.random.default_rng(1).normal(size=(33, 17)).astype(np.float32)
    x[0, :4] = [127.0, 0.5, 1.5, -2.5]  # x / scale = 127, .5, 1.5, -2.5: the ties
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, scale = int8_compress(tx)
    r_q, r_scale = r_int8_compress(jnp.asarray(x).astype(dtype))
    np.testing.assert_array_equal(_np(q), np.asarray(r_q))
    assert np.float32(float(scale)) == np.asarray(r_scale)
    assert list(_np(q)[0, :4]) == [127, 0, 2, -2]
    tree = compress_tree({"a": tx, "b": [tx[:3]]})
    assert torch.equal(tree["a"][0], q) and tree["b"][0][0].shape == (3, 17)


# ---------------------------------------------------------------------------
# the restartable trainer (mirrors of tests/test_runtime_faults.py)
# ---------------------------------------------------------------------------


def _tiny_setup(tmp_path, arch="phi3-mini-3.8b", ckpt_every=5):
    cfg = get_arch(arch).reduced
    model = build_model(cfg)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    trainer = Trainer(
        model, ds, str(tmp_path / "ckpt"),
        train_step=make_train_step(model, base_lr=1e-3, warmup_steps=2, total_steps=50),
        ckpt_every=ckpt_every, device="cpu",
    )
    return model, ds, trainer


def test_loss_decreases_end_to_end(tmp_path):
    _, _, trainer = _tiny_setup(tmp_path)
    trainer.run(30)
    losses = [m["ce_loss"] for m in trainer.metrics_history]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, (
        f"no learning signal: first {np.mean(losses[:5]):.3f} last {np.mean(losses[-5:]):.3f}"
    )


def test_crash_restart_resumes_from_checkpoint(tmp_path):
    _, _, trainer = _tiny_setup(tmp_path, ckpt_every=5)
    crashed = {"done": False}

    def fault_hook(step):
        if step == 12 and not crashed["done"]:
            crashed["done"] = True
            raise _InjectedFault("node died")

    state = trainer.run(20, fault_hook=fault_hook)
    assert int(state.step) == 20
    assert crashed["done"]
    # steps 10..12 were replayed after restoring the step-10 checkpoint
    assert len(trainer.metrics_history) >= 20


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "recurrentgemma-2b"])
def test_restart_is_bit_exact(tmp_path, arch):
    """Training N steps straight == training with a crash + restart."""
    _, _, t1 = _tiny_setup(tmp_path / "a", arch, ckpt_every=4)
    s_straight = t1.run(8)
    _, _, t2 = _tiny_setup(tmp_path / "b", arch, ckpt_every=4)
    crashed = {"done": False}

    def fault(step):
        if step == 6 and not crashed["done"]:
            crashed["done"] = True
            raise _InjectedFault()

    s_restarted = t2.run(8, fault_hook=fault)
    assert crashed["done"]
    for (pa, a), (pb, b) in zip(s_straight.params.leaves(), s_restarted.params.leaves()):
        assert pa == pb and torch.equal(a, b), pa


def test_too_many_faults_raises(tmp_path):
    _, _, trainer = _tiny_setup(tmp_path)

    def always_fault(step):
        raise _InjectedFault("flaky node")

    with pytest.raises(_InjectedFault):
        trainer.run(5, fault_hook=always_fault, max_restarts=2)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(factor=3.0)
    flagged = []

    def _on_straggler(step, dt, med):
        flagged.append(step)

    wd.on_straggler = _on_straggler
    for s in range(20):
        wd.record(s, 0.01)
    wd.record(20, 0.5)  # 50× median
    assert flagged == [20]
    assert wd.stats.stragglers == 1


def test_microbatched_step_matches_unbatched():
    """grad accumulation (microbatches=4) == single big batch, numerically."""
    cfg = get_arch("phi3-mini-3.8b").reduced
    model = build_model(cfg)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    s1 = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
    s2 = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
    s1, m1 = make_train_step(model, base_lr=1e-3)(s1, batch)
    s2, m4 = make_train_step(model, base_lr=1e-3, microbatches=4)(s2, batch)
    np.testing.assert_allclose(float(m1["ce_loss"]), float(m4["ce_loss"]), rtol=1e-4)
    for (_, a), (_, b) in zip(s1.params.leaves(), s2.params.leaves()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5)


def test_microbatch_gradients_sum_in_float32_for_bfloat16_weights(monkeypatch):
    """As the reference's ``lax.scan`` accumulation: the microbatches'
    gradients of bfloat16 weights are summed in float32, then divided."""
    cfg = dataclasses.replace(get_arch("phi3-mini-3.8b").reduced, param_dtype="bfloat16")
    model = build_model(cfg)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
    state = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
    want = None
    for i in range(2):
        model.loss(state.params, {k: v[2 * i:2 * i + 2] for k, v in batch.items()})[0].backward()
        g = [p.grad.float() for _path, p in state.params.leaves()]
        want = g if want is None else [a + b for a, b in zip(want, g)]
        state.params.zero_grad(set_to_none=True)
    seen = {}

    def capture(params, grads, opt, lr, **kw):
        seen["grads"] = grads
        return params, opt

    monkeypatch.setattr(loop, "adamw_update", capture)
    make_train_step(model, microbatches=2, max_grad_norm=1e9)(state, batch)
    assert any(p.dtype == torch.bfloat16 for _path, p in state.params.leaves())
    for got, w in zip(seen["grads"], want):
        assert got.dtype == torch.float32 and torch.equal(got, w / 2)


# ---------------------------------------------------------------------------
# the launcher and the device defaults
# ---------------------------------------------------------------------------


def test_launch_train_logs_and_commits_a_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    metrics = tmp_path / "metrics.json"
    argv = ["--arch", "recurrentgemma-2b", "--steps", "4", "--batch", "2", "--seq", "16", "--log-every", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(ckpt), "--device", "cpu", "--metrics-out", str(metrics)]
    launch_train.main(argv)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in lines] == [1, 2, 4]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    assert "done: 4 steps" in out
    assert latest_step(ckpt) == 4 and (ckpt / "step_000000004" / "COMMIT").exists()
    assert len(json.loads(metrics.read_text())) == 3
    launch_train.main(argv[:3] + ["6"] + argv[4:])  # resumes from step 4
    assert "done: 2 steps" in capsys.readouterr().out and latest_step(ckpt) == 6


def test_launch_train_refuses_a_batch_that_does_not_split(tmp_path):
    """As the reference's reshape into (microbatches, B // microbatches, ...):
    no rows are dropped without a word."""
    argv = ["--arch", "phi3-mini-3.8b", "--steps", "1", "--batch", "10", "--microbatches", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    with pytest.raises(ValueError, match="10 rows does not split into 4 microbatches"):
        launch_train.main(argv)


def test_training_entry_points_default_to_the_card():
    """``Trainer``, ``init_train_state``, ``load_checkpoint`` and the launcher
    put what they make on the card unless the caller names another device."""
    for fn in (Trainer.__init__, init_train_state, load_checkpoint, CheckpointManager.restore_or_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert "default=\"cuda\"" in inspect.getsource(launch_train.main)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_train_state(build_model(get_arch("phi3-mini-3.8b").reduced))
