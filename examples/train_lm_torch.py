"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.

The port of ``examples/train_lm.py``, on the full public stack: config →
model → synthetic data pipeline → restartable ``Trainer`` (asynchronous
checkpoints, straggler watchdog).  The model attends ``naive``, as the
reference's does, so no hand-written kernel runs here.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --batch 2 --seq 64 --device cpu

A checkpoint directory that already holds a checkpoint resumes from it.
Without a GPU it says so unless ``--device cpu`` is given.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.storage import resolve_device  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.models import active_param_count, build_model, exact_param_count  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.runtime.loop import StragglerWatchdog, Trainer, make_train_step  # noqa: E402

# ~100M-parameter decoder-only config (llama-style), the reference's
CFG_100M = ArchConfig(
    name="repro-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32064,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    attention_impl="naive",
    dtype="float32",
)


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int, lr: float, ckpt_dir, metrics_out, device,
          params=None) -> dict:
    """Train ``cfg`` for ``steps`` steps on ``device`` (resuming from
    ``ckpt_dir`` when it holds a checkpoint); ``params`` (a ParamTree, e.g.
    weights carried from the reference) replaces a fresh start's weights.
    Returns the losses of every step, the logged metrics, tokens/s and the
    card's peak memory."""
    model = build_model(cfg)
    n_exact, n_active = exact_param_count(cfg), active_param_count(cfg)
    print(f"model: {cfg.name} — {n_exact / 1e6:.1f}M params ({n_active / 1e6:.1f}M active per token)")

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    watchdog = StragglerWatchdog()
    trainer = Trainer(model, ds, str(ckpt_dir),
                      train_step=make_train_step(model, base_lr=lr, warmup_steps=20, total_steps=steps),
                      ckpt_every=50, watchdog=watchdog, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    state = trainer.restore_or_init()
    start = trainer.start_step(state)
    if params is not None and start == 0:
        given = dict(tree_leaves(params))
        with torch.no_grad():
            for path, p in state.params.leaves():
                p.copy_(given[path])
    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        b = trainer.batch_at(step)
        t_step = time.perf_counter()
        state, metrics = trainer._step(state, b)
        losses.append(float(metrics["loss"]))  # synchronizes the card
        watchdog.record(step, time.perf_counter() - t_step)
        if step == start or (step + 1) % 10 == 0:
            dt = time.perf_counter() - t0
            tput = (step + 1 - start) * batch * seq / max(dt, 1e-9)
            print(f"step {step + 1:4d}  loss {losses[-1]:.4f}  grad {float(metrics['grad_norm']):.3f}  "
                  f"{tput:.0f} tok/s", flush=True)
            trainer.metrics_history.append({"step": step + 1, **{k: float(v) for k, v in metrics.items()}})
        if (step + 1) % 50 == 0 or step + 1 == steps:
            trainer.ckpt.save_async(step + 1, state)
    wall = time.perf_counter() - t0
    trainer.ckpt.wait()

    out = Path(metrics_out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(trainer.metrics_history, indent=1))
    tokens_per_s = (steps - start) * batch * seq / max(wall, 1e-9)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    result = {"exact_params": n_exact, "active_params": n_active, "start": start, "losses": losses,
              "metrics": trainer.metrics_history, "wall_s": wall, "tokens_per_s": tokens_per_s,
              "peak_bytes": peak, "stragglers": watchdog.stats.stragglers, "device": str(device)}
    if trainer.metrics_history:
        first, last = trainer.metrics_history[0]["ce_loss"], trainer.metrics_history[-1]["ce_loss"]
        peak_text = "not measured on the host" if peak is None else f"{peak / 1e9:.2f} GB"
        print(f"done: ce {first:.3f} → {last:.3f} over {steps - start} steps, {tokens_per_s:.0f} tok/s, "
              f"peak memory {peak_text}")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=str(ROOT / ".train_ckpt" / "repro-100m"))
    ap.add_argument("--metrics-out", default=str(ROOT / "experiments" / "train_100m_torch_metrics.json"))
    ap.add_argument("--device", default="cuda", help="device of the model and data (cpu on a host without a card)")
    args = ap.parse_args(argv)
    return train(CFG_100M, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                 metrics_out=args.metrics_out, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
