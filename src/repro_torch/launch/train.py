"""End-to-end training launcher (the reference's ``repro/launch/train.py``, on
one device: sharding over a mesh is not ported yet).

Reduced config by default; the weights and the state live on the card
unless ``--device`` names another.  On the host, for example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --reduced --steps 30 --batch 4 --seq 64 --device cpu --ckpt-dir .train_ckpt/mamba2

A rerun with the same ``--ckpt-dir`` resumes from its newest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.runtime.loop import StragglerWatchdog, Trainer, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / ".train_ckpt"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", help="device of the weights and batches (default: the card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    entry = get_arch(args.arch)
    cfg = entry.reduced if args.reduced else entry.full
    model = build_model(cfg)

    dataset = SyntheticLMDataset(
        vocab=cfg.vocab,
        seq_len=args.seq,
        global_batch=args.batch,
        frames_shape=(cfg.encoder_seq, cfg.d_model) if cfg.is_encdec else None,
        patches_shape=(cfg.encoder_seq, cfg.d_model) if cfg.frontend == "vision" else None,
    )
    step_fn = make_train_step(
        model, base_lr=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 5), microbatches=args.microbatches,
    )
    trainer = Trainer(
        model, dataset, args.ckpt_dir,
        train_step=step_fn, ckpt_every=args.ckpt_every,
        watchdog=StragglerWatchdog(), device=args.device,
    )
    t0 = time.time()
    state = trainer.restore_or_init()
    start_step = int(state.step)
    for step in range(start_step, args.steps):
        state, metrics = trainer._step(state, trainer.batch_at(step))
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            print(f"step {step + 1:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            trainer.metrics_history.append({k: float(v) for k, v in metrics.items()})
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            trainer.ckpt.save_async(step + 1, state)
    trainer.ckpt.wait()
    dt = time.time() - t0
    steps_done = args.steps - start_step
    print(f"done: {steps_done} steps in {dt:.1f}s "
          f"({steps_done * args.batch * args.seq / max(dt, 1e-9):.0f} tok/s)", flush=True)

    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(trainer.metrics_history, indent=1))


if __name__ == "__main__":
    main()
