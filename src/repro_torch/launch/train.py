"""End-to-end training launcher (the reference's ``repro/launch/train.py``).

Reduced config by default; the weights and the state live on the card
unless ``--device`` names another.  On one device, on the host for example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --reduced --steps 30 --batch 4 --seq 64 --device cpu --ckpt-dir .train_ckpt/mamba2

``--mesh DATA MODEL`` shards the state and the batch over a ("data",
"model") mesh by the logical rules (``parallel.sharding.DEFAULT_RULES``),
one process per rank: under ``torchrun --nproc-per-node N`` (the process
group from its environment), or with ``--spawn``, which starts the N ranks
here (``launch.ranks``).  Ranks that share one card use the
``gloo_staged`` backend, one card a rank ``nccl``; on the host::

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --steps 10 --batch 4 --seq 64 --device cpu --mesh 2 2 --spawn --ckpt-dir .train_ckpt/rg22

A rerun with the same ``--ckpt-dir`` resumes from its newest checkpoint,
on any mesh (the restore re-shards).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.runtime.loop import StragglerWatchdog, Trainer, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / ".train_ckpt"


def train(args: argparse.Namespace, rank: int = 0) -> None:
    """The training loop; under ``--mesh`` every rank runs it (an initialised
    process group), rank 0 logs and writes."""
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
    shardings, scope = None, nullcontext()
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.specs import state_shardings
        from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

        mesh = make_mesh(args.mesh, ("data", "model"), device_type=args.device.split(":")[0])
        shardings, scope = state_shardings(model, mesh), axis_rules(DEFAULT_RULES, mesh)
    with scope:
        trainer = Trainer(
            model, dataset, args.ckpt_dir,
            train_step=step_fn, ckpt_every=args.ckpt_every,
            watchdog=StragglerWatchdog(), device=args.device, shardings=shardings,
        )
        t0 = time.time()
        state = trainer.restore_or_init()
        start_step = trainer.start_step(state)
        for step in range(start_step, args.steps):
            state, metrics = trainer._step(state, trainer.batch_at(step))
            if (step + 1) % args.log_every == 0 or step == start_step:
                if rank == 0:
                    print(f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}  "
                          f"lr {float(metrics['lr']):.2e}  gnorm {float(metrics['grad_norm']):.3f}", flush=True)
                trainer.metrics_history.append({k: float(v) for k, v in metrics.items()})
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                trainer.ckpt.save_async(step + 1, state)
        trainer.ckpt.wait()
    dt = time.time() - t0
    steps_done = args.steps - start_step
    if rank == 0:
        print(f"done: {steps_done} steps in {dt:.1f}s "
              f"({steps_done * args.batch * args.seq / max(dt, 1e-9):.0f} tok/s)", flush=True)
        if args.metrics_out:
            Path(args.metrics_out).write_text(json.dumps(trainer.metrics_history, indent=1))


def _rank(rank: int, world: int, args: argparse.Namespace) -> None:
    train(args, rank)


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
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("DATA", "MODEL"), default=None,
                    help="shard over a (data, model) mesh, one process per rank (torchrun, or --spawn)")
    ap.add_argument("--spawn", action="store_true", help="with --mesh: start the ranks here")
    ap.add_argument("--backend", default=None,
                    help="process group backend (default: gloo on the host, gloo_staged for ranks on the card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if not args.mesh:
        return train(args)
    world = args.mesh[0] * args.mesh[1]
    on_card = args.device.startswith("cuda")
    backend = args.backend or ("gloo_staged" if on_card else "gloo")
    if args.spawn:
        from repro_torch.launch.ranks import run_ranks

        run_ranks(_rank, world, (args,), store_dir=Path(args.ckpt_dir) / ".rendezvous", backend=backend,
                  timeout=24 * 3600.0)
        return None
    import torch.distributed as dist

    if backend == "gloo_staged":  # gloo, DTensor's collectives staged through host buffers
        from repro_torch.parallel import staged

        staged.install()
        backend = "gloo"
    dist.init_process_group(backend)  # torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR/PORT
    try:
        if int(os.environ["WORLD_SIZE"]) != world:
            ap.error(f"--mesh {args.mesh} needs {world} ranks, torchrun started {os.environ['WORLD_SIZE']}")
        train(args, dist.get_rank())
    finally:
        dist.destroy_process_group()
    return None


if __name__ == "__main__":
    main()
