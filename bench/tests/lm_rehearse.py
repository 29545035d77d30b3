"""A run of an LM decode cell without the command's look for a card, with
a fault or the check's control planted under the timed path
(``lm_faults.py``).

    python bench/tests/lm_rehearse.py <cell> [fault]
    python bench/tests/lm_rehearse.py <cell> [fault] --card --seed <n> [<n> ...] --seconds <s> [--trace 1]

prints a result line a seed.  By default it runs on the CPU at a small size
(the model's shape, every width cut: ``SMALL``); with ``--card``, at the
cell's own size on its card.  Several seeds run one after the other in the
same process."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# one dense layer, then two MoE layers of 8 experts (2 a token, 2 shared)
SMALL = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
         "intermediate_size": 96, "vocab_size": 512, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
         "moe_intermediate_size": 16, "n_shared_experts": 2, "batch": 6, "prompt": 44}


def runs(cell: str, fault=None, seeds=(2**33 + 7,), seconds: float = 0.3, trace: bool = False,
         card: bool = False):
    """The result line of each seed's run."""
    import torch

    from bench import harness
    from bench.run import result, setup_environment
    from bench.tests import lm_faults

    spec = harness.load(cell, seeds[0], seconds, trace, None if card else SMALL)
    if card:
        setup_environment()
    spec.update(device="cuda" if card else "cpu")
    if fault:
        getattr(lm_faults, fault)(spec)
    for seed in seeds:
        gc.collect()
        if card and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        rec = harness.run_rank(0, 1, dict(spec, seed=int(seed), start=time.time()))
        device = {"platform": "gpu" if card else "cpu", "kind": rec["kind"], "count": 1,
                  "memory_peak_bytes": rec["memory_peak_bytes"]}
        out = result(dict(spec, seed=int(seed)), [rec], device)
        out["banned"] = sorted(set(harness.banned_modules()) | set(rec["banned"]))
        out.update(fault=fault, seed=int(seed))
        yield out


def run(cell: str, fault=None, **kw) -> dict:
    """One run's result line (on the CPU at the small size unless ``card``)."""
    return next(iter(runs(cell, fault, **kw)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("fault", nargs="?")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--seed", type=int, nargs="+", default=[2**33 + 7])
    ap.add_argument("--seconds", type=float, default=0.3)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for out in runs(a.cell, a.fault, a.seed, a.seconds, bool(a.trace), a.card):
        for name, c in out["checks"].items():
            print(f"check {name} (seed {out['seed']}): {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
