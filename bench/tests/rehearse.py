"""A run of one cell without the command's look for a card, with a fault
or the check's control planted under the timed path (``faults.py``).

    python bench/tests/rehearse.py <cell> [fault]
    python bench/tests/rehearse.py <cell> [fault] --card --seed <n> [<n> ...] --seconds <s> [--trace 1]

prints a result line a seed, with the modules of JAX or the reference
package the run loaded under ``banned``.  By default it runs on the CPU at
a small size; with ``--card``, at the cell's own size on the cards it asks
for (the readings of the control and of a fault at a cell's size).  Several
seeds run one after the other in the same processes, which start once; the
port keeps each run's prepared launchers, with their scratch, so a few
seeds a process at a cell's size."""

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

SMALL = {"domain": [12, 10, 6]}
MEMBERS = 4


def faulted_rank(rank: int, world: int, spec, fault, seeds):
    """One rank's runs, a seed each, with ``fault`` (a function of
    ``faults.py``) planted in the program first, in the rank's own process."""
    import torch

    from bench import harness
    from bench.tests import faults

    if fault:
        getattr(faults, fault)(spec)
    records = []
    for seed in seeds:
        gc.collect()
        if spec["device"] == "cuda" and torch.cuda.is_initialized():  # a later seed: the peak anew
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(torch.device("cuda", rank))
        records.append(harness.run_rank(rank, world, dict(spec, seed=int(seed), start=time.time())))
    return records


def runs(cell: str, fault=None, seeds=(2**33 + 7,), seconds: float = 0.3, trace: bool = False,
         card: bool = False):
    """The result line of each seed's run."""
    from bench import harness
    from bench.run import result, run_cell, setup_environment

    spec = harness.load(cell, seeds[0], seconds, trace, None if card else SMALL)
    if not card and int(spec["cfg"].get("members", 1)) > 1:
        spec["cfg"]["members"] = MEMBERS
    if card:
        setup_environment()
    spec.update(device="cuda" if card else "cpu", start=time.time())
    per_rank = run_cell(spec, faulted_rank, (fault, tuple(seeds)))
    for i, seed in enumerate(seeds):
        ranks = [r[i] for r in per_rank]
        device = {"platform": "gpu" if card else "cpu", "kind": ranks[0]["kind"], "count": spec["chips"],
                  "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
        out = result(dict(spec, seed=int(seed)), ranks, device)
        out["banned"] = sorted(set(harness.banned_modules()).union(*(r["banned"] for r in ranks)))
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
            print(f"check {name} (seed {out['seed']}): {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
