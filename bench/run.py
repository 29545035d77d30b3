"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's calls), ``failed`` (the compared numbers over
their limit), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit,
which also end standard error.  Without enough cards, or with JAX or the
reference package loaded, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

RANK_TIMEOUT_S = 330.0  # every rank's whole run, and the process group's timeout: inside the 360 s a run has


def setup_environment() -> None:
    """Every cache the program builds into lives at a fixed path in the checkout."""
    os.environ["REPRO_TORCH_GT_CACHE"] = str(ROOT / ".gt_cache_torch")


def run_cell(spec, rank_fn=None, args=()):
    """The rank records of one run (one process a card): ``rank_fn(rank,
    world, spec, *args)``, by default ``harness.run_rank``."""
    rank_fn = rank_fn or harness.run_rank
    if spec["chips"] == 1:
        return [rank_fn(0, 1, spec, *args)]
    import tempfile

    from repro_torch.launch.ranks import run_ranks

    backend = "nccl" if spec["device"] == "cuda" else "gloo"
    return run_ranks(rank_fn, spec["chips"], (spec, *args), store_dir=tempfile.gettempdir(),
                     backend=backend, timeout=RANK_TIMEOUT_S)


def read_metrics(spec, ranks, metrics) -> dict:
    """Each metric's value, by its reader (``bench/metrics/<name>.py``, or
    ``<family>.py`` for ``<family>.<cell>``); a reader that finds nothing
    leaves its metric out."""
    ctx = {"spec": spec, "ranks": ranks}
    out = {}
    for m in metrics:
        value = harness.module("metrics", m["name"].removesuffix("." + spec["cell"])).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(spec, ranks, device: dict) -> dict:
    """The result line from the ranks' records (rank 0 first)."""
    r0 = ranks[0]
    checks = r0["checks"]
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    out = {"correct": failed == 0, "attempted": r0["attempted"], "failed": failed}
    if spec["trace"]:
        out["metrics"] = read_metrics(spec, ranks, spec["per_layer"])
        tr = [r.get("trace") or {} for r in ranks]
        out["device"] = dict(device, busy_s=sum(t.get("busy_s", 0.0) for t in tr) / len(tr),
                             window_s=sum(t.get("window_s", 0.0) for t in tr) / len(tr))
        out["breakdown"] = {k: tr[0].get(k, []) for k in ("device_ops", "idle_gaps")}
    else:
        out["metrics"] = read_metrics(spec, ranks, spec["e2e"])
        out["device"] = device
    out["state"] = dict(r0["state"], **{k: r0[k] for k in ("steps", "window_s") if k in r0})
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.load(args.workload, args.seed, args.seconds, bool(args.trace))
    setup_environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {spec['chips']} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    spec.update(device="cuda", start=START)
    ranks = run_cell(spec)
    banned = sorted(set(harness.banned_modules()).union(*(r["banned"] for r in ranks)))
    if banned:
        print(f"bench: modules of {banned} were loaded; the benchmark runs the port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": ranks[0]["kind"], "count": spec["chips"],
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    out = result(spec, ranks, device)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
