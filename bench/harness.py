"""The benchmark's one general run, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  Each
piece is a file the harness finds by name, and nothing here names a cell:

- ``bench/configs/<config>.json``: the deployment, the step's work as data,
  and three module names: ``inputs`` (``bench/inputs/<inputs>.py``, the
  fields made from the seed), ``reference`` (``bench/reference/<reference>.py``,
  the plain reference) and ``check`` (``bench/checks/<check>.py``, the
  comparison that decides ``correct``);
- ``bench/traffic/<traffic>.json``: the ``driver`` (``bench/drivers/<driver>.py``,
  the entry point the window drives), the ``loop`` (``bench/loops/<loop>.py``,
  set-up, the window and the traced extras) and their parameters;
- ``bench/workloads/<cell>.json``: the cell's limits for the check;
- ``bench/metrics/<name>.py``: the reader of each metric, end-to-end
  (``<name>``) or per-layer (``<family>.<cell>``, read by ``<family>.py``).

A run, on every rank (one process a card): the driver builds its session,
the loop runs set-up, the window and, with ``--trace 1``, its traced extras,
and keeps the states the check compares; the program's fields are freed
once the peak of device memory has been read; then the check compares the
kept states with the reference.  ``run.py`` turns the ranks' records into
the result line through the metric readers.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
BANNED = ("jax", "jaxlib", "flax", "repro")  # whole top-level names: the port is repro_torch


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py``: a driver, loop, check, reference, inputs or metric module."""
    return importlib.import_module(f"bench.{kind}.{name}")


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def load(cell: str, seed: int, seconds: float, trace: bool,
         config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Everything a run of ``cell`` needs, as plain data (ranks get a copy);
    ``config`` replaces keys of the cell's configuration (a small domain on
    the CPU)."""
    bench = _json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        names = [w["name"] for w in bench["workloads"]]
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has {names}")
    cfg = _json(ROOT / next(c["file"] for c in bench["configs"] if c["name"] == wl["config"]))
    cfg.update(config or {})
    traffic = _json(BENCH / "traffic" / f"{wl['traffic']}.json")
    cellfile = _json(BENCH / "workloads" / f"{cell}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
    return {"cell": cell, "chips": int(wl["chips"]), "cfg": cfg, "traffic": traffic,
            "limits": cellfile["limits"], "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
            "e2e": e2e, "per_layer": per_layer}


class Ranks:
    """Synchronize and agree across the ranks (a no-op on one)."""

    def __init__(self, world: int, device):
        import torch

        self.world, self.device, self.torch = world, device, torch
        self.card = device.type == "cuda"

    def sync(self):
        if self.card:
            self.torch.cuda.synchronize(self.device)

    def barrier(self):
        self.sync()
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(**({"device_ids": [self.device.index]} if self.card else {}))

    def max(self, x: float) -> float:
        if self.world == 1:
            return float(x)
        import torch.distributed as dist

        t = self.torch.tensor([float(x)], dtype=self.torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())


def run_rank(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's run: its record for the metric readers, with the check's
    numbers under ``checks`` and what it reports of the state under ``state``."""
    import torch

    card = spec["device"] == "cuda"
    device = torch.device("cuda", rank) if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    ranks = Ranks(world, device)
    cfg, traffic = spec["cfg"], spec["traffic"]
    sess = module("drivers", traffic["driver"]).build(cfg, traffic, spec["seed"], device, rank, world)
    record, kept = module("loops", traffic["loop"]).run(spec, sess, ranks, device)
    record.update(rank=rank, where=dict(sess.where))
    record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if card else 0
    record["kind"] = torch.cuda.get_device_name(device) if card else "cpu"
    sess.free()
    del sess
    if card:
        torch.cuda.empty_cache()
    check = module("checks", cfg["check"])
    record["checks"], record["state"] = check.compare(spec, kept, record, device, ranks)
    record["banned"] = banned_modules()
    return record
