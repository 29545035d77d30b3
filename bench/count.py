"""The yardstick of the per-layer shares: a step's least time on the card.

The work of one step is data in the configuration's file (``step``): which
fields the step reads, with the horizontal halo it reads of each, which it
leaves changed for the caller, and the arithmetic operations per point of
each definition on its first level, its inner levels and its last level
(counted from the definitions by hand; ``bench/tests`` checks the sums).
Temporaries that the definitions pass between stencils count nothing.  So
the count is the same whatever kernels implement the step.

The least time is the larger of the bytes over the card's memory bandwidth
and the operations over its peak rate in the configuration's dtype; on a
domain split over chips, the work divides over them.  Peaks: NVIDIA H100
SXM data sheet (dense, no sparsity, at the full 700 W).
"""

from __future__ import annotations

from typing import Any, Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}


def step_work(cfg: Dict[str, Any]) -> Dict[str, float]:
    """Bytes and operations of one step of every member on the whole domain."""
    ni, nj, nk = (int(d) for d in cfg["domain"])
    members = int(cfg.get("members", 1))
    shared = set(cfg.get("shared", ()))
    size = ITEMSIZE[cfg["dtype"]]
    step = cfg["step"]
    nbytes = 0
    for name, (hi, hj) in step["reads"].items():
        nbytes += (ni + 2 * hi) * (nj + 2 * hj) * nk * size * (1 if name in shared else members)
    for name in step["writes"]:
        nbytes += ni * nj * nk * size * members
    per_column = sum(first + last + (nk - 2) * inner for first, inner, last in step["ops_per_point"].values())
    ops = per_column * ni * nj * members
    return {"bytes": float(nbytes), "ops": float(ops)}


def least_seconds(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The least time of one step on one chip of the configuration's mesh
    (the work divided over its chips), and which of bytes or operations
    bounds it."""
    work = step_work(cfg)
    chips = 1
    for n in cfg.get("mesh") or (1,):
        chips *= int(n)
    t_bytes = work["bytes"] / chips / HBM_BYTES_PER_S
    t_ops = work["ops"] / chips / PEAK_FLOPS[cfg["dtype"]]
    return {"seconds": max(t_bytes, t_ops), "bound": "bytes" if t_bytes >= t_ops else "operations", **work}
