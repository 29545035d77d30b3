"""The device trace of a short profiled window, reduced to what the
per-layer readers and the result's ``breakdown`` take: the window's length,
the seconds in which the device ran an operation, the kernels' own seconds,
the costliest device operations, and the longest idle gaps named by what the
host was doing when each began.

``torch.profiler`` traces the card through CUPTI; the trace is written to a
temporary directory, read back and deleted."""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def profile(fn: Callable[[], None], device) -> Dict[str, Any]:
    """Run ``fn`` (which ends in a synchronize) under the profiler and reduce
    its trace; with no card, the host's events alone (no device numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            with record_function(WINDOW):
                fn()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    return reduce(events.get("traceEvents", events) if isinstance(events, dict) else events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Seconds of the window, of device busy time, of kernels (NCCL's
    excluded: they wait on peers as much as they work), and the top ten
    device operations (by kernel name, without its arguments) and idle gaps."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    clipped = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])), e) for e in dev]
    clipped = [(a, b, e) for a, b, e in clipped if b > a]
    busy = _union([(a, b) for a, b, _e in clipped])
    by_name: Dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    for a, b, e in clipped:
        by_name[e["name"].split("(")[0]] += b - a
        if e.get("cat") == "kernel" and "nccl" not in e["name"].lower():
            kernel_us += b - a
    host = [e for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        inner = [e for e in host if float(e["ts"]) <= g0 < float(e["ts"]) + float(e["dur"])]
        name = min(inner, key=lambda e: float(e["dur"]))["name"] if inner else "host: no traced operation"
        gaps[name] += g1 - g0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_events": len(clipped),
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in top_gaps],
    }
