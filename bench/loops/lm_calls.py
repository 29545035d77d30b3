"""The ``calls`` loop (``bench/loops/calls.py``: set-up, the window, the
states kept) with traced extras for an entry that launches tens of
thousands of kernels a call, as an LM's decode steps do:

1. a burst of calls timed on the host, each begun right after a synchronize;
2. ``TRACE_CALLS`` calls with the session's counters reset and read after
   (for the LM driver: its device probe, CUDA events at each span's bounds
   and its device counts), not profiled;
3. one call under the profiler, reduced by ``reduce`` below: the same
   record as ``bench/trace.py``'s, but each idle gap is named by a sweep
   over the host's events in time order, where ``bench/trace.py`` scans
   every host event for every gap, which at some 20k kernels a call and
   several times as many host events does not finish in a run's time.

The record's ``trace``: ``steps`` (the counters' window), ``host_s_per_step``,
``counters``, ``exec_info``, and the profiled call's ``profiled_steps``,
``window_s``, ``busy_s``, ``kernel_s``, ``device_ops`` and ``idle_gaps``.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List

from bench.loops import calls
from bench.trace import DEVICE_CATS, HOST_CATS, WINDOW, _union

HOST_BURSTS = 3
TRACE_CALLS = 3


def run(spec: Dict[str, Any], sess, ranks, device):
    record, kept = calls.run(dict(spec, trace=False), sess, ranks, device)
    if spec["trace"]:
        kept["final"] = calls._clone(kept["final"])
        record["trace"] = _traced(sess, ranks, device)
    return record, kept


def _traced(sess, ranks, device) -> Dict[str, Any]:
    host = []
    for _ in range(HOST_BURSTS):
        ranks.barrier()
        t0 = time.perf_counter()
        sess.call(None)
        host.append((time.perf_counter() - t0) / sess.steps)
    ranks.barrier()
    infos: List[dict] = []
    sess.reset_counters()
    for _ in range(TRACE_CALLS):
        infos.append({})
        sess.call(infos[-1])
    ranks.sync()
    counters = sess.counters()

    def window():
        sess.call(None)
        ranks.sync()

    red = profile(window, device)
    return {"steps": TRACE_CALLS * sess.steps, "host_s_per_step": statistics.median(host), "counters": counters,
            "exec_info": json.loads(json.dumps(infos, default=repr)), "profiled_steps": sess.steps, **red}


def profile(fn, device) -> Dict[str, Any]:
    """Run ``fn`` (which ends in a synchronize) under the profiler and reduce its trace."""
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


def reduce(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``bench/trace.py``'s reduction in one sweep: the window, device busy
    time, kernel time (NCCL's excluded), the top ten device operations and
    idle gaps, each gap named by the innermost host event that holds its
    start (of nested events, the one begun last; ``host: no traced
    operation`` where none does)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    clipped = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
            if b > a:
                clipped.append((a, b, e))
    busy = _union([(a, b) for a, b, _e in clipped])
    by_name: Dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    for a, b, e in clipped:
        by_name[e["name"].split("(")[0]] += b - a
        if e.get("cat") == "kernel" and "nccl" not in e["name"].lower():
            kernel_us += b - a
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    open_: List[Any] = []  # host events begun and not known to have ended, the latest begun on top
    i = 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        while i < len(host) and host[i][0] <= g0:
            while open_ and open_[-1][1] <= host[i][0]:
                open_.pop()
            open_.append(host[i])
            i += 1
        while open_ and open_[-1][1] <= g0:
            open_.pop()
        gaps[open_[-1][2] if open_ else "host: no traced operation"] += g1 - g0
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
