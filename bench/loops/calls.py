"""Whole calls of the entry back to back: the loop of a model that advances
its state ``steps`` steps between outputs.

1. set-up: one call, which compiles; the state after it is kept (the
   check's first comparison, from the seeded fields); then a few calls that
   time a call, to size the window;
2. the window: whole calls until about ``--seconds`` have passed, ended by
   a synchronize (and, across ranks, a barrier); the state before the last
   call is copied once, before that call, and the state after it kept;
3. with ``--trace 1``: a burst of calls timed on the host, each begun right
   after a synchronize, then a short profiled window with the session's
   counters and each call's ``exec_info``.

The record: ``setup_s``, ``window_s``, ``attempted`` (the window's calls), ``steps``,
``steps_per_call`` and, traced, ``trace`` (``steps``, ``host_s_per_step``,
``counters``, ``exec_info`` and the profiler's reduction, ``bench/trace.py``).
The kept states: ``first``, ``before`` and ``final``, each the session's
``state()``.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Any, Dict, List

SIZING_CALLS = 2  # calls in set-up that time a call, to size the window
HOST_BURSTS = 5  # traced run: calls timed on the host, each begun after a synchronize
TRACE_CALLS = 3  # traced run: calls under the profiler (30 steps: a trace of some hundred kernels)


def _clone(state):
    import torch

    return {k: v.clone(memory_format=torch.contiguous_format) for k, v in state.items()}


def run(spec: Dict[str, Any], sess, ranks, device):
    import torch

    # set-up: the first call compiles; its result is the first one checked
    sess.call(None)
    ranks.sync()
    first = _clone(sess.state())
    ranks.barrier()
    t0 = time.perf_counter()
    for _ in range(SIZING_CALLS):
        sess.call(None)
    ranks.barrier()
    per_call = ranks.max((time.perf_counter() - t0) / SIZING_CALLS)
    n_calls = max(2, int(round(spec["seconds"] / per_call)))
    before = {k: torch.empty_like(v) for k, v in first.items()}

    # the window
    ranks.barrier()
    t0 = time.perf_counter()
    setup_s = time.time() - spec["start"]
    for i in range(n_calls):
        if i == n_calls - 1:
            for k, v in sess.state().items():
                before[k].copy_(v)
        sess.call(None)
    ranks.barrier()
    window_s = time.perf_counter() - t0
    record: Dict[str, Any] = {"setup_s": setup_s, "window_s": window_s, "attempted": n_calls,
                              "steps": n_calls * sess.steps, "steps_per_call": sess.steps}
    final = sess.state()
    if spec["trace"]:
        final = _clone(final)
        record["trace"] = _traced(sess, ranks, device)
    return record, {"first": first, "before": before, "final": final}


def _traced(sess, ranks, device) -> Dict[str, Any]:
    """Host time a step, then a short profiled window with the counters."""
    from bench import trace

    host = []
    for _ in range(HOST_BURSTS):
        ranks.barrier()
        t0 = time.perf_counter()
        sess.call(None)
        host.append((time.perf_counter() - t0) / sess.steps)
    ranks.barrier()
    infos: List[dict] = []
    sess.reset_counters()

    def window():
        for _ in range(TRACE_CALLS):
            infos.append({})
            sess.call(infos[-1])
        ranks.sync()

    red = trace.profile(window, device)
    return {"steps": TRACE_CALLS * sess.steps, "host_s_per_step": statistics.median(host),
            "counters": sess.counters(), "exec_info": json.loads(json.dumps(infos, default=repr)), **red}
