"""One process per rank: spawn a process group, run a function on every rank.

The reference runs every device from one controller; the port runs one
process per rank, as PyTorch does.  ``run_ranks(fn, world_size, ...)``
spawns ``world_size`` processes (the ``spawn`` start method: each imports
afresh), joins them into one process group over a ``file://`` store, calls
``fn(rank, world_size, *args)`` in each and returns the ranks' results in
rank order.  No TCP port is needed, so many such groups can run side by
side on one host.

A rank that raises or dies, or a run that outlasts ``timeout``, fails the
whole run: every rank still alive is terminated and ``RankError`` names the
first fault.  The process group's own timeout is ``timeout`` too, so an
exchange that waits for a dead peer raises instead of hanging.

``fn`` must be importable by name (a module-level function of a module the
children can import), and so must everything in ``args``.  Results travel
back pickled; large arrays are better written to files by the rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Sequence


class RankError(RuntimeError):
    """A rank failed, died or hung."""


def _rank_main(fn, rank: int, world_size: int, args, store: str, backend: str, timeout: float,
               results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the host's cores
    if backend == "gloo_staged":  # gloo, DTensor's collectives staged through host buffers
        from repro_torch.parallel import staged

        staged.install()
        backend = "gloo"
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), *, store_dir, backend: str = "gloo",
              timeout: float = 120.0) -> List[Any]:
    """``[fn(rank, world_size, *args) for each rank]``, each in its own
    process of one ``backend`` process group, with one CPU thread;
    ``"gloo_staged"`` is gloo with ``parallel.staged.install()`` (ranks that
    share one card).
    ``store_dir`` holds the ``file://`` rendezvous (a fresh file per run)."""
    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    store = store_dir / f"rendezvous.{os.getpid()}.{time.monotonic_ns()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, r, world_size, tuple(args), str(store), backend, float(timeout), results))
             for r in range(world_size)]
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"{dead[0].name} exited with code {dead[0].exitcode} before reporting")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world_size)) - set(out))
                    raise RankError(f"ranks {missing} did not finish within {timeout:.0f} s")
                continue
            if not ok:
                raise RankError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RankError(f"{p.name} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        results.close()
        store.unlink(missing_ok=True)
    return [out[r] for r in range(world_size)]
