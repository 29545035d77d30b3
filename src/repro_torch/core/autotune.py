"""Horizontal tile-size autotuning for the ``cuda`` and ``numpy`` backends.

The code generators bake one block into a module (the ``cuda`` kernel's
``BLOCK``, the numpy module's ``_BLOCK_DEFAULT``), but the best ``(BI, BJ)``
depends on the domain, the stencil's on-chip footprint and the balance of
staging and compute — the schedule knob the paper argues the toolchain (not
the user) should turn.  This module times a small set of candidate blocks on
synthetic inputs shaped from the module's field metadata (warmup, then
best-of-N) and picks the fastest.

Results are **keyed on the pass-aware cache fingerprint** from
``core/caching.py`` and persisted as ``rt_<name>_<fp>.tune.json`` next to the
generated module, so a second build of the identical IR + options is a pure
cache hit — the search never reruns.  A different ``opt_level`` / pass set /
codegen option is a different fingerprint and tunes (and persists)
independently.  The chosen block and per-candidate timings surface through
``exec_info["autotune"]`` on the stencil call.

On the card (the reference package's ``repro/core/autotune.py`` tunes Pallas
TPU tiles instead):

* a candidate is a thread block ``dim3(BJ, BI)``: at most 1024 threads,
  ``BJ`` a multiple of 32 (J is the stride-1 axis of the card layout, one
  warp a row), and the block's shared memory (the module's
  ``_smem_bytes(bi, bj)``) within ``codegen_cuda.SMEM_MAX``;
* ``BI`` and ``BJ`` are constants of the generated source, so every
  candidate is its own ``nvcc`` build: all of them start before the first is
  waited on, and a build that fails raises (no candidate is silently
  dropped);
* the synthetic fields are made on the card in the card layout
  (``storage.card_tensor``), which is how ``storage`` allocates the ``cuda``
  backend's fields, and each candidate's launch is prepared once and timed
  with CUDA events;
* a member-batched shape (``batch_count`` not ``None``) is timed through the
  member-batched kernel, ``gridDim.z`` = members, exactly as an ``Ensemble``
  launches it, with the fields the call shares among members shared.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as otrace

from . import caching

# (BI, BJ) thread blocks for the generated CUDA kernel: J, the stride-1 axis,
# in whole warps; the i side sets how many blocks share the card's 132 SMs
# (256 x 256 at the default (8, 32): 256 blocks).  The module's own block is
# always added.  Each candidate is one nvcc build.
DEFAULT_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (2, 64),
    (4, 32),
    (4, 64),
    (8, 32),
    (8, 64),
    (16, 32),
)

# (TI, TJ) candidates for the tiled numpy backend (codegen_array stage
# tiling): row-major arrays want long contiguous j-runs; the i side sets the
# L2 working-set of a tile's live stage chain.
DEFAULT_NUMPY_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (32, 64),
    (32, 128),
    (64, 128),
    (64, 256),
    (128, 128),
)

MAX_THREADS = 1024  # threads in one H100 block
WARP = 32


def _is_numpy_module(module) -> bool:
    return getattr(module, "_BACKEND", None) == "numpy"


def _is_cuda_module(module) -> bool:
    return hasattr(module, "CUDA_SOURCE")


_lock = threading.Lock()
_memory: Dict[Tuple[str, str, str], Dict[str, Any]] = {}


def _default_block(module) -> Tuple[int, int]:
    if _is_cuda_module(module):
        return tuple(module.BLOCK)
    return tuple(getattr(module, "_BLOCK_DEFAULT", (8, 128)))


def _fits_card(module, bi: int, bj: int) -> bool:
    from .codegen_cuda import SMEM_MAX

    return bi * bj <= MAX_THREADS and bj % WARP == 0 and module._smem_bytes(bi, bj) <= SMEM_MAX


def candidate_blocks(
    module,
    domain: Tuple[int, int, int],
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
) -> List[Tuple[int, int]]:
    """Domain-clamped, footprint-filtered, deduplicated candidate blocks.

    A ``cuda`` module keeps blocks of at most 1024 threads whose ``BJ`` is a
    multiple of 32 and whose shared memory fits ``SMEM_MAX``; ``BJ`` clamps
    to the domain in whole warps."""
    ni, nj, nk = domain
    cuda = _is_cuda_module(module)
    defaults = DEFAULT_NUMPY_CANDIDATES if _is_numpy_module(module) else DEFAULT_CANDIDATES
    cands = [tuple(c) for c in (candidates or defaults)]
    default = _default_block(module)
    if default not in cands:
        cands.insert(0, default)

    def clamp(bi, bj):
        if cuda:
            return (min(int(bi), ni), min(int(bj), -(-nj // WARP) * WARP))
        return (min(int(bi), ni), min(int(bj), nj))

    seen: set = set()
    out: List[Tuple[int, int]] = []
    for bi, bj in cands:
        eff = clamp(bi, bj)
        if eff in seen:
            continue
        seen.add(eff)
        if cuda and not _fits_card(module, *eff):
            continue
        out.append(eff)
    if not out:  # every candidate over budget: the clamped default
        out.append(clamp(*default))
    return out


def _synthetic_call_args(module, domain: Tuple[int, int, int], batch: Optional[int] = None):
    """Fields/scalars/origins for timing a numpy module, built from its
    metadata: mutable host arrays (its generated ``run`` writes fields in
    place), uniform in [0.5, 1.5] — away from zero so division-heavy stencils
    (Thomas solvers) stay finite, with enough variation that no arithmetic
    folds away.  ``batch`` prepends a member axis to every field."""
    ni, nj, nk = domain
    H = int(getattr(module, "_H", 0))
    rng = np.random.default_rng(0)
    fields: Dict[str, Any] = {}
    origins: Dict[str, Tuple[int, int, int]] = {}
    for name, axes in module._AXES.items():
        dtype = module._DTYPES[name]
        if axes == ("I", "J", "K"):
            shape: Tuple[int, ...] = (ni + 2 * H, nj + 2 * H, nk)
            origins[name] = (H, H, 0)
        elif axes == ("I", "J"):
            shape = (ni + 2 * H, nj + 2 * H)
            origins[name] = (H, H, 0)
        else:
            shape = (nk,)
            origins[name] = (0, 0, 0)
        if batch is not None:
            shape = (batch,) + shape
        fields[name] = np.asarray(0.5 + rng.random(shape), dtype=dtype)
    scalars = {s: 0.5 for s in module._SCALARS}
    return fields, scalars, origins


def _card_call_args(module, domain: Tuple[int, int, int], operand_shapes=None, batch: Optional[int] = None,
                    member_scalars: Sequence[str] = ()):
    """Fields/scalars/origins for timing a ``cuda`` module on the card.

    Every field has the largest halo of the stencil's fields around the
    domain (origin ``(H, H, 0)``), as the climate step's fields do, and IJK
    fields are allocated in the card layout.  With ``batch``, a field is
    member-batched when the call's ``operand_shapes`` give it the extra
    leading axis (every field when the shapes do not name it) and shared
    otherwise; each per-member scalar takes ``batch`` values."""
    import torch

    from .storage import card_tensor

    ni, nj, nk = domain
    H = max([0] + [max(-ilo, ihi, -jlo, jhi) for *_x, (ilo, ihi, jlo, jhi) in module.FIELDS])
    shapes = dict(operand_shapes or ())
    gen = torch.Generator(device="cuda").manual_seed(0)
    fields: Dict[str, Any] = {}
    origins: Dict[str, Tuple[int, int, int]] = {}
    for name, axes, dtype, _written, _ext in module.FIELDS:
        full = {"I": ni + 2 * H, "J": nj + 2 * H, "K": nk}
        shape: Tuple[int, ...] = tuple(full[a] for a in axes)
        batched = batch is not None and (name not in shapes or len(shapes[name]) == len(axes) + 1)
        if batched:
            shape = (batch,) + shape
        tdt = getattr(torch, dtype)
        values = 0.5 + torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)
        if len(shape) in (3, 4) and tuple(axes) == ("I", "J", "K"):
            t = card_tensor(shape, tdt, "cuda").copy_(values)
        else:
            t = values.to(tdt)
        fields[name] = t
        origins[name] = (H if "I" in axes else 0, H if "J" in axes else 0, 0)
    scalars: Dict[str, Any] = {
        s: ((0.5,) * batch if batch is not None and s in member_scalars else 0.5) for s, _dt in module.SCALARS
    }
    return fields, scalars, origins


def batch_count(module, operand_shapes) -> Optional[int]:
    """The leading member-batch extent implied by the operand shapes, or
    ``None`` for an unbatched call (ranks match the module's field axes)."""
    if not operand_shapes:
        return None
    if _is_cuda_module(module):
        axes = {name: ax for name, ax, *_ in module.FIELDS}
    else:
        axes = module._AXES
    for name, shape in operand_shapes:
        if name in axes and len(shape) == len(axes[name]) + 1:
            return int(shape[0])
    return None


def _time_numpy_block(module, fields, scalars, domain, origins, block, warmup: int, iters: int,
                      batch: Optional[int] = None) -> float:
    """Best-of-``iters`` host wall time of one tiled numpy call, in µs; a
    batched shape is timed member by member, as host backends run members."""
    # synchronous host execution: nothing to wait on.  The generated run()
    # writes fields in place, so each candidate gets a fresh copy of the
    # synthetic data — otherwise recurrence stencils would drift values
    # across candidates and bias the timings.
    fields = {n: np.array(v, copy=True) for n, v in fields.items()}
    members = [fields] if batch is None else [{n: v[m] for n, v in fields.items()} for m in range(batch)]

    def call():
        for mf in members:
            module.run(mf, scalars, domain, origins, block=block)

    for _ in range(max(1, warmup)):
        call()
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _time_cuda_launch(launch, warmup: int, iters: int) -> float:
    """Best-of-``iters`` card time of one prepared launch, in µs (CUDA events)."""
    import torch

    for _ in range(max(1, warmup)):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(max(1, iters)):
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def _domain_key(domain: Tuple[int, int, int], candidates, operand_shapes=None) -> str:
    """Store key for one tuning record.

    The FULL operand shapes participate alongside the compute domain: a
    member-batched run has the same ``(ni, nj, nk)`` domain as the unbatched
    one but a different balance per block, so it must never reuse a
    ``(BI, BJ)`` tuned for unbatched shapes (and vice versa).
    """
    key = "x".join(str(d) for d in domain)
    if operand_shapes:
        key += "|" + ";".join(
            f"{name}:{'x'.join(str(s) for s in shape)}" for name, shape in sorted(operand_shapes)
        )
    if candidates:
        key += "|" + ";".join(f"{bi}x{bj}" for bi, bj in candidates)
    return key


def _load_store(path) -> Dict[str, Any]:
    try:
        data = json.loads(path.read_text())
        if isinstance(data, dict) and "domains" in data:
            return data
    except (OSError, ValueError):
        pass
    return {"version": 1, "domains": {}}


def _search(module, domain, blocks, operand_shapes, batch, warmup, iters, kernels, member_scalars):
    """Time every candidate block; returns ``[{"block": [bi, bj], "us": t}]``."""
    if _is_numpy_module(module):
        fields, scalars, origins = _synthetic_call_args(module, domain, batch)
        return [
            {"block": list(b),
             "us": _time_numpy_block(module, fields, scalars, domain, origins, b, warmup, iters, batch)}
            for b in blocks
        ]
    if not _is_cuda_module(module) or kernels is None:
        raise TypeError(f"autotune: no timing route for module {getattr(module, '__name__', module)!r}")
    # every candidate is its own build: start them all, then wait on each
    # (a failed build raises with nvcc's output)
    variants = [kernels(b) for b in blocks]
    for k in variants:
        k.start_build()
    for k in variants:
        k.finish_build()
    fields, scalars, origins = _card_call_args(module, domain, operand_shapes, batch, member_scalars)
    timings = []
    for b, k in zip(blocks, variants):
        launch = k.prepare(fields, scalars, domain, origins, members=batch)
        timings.append({"block": list(b), "us": _time_cuda_launch(launch, warmup, iters)})
        del launch  # its scratch goes before the next candidate's
    return timings


def select_block(
    module,
    name: str,
    fingerprint: str,
    domain: Tuple[int, int, int],
    *,
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
    warmup: int = 1,
    iters: int = 3,
    operand_shapes=None,
    kernels: Optional[Callable[[Tuple[int, int]], Any]] = None,
    member_scalars: Sequence[str] = (),
) -> Tuple[Tuple[int, int], Dict[str, Any]]:
    """The tuned ``(BI, BJ)`` for ``domain``, searching at most once.

    ``operand_shapes`` — ``((field_name, shape), ...)`` of the actual call —
    folds the full operand geometry (member/batch axes included) into the
    store key, and batched shapes are timed as they will run.  A ``cuda``
    module needs ``kernels``: the stencil's kernel for a block (the
    member-batched one, with ``member_scalars`` per member, when the shapes
    are batched).  Returns ``(block, record)`` where ``record`` carries the
    per-candidate timings (``cache_hit`` marks a persisted result being
    reused).
    """
    domain = tuple(int(d) for d in domain)
    cands = [tuple(c) for c in candidates] if candidates else None
    operand_shapes = (
        tuple(sorted((str(n), tuple(int(x) for x in s)) for n, s in operand_shapes))
        if operand_shapes
        else None
    )
    dkey = _domain_key(domain, cands, operand_shapes)
    path = caching.tuning_path(name, fingerprint)

    with _lock:
        mem = _memory.get((name, fingerprint, dkey))
        if mem is not None:
            rec = dict(mem, cache_hit=True)
            return tuple(rec["block"]), rec
        store = _load_store(path)
        entry = store["domains"].get(dkey)
        if entry is not None:
            rec = dict(entry, cache_hit=True)
            _memory[(name, fingerprint, dkey)] = dict(entry)
            return tuple(rec["block"]), rec

    with otrace.span(
        "stencil.autotune", category="compile", stencil=name, domain=list(domain)
    ) as tsp:
        blocks = candidate_blocks(module, domain, cands)
        batch = batch_count(module, operand_shapes)
        timings = _search(module, domain, blocks, operand_shapes, batch, warmup, iters, kernels,
                          tuple(member_scalars))
        best = min(timings, key=lambda t: t["us"])
        tsp.set("candidates", len(blocks))
        tsp.set("block", list(best["block"]))
        tsp.set("cache_hit", False)
    record: Dict[str, Any] = {
        "block": list(best["block"]),
        "timings": timings,
        "domain": list(domain),
        "batch": batch,
        "cache_hit": False,
    }

    with _lock:
        persisted = {k: v for k, v in record.items() if k != "cache_hit"}
        _memory[(name, fingerprint, dkey)] = persisted
        store = _load_store(path)
        store["domains"][dkey] = persisted
        try:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            tmp.write_text(json.dumps(store, indent=2) + "\n")
            tmp.replace(path)
        except OSError:
            pass  # read-only cache: in-memory result still serves this process
    return tuple(record["block"]), record


def record_batch_observation(
    name: str,
    fingerprint: str,
    batch: int,
    us_per_step: float,
    *,
    source: str = "serving",
) -> None:
    """Merge one *observed* ``(batch size → wall)`` record into the tune store.

    The serving engine calls this with the per-step dispatch wall of batches
    it actually ran, closing the loop the other way around: ``select_block``
    writes measurements the tuner made, this writes measurements the traffic
    made.  Records land under their own ``serving|batch=N`` domain key —
    they carry ``"batch"``, so :func:`repro_torch.serving.engine.tuned_member_counts`
    picks the extents up as preferred padding targets, while the key shape
    keeps them from ever colliding with a tuner-written ``(BI, BJ)`` record.

    Concurrency: the store is read-merged-rewritten under the module lock
    with an atomic (pid-suffixed tmp + ``replace``) publish, so concurrent
    engines — or an engine racing the tuner — never clobber each other's
    *other* keys; the worst cross-process race loses one observation, never
    the store.  The best (minimum) wall wins; observation counts accumulate.
    An unwritable store is ignored — feedback is an optimization, never a
    liveness dependency."""
    path = caching.tuning_path(name, fingerprint)
    dkey = f"serving|batch={int(batch)}"
    with _lock:
        store = _load_store(path)
        prev = store["domains"].get(dkey)
        count = 1
        best = float(us_per_step)
        if isinstance(prev, dict):
            count += int(prev.get("count", 0))
            prev_us = prev.get("us_per_step")
            if isinstance(prev_us, (int, float)):
                best = min(best, float(prev_us))
        store["domains"][dkey] = {
            "batch": int(batch),
            "us_per_step": best,
            "count": count,
            "source": source,
        }
        try:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            tmp.write_text(json.dumps(store, indent=2) + "\n")
            tmp.replace(path)
        except OSError:
            pass  # read-only store: the next engine re-observes, nothing breaks
