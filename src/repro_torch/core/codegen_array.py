"""Source generators for the ``numpy`` and ``torch`` backends.

``numpy`` mirrors the paper's NumPy backend (vectorized slices, in-place
writes).  ``torch`` is the same program on torch tensors: in-place slice
writes and Python k-loops for FORWARD/BACKWARD sweeps, on whatever device
the fields live on.  It is the plain PyTorch version of the generated CUDA
kernel (``codegen_cuda.py``): the CPU tests run it against the reference
package, and on the card the kernel is held against it.

Horizontal stage tiling (``numpy_stage_tiling``, the numpy analogue of the
Pallas ``(BI, BJ)`` block schedule): PARALLEL multi-stages are emitted as
loops over ``(TI, TJ)`` tiles of the compute domain, with every stage's
vectorized slice clamped to the current tile (extended by the stage's
compute extent, like the Pallas halo'd tile DMA).  One tile's whole stage
chain runs before the next tile starts, so intermediate temporaries stay
cache-resident instead of streaming the full domain per statement — the
cache-blocking transform of the paper's CPU backends.  Legality is the
recompute-in-overlap argument: boundary tiles recompute extended regions,
which is value-preserving only when no stage writes a field that an
earlier-or-same stage reads (no anti-dependency), checked structurally per
multi-stage; failing multi-stages fall back to untiled emission.  The tile
is a runtime knob (``run(..., block=)``) defaulting to the baked
``_BLOCK_DEFAULT``, so the autotuner (``core/autotune.py``) can time
candidate tiles exactly the way it does for Pallas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import ir
from .codegen_common import (
    ArrayExprPrinter,
    ArrayStmtEmitter,
    Emitter,
    TorchExprPrinter,
    bound_expr,
    emit_helpers,
    emit_parallel_block,
    multistage_plan,
    temp_alloc_shape,
)

# default (TI, TJ) tile for the tiled numpy backend — row-major arrays want
# long contiguous j-runs; 64×128 float64 ≈ 64 KB per field slab (L2-sized
# once a few stages are live)
DEFAULT_NUMPY_TILE: Tuple[int, int] = (64, 128)


def _written_api_fields(impl: ir.StencilImplementation) -> List[str]:
    return list(impl.written_api_fields())


def _ms_tileable(ms: ir.MultiStage) -> bool:
    """A PARALLEL multi-stage tiles when every per-tile read provably sees
    per-tile-written (or never-written) data.  Two structural conditions,
    checked per interval (an interval's tiles all complete before the next
    interval starts, so cross-interval flow is always safe):

    * **no anti-dependency** — no stage writes a field that an
      earlier-or-same stage reads.  Boundary tiles recompute their
      extent-extended overlap regions; an anti-dependency would make the
      recomputation see modified inputs (``o = o + t`` double-applies).
    * **writer coverage** — for every read of a field some stage in the
      interval writes, every writer's compute extent must cover the
      reader's region shifted by the read offset.  The extent fixpoint
      guarantees this for temporaries (they are computed on their full
      required extent), but API fields are only ever written on the bare
      compute domain: a later stage reading one at a horizontal offset (or
      over an extended region) would reach into a neighboring tile whose
      write has not run yet — a miscompile the backend-differential fuzzer
      corpus pins (``_t_api_feedback``)."""
    if ms.order != ir.IterationOrder.PARALLEL:
        return False
    for itv in ms.intervals:
        writer_exts: Dict[str, List[ir.Extent]] = {}
        for st in itv.stages:
            for w in st.writes:
                writer_exts.setdefault(w, []).append(st.compute_extent)
        seen_reads: set = set()
        for st in itv.stages:
            for stmt in st.stmts:
                for rname, off in ir.stmt_reads(stmt):
                    seen_reads.add(rname)
                    for wext in writer_exts.get(rname, ()):
                        need = st.compute_extent.add_offset((off[0], off[1], 0))
                        if (
                            wext.i[0] > need.i[0]
                            or wext.i[1] < need.i[1]
                            or wext.j[0] > need.j[0]
                            or wext.j[1] < need.j[1]
                        ):
                            return False
            if seen_reads & set(st.writes):
                return False
    return True


def tiling_plan(impl: ir.StencilImplementation) -> Dict[str, int]:
    """Per-stencil tiling summary (how many multi-stages the legality check
    admits) — shared by the code generator and the build-time pass report."""
    tiled = untileable = sequential = 0
    for ms in impl.multi_stages:
        if ms.order != ir.IterationOrder.PARALLEL:
            sequential += 1
        elif _ms_tileable(ms):
            tiled += 1
        else:
            untileable += 1
    return {
        "tiled_multistages": tiled,
        "untileable_multistages": untileable,
        "sequential_multistages": sequential,
    }


def generate_array_source(
    impl: ir.StencilImplementation,
    lib: str,
    tile: Optional[Tuple[int, int]] = None,
) -> str:
    """Generate module source for lib in {'np', 'torch'}.

    ``tile`` (numpy only) emits tile-blocked PARALLEL multi-stages with the
    given default ``(TI, TJ)`` and a ``block=`` override on ``run``."""
    if lib not in ("np", "torch"):
        raise ValueError(f"unknown array library {lib!r}")
    if tile is not None and lib != "np":
        raise ValueError("stage tiling is numpy-only")

    axes_of = {f.name: f.axes for f in impl.all_fields}
    dtype_of = {f.name: f.dtype for f in impl.all_fields}

    if lib == "torch":
        printer: ArrayExprPrinter = TorchExprPrinter(impl, axes_of, dtype_of)
    else:
        printer = ArrayExprPrinter(impl, lib, axes_of, dtype_of)

    body = Emitter()
    body.push()  # inside def run

    body.line("ni, nj, nk = domain")
    if tile is not None:
        body.line("_TI, _TJ = block or _BLOCK_DEFAULT")
    for f in impl.api_fields:
        body.line(f"{f.name} = fields['{f.name}']")
        body.line(f"_oi_{f.name}, _oj_{f.name}, _ok_{f.name} = origins['{f.name}']")
    for s in impl.scalars:
        if lib == "torch":
            # python scalars: weak in torch's type promotion, host-side values
            body.line(f"{s.name} = _scalar(scalars['{s.name}'])")
        else:
            body.line(f"{s.name} = scalars['{s.name}']")
    if impl.temporaries:
        body.line("# --- temporaries (never observable outside the stencil, paper §2.2)")
    if lib == "torch" and impl.api_fields:
        body.line(f"_dev = {impl.api_fields[0].name}.device")
    for t in impl.temporaries:
        shape, origin = temp_alloc_shape(impl, t.name)
        if lib == "torch":
            body.line(f"{t.name} = torch.zeros({shape}, dtype=torch.{t.dtype}, device=_dev)")
        else:
            body.line(f"{t.name} = np.zeros({shape}, dtype='{t.dtype}')")
        body.line(f"_oi_{t.name}, _oj_{t.name}, _ok_{t.name} = {origin}")

    for mi, ms in enumerate(impl.multi_stages):
        body.line(f"# === multi-stage {mi}: {multistage_plan(ms)}")
        if ms.order == ir.IterationOrder.PARALLEL:
            if tile is not None and _ms_tileable(ms):
                _emit_tiled_parallel_ms(impl, printer, body, ms, mi)
            else:
                _emit_parallel_ms(impl, printer, body, ms, mi)
        else:
            _emit_sequential_ms(impl, printer, body, ms, mi)
    body.line("return None")

    # ---- assemble module
    backend = "torch" if lib == "torch" else "numpy"
    out = Emitter()
    out.line(f'"""Auto-generated by repro_torch.core — stencil {impl.name!r}, backend {backend!r}."""')
    if lib == "torch":
        out.line("import torch")
        float_dt = next((f.dtype for f in impl.api_fields if f.dtype.startswith("float")), "float64")
        out.line(f"_FDT = torch.{float_dt}")
        out.line("def _scalar(x):")
        out.push()
        out.line("return x.item() if hasattr(x, 'item') else x")
        out.pop()
    else:
        out.line("import numpy as np")
    emit_helpers(out, printer.used_helpers, lib)
    # metadata mirroring the cuda module exports, so the autotuner can build
    # synthetic arguments and time candidate tiles uniformly
    h = impl.max_halo
    api = {f.name for f in impl.api_fields}
    out.line(f"_BACKEND = {backend!r}")
    out.line(f"_H = {max(h[0], h[1])}")
    out.line(f"_SCALARS = {[s.name for s in impl.scalars]!r}")
    out.line(f"_AXES = {dict(sorted((n, axes_of[n]) for n in api))!r}")
    out.line(f"_DTYPES = {dict(sorted((n, dtype_of[n]) for n in api))!r}")
    if lib == "np":
        out.line(f"_TILING = {tiling_plan(impl)!r}")
    if tile is not None:
        out.line(f"_BLOCK_DEFAULT = {tuple(tile)!r}")
    out.line()
    if tile is not None:
        out.line("def run(fields, scalars, domain, origins, block=None):")
    else:
        out.line("def run(fields, scalars, domain, origins):")
    return out.source() + body.source()


_emit_parallel_ms = emit_parallel_block


def _emit_tiled_parallel_ms(
    impl: ir.StencilImplementation,
    printer: ArrayExprPrinter,
    body: Emitter,
    ms: ir.MultiStage,
    mi: int,
) -> None:
    """A PARALLEL multi-stage as (TI, TJ) tile loops: each tile runs the
    whole stage chain (over the tile extended by each stage's compute
    extent) before the next tile starts — temporaries stay cache-hot."""
    for ii, itv in enumerate(ms.intervals):
        k0, k1 = f"_k0_{mi}_{ii}", f"_k1_{mi}_{ii}"
        body.line(f"{k0} = {bound_expr(itv.interval.start)}")
        body.line(f"{k1} = {bound_expr(itv.interval.end)}")
        printer.mode = "block"
        printer.k0, printer.k1 = k0, k1
        body.line("for _t0 in range(0, ni, _TI):")
        body.push()
        body.line("_t1 = min(_t0 + _TI, ni)")
        body.line("for _u0 in range(0, nj, _TJ):")
        body.push()
        body.line("_u1 = min(_u0 + _TJ, nj)")
        printer.irange = ("_t0", "_t1")
        printer.jrange = ("_u0", "_u1")
        emitter = ArrayStmtEmitter(printer, body)
        for st in itv.stages:
            printer.extent = st.compute_extent
            for stmt in st.stmts:
                emitter.stmt(stmt)
        printer.irange = ("0", "ni")
        printer.jrange = ("0", "nj")
        body.pop()
        body.pop()


def _emit_sequential_ms(
    impl: ir.StencilImplementation,
    printer: ArrayExprPrinter,
    body: Emitter,
    ms: ir.MultiStage,
    mi: int,
) -> None:
    """Plain python k-loops (in-place plane writes), numpy and torch alike."""
    backward = ms.order == ir.IterationOrder.BACKWARD
    for ii, itv in enumerate(ms.intervals):
        k0, k1 = f"_k0_{mi}_{ii}", f"_k1_{mi}_{ii}"
        body.line(f"{k0} = {bound_expr(itv.interval.start)}")
        body.line(f"{k1} = {bound_expr(itv.interval.end)}")
        printer.mode = "plane"
        if backward:
            body.line(f"for k in range({k1} - 1, {k0} - 1, -1):")
        else:
            body.line(f"for k in range({k0}, {k1}):")
        body.push()
        body.line("pass")
        emitter = ArrayStmtEmitter(printer, body)
        for st in itv.stages:
            printer.extent = st.compute_extent
            for stmt in st.stmts:
                emitter.stmt(stmt)
        body.pop()


def generate_numpy_source(
    impl: ir.StencilImplementation, tile: Optional[Tuple[int, int]] = None
) -> str:
    return generate_array_source(impl, "np", tile=tile)


def generate_torch_source(impl: ir.StencilImplementation) -> str:
    return generate_array_source(impl, "torch")
