"""Multi-pod dry run: one step of every (arch × shape × mesh) cell on a fake
process group, with no device memory and no data.

The reference package's ``repro/launch/dryrun.py`` lowers and compiles each
cell for 512 placeholder host devices and reads XLA's memory and cost
analyses.  The port's counterpart is a ``FakeTensorMode`` trace over a fake
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, seen from rank 0:
the state, batch and cache are DTensors built with ``DTensor.from_local`` on
fake local shards placed by ``launch.specs`` (made under the mode, which
they carry), and one train step (with the reference's
``TRAIN_MICROBATCHES``), one prefill or one decode step runs on them under
the walk of ``launch.hlo_count``.  The report keeps the reference's
keys:

* ``memory.argument_bytes``: the rank's shard bytes of state, batch and cache;
* ``memory.output_bytes`` / ``memory.temp_bytes``: the bytes the step's
  operations allocated that are still alive at its end, and the rest of
  their peak (beyond the arguments);
* ``cost`` and ``walked``: the walk's flops, bytes and collectives;
* ``collectives`` (per kind, count and bytes) and ``collective_link_bytes``
  (the reference's ring model).

Hand-written kernels do not run on fake tensors (their wrappers give the
output's shape only), so their work is not in ``cost``; the full configs
attend with ``chunked`` in the plain operations the walk counts.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch

The fake group is global to the process: ``lower_cell`` makes it and
destroys it before it returns.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, get_shape, list_archs
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import build_model
from repro_torch.models.layers import ParamTree, map_tree, tree_leaves
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
from repro_torch.runtime.loop import TrainState, make_train_step

from .hlo_count import CostWalk
from .specs import (
    batch_shardings,
    cache_shardings,
    cache_specs,
    param_shardings,
    serve_batch_shardings,
    serve_input_specs,
    state_shardings,
    train_state_specs,
)

# microbatch counts keeping per-device live activations bounded at train_4k
TRAIN_MICROBATCHES = {
    "deepseek-coder-33b": 8,
    "command-r-35b": 8,
    "stablelm-12b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "moonshot-v1-16b-a3b": 8,
    "recurrentgemma-2b": 4,
    "phi3-mini-3.8b": 4,
    "whisper-medium": 4,
    "internvl2-1b": 4,
    "mamba2-370m": 4,
}

PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _collective_link_bytes(colls: Dict[str, Any]) -> float:
    """Ring-model per-device link traffic (bytes) from collective sums."""
    total = 0.0
    for kind, rec in colls.items():
        b = rec["bytes"] if isinstance(rec, dict) else rec
        total += 2.0 * b if kind == "all-reduce" else b
    return total


@contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0;
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group: one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextmanager
def _alltoall_on_any_device():
    """Let DTensor move a shard from one dimension to another by all-to-all
    on a CPU mesh too: its CPU fallback (an all-gather, then a chunk) would
    stand in for the all-to-all the card runs, at the full tensor's size."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._group_or_group_name(funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def _local_shape(shape, mesh, placements):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] = math.ceil(local[p.dim] / mesh.size(i))
    return tuple(local)


def _fake_leaf(meta: torch.Tensor, sharding, device) -> torch.Tensor:
    """A DTensor of ``meta``'s global shape and dtype over a fake local shard."""
    from torch.distributed.tensor import DTensor

    placements = sharding.placements()
    local = torch.empty(_local_shape(meta.shape, sharding.mesh, placements), dtype=meta.dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, placements, run_check=False, shape=meta.shape,
                              stride=torch.empty(meta.shape, device="meta").stride())


def _fake_tree(tree: Any, shardings: Any, device) -> Any:
    flat = dict(tree_leaves(shardings))
    return map_tree(lambda path, t: _fake_leaf(t, flat[path], device), tree)


def _local_bytes(tree: Any) -> int:
    total = 0
    for _p, t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def lower_cell(arch: str, shape_id: str, multi_pod: bool, *, reduced: bool = False,
               mesh_shape: Optional[Sequence[int]] = None, device: str = "cuda") -> Dict[str, Any]:
    """One cell's step on a fake mesh (the production mesh, or ``mesh_shape``
    over the same axis names), its tensors fake ones on ``device`` (nothing is
    allocated but small real index tensors the model makes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_mesh

    entry = get_arch(arch)
    cfg = entry.reduced if reduced else entry.full
    shape = get_shape(shape_id)
    model = build_model(cfg)
    mesh_dims, axes = PRODUCTION_MESHES[multi_pod]
    mesh_dims = tuple(mesh_shape or mesh_dims)
    axes = axes[-len(mesh_dims):]
    n_dev = math.prod(mesh_dims)
    report: Dict[str, Any] = {"arch": arch, "shape": shape_id, "mesh": "x".join(map(str, mesh_dims)),
                              "devices": n_dev, "kind": shape.kind}
    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    walk = CostWalk(fake)
    # the step counters are host scalars (real): the schedule reads them
    steps = torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    with fake_world(n_dev):
        mesh = make_mesh(mesh_dims, axes, device_type=torch.device(device).type)
        with axis_rules(DEFAULT_RULES, mesh), fake:
            if shape.kind == "train":
                batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                         for k, s in make_batch_specs(cfg, shape).items()}
                st = train_state_specs(model)
                sh = state_shardings(model, mesh)
                params = ParamTree(_fake_tree(st.params.to_tree(), sh.params, device)).trainable_()
                opt = OptState(step=steps[1], m=_fake_tree(st.opt.m, sh.opt.m, device),
                               v=_fake_tree(st.opt.v, sh.opt.v, device))
                state = TrainState(step=steps[0], params=params, opt=opt)
                fbatch = _fake_tree(batch, batch_shardings(mesh, batch), device)
                args = (state, fbatch)
                fn = make_train_step(model, microbatches=TRAIN_MICROBATCHES.get(arch, 1))
            else:
                batch = serve_input_specs(cfg, shape.kind, shape.seq_len, shape.global_batch)
                cache = cache_specs(model, shape.global_batch, shape.seq_len)
                params = ParamTree(_fake_tree(model.abstract_params().to_tree(), param_shardings(model, mesh),
                                              device))
                fbatch = _fake_tree(batch, serve_batch_shardings(mesh, batch), device)
                fcache = _fake_tree(cache, cache_shardings(mesh, cache), device)
                if "enc_kv" in fbatch:  # the reference's stacked pair → the port's per-layer pairs
                    k, v = fbatch["enc_kv"]
                    fbatch["enc_kv"] = [(k[i], v[i]) for i in range(cfg.n_layers)]
                args = (params, fbatch, fcache)
                fn = model.prefill if shape.kind == "prefill" else model.decode_step
            report["memory"] = {"argument_bytes": _local_bytes(args)}
        # the step runs outside the mode: the fake leaves carry it, and
        # DTensor's own index arithmetic (on real tensors) stays real
        cpu_mesh = mesh.device_type == "cpu"
        with axis_rules(DEFAULT_RULES, mesh), (_alltoall_on_any_device() if cpu_mesh else nullcontext()), walk:
            out = fn(*args)
        live_at_end = walk.live_bytes
        del out
    report["lower_compile_s"] = round(time.time() - t0, 2)
    mem = report["memory"]
    mem["output_bytes"] = int(live_at_end)
    mem["temp_bytes"] = int(walk.peak_bytes - live_at_end)
    mem["total_per_device_bytes"] = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    walked = walk.totals()
    report["cost"] = {"flops": walked["flops"], "bytes_accessed": walked["bytes"], "transcendentals": 0.0}
    colls = {k: {"count": walk.counts[k], "bytes": v} for k, v in walked["collectives"].items()}
    report["collectives"] = colls
    report["collective_link_bytes"] = _collective_link_bytes(colls)
    report["walked"] = {**walked, "collective_link_bytes": _collective_link_bytes(walked["collectives"])}
    return report


def lower_stencil_cell(multi_pod: bool, *, global_ij: int = 8192, nk: int = 64, backend: str = "torch",
                       dtype: str = "float64", device: str = "cuda") -> Dict[str, Any]:
    """The paper's own workload at production scale: distributed horizontal
    diffusion (halo exchange + the local stencil) on rank 0's block.  The
    exchange posts point-to-point messages; where the fake group does not
    take them, the report says so and the cell fails."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.stencils.distributed import DistributedStencil
    from repro_torch.stencils.hdiff import build_hdiff

    mesh_dims, _axes = PRODUCTION_MESHES[multi_pod]
    gi = global_ij * (2 if multi_pod else 1)
    report: Dict[str, Any] = {"arch": f"stencil-hdiff-{backend}" + ("-f32" if dtype == "float32" else ""),
                              "shape": f"{gi}x{global_ij}x{nk}", "mesh": "x".join(map(str, mesh_dims)),
                              "devices": math.prod(mesh_dims), "kind": "stencil"}
    st = build_hdiff(backend, dtype=dtype)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    walk = CostWalk(fake)
    t0 = time.time()
    with fake_world(math.prod(mesh_dims)):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=torch.device(device).type)
        ni, nj = gi // (mesh_dims[-2] * (2 if multi_pod else 1)), global_ij // mesh_dims[-1]
        with fake:
            dt = getattr(torch, dtype)
            fields = {"in_phi": torch.empty((ni, nj, nk), dtype=dt, device=device),
                      "out_phi": torch.empty((ni, nj, nk), dtype=dt, device=device)}
            report["memory"] = {"argument_bytes": _local_bytes(fields)}
            try:
                dist_st = DistributedStencil(st, mesh, i_axis="data", j_axis="model")
                with walk:
                    out = dist_st(fields, {"alpha": 0.05})
            except Exception as e:  # noqa: BLE001 — reported, and the cell fails
                report["error"] = f"the fake process group did not take the halo exchange: {type(e).__name__}: {e}"
                raise StencilCellError(report) from e
            live_at_end = walk.live_bytes
            del out
    report["lower_compile_s"] = round(time.time() - t0, 2)
    mem = report["memory"]
    mem["output_bytes"], mem["temp_bytes"] = int(live_at_end), int(walk.peak_bytes - live_at_end)
    mem["total_per_device_bytes"] = sum(mem.values())
    walked = walk.totals()
    report["cost"] = {"flops": walked["flops"], "bytes_accessed": walked["bytes"]}
    report["collectives"] = {k: {"count": walk.counts[k], "bytes": v} for k, v in walked["collectives"].items()}
    report["collective_link_bytes"] = _collective_link_bytes(report["collectives"])
    report["walked"] = {**walked, "collective_link_bytes": report["collective_link_bytes"]}
    return report


class StencilCellError(RuntimeError):
    """The stencil cell failed; ``report`` says why."""

    def __init__(self, report: Dict[str, Any]):
        super().__init__(report["error"])
        self.report = report


def cells_for(arch: str):
    return list(get_arch(arch).shapes)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--stencil", action="store_true", help="run the distributed-stencil (paper workload) cell")
    ap.add_argument("--stencil-dtype", default="float64")
    ap.add_argument("--device", default="cuda", help="device of the fake tensors (cpu on a host without a card)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.stencil:
        for multi_pod in meshes:
            tag = f"stencil-hdiff_{'multi' if multi_pod else 'single'}" + (
                "_f32" if args.stencil_dtype == "float32" else "")
            try:
                report = lower_stencil_cell(multi_pod, dtype=args.stencil_dtype, device=args.device)
            except StencilCellError as e:
                (outdir / f"{tag}.json").write_text(json.dumps(e.report, indent=1))
                raise SystemExit(f"FAIL {tag}: {e}") from e
            (outdir / f"{tag}.json").write_text(json.dumps(report, indent=1))
            print(f"OK   {tag}: {report['lower_compile_s']}s, colls {report['walked']['collectives']}")
        return

    if args.all:
        targets = [(a, s) for a in list_archs() for s in cells_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        targets = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_id in targets:
        for multi_pod in meshes:
            tag = f"{arch}_{shape_id}_{'multi' if multi_pod else 'single'}"
            path = outdir / f"{tag}.json"
            try:
                report = lower_cell(arch, shape_id, multi_pod, device=args.device)
                path.write_text(json.dumps(report, indent=1))
                mem_gb = report["memory"]["total_per_device_bytes"] / 2**30
                print(f"OK   {tag}: {report['lower_compile_s']}s, {mem_gb:.2f} GiB/dev, "
                      f"flops {report['cost']['flops']:.3e}, link {report['collective_link_bytes']:.3e} B", flush=True)
            except Exception as e:  # noqa: BLE001
                failures += 1
                path.with_suffix(".error.txt").write_text(traceback.format_exc())
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
