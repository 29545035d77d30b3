# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""The rank programs of the port's distributed tests.

``tests/test_torch_distributed.py`` and
``tests/test_torch_program_distributed.py`` run these on 8 CPU ranks of one
gloo process group (``repro_torch.launch.ranks.run_ranks``), once per test
file.  Each rank takes the same global NumPy inputs, runs its own block, and
rank 0 returns the gathered global results for the tests to check.  This
module imports neither JAX nor the reference package: it is what every
spawned rank imports.
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gtscript
from repro_torch.core.gtscript import PARALLEL, Field, computation, interval
from repro_torch.launch.mesh import axis_size, make_host_mesh, make_mesh
from repro_torch.parallel import halo
from repro_torch.program import ProgramError, program, request_exchange
from repro_torch.stencils.distributed import DistributedStencil
from repro_torch.stencils.hdiff import build_hdiff
from repro_torch.stencils.library import laplacian

BACKEND = "cuda"  # on CPU tensors its stencils run their plain torch modules
EXCHANGE_CASES = (  # (mesh shape over ("data", "model"), periodic, halo)
    ((4, 2), (False, False), 2),
    ((4, 2), (True, True), 2),
    ((8, 1), (True, True), 2),
    ((2, 4), (True, False), 1),
)
NT = 10
SCALARS = {"dx": 1.0, "dy": 1.0, "dt": 0.1, "alpha": 0.05}


def shift_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a[-1, 0, 0]


def diffuse_defs(phi: Field[np.float64], out: Field[np.float64], *, alpha: np.float64):
    with computation(PARALLEL), interval(...):
        out = phi + alpha * laplacian(phi)


def advect_defs(phi: Field[np.float64], u: Field[np.float64], v: Field[np.float64],
                adv: Field[np.float64], *, dx: np.float64, dy: np.float64):
    with computation(PARALLEL), interval(...):
        fx = (phi[0, 0, 0] - phi[-1, 0, 0]) / dx if u > 0.0 else (phi[1, 0, 0] - phi[0, 0, 0]) / dx
        fy = (phi[0, 0, 0] - phi[0, -1, 0]) / dy if v > 0.0 else (phi[0, 1, 0] - phi[0, 0, 0]) / dy
        adv = -(u * fx + v * fy)


def euler_defs(phi: Field[np.float64], adv: Field[np.float64], out: Field[np.float64], *, dt: np.float64):
    with computation(PARALLEL), interval(...):
        out = phi + dt * adv


def build_step(backend: str = BACKEND):
    """The three stencils and the reference tests' ``dist_climate`` program."""
    build = gtscript.stencil(backend=backend)
    advect, euler, diffuse = build(advect_defs), build(euler_defs), build(diffuse_defs)

    @program(backend=backend, name="dist_climate")
    def step(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
        advect(phi, u, v, adv, dx=dx, dy=dy)
        euler(phi, adv, phi_star, dt=dt)
        diffuse(phi_star, phi_new, alpha=alpha)
        return {"phi": phi_new, "phi_new": phi}

    @program(backend=backend, name="dist_forced")
    def fstep(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
        request_exchange(phi, 2)
        advect(phi, u, v, adv, dx=dx, dy=dy)
        euler(phi, adv, phi_star, dt=dt)
        diffuse(phi_star, phi_new, alpha=alpha)
        return {"phi": phi_new, "phi_new": phi}

    @program(backend=backend, name="dist_open")
    def open_step(phi, u, v, adv, *, dx, dy):
        advect(phi, u, v, adv, dx=dx, dy=dy)
        return {"tendency": adv}

    return (advect, euler, diffuse), step, fstep, open_step


def _everyone(value):
    """``value`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _local(x: np.ndarray, mesh, member_axis=None) -> torch.Tensor:
    return halo.shard_blocks(torch.from_numpy(x), mesh, member_axis=member_axis).contiguous()


def _global(t: torch.Tensor, mesh, member_axis=None) -> np.ndarray:
    return halo.gather_blocks(t, mesh, member_axis=member_axis).numpy()


def stencil_cases(rank: int, world: int, inputs: dict):
    """DistributedStencil (hdiff, the periodic shift), the exchange itself on
    several meshes, and the meshes' sizes."""
    out = {}
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    host = make_host_mesh("cpu")
    out["mesh"] = {"data": axis_size(mesh, "data"), "model": axis_size(mesh, "model"),
                   "host": axis_size(host, "data"), "host_names": list(host.mesh_dim_names)}

    x = _local(inputs["hdiff_in"], mesh)
    d = DistributedStencil(build_hdiff(BACKEND), mesh)
    halo.reset_message_counts()
    res = d({"in_phi": x, "out_phi": torch.zeros_like(x)}, {"alpha": 0.05})
    out["messages"] = _everyone(halo.message_counts())
    out["hdiff_written"] = sorted(res)
    out["hdiff_input_kept"] = bool(torch.equal(x, _local(inputs["hdiff_in"], mesh)))
    out["hdiff"] = _global(res["out_phi"], mesh)

    shift = DistributedStencil(gtscript.stencil(backend=BACKEND)(shift_defs), mesh, periodic=(True, True))
    a = _local(inputs["shift_in"], mesh)
    out["shift"] = _global(shift({"a": a, "o": torch.zeros_like(a)}, {})["o"], mesh)

    out["exchange"] = []
    for shape, periodic, h in EXCHANGE_CASES:
        m = make_mesh(shape, ("data", "model"), "cpu")
        halo.reset_message_counts()
        padded = halo.exchange_halo_2d(_local(inputs["exchange_in"], m), h, m, periodic=periodic)
        out["exchange"].append({"blocks": _global(padded, m), "messages": _everyone(halo.message_counts())})
    return out if rank == 0 else None


def _eager_chain(stencils, mesh, f):
    """NT steps of the three stencils, one DistributedStencil call each a
    step (every field each takes exchanged), on this rank's blocks ``f``."""
    sc = SCALARS
    d_advect, d_euler, d_diffuse = (DistributedStencil(s, mesh) for s in stencils)
    for _ in range(NT):
        f["adv"] = d_advect({"phi": f["phi"], "u": f["u"], "v": f["v"], "adv": f["adv"]},
                            {"dx": sc["dx"], "dy": sc["dy"]})["adv"]
        f["phi_star"] = d_euler({"phi": f["phi"], "adv": f["adv"], "out": f["phi_star"]}, {"dt": sc["dt"]})["out"]
        new = d_diffuse({"phi": f["phi_star"], "out": f["phi_new"]}, {"alpha": sc["alpha"]})["out"]
        f["phi"], f["phi_new"] = new, f["phi"]
    return f


def _fresh(inputs, mesh):
    phi0, u0, v0 = (inputs[k] for k in ("phi0", "u0", "v0"))
    f = {"phi": phi0, "u": u0, "v": v0}
    f.update({n: np.zeros_like(phi0) for n in ("adv", "phi_star", "phi_new")})
    return {n: _local(a, mesh) for n, a in f.items()}


def _profiled_annotations(fn):
    """The names of the user annotations a CPU profile of ``fn()`` holds."""
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "user_annotation"})


def program_cases(rank: int, world: int, inputs: dict):
    """The distributed program against the eager chain of DistributedStencils,
    its forced marker, iterate, open outputs, and the ensemble over members x
    domain."""
    out = {}
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    (advect, euler, diffuse), step, fstep, open_step = build_step()
    sc = dict(SCALARS)

    out["eager"] = _global(_eager_chain((advect, euler, diffuse), mesh, _fresh(inputs, mesh))["phi"], mesh)

    # the program: the minimal plan, NT calls with host-side rotation
    dp = step.distribute(mesh)
    g = _fresh(inputs, mesh)
    info = {}
    halo.reset_message_counts()
    for t in range(NT):
        o = dp(g, sc, exec_info=info if t == 0 else None)
        g["phi"], g["phi_new"] = o["phi"], o["phi_new"]
    out["program_messages"] = _everyone(halo.message_counts())
    out["program"] = _global(g["phi"], mesh)
    out["report"] = info["program_report"]
    out["timings"] = info["rank_timings"]

    info = {}
    fdp = fstep.distribute(mesh)
    fdp(_fresh(inputs, mesh), sc, exec_info=info)
    out["forced_ops"] = info["program_report"]["halo_plan"]["ops"]

    info = {}
    halo.reset_message_counts()
    final = dp.iterate(NT, _fresh(inputs, mesh), sc, exec_info=info)
    out["iterate_messages"] = _everyone(halo.message_counts())
    out["iterate_timings"] = _everyone(info["rank_timings"])
    out["coords"] = _everyone((int(mesh.get_local_rank("data")), int(mesh.get_local_rank("model"))))
    out["iterate"] = _global(final["phi"], mesh)
    out["iterate_report"] = info["program_report"]
    out["profiled"] = _profiled_annotations(lambda: dp.iterate(2, _fresh(inputs, mesh), sc))

    f = {n: _local(inputs[k], mesh) for n, k in (("phi", "phi0"), ("u", "u0"), ("v", "v0"))}
    f["adv"] = torch.zeros_like(f["phi"])
    try:
        open_step.distribute(mesh).iterate(3, f, {"dx": sc["dx"], "dy": sc["dy"]})
        out["open_raised"] = False
    except ProgramError:
        out["open_raised"] = True

    # members x domain: members over "ens", tiles over (data, model)
    emesh = make_mesh((2, 2, 2), ("ens", "data", "model"), "cpu")
    dens = step.ensemble(inputs["members"].shape[0]).distribute(emesh, member_axis="ens")
    members = inputs["members"]
    e = {"phi": _local(members, emesh, "ens"), "u": _local(inputs["u0"], emesh), "v": _local(inputs["v0"], emesh)}
    e.update({n: torch.zeros_like(e["phi"]) for n in ("adv", "phi_star", "phi_new")})
    info = {}
    halo.reset_message_counts()
    o = dens(e, sc, exec_info=info)
    out["ensemble_messages"] = _everyone(halo.message_counts())
    out["ensemble"] = _global(o["phi"], emesh, "ens")
    out["ensemble_report"] = info["ensemble_report"]
    return out if rank == 0 else None


def failing_rank(rank: int, world: int):
    if rank == world - 1:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hanging_rank(rank: int, world: int):
    import time

    time.sleep(600)


def card_mesh_shape(world: int):
    return (world // 2, 2) if world % 2 == 0 else (world, 1)


def card_cases(rank: int, world: int, inputs: dict, one_card: bool):
    """On the card: hdiff through DistributedStencil and the dist_climate
    program against its eager chain, the meshes and stencils at their
    defaults (``device_type="cuda"``, the ``cuda`` backend).  All ranks share
    card 0 (``one_card``; gloo) or each has its own (nccl)."""
    from repro_torch.core import codegen_cuda, storage

    dev = torch.device("cuda", 0 if one_card else rank)
    torch.cuda.set_device(dev)
    mesh = make_mesh(card_mesh_shape(world), ("data", "model"))

    def card(x: np.ndarray, m=mesh) -> torch.Tensor:
        block = halo.shard_blocks(torch.from_numpy(x), m)
        t = storage.card_tensor(block.shape, torch.float64, dev)
        t.copy_(block)
        return t

    out = {"device_type": mesh.device_type, "backend": dist.get_backend()}
    hd = build_hdiff()
    x = card(inputs["hdiff_in"])
    codegen_cuda.reset_launch_counts()
    res = DistributedStencil(hd, mesh)({"in_phi": x, "out_phi": torch.zeros_like(x)}, {"alpha": 0.05})
    torch.cuda.synchronize()
    out["hdiff_launches"] = hd.launches
    out["hdiff"] = _global(res["out_phi"], mesh)

    (advect, euler, diffuse), step, _fstep, _open = build_step()
    sc = dict(SCALARS)
    fresh = {"phi": inputs["phi0"], "u": inputs["u0"], "v": inputs["v0"]}
    fresh.update({n: np.zeros_like(inputs["phi0"]) for n in ("adv", "phi_star", "phi_new")})
    f = _eager_chain((advect, euler, diffuse), mesh, {n: card(a) for n, a in fresh.items()})
    dp = step.distribute(mesh)
    g = {n: card(a) for n, a in fresh.items()}
    groups = dp.plan(g, sc).group_objects
    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()
    final = dp.iterate(NT, g, sc)
    torch.cuda.synchronize()
    out["program_launches"] = [o.launches for o in groups]
    out["all_launches"] = sum(codegen_cuda.launch_counts().values())
    out["exchanges"] = halo.message_counts()["exchanges"]
    out["program_equals_eager"] = bool(torch.equal(final["phi"], f["phi"]))
    everyone = _everyone({k: out[k] for k in ("program_launches", "all_launches", "exchanges",
                                               "program_equals_eager", "hdiff_launches")})
    return {**out, "ranks": everyone} if rank == 0 else None


def compressed_allreduce(rank: int, world: int, grads: np.ndarray, errors: np.ndarray) -> dict:
    """``tests/test_torch_compression.py``: rank r mean-reduces ``grads[r]``
    with int8 payloads, once plainly and once with the carried error
    ``errors[r]`` (error feedback); returns its results and residuals."""
    from repro_torch.runtime.compression import dp_allreduce_compressed, dp_allreduce_compressed_ef

    g = torch.from_numpy(grads[rank])
    plain = dp_allreduce_compressed({"g": g, "stack": [g[:3].to(torch.bfloat16)]})
    reduced, residual = dp_allreduce_compressed_ef({"g": g}, {"g": torch.from_numpy(errors[rank])})
    return {"mean": plain["g"].numpy(), "bf16": plain["stack"][0].float().numpy(),
            "bf16_dtype": str(plain["stack"][0].dtype), "ef_mean": reduced["g"].numpy(),
            "residual": residual["g"].numpy()}


def exchange_under_a_walk(rank, world):
    """One 1-deep exchange on (2, 2) under an active ``CostWalk``: the
    messages this rank posted and received, the messages the walk recorded
    (none on a real group), and whether each rim holds its neighbour's
    stripe (every block filled with its rank's number); and the error of an
    exchange whose ``post`` hook is the walk's (it takes only the dry run's
    fake group)."""
    from repro_torch.launch.hlo_count import CostWalk

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    ex = halo.HaloExchange(mesh)
    padded = torch.zeros(6, 6, 1, dtype=torch.float64)
    halo.interior(padded, 1).fill_(float(rank))
    before = halo.message_counts()
    with CostWalk() as walk:
        ex.fill(padded, 1)
    after = halo.message_counts()
    ci, cj = int(mesh.get_local_rank("data")), int(mesh.get_local_rank("model"))
    other_i, other_j = (1 - ci) * 2 + cj, ci * 2 + (1 - cj)
    rim_i = padded[5 if ci == 0 else 0, 1:5, 0]  # the i rim toward the other data rank
    rim_j = padded[1:5, 5 if cj == 0 else 0, 0]
    try:
        halo.HaloExchange(mesh, post=walk.record_messages).fill(padded, 1)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"recorded": len(walk.messages), "sent": after["send"] - before["send"],
            "received": after["recv"] - before["recv"],
            "rims_right": bool((rim_i == other_i).all() and (rim_j == other_j).all()),
            "walk_hook_refused": refused}
