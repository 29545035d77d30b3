"""The port's distributed program and ensemble on 8 CPU ranks, held against
the eager distributed chain, a single-domain oracle and the reference.

The module fixture spawns 8 ranks of one gloo process group once
(``launch.ranks.run_ranks``) and every rank runs
``torch_dist_ranks.program_cases`` on its own blocks; the reference's
``DistributedProgram``/``DistributedEnsemble`` run in one subprocess with 8
host devices on the same NumPy inputs.  Each test mirrors the reference test
of the same name in ``tests/test_program_distributed.py``: the program equals
the eager chain of ``DistributedStencil``s bit for bit over 10 steps, and
``iterate`` the calls; the port is held to the single-domain oracle and to
the reference within 1e-12, and its halo plans equal the reference's.  The
planner itself (``program/halo.py``, a framework-free copy) is compared with
the reference's in process.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_dist_ranks as ranks  # noqa: E402
from repro.core import gtscript as r_gtscript  # noqa: E402
from repro.program import program as r_program  # noqa: E402
from repro.program import request_exchange as r_request_exchange  # noqa: E402
from repro.program.compile import ProgramPlan as RefProgramPlan  # noqa: E402
from repro.program.graph import ProgramGraph as RefProgramGraph  # noqa: E402
from repro.program.halo import plan_halo_exchanges as r_plan_halo_exchanges  # noqa: E402
from repro.stencils import forecast as r_forecast  # noqa: E402
from repro.stencils import vadv as r_vadv  # noqa: E402
from repro_torch.core import gtscript, storage  # noqa: E402
from repro_torch.program import program, request_exchange  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.program.compile import ProgramPlan  # noqa: E402
from repro_torch.program.graph import ProgramGraph  # noqa: E402
from repro_torch.program.halo import plan_halo_exchanges  # noqa: E402
from repro_torch.stencils import climate, forecast  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
WORLD = 8
NI, NJ, NK, NT = 32, 16, 6, ranks.NT
NMEM = 4

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, {src!r})
import repro
import jax, jax.numpy as jnp
import numpy as np
from repro.core import gtscript
from repro.core.gtscript import Field, PARALLEL, computation, interval
from repro.ensemble import Ensemble
from repro.parallel.halo import request_exchange
from repro.program import program
from repro.stencils.library import laplacian

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

build = gtscript.stencil(backend="jax")
advect, euler, diffuse = build(advect_defs), build(euler_defs), build(diffuse_defs)

@program(backend="jax", name="dist_climate")
def step(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
    advect(phi, u, v, adv, dx=dx, dy=dy)
    euler(phi, adv, phi_star, dt=dt)
    diffuse(phi_star, phi_new, alpha=alpha)
    return {{"phi": phi_new, "phi_new": phi}}

@program(backend="jax", name="dist_forced")
def fstep(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
    request_exchange(phi, 2)
    advect(phi, u, v, adv, dx=dx, dy=dy)
    euler(phi, adv, phi_star, dt=dt)
    diffuse(phi_star, phi_new, alpha=alpha)
    return {{"phi": phi_new, "phi_new": phi}}

tmp, nt = sys.argv[1], int(sys.argv[2])
inp = np.load(tmp + "/inputs.npz")
sc = {{k: np.float64(v) for k, v in json.loads(sys.argv[3]).items()}}
z = jnp.zeros(inp["phi0"].shape)

def fresh():
    return {{"phi": jnp.asarray(inp["phi0"]), "u": jnp.asarray(inp["u0"]), "v": jnp.asarray(inp["v0"]),
            "adv": z, "phi_star": z, "phi_new": z}}

mesh = jax.make_mesh((4, 2), ("data", "model"))
dp = step.distribute(mesh)
g, info = fresh(), {{}}
for t in range(nt):
    o = dp(g, sc, exec_info=info if t == 0 else None)
    g["phi"], g["phi_new"] = o["phi"], o["phi_new"]
out = {{"program": np.asarray(g["phi"])}}
summary = {{"program": info["program_report"]["halo_plan"]}}
info = {{}}
fstep.distribute(mesh)(fresh(), sc, exec_info=info)
summary["forced"] = info["program_report"]["halo_plan"]
info = {{}}
out["iterate"] = np.asarray(dp.iterate(nt, fresh(), sc, exec_info=info)["phi"])
summary["iterate"] = info["program_report"]["halo_plan"]

emesh = jax.make_mesh((2, 2, 2), ("ens", "data", "model"))
members = inp["members"]
dens = Ensemble(step, members.shape[0]).distribute(emesh, member_axis="ens")
zm = jnp.zeros(members.shape)
info = {{}}
o = dens({{"phi": jnp.asarray(members), "u": jnp.asarray(inp["u0"]), "v": jnp.asarray(inp["v0"]),
          "adv": zm, "phi_star": zm, "phi_new": zm}}, sc, exec_info=info)
out["ensemble"] = np.asarray(o["phi"])
summary["ensemble"] = info["ensemble_report"]["program_report"]["halo_plan"]
np.savez(tmp + "/reference.npz", **out)
with open(tmp + "/reference.json", "w") as f:
    json.dump(summary, f)
"""


def _inputs():
    rng = np.random.default_rng(0)
    phi0 = rng.normal(size=(NI, NJ, NK))
    noise = np.random.default_rng(1).normal(size=(NMEM, NI, NJ, NK))
    return {"phi0": phi0, "u0": np.full((NI, NJ, NK), 0.8), "v0": np.full((NI, NJ, NK), -0.4),
            "members": phi0[None] + 1e-3 * noise}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results of the port, the reference's arrays, the reference's
    halo-plan summaries, the inputs)."""
    tmp = tmp_path_factory.mktemp("torch_program_distributed")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    script = tmp / "reference.py"
    script.write_text(textwrap.dedent(_REFERENCE.format(src=SRC)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, str(script), str(tmp), str(NT), json.dumps(ranks.SCALARS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = run_ranks(ranks.program_cases, WORLD, (inputs,), store_dir=tmp, timeout=120)[0]
    finally:
        _out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, f"reference subprocess failed:\n{err[-3000:]}"
    return port, dict(np.load(tmp / "reference.npz")), json.loads((tmp / "reference.json").read_text()), inputs


def _oracle(phi0, u0, v0, steps):
    """The eager chain on one zero-padded domain (the port's numpy backend):
    the boundary the mesh decomposition's edges see."""
    build = gtscript.stencil(backend="numpy")
    advect, euler, diffuse = (build(d) for d in (ranks.advect_defs, ranks.euler_defs, ranks.diffuse_defs))
    h = 1
    shape = (NI + 2 * h, NJ + 2 * h, NK)

    def pad(x):
        p = np.zeros(shape)
        p[h:-h, h:-h] = x
        return storage.from_array(p, backend="numpy", default_origin=(h, h, 0))

    s = {"phi": pad(phi0), "u": pad(u0), "v": pad(v0)}
    s.update({n: pad(np.zeros_like(phi0)) for n in ("adv", "phi_star", "phi_new")})
    sc, dom = ranks.SCALARS, (NI, NJ, NK)
    for _ in range(steps):
        advect(s["phi"], s["u"], s["v"], s["adv"], dx=sc["dx"], dy=sc["dy"], domain=dom)
        euler(s["phi"], s["adv"], s["phi_star"], dt=sc["dt"], domain=dom)
        diffuse(s["phi_star"], s["phi_new"], alpha=sc["alpha"], domain=dom)
        s["phi"], s["phi_new"] = s["phi_new"], s["phi"]
    return s["phi"].to_numpy()[h:-h, h:-h]


def test_distributed_program_bit_identical_to_eager_chain(runs):
    port, ref, ref_plans, _inputs = runs
    rep = port["report"]
    assert np.abs(port["program"] - port["eager"]).max() == 0.0  # bit-identical across 10 steps
    assert rep["fused_stencils"] >= 1
    assert rep["eliminated_temporaries"] == ["adv"]
    # minimal plan: phi before the advect group, phi_star before diffuse —
    # against six a step for the eager chain (every field of every call)
    assert rep["halo_plan"]["inserted"] == 2
    assert rep["halo_plan"]["baseline_per_step"] == 6
    assert rep["halo_plan"] == ref_plans["program"]
    assert np.abs(port["program"] - ref["program"]).max() < 1e-12


def test_distributed_program_matches_single_device(runs):
    port, _ref, _plans, inputs = runs
    oracle = _oracle(inputs["phi0"], inputs["u0"], inputs["v0"], NT)
    assert np.abs(port["program"] - oracle).max() < 1e-12


def test_forced_exchange_marker_honoured(runs):
    port, _ref, ref_plans, _inputs = runs
    ops = port["forced_ops"]
    assert [o for o in ops if o["forced"]] == [{"buffer": "phi", "halo": 2, "before_group": 0, "forced": True}]
    # the forced depth-2 exchange covers advect's depth-1 need: no extra op
    assert len(ops) == 2
    assert ops == ref_plans["forced"]["ops"]


def test_distributed_iterate_bit_identical_to_eager_distributed_loop(runs):
    port, ref, ref_plans, _inputs = runs
    rep = port["iterate_report"]
    assert np.abs(port["iterate"] - port["program"]).max() == 0.0
    assert rep["iterated_steps"] == NT
    assert rep["halo_plan"]["inserted"] == 2
    assert rep["halo_plan"] == ref_plans["iterate"]
    assert np.abs(port["iterate"] - ref["iterate"]).max() < 1e-12


def test_distributed_iterate_requires_rotation_closed_outputs(runs):
    port, _ref, _plans, _inputs = runs
    assert port["open_raised"] is True


def test_distributed_ensemble_members_times_domain_sharding(runs):
    """Members over "ens", tiles over (data, model); each rank's two members
    advance together — one exchange a buffer carries both — and match the
    single-domain oracle member by member and the reference's ensemble."""
    port, ref, ref_plans, inputs = runs
    rep = port["ensemble_report"]
    oracle = np.stack([_oracle(m, inputs["u0"], inputs["v0"], 1) for m in inputs["members"]])
    assert np.abs(port["ensemble"] - oracle).max() < 1e-12
    assert np.abs(port["ensemble"] - ref["ensemble"]).max() < 1e-12
    assert rep["members"] == NMEM and rep["members_per_shard"] == 2
    assert rep["program_report"]["halo_plan"]["inserted"] == 2
    assert rep["program_report"]["halo_plan"] == ref_plans["ensemble"]
    assert list(port["ensemble"].shape) == [NMEM, NI, NJ, NK]
    assert all(m["exchanges"] == 2 for m in port["ensemble_messages"])


def test_distributed_program_exchanges_follow_the_plan(runs):
    """Each rank runs the plan's 2 exchanges a step (the eager chain: 6); a
    (4, 2) rank posts a message to each of its 2 to 3 neighbours an exchange."""
    port, _ref, _plans, _inputs = runs
    msgs = port["program_messages"]
    assert [m["exchanges"] for m in msgs] == [2 * NT] * WORLD
    assert sum(m["send"] for m in msgs) == sum(m["recv"] for m in msgs) == 2 * NT * 20


def test_distributed_program_reports_rank_timings(runs):
    port, _ref, _plans, _inputs = runs
    t = port["timings"]
    assert t["clock"] == "host" and t["steps"] == 1
    assert t["exchange_count"] == 2 and t["groups_count"] == 2
    assert 0 < t["exchange_seconds"] + t["groups_seconds"] <= t["seconds"]


def _tiles(t):
    return abs(t["pack_seconds"] + t["wait_seconds"] + t["unpack_seconds"] - t["exchange_seconds"]) <= 1e-9


def test_rank_timings_split_the_exchange(runs):
    """Pack, wait and unpack tile each exchange on the host clock, and every
    phase counts as the plan predicts: 2 exchanges a step (phi, phi_star),
    each a pack, a wait and an unpack on both axes, since every rank of
    (4, 2) has a neighbour on each.  One call copies phi and phi_star into
    padded buffers and writes neither after, so nothing is copied back; an
    iterate copies a third (the rotation binds phi to a buffer the padded
    phi_new does not hold), and hands back the 3 names bound to padded
    buffers, each written since its copy."""
    port, _ref, _plans, _inputs = runs
    one = port["timings"]
    assert _tiles(one)
    assert (one["exchange_count"], one["pack_count"], one["wait_count"], one["unpack_count"]) == (2, 4, 4, 4)
    assert (one["pad_count"], one["release_count"]) == (2, 0)
    assert one["scratch_bytes"] == 0  # CPU tensors launch nothing
    assert 0 < one["steady_wait_seconds"]
    for t in port["iterate_timings"]:
        assert t["steps"] == NT and _tiles(t)
        assert t["exchange_count"] == 2 * NT
        assert t["pack_count"] == t["wait_count"] == t["unpack_count"] == 4 * NT
        assert (t["pad_count"], t["release_count"]) == (3, 3)
        assert t["pad_seconds"] > 0 and t["release_seconds"] > 0


def test_steady_wait_leaves_out_the_runs_first_exchange(monkeypatch):
    """``steady_wait_seconds``: the waits of every exchange but the first,
    scaled to all of them; the first's long wait (the ranks' skew at the
    run's start) stays in ``wait_seconds`` alone.  A wait is the axis'
    ``halo.post`` and ``halo.wait`` spans, and the exchanges' seconds are
    the sum of their phases."""
    from repro_torch.obs import trace as otrace
    from repro_torch.program import compile as prog_compile

    now = [0.0]
    monkeypatch.setattr(otrace, "monotonic", lambda: now[0])

    def tick(name, ticks):
        with otrace.device_span(name):
            now[0] += ticks

    with otrace.probing("cpu") as probe, otrace.device_span("dist.iterate"):
        for wait in (50.0, 2.0, 2.0, 2.0):
            with otrace.device_span("halo.exchange"):
                for _axis in range(2):
                    tick("halo.pack", 1.0)
                    tick("halo.post", 1.0)
                    tick("halo.wait", wait - 1.0)
                    tick("halo.unpack", 1.0)
    t = prog_compile._rank_timings(probe.result(), 2)
    assert (t["exchange_count"], t["wait_count"]) == (4, 8)
    assert t["wait_seconds"] == 2 * 50 + 6 * 2
    assert t["steady_wait_seconds"] == 6 * 2 * 4 / 3
    assert t["pack_seconds"] + t["wait_seconds"] + t["unpack_seconds"] == t["exchange_seconds"] == 128
    assert t["seconds"] == 128 and t["steps"] == 2


def test_message_bytes_are_the_plans_stripes(runs):
    """send_bytes and recv_bytes: each planned exchange's H-deep stripes, an
    i stripe (H x nj x nk) a neighbour along "data" and a j stripe of the
    i-padded rows ((ni + 2H) x H x nk) a neighbour along "model"."""
    port, _ref, _plans, _inputs = runs
    ni, nj = NI // 4, NJ // 2
    halos = [op["halo"] for op in port["iterate_report"]["halo_plan"]["ops"]]
    for (ci, cj), msgs in zip(port["coords"], port["iterate_messages"]):
        n_i, n_j = (ci > 0) + (ci < 3), (cj > 0) + (cj < 1)
        want = NT * sum(8 * NK * h * (n_i * nj + n_j * (ni + 2 * h)) for h in halos)
        assert msgs["send_bytes"] == msgs["recv_bytes"] == want
        assert msgs["send"] == msgs["recv"] == NT * len(halos) * (n_i + n_j)


def test_profiled_spans_of_the_distributed_step(runs):
    """Under torch.profiler, with the tracer off, the rank step's and the
    exchange's spans are user annotations of the profile."""
    port, _ref, _plans, _inputs = runs
    want = {"dist.iterate", "rank_step.pad", "rank_step.release", "halo.exchange", "halo.pack",
            "halo.post", "halo.wait", "halo.unpack"}
    assert want <= set(port["profiled"])


# ---------------------------------------------------------------------------
# The planner, in process: the port's copy against the reference
# ---------------------------------------------------------------------------


def _three_stencil_program(program_fn, build, exchange, defs, kind):
    """The reference tests' ``dist_climate`` step (``dist_forced`` with the
    marker) over ``defs``' advect, euler and diffuse, in either package."""
    advect, euler, diffuse = (build(defs.advect_defs), build(defs.euler_defs), build(defs.diffuse_defs))

    def step(phi, u, v, adv, phi_star, phi_new, *, dx, dy, dt, alpha):
        if kind == "dist_forced":
            exchange(phi, 2)
        advect(phi, u, v, adv, dx=dx, dy=dy)
        euler(phi, adv, phi_star, dt=dt)
        diffuse(phi_star, phi_new, alpha=alpha)
        return {"phi": phi_new, "phi_new": phi}

    return program_fn(definition=step, name=kind)


def _programs(kind):
    """(the port's program, the reference's program, their field names)."""
    if kind == "climate_step":
        build = r_gtscript.stencil(backend="jax")
        wsys, vsolve = build(r_vadv.vadv_system_defs), build(r_vadv.vadv_defs)
        advect, euler, diffuse = (build(d) for d in (r_forecast.advect_defs, r_forecast.euler_defs,
                                                     r_forecast.diffuse_defs))

        @r_program(backend="jax", name="climate_step")
        def ref_step(phi, u, v, w, adv, phi_star, phi_h, a, b, c, d, phi_new, *, dt, dx, dy, dz, alpha):
            advect(phi, u, v, adv, dx=dx, dy=dy)
            euler(phi, adv, phi_star, dt=dt)
            diffuse(phi_star, phi_h, alpha=alpha)
            wsys(w, phi_h, a, b, c, d, dt=dt, dz=dz)
            vsolve(a, b, c, d, phi_new)
            return {"phi": phi_new, "phi_new": phi}

        return climate.build_program("cuda", (8, 8, 6)), ref_step, list(climate.FIELD_NAMES)
    port = _three_stencil_program(lambda **kw: program("cuda", **kw), gtscript.stencil(backend="cuda"),
                                  request_exchange, forecast, kind)
    ref = _three_stencil_program(lambda **kw: r_program("jax", **kw), r_gtscript.stencil(backend="jax"),
                                 r_request_exchange, r_forecast, kind)
    return port, ref, ["phi", "u", "v", "adv", "phi_star", "phi_new"]


@pytest.mark.parametrize("kind", ["dist_climate", "dist_forced", "climate_step"])
def test_halo_plan_equals_the_reference(kind):
    """The port's ``plan_halo_exchanges`` on its traced program equals the
    reference's on the reference's: the same exchanges and read depths."""
    prog, rprog, names = _programs(kind)
    local = (8, 8, 6)
    sc = {**ranks.SCALARS, "dz": 1.0}
    scalars = {n: sc[n] for n in prog.scalar_params}
    fields = {n: torch.zeros(local, dtype=torch.float64) for n in names}
    graph = ProgramGraph(prog.trace(fields, scalars))
    pplan = ProgramPlan("p", graph, "cuda", {}, False, distributed=True)
    plan = plan_halo_exchanges(graph, pplan.groups, pplan.markers)

    rgraph = RefProgramGraph(rprog.trace({n: np.zeros(local) for n in names},
                                         {n: np.float64(v) for n, v in scalars.items()}))
    rpplan = RefProgramPlan("p", rgraph, "jax", {}, False, distributed=True)
    rplan = r_plan_halo_exchanges(rgraph, rpplan.groups, rpplan.markers)
    assert plan.summary() == rplan.summary()
    assert plan.read_depth == rplan.read_depth
    assert pplan.base_report()["group_stencils"] == rpplan.base_report()["group_stencils"]


@pytest.mark.parametrize("case,match", [
    ("unbatched", "no member-batched"),
    ("members", "holds 3 members"),
    ("shared_output", "not member-batched"),
    ("per_member_scalar", "shared by the members"),
])
def test_distributed_ensemble_refuses_what_it_cannot_run(tmp_path, case, match):
    """On a one-rank 1 x 1 x 1 mesh: a call with no member axis, the wrong
    member count, a written field shared by the members, or a per-member
    scalar raises ``EnsembleError`` before anything runs."""
    import torch.distributed as dist

    from repro_torch.ensemble import EnsembleError
    from repro_torch.launch.mesh import make_mesh

    _st, step, _f, _o = ranks.build_step()
    local = (8, 8, 4)
    fields = {n: torch.zeros((NMEM,) + local, dtype=torch.float64) for n in ("phi", "adv", "phi_star", "phi_new")}
    fields.update({n: torch.zeros(local, dtype=torch.float64) for n in ("u", "v")})
    sc = dict(ranks.SCALARS)
    if case == "unbatched":
        fields = {n: t[0] if t.dim() == 4 else t for n, t in fields.items()}
    elif case == "members":
        fields["phi"] = fields["phi"][:3]
    elif case == "shared_output":
        fields["phi_new"] = fields["phi_new"][0]
    else:
        sc["dt"] = np.full(NMEM, 0.1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        dens = step.ensemble(NMEM).distribute(make_mesh((1, 1, 1), ("ens", "data", "model"), "cpu"))
        with pytest.raises(EnsembleError, match=match):
            dens(fields, sc)
    finally:
        dist.destroy_process_group()
