"""The port's cost walk (``launch/hlo_count.py``) and dry run
(``launch/dryrun.py``) against the reference's.

The walk counts the aten operations a step dispatches: every iteration of
a loop (the reference's HLO walk has to multiply ``while`` bodies by their
trip count), a matrix product's 2·|out|·|contraction|, and, on an MLP, the
flops the reference's ``analyze_hlo_text`` reads from its compiled forward.
The dry run lowers reduced cells on fake (2, 2) and (2, 2, 2) process
groups in a subprocess (the fake group is global to a process): the reports
carry the reference's keys, and each rank's argument bytes equal the sum of
the sharded leaf bytes of the reference's specs.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.configs import get_shape as r_get_shape  # noqa: E402
from repro.data.pipeline import make_batch_specs as r_make_batch_specs  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro.launch.hlo_count import analyze_hlo_text  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro_torch.launch.hlo_count import CostWalk, analyze  # noqa: E402
from repro_torch.models import layers  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
# (arch, shape, mesh shape): one cell of each kind, reduced widths
CELLS = [("phi3-mini-3.8b", "train_4k", (2, 2)), ("moonshot-v1-16b-a3b", "decode_32k", (2, 2, 2)),
         ("recurrentgemma-2b", "decode_32k", (2, 2))]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def test_a_loop_of_matmuls_counts_every_iteration():
    """The reference's own example: 20 steps of a (64, 64) matmul count 20
    times (XLA's cost analysis counts a scanned body once)."""
    a, w = torch.randn(64, 64), torch.randn(64, 64)

    def loop():
        x = a
        for _ in range(20):
            x = x @ w
        return x

    assert analyze(loop)["flops"] == 20 * 2 * 64 * 64 * 64


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "baddbmm", "conv"])
def test_dot_flops_are_2_out_contraction(op):
    g = torch.Generator().manual_seed(0)
    m, k, n, b = 6, 10, 7, 3
    x2, w2 = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    x3, w3 = torch.randn(b, m, k, generator=g), torch.randn(b, k, n, generator=g)
    calls = {
        "mm": (lambda: torch.mm(x2, w2), 2 * m * n * k),
        "bmm": (lambda: torch.bmm(x3, w3), 2 * b * m * n * k),
        "addmm": (lambda: torch.addmm(torch.zeros(m, n), x2, w2), 2 * m * n * k),
        "baddbmm": (lambda: torch.baddbmm(torch.zeros(b, m, n), x3, w3), 2 * b * m * n * k),
        # (N, C_in, L) * (C_out, C_in, K): out (N, C_out, L - K + 1), contraction C_in·K
        "conv": (lambda: torch.nn.functional.conv1d(torch.randn(2, 4, 9), torch.randn(5, 4, 3)), 2 * 2 * 5 * 7 * 4 * 3),
    }
    fn, want = calls[op]
    assert analyze(fn)["flops"] == want


def test_bytes_skip_views_and_count_collective_payloads():
    x = torch.randn(8, 16)
    with CostWalk() as walk:
        x.view(16, 8).t()
    assert walk.bytes == 0
    with CostWalk() as walk:
        x + 1
    assert walk.bytes == 2 * x.numel() * 4


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_flops_equal_the_reference_hlo_walk(activation):
    d, f, b, s = 48, 96, 2, 16
    spec = r_layers.mlp_spec(d, f, activation, False)
    rng = np.random.default_rng(0)
    r_params = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), spec,
                                      is_leaf=lambda p: isinstance(p, r_layers.ParamSpec))
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    hlo = jax.jit(lambda p, x: r_layers.mlp(p, x, activation)).lower(r_params, x).compile().as_text()
    want = analyze_hlo_text(hlo)["flops"]
    t_params = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), r_params)
    got = analyze(lambda: layers.mlp(t_params, torch.from_numpy(x), activation))["flops"]
    assert got == want > 0


_DRYRUN = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch.dryrun import lower_cell
out = []
for arch, shape, mesh in {cells!r}:
    out.append(lower_cell(arch, shape, len(mesh) == 3, reduced=True, mesh_shape=mesh, device="cpu"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reports():
    code = _DRYRUN.format(src=SRC, cells=CELLS)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _ref_argument_bytes(arch, shape_id, mesh_shape, monkeypatch):
    """Each rank's bytes of the reference's sharded arguments (reduced config)."""
    monkeypatch.setattr(r_specs, "NamedSharding", lambda mesh, spec: spec)
    names = AXES[len(mesh_shape)]
    mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(mesh_shape, dtype=np.int8))
    sizes = dict(zip(names, mesh_shape))
    cfg = r_get_arch(arch).reduced
    model, shape = r_build_model(cfg), r_get_shape(shape_id)
    if shape.kind == "train":
        batch = r_make_batch_specs(cfg, shape)
        trees = [(r_specs.train_state_specs(model), r_specs.state_shardings(model, mesh)),
                 (batch, r_specs.batch_shardings(mesh, batch))]
    else:
        batch = r_specs.serve_input_specs(cfg, shape.kind, shape.seq_len, shape.global_batch)
        cache = r_specs.cache_specs(model, shape.global_batch, shape.seq_len)
        trees = [(model.param_shapes(), r_specs.param_shardings(model, mesh)),
                 (batch, r_specs.serve_batch_shardings(mesh, batch)), (cache, r_specs.cache_shardings(mesh, cache))]
    total = 0
    for leaves, specs in trees:
        for leaf, spec in zip(jax.tree_util.tree_leaves(leaves), jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
            ways = 1
            for ax in tuple(spec):
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    ways *= sizes.get(a, 1) if a else 1
            total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // ways
    return total


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_dryrun_reports_match_the_reference(reports, i, monkeypatch):
    arch, shape_id, mesh_shape = CELLS[i]
    rep = reports[i]
    assert {"arch", "shape", "mesh", "devices", "kind", "memory", "cost", "collectives",
            "collective_link_bytes", "walked", "lower_compile_s"} <= set(rep)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "total_per_device_bytes"} <= set(rep["memory"])
    assert {"flops", "bytes_accessed"} <= set(rep["cost"]) and {"flops", "bytes", "collectives"} <= set(rep["walked"])
    assert rep["devices"] == int(np.prod(mesh_shape)) and rep["cost"]["flops"] > 0
    assert rep["memory"]["argument_bytes"] == _ref_argument_bytes(arch, shape_id, mesh_shape, monkeypatch)


# ---------------------------------------------------------------------------
# the paper's own workload: the distributed-hdiff stencil cell
# ---------------------------------------------------------------------------

STENCIL_IJ = 1024  # the reduced global_ij (the production cell: 8192)
_REF_STENCIL = """
import json, sys
sys.path.insert(0, {src!r})
from repro.launch.dryrun import lower_stencil_cell
print(json.dumps([lower_stencil_cell(m, global_ij={ij}) for m in (False, True)]))
"""
_PORT_STENCIL = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch.dryrun import lower_stencil_cell
print(json.dumps([lower_stencil_cell(m, global_ij={ij}, device="cpu") for m in (False, True)]))
"""


def _run(code: str, env=None):
    import os

    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={**os.environ, **(env or {})})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def stencil_reports():
    """(reference, port) reports of the stencil cell on both production
    meshes at ``STENCIL_IJ``: each package in its own subprocess (the
    reference with 512 host devices, as its dry run sets ``XLA_FLAGS``; the
    port's fake group is global to a process)."""
    ref = _run(_REF_STENCIL.format(src=SRC, ij=STENCIL_IJ),
               {"XLA_FLAGS": "--xla_force_host_platform_device_count=512", "JAX_PLATFORMS": "cpu"})
    port = _run(_PORT_STENCIL.format(src=SRC, ij=STENCIL_IJ))
    return ref, port


@pytest.mark.parametrize("mesh", [0, 1], ids=["16x16", "2x16x16"])
def test_stencil_cell_posts_the_references_collective_permutes(stencil_reports, mesh):
    """An interior rank's halo exchange: the reference's collective-permute
    count and bytes, link bytes and argument bytes, exactly."""
    ref, port = (r[mesh] for r in stencil_reports)
    assert port["mesh"] == ref["mesh"] and port["shape"] == ref["shape"]
    assert port["collectives"] == ref["collectives"]
    assert port["collectives"]["collective-permute"]["count"] == 8
    assert port["collective_link_bytes"] == ref["collective_link_bytes"]
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    # each message is one stripe, to one of the rank's four neighbours
    assert len({m["peer"] for m in port["messages"]}) == 4
    assert sum(m["bytes"] for m in port["messages"]) == port["collectives"]["collective-permute"]["bytes"]


def test_fake_group_exchange_records_and_posts_nothing():
    """On the dry run's fake group an exchange whose ``post`` hook is the
    walk's posts no message (the counts of posted messages stay), records
    the four an interior rank would send in the walk, and leaves the rims
    as they are; without the hook the fake group raises."""
    from repro_torch.launch.dryrun import fake_world, interior_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import halo

    dims = (4, 4)
    with fake_world(16, rank=interior_rank(dims)):
        mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
        walk = CostWalk()
        ex = halo.HaloExchange(mesh, post=walk.record_messages)
        padded = torch.zeros(16, 12, 3, dtype=torch.float64)
        halo.interior(padded, 2).fill_(1.0)
        before = halo.message_counts()
        with walk:
            ex.fill(padded, 2)
        after = halo.message_counts()
        assert (after["send"], after["recv"]) == (before["send"], before["recv"])
        assert float(padded.sum()) == 12 * 8 * 3  # the rims hold their zeros
        rank = interior_rank(dims)  # (2, 2): neighbours (1, 2), (3, 2), (2, 1), (2, 3)
        assert sorted(m["peer"] for m in walk.messages) == sorted([rank - 4, rank + 4, rank - 1, rank + 1])
        # i stripes 2 x 8 x 3, j stripes of the i-padded rows 16 x 2 x 3, float64
        assert sorted(m["bytes"] for m in walk.messages) == [2 * 8 * 3 * 8] * 2 + [16 * 2 * 3 * 8] * 2
        assert walk.counts == {"collective-permute": 4}
        with pytest.raises(ValueError, match="backend 'fake'"):
            halo.HaloExchange(mesh).fill(padded, 2)


def test_exchange_refuses_other_backends(monkeypatch):
    """Only gloo and nccl carry an exchange, and the walk records only the
    dry run's fake group's messages."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import halo

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        monkeypatch.setattr(halo.dist, "get_backend", lambda group=None: "mpi")
        padded = torch.zeros(6, 6, 1, dtype=torch.float64)
        with pytest.raises(ValueError, match="backend 'mpi'"):
            halo.HaloExchange(mesh).fill(padded, 1)
        with pytest.raises(ValueError, match="backend 'mpi'"):
            halo.HaloExchange(mesh, post=CostWalk().record_messages).fill(padded, 1)


def test_real_gloo_group_takes_the_real_exchange_under_a_walk(tmp_path):
    """Four gloo ranks on (2, 2), each exchanging under an active cost walk:
    the messages are posted (counted as sent and received), none is recorded
    as the fake group's, and the rims hold the neighbours' stripes; an
    exchange whose ``post`` hook is the walk's refuses the real group."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_dist_ranks as dist_ranks

    from repro_torch.launch.ranks import run_ranks

    res = run_ranks(dist_ranks.exchange_under_a_walk, 4, store_dir=tmp_path, timeout=120)
    for r in res:
        assert r["recorded"] == 0 and r["sent"] == 2 and r["received"] == 2, r
        assert r["rims_right"], r
        assert "backend 'gloo'" in r["walk_hook_refused"], r
