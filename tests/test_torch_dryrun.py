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
