"""The port's halo exchange and ``DistributedStencil`` on 8 CPU ranks,
held against the reference's distributed stencils.

The port runs one process per rank: the module fixture spawns 8 ranks of one
gloo process group once (``launch.ranks.run_ranks``, a ``file://`` store
under the test's temporary directory, one CPU thread a rank) and every rank
runs ``torch_dist_ranks.stencil_cases`` on its own blocks.  The reference is
one controller: its outputs come from one subprocess with 8 host devices
(``--xla_force_host_platform_device_count=8``), fed the same NumPy inputs.
Each test mirrors the reference test of the same name in
``tests/test_distributed.py``; the port's results are held to the
reference's within 1e-12 (the exchanged blocks exactly).
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
from repro.parallel import halo as r_halo  # noqa: E402
from repro_torch.core import gtscript, storage  # noqa: E402
from repro_torch.launch.ranks import RankError, run_ranks  # noqa: E402
from repro_torch.parallel import halo  # noqa: E402
from repro_torch.stencils.distributed import DistributedStencil  # noqa: E402
from repro_torch.stencils.hdiff import build_hdiff  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
WORLD = 8
H = 3

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, {src!r})
import repro
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import gtscript
from repro.core.gtscript import Field, PARALLEL, computation, interval
from repro.parallel.halo import exchange_halo_2d
from repro.stencils.distributed import DistributedStencil, shard_map
from repro.stencils.hdiff import build_hdiff

tmp, cases = sys.argv[1], json.loads(sys.argv[2])
inp = np.load(tmp + "/inputs.npz")
out = {{}}
mesh = jax.make_mesh((4, 2), ("data", "model"))
x = jnp.asarray(inp["hdiff_in"])
d = DistributedStencil(build_hdiff("jax"), mesh)
out["hdiff"] = np.asarray(d({{"in_phi": x, "out_phi": jnp.zeros_like(x)}}, {{"alpha": np.float64(0.05)}})["out_phi"])

def shift_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a[-1, 0, 0]

shift = DistributedStencil(gtscript.stencil(backend="jax")(shift_defs), mesh, periodic=(True, True))
a = jnp.asarray(inp["shift_in"])
out["shift"] = np.asarray(shift({{"a": a, "o": jnp.zeros_like(a)}}, {{}})["o"])

for k, (shape, periodic, h) in enumerate(cases):
    m = jax.make_mesh(tuple(shape), ("data", "model"))
    body = lambda b, h=h, shape=shape, periodic=periodic: exchange_halo_2d(
        b, h, "data", "model", shape[0], shape[1], tuple(periodic))
    fn = jax.jit(shard_map(body, mesh=m, in_specs=P("data", "model"), out_specs=P("data", "model")))
    out[f"exchange{{k}}"] = np.asarray(fn(jnp.asarray(inp["exchange_in"])))
np.savez(tmp + "/reference.npz", **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"hdiff_in": rng.normal(size=(64, 32, 5)), "shift_in": rng.normal(size=(16, 8, 3)),
            "exchange_in": rng.normal(size=(16, 8, 3))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results of the port, the reference's arrays, the inputs)."""
    tmp = tmp_path_factory.mktemp("torch_distributed")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    script = tmp / "reference.py"
    script.write_text(textwrap.dedent(_REFERENCE.format(src=SRC)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, str(script), str(tmp), json.dumps(ranks.EXCHANGE_CASES)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = run_ranks(ranks.stencil_cases, WORLD, (inputs,), store_dir=tmp, timeout=120)[0]
    finally:
        _out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, f"reference subprocess failed:\n{err[-3000:]}"
    return port, dict(np.load(tmp / "reference.npz")), inputs


def test_distributed_hdiff_matches_single_device(runs):
    port, ref, inputs = runs
    inner = inputs["hdiff_in"]
    ni, nj, nk = inner.shape
    # single-domain oracle on the port's numpy backend, zero halo boundary
    padded = np.zeros((ni + 2 * H, nj + 2 * H, nk))
    padded[H:-H, H:-H] = inner
    i_s = storage.from_array(padded, backend="numpy", default_origin=(H, H, 0))
    o_s = storage.zeros(padded.shape, backend="numpy", default_origin=(H, H, 0))
    build_hdiff("numpy")(i_s, o_s, alpha=np.float64(0.05), domain=(ni, nj, nk))
    oracle = o_s.to_numpy()[H:-H, H:-H]
    assert np.abs(port["hdiff"] - oracle).max() < 1e-12
    assert np.abs(port["hdiff"] - ref["hdiff"]).max() < 1e-12


def test_distributed_periodic_shift(runs):
    port, ref, inputs = runs
    assert np.abs(port["shift"] - np.roll(inputs["shift_in"], 1, axis=0)).max() < 1e-12
    assert np.abs(port["shift"] - ref["shift"]).max() < 1e-12


def _pairs(n: int, periodic: bool) -> int:
    return len(r_halo._perm_up(n, periodic)) + len(r_halo._perm_down(n, periodic))


def test_halo_messages_posted(runs):
    """The reference counts ``collective-permute``s in the HLO (at least 4:
    2 stripes x 2 directions); the port counts the messages each rank posts.
    hdiff exchanges both its fields: on the (4, 2) mesh every rank posts at
    least 4, and in all each field's exchange sends what the reference's
    pairs name (i: 2 columns of ranks, j: 4 rows)."""
    port, _ref, _inputs = runs
    msgs = port["messages"]
    assert len(msgs) == WORLD
    assert all(m["exchanges"] == 2 and m["send"] + m["recv"] >= 4 for m in msgs)
    per_field = 2 * _pairs(4, False) + 4 * _pairs(2, False)
    assert sum(m["send"] for m in msgs) == sum(m["recv"] for m in msgs) == 2 * per_field == 40


@pytest.mark.parametrize("case", range(len(ranks.EXCHANGE_CASES)),
                         ids=[f"{s[0]}x{s[1]}-periodic{int(p[0])}{int(p[1])}-h{h}"
                              for s, p, h in ranks.EXCHANGE_CASES])
def test_exchange_halo_2d_blocks_equal_the_reference(runs, case):
    """Every rank's haloed block (interior, rims and corners) equals the
    reference's ``exchange_halo_2d`` inside ``shard_map``; zeros where no
    rank sends, nothing across an axis of size 1 even when periodic."""
    port, ref, _inputs = runs
    (ni, nj), (pi, pj), _h = ranks.EXCHANGE_CASES[case]
    got = port["exchange"][case]
    np.testing.assert_array_equal(got["blocks"], ref[f"exchange{case}"])
    expected = nj * _pairs(ni, pi) + ni * _pairs(nj, pj)
    assert sum(m["send"] for m in got["messages"]) == sum(m["recv"] for m in got["messages"]) == expected


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("periodic", [False, True])
def test_perm_pairs_equal_the_reference(n, periodic):
    assert halo._perm_up(n, periodic) == r_halo._perm_up(n, periodic)
    assert halo._perm_down(n, periodic) == r_halo._perm_down(n, periodic)


def test_meshes_over_the_process_group(runs):
    port, _ref, _inputs = runs
    assert port["mesh"] == {"data": 4, "model": 2, "host": WORLD, "host_names": ["data"]}


def test_distributed_stencil_writes_only_fresh_blocks(runs):
    port, _ref, _inputs = runs
    assert port["hdiff_written"] == ["out_phi"]
    assert port["hdiff_input_kept"] is True


def test_distributed_stencil_requires_a_torch_backend():
    st = gtscript.stencil(backend="numpy")(ranks.shift_defs)
    with pytest.raises(TypeError, match="torch/cuda"):
        DistributedStencil(st, mesh=None)


def test_run_ranks_fails_on_a_failed_or_hung_rank(tmp_path):
    with pytest.raises(RankError, match="rank 1 failed"):
        run_ranks(ranks.failing_rank, 2, store_dir=tmp_path, timeout=60)
    with pytest.raises(RankError, match="did not finish"):
        run_ranks(ranks.hanging_rank, 1, store_dir=tmp_path, timeout=8)
