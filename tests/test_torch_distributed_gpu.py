"""The port's distributed stencils on CUDA cards: the halo exchange over
gloo with every rank on one card (stripes staged through pinned host
memory), and over NCCL with one rank a card.  The meshes and stencils run at
their defaults (``device_type="cuda"``, the ``cuda`` backend); hdiff is held
against ``ops.hdiff`` on the zero-padded global domain (1e-12) and the
distributed program's ``iterate`` against the eager chain of
``DistributedStencil``s bit for bit, two group launches a step.

Needs a GPU and nvcc (NCCL: two cards or more); skipped elsewhere.  Imports
neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_distributed_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_dist_ranks as ranks  # noqa: E402
from repro_torch.kernels.hdiff import ops as hdiff_ops  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.program.compile import DistributedStepPlan  # noqa: E402

pytestmark = pytest.mark.gpu
NI, NJ, NK = 64, 32, 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    return torch.device("cuda")


def _inputs():
    rng = np.random.default_rng(0)
    return {"hdiff_in": rng.normal(size=(NI, NJ, NK)), "phi0": rng.normal(size=(NI, NJ, NK)),
            "u0": np.full((NI, NJ, NK), 0.8), "v0": np.full((NI, NJ, NK), -0.4)}


def _build(world: int) -> None:
    """Build every kernel the ranks launch here, once, before they start."""
    (advect, euler, diffuse), step, _f, _o = ranks.build_step()
    local = (NI // ranks.card_mesh_shape(world)[0], NJ // ranks.card_mesh_shape(world)[1], NK)
    meta = {n: torch.empty(local, dtype=torch.float64, device="meta")
            for n in ("phi", "u", "v", "adv", "phi_star", "phi_new")}
    plan = DistributedStepPlan(step, meta, dict(ranks.SCALARS), local, {})
    kernels = [s.kernel for s in (advect, euler, diffuse, ranks.build_hdiff())]
    kernels += [o.kernel for o in plan.group_objects]
    for k in kernels:
        k.start_build()
    for k in kernels:
        k.finish_build()


def _check(res: dict, inputs: dict, world: int, backend: str) -> None:
    assert res["device_type"] == "cuda" and res["backend"] == backend
    h = hdiff_ops.HALO
    padded = np.pad(inputs["hdiff_in"], ((h, h), (h, h), (0, 0)))
    ref = hdiff_ops.hdiff(torch.from_numpy(padded).cuda(), 0.05)[h:-h, h:-h].cpu().numpy()
    assert np.abs(res["hdiff"] - ref).max() < 1e-12
    assert len(res["ranks"]) == world
    for r in res["ranks"]:
        assert r["hdiff_launches"] == 1
        assert r["program_launches"] == [ranks.NT, ranks.NT] and r["all_launches"] == 2 * ranks.NT
        assert r["exchanges"] == 2 * ranks.NT
        assert r["program_equals_eager"] is True


def test_card_defaults_over_gloo(card, tmp_path):
    """Four ranks on one card over gloo: what chip_smoke.py's path I runs."""
    _build(4)
    inputs = _inputs()
    res = run_ranks(ranks.card_cases, 4, (inputs, True), store_dir=tmp_path, backend="gloo", timeout=300)[0]
    _check(res, inputs, 4, "gloo")


def test_nccl_transport_one_rank_a_card(card, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"the NCCL transport needs two cards or more (NCCL takes one rank a card); {n} here")
    world = 4 if n >= 4 else 2
    _build(world)
    inputs = _inputs()
    res = run_ranks(ranks.card_cases, world, (inputs, False), store_dir=tmp_path, backend="nccl", timeout=300)[0]
    _check(res, inputs, world, "nccl")
