"""The port's sharded half on CUDA cards: the entry points' device defaults,
and the sharded train step over NCCL on four cards (skipped with fewer).

Needs a GPU; skipped elsewhere.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_sharded_gpu.py

Four ranks on one card run through ``chip_smoke.py`` path K (``gloo_staged``);
NCCL refuses two ranks on one card.
"""

from datetime import timedelta

import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_sharded_ranks as ranks  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.specs import init_sharded_params, init_sharded_state, param_shardings, state_shardings  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def one_rank(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.parallel import staged

    staged.install()  # gloo, DTensor's collectives on CUDA tensors staged through the host
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_entry_points_default_to_the_card(one_rank):
    model = build_model(ranks.config("recurrentgemma-2b", "float32"))
    with axis_rules(DEFAULT_RULES, one_rank):
        params = init_sharded_params(model, param_shardings(model, one_rank))
        state = init_sharded_state(model, state_shardings(model, one_rank))
    assert one_rank.device_type == "cuda"
    for tree in (params.leaves(), state.params.leaves()):
        assert {p.to_local().device.type for _n, p in tree} == {"cuda"}


def test_sharded_step_over_nccl_on_four_cards(tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (one a rank: NCCL refuses two ranks on one card)")
    for r in run_ranks(ranks.nccl_train_case, 4, (), store_dir=tmp_path, backend="nccl", timeout=600):
        for arch, dev in r.items():  # the first step's gradients, as test_torch_sharded.py holds float32
            assert dev <= 1e-5, (arch, dev)
