"""The climate step's second group on a CUDA card, where the k-walk runs
diffuse, vadv_system's intervals and vadv's forward sweep down each column at
once and keeps their temporaries in registers: the one-member kernel, the
member-batched kernel of an ensemble and the distributed program's kernel,
each against the plain ``torch`` program (1e-12 of the state's scale) and
the member-batched and distributed ones against the one-member kernel bit
for bit.  The eager ``vadv_system`` is held against its plain module by
``test_torch_gpu.py::test_generated_kernels_on_both_layouts``.

Needs a GPU and nvcc; skipped elsewhere.  Imports neither JAX nor the
reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_walk_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.core import codegen_cuda, storage  # noqa: E402
from repro_torch.ensemble import Ensemble  # noqa: E402
from repro_torch.stencils import climate  # noqa: E402

pytestmark = pytest.mark.gpu
H = climate.HALO
DOM = (40, 36, 12)  # ragged against the (8, 32) blocks
STEPS = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    return torch.device("cuda")


def _arrays(seed=7, dom=DOM, halo=H):
    ni, nj, nk = dom
    shape = (ni + 2 * halo, nj + 2 * halo, nk)
    rng = np.random.default_rng(seed)
    arrays = {n: np.zeros(shape) for n in climate.FIELD_NAMES}
    arrays["phi"] = rng.normal(size=shape)
    arrays["u"] = np.full(shape, 0.8)
    arrays["v"] = np.full(shape, -0.4)
    arrays["w"] = 0.2 * rng.random(shape)
    return arrays


def _fields(backend, device, arrays):
    return {n: storage.from_array(a, backend=backend, default_origin=(H, H, 0), device=device)
            for n, a in arrays.items()}


def _plain_steps(device, arrays, steps=STEPS):
    """The step as the plain ``torch`` program, ``steps`` times."""
    f = _fields("torch", device, arrays)
    prog = climate.build_program("torch", DOM, name="walk_plain_step")
    for _ in range(steps):
        prog(**f, **climate.DEFAULT_SCALARS)
    return f


def _assert_walked(obj):
    sched = obj.kernel.module.SCHEDULE
    (walk,) = sched["k_walks"]
    assert walk["lookahead"] == 1
    assert sorted(n for n, kind in sched["temporaries"].items() if kind == "full") == ["_p4_cp", "_p4_dp"]


def _assert_close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale)


def test_walked_group_matches_the_plain_program(card):
    arrays = _arrays()
    prog = climate.build_program("cuda", DOM, name="walk_step")
    f = _fields("cuda", card, arrays)
    for _ in range(STEPS):
        prog(**f, **climate.DEFAULT_SCALARS)
    torch.cuda.synchronize()
    cp = next(iter(prog._cache.values()))
    _assert_walked(cp.group_objects[1])
    assert cp.group_objects[1].launches == STEPS
    plain = _plain_steps(card, arrays)
    for n in ("phi", "phi_new", "phi_star", "phi_h"):
        _assert_close(f[n].data, plain[n].data)


def test_walked_member_batched_group_matches_the_member_loop(card):
    members = 3
    per_member = [_arrays(seed=20 + m) for m in range(members)]
    batched = {}
    for n in climate.FIELD_NAMES:
        t = storage.card_tensor((members,) + per_member[0][n].shape, torch.float64, card)
        t.copy_(torch.from_numpy(np.stack([a[n] for a in per_member])))
        batched[n] = storage.Storage(t, "cuda", (0, H, H, 0), ("N", "I", "J", "K"))
    prog = climate.build_program("cuda", DOM, name="walk_member_step")
    ens = Ensemble(prog, members)
    codegen_cuda.reset_launch_counts()
    ens.iterate(STEPS, **batched, **climate.DEFAULT_SCALARS)
    torch.cuda.synchronize()
    runs = next(iter(ens._cache.values())).batched_runs({})
    assert sum(codegen_cuda.launch_counts().values()) == STEPS * len(runs)
    _assert_walked(runs[1])
    one = climate.build_program("cuda", DOM, name="walk_member_one")
    for m in range(members):
        f = _fields("cuda", card, per_member[m])
        for _ in range(STEPS):
            one(**f, **climate.DEFAULT_SCALARS)
        torch.cuda.synchronize()
        assert torch.equal(batched["phi"].data[m], f["phi"].data), m
        _assert_close(batched["phi"].data[m], _plain_steps(card, per_member[m])["phi"].data)


def test_walked_distributed_group_matches_the_program(card, tmp_path):
    """The distributed program on a one-rank 1 x 1 mesh over gloo: its
    groups (``<name>_dist_g*``) walk as the program's do and give its bits."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    arrays = {n: np.pad(a[H:-H, H:-H], ((H, H), (H, H), (0, 0))) for n, a in _arrays(seed=31).items()}
    single = _fields("cuda", card, arrays)
    prog = climate.build_program("cuda", DOM, name="walk_dist_step")
    for _ in range(STEPS):
        prog(**single, **climate.DEFAULT_SCALARS)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        dp = prog.distribute(make_mesh((1, 1), ("data", "model")), periodic=(True, True))

        def local():
            out = {}
            for n, a in arrays.items():
                t = storage.card_tensor(a[H:-H, H:-H].shape, torch.float64, card)
                out[n] = t.copy_(torch.from_numpy(np.ascontiguousarray(a[H:-H, H:-H])))
            return out

        groups = dp.plan(local(), climate.DEFAULT_SCALARS).group_objects
        final = dp.iterate(STEPS, local(), climate.DEFAULT_SCALARS)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    _assert_walked(groups[1])
    assert torch.equal(final["phi"], single["phi"].data[H:-H, H:-H])
    _assert_close(final["phi"], _plain_steps(card, arrays)["phi"].data[H:-H, H:-H])
