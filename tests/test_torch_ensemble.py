"""The port's ensembles (``repro_torch.ensemble``) on the CPU.

An N-member run is bit-identical (float64) to a loop over the members, each
run alone through the single-member program — for one step, for
``iterate(n)``, for shared (broadcast) fields and for per-member scalars.
Started from the reference's perturbed arrays, it stays within 1e-12 of the
reference's ``jax.vmap`` ensemble; the statistics stencil stays within 1e-12
of the reference's.  The port's own perturbations are counter-based: member
m's noise does not depend on the member count.  On the card, each group is
one launch for all members (``test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.ensemble import Ensemble as RefEnsemble  # noqa: E402
from repro.ensemble import EnsembleStatistics as RefStatistics  # noqa: E402
from repro.ensemble import batch as r_batch  # noqa: E402
from repro.ensemble import perturb as r_perturb  # noqa: E402
from repro.stencils import forecast as r_forecast  # noqa: E402
from repro_torch.core import storage  # noqa: E402
from repro_torch.core.storage import Storage  # noqa: E402
from repro_torch.ensemble import (  # noqa: E402
    Ensemble,
    EnsembleError,
    EnsembleStatistics,
    batch,
    normal_noise,
    perturb,
    stats_definition,
    uniform_noise,
)
from repro_torch.stencils import forecast  # noqa: E402

DOM = (12, 10, 5)
N = 4
H = forecast.HALO
SHARED = ("u", "v")
SCALARS = dict(forecast.DEFAULT_SCALARS)


@pytest.fixture(scope="module")
def steps():
    return {be: forecast.build_forecast_step(be, DOM, name=f"ens_step_{be}") for be in ("torch", "cuda")}


def _base(backend="torch"):
    return forecast.make_forecast_fields(backend, DOM, seed=0, device="cpu")[0]


def _batched(backend="torch", members=N, shared=SHARED):
    out = {}
    for n, f in _base(backend).items():
        if n == "phi":
            out[n] = perturb(f, members, seed=0, amplitude=1e-3)
        elif n in shared:
            out[n] = f
        else:
            out[n] = batch.broadcast(f, members)
    return out


def _member_loop(step, fields, nt=1, scalars=None):
    """The plain loop: each member alone through the single-member program."""
    out = []
    for m in range(N):
        mf = {}
        for n, src in fields.items():
            arr = src.to_numpy()[m] if src.is_member_batched else src.to_numpy()
            origin = src.default_origin[1:] if src.is_member_batched else src.default_origin
            mf[n] = storage.from_array(arr, backend=step.backend, default_origin=origin, device="cpu")
        sc = dict(SCALARS if scalars is None else scalars(m))
        for _ in range(nt):
            step(**mf, **sc)
        out.append(mf["phi"].to_numpy())
    return np.stack(out)


# ---------------------------------------------------------------------------
# bit-identity: the batched step == the member loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("nt", [1, 5])
def test_ensemble_bit_identical_to_member_loop(steps, backend, nt):
    fields = _batched(backend)
    ref = _member_loop(steps[backend], fields, nt=nt)
    u_before = fields["u"].data.clone()
    ens = Ensemble(steps[backend], N)
    info = {}
    if nt == 1:
        outs = ens(**fields, **SCALARS, exec_info=info)
        assert set(outs) == {"phi", "phi_new"}
    else:
        ens.iterate(nt, **fields, **SCALARS, exec_info=info)
        assert info["ensemble_report"]["iterated_steps"] == nt
    np.testing.assert_array_equal(fields["phi"].to_numpy(), ref)
    rep = info["ensemble_report"]
    assert rep["members"] == N and rep["shared_fields"] == list(SHARED)
    assert rep["program_report"]["groups"] == (2 if backend == "cuda" else 1)
    # shared fields come back as they went in: rank 3, not N-replicated
    assert fields["u"].axes == ("I", "J", "K") and torch.equal(fields["u"].data, u_before)


def test_all_batched_fields_and_per_member_scalars(steps):
    dts = np.linspace(0.05, 0.2, N)
    fields = _batched("cuda", shared=())
    ref = _member_loop(steps["cuda"], fields, nt=2, scalars=lambda m: dict(SCALARS, dt=np.float64(dts[m])))
    Ensemble(steps["cuda"], N).iterate(2, **fields, **dict(SCALARS, dt=dts))
    np.testing.assert_array_equal(fields["phi"].to_numpy(), ref)


def test_matches_reference_ensemble_from_its_perturbed_arrays():
    """The reference perturbs (jax.random), both packages start from those
    arrays; the port's torch ensemble against the reference's vmapped jax
    ensemble, 5 steps."""
    nt = 5
    r_step = r_forecast.build_forecast_step("jax", DOM, name="r_ens_step")
    r_fields, _ = r_forecast.make_forecast_fields("jax", DOM, seed=0)
    rb = {}
    for n, f in r_fields.items():
        if n == "phi":
            rb[n] = r_perturb(f, N, seed=4, amplitude=1e-2)
        elif n in SHARED:
            rb[n] = f
        else:
            rb[n] = r_batch.broadcast(f, N, backend="jax")
    pb = {}
    for n, f in rb.items():
        arr = np.asarray(f.data)
        if f.is_member_batched:
            pb[n] = batch.from_member_arrays(list(arr), backend="torch", default_origin=f.default_origin[1:],
                                             device="cpu")
        else:
            pb[n] = storage.from_array(arr, backend="torch", default_origin=f.default_origin, device="cpu")
    RefEnsemble(r_step, N).iterate(nt, **rb, **SCALARS)
    step = forecast.build_forecast_step("torch", DOM, name="t_ens_vs_ref")
    Ensemble(step, N).iterate(nt, **pb, **SCALARS)
    np.testing.assert_allclose(pb["phi"].to_numpy(), np.asarray(rb["phi"].data), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# error surface
# ---------------------------------------------------------------------------


def test_numpy_program_rejected():
    with pytest.raises(EnsembleError, match="torch/cuda"):
        Ensemble(forecast.build_forecast_step("numpy", DOM, name="np_step"), N)


@pytest.mark.parametrize("case,match", [
    ("shared_write", "not member-batched"),
    ("members", "3 members"),
    ("unbatched", "no member-batched field"),
    ("scalar_length", "length 3"),
])
def test_inconsistent_calls_raise(steps, case, match):
    ens = Ensemble(steps["cuda"], N)
    sc = dict(SCALARS)
    if case == "shared_write":
        fields = _batched("cuda", shared=("u", "v", "phi_new"))  # phi_new is written
    elif case == "members":
        fields = _batched("cuda", members=3)
    elif case == "unbatched":
        fields = _base("cuda")
    else:
        fields, sc["dt"] = _batched("cuda"), np.linspace(0.1, 0.2, 3)
    with pytest.raises(EnsembleError, match=match):
        ens(**fields, **sc)


def test_distribute_on_one_rank_matches_the_ensemble(steps, tmp_path):
    """``distribute()`` is ported: on a one-rank 1 x 1 x 1 mesh the
    distributed ensemble's step on the interiors (all N members on the rank,
    u and v shared) equals the single-rank ensemble on zero-haloed storages
    bit for bit."""
    import torch.distributed as dist

    from repro_torch.ensemble import DistributedEnsemble
    from repro_torch.launch.mesh import make_mesh

    def zero_halo(a):
        out = np.zeros_like(a)
        out[..., H:-H, H:-H, :] = a[..., H:-H, H:-H, :]
        return out

    fields = _batched("cuda")
    single = {n: storage.from_array(zero_halo(f.to_numpy()), backend="cuda", default_origin=f.default_origin,
                                    axes=f.axes, device="cpu") for n, f in fields.items()}
    local = {n: torch.from_numpy(f.to_numpy()[..., H:-H, H:-H, :].copy()) for n, f in fields.items()}
    Ensemble(steps["cuda"], N)(**single, **SCALARS)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        dens = Ensemble(steps["cuda"], N).distribute(make_mesh((1, 1, 1), ("ens", "data", "model"), "cpu"),
                                                      member_axis="ens")
        assert isinstance(dens, DistributedEnsemble) and dens.local_members == N
        info = {}
        out = dens(local, SCALARS, exec_info=info)
    finally:
        dist.destroy_process_group()
    assert info["ensemble_report"]["members_per_shard"] == N
    np.testing.assert_array_equal(out["phi"].numpy(), single["phi"].to_numpy()[:, H:-H, H:-H, :])


# ---------------------------------------------------------------------------
# perturbations: counter-based, one generator a member
# ---------------------------------------------------------------------------


def test_perturbation_counter_based_reproducibility():
    base = storage.zeros(DOM, backend="torch", default_origin=(H, H, 0), device="cpu")
    a = perturb(base, 4, seed=7).to_numpy()
    b = perturb(base, 8, seed=7).to_numpy()
    assert np.array_equal(a, b[:4])  # member m draws the same numbers whatever N
    assert not np.array_equal(a, perturb(base, 4, seed=8).to_numpy())
    assert not np.array_equal(a[0], a[1])
    assert 0.5e-3 < float(a.std()) < 2e-3  # amplitude 1e-3 times standard normal noise


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_noise_drawn_on_the_named_device_and_the_card_by_default(kind, monkeypatch):
    draw = {"normal": normal_noise, "uniform": uniform_noise}[kind]
    a = draw(3, 4, (5, 4, 3), device="cpu")
    b = draw(3, 6, (5, 4, 3), dtype="float32", device="cpu")
    assert a.device.type == "cpu" and a.shape == (4, 5, 4, 3) and a.dtype == torch.float64
    assert b.dtype == torch.float32 and not torch.equal(a[0], a[1])
    assert torch.equal(a, draw(3, 8, (5, 4, 3), device="cpu")[:4])  # member m's noise whatever N
    if kind == "uniform":
        assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    # no device named: the card, so a host without one refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        draw(3, 4, (5, 4, 3))


def test_perturb_control_member_and_layout():
    arr = np.random.default_rng(1).normal(size=(DOM[0] + 2, DOM[1] + 2, DOM[2]))
    base = storage.from_array(arr, backend="cuda", default_origin=(H, H, 0), device="cpu")
    p = perturb(base, 4, seed=0, amplitude=1e-2, perturb_member0=False, kind="uniform", relative=True)
    assert np.array_equal(p.to_numpy()[0], arr)
    assert not np.array_equal(p.to_numpy()[1], arr)
    assert np.abs(p.to_numpy()[1:] - arr).max() <= 1e-2 * np.abs(arr).max()
    assert p.axes == ("N", "I", "J", "K") and p.default_origin == (0, H, H, 0)
    assert storage.is_card_layout(p.data)  # the member axis outermost in the card layout
    with pytest.raises(EnsembleError, match="unknown perturbation kind"):
        perturb(base, 2, kind="lognormal")


def test_batch_helpers_round_trip():
    arrays = [np.random.default_rng(i).normal(size=(6, 5, 3)) for i in range(3)]
    b = batch.scatter_members(arrays[:2], 3, template=storage.from_array(arrays[0], backend="cuda", device="cpu"))
    assert b.members == 3 and storage.is_card_layout(b.data)
    for m, want in enumerate(arrays[:2] + arrays[1:2]):  # padded with the last request
        np.testing.assert_array_equal(batch.gather_member(b, m), want)
    assert isinstance(batch.member_view(b, 1), Storage) and batch.member_view(b, 1).data.data_ptr() == b.data[1].data_ptr()
    z = batch.zeros(3, (6, 5, 3), backend="numpy", default_origin=(1, 1, 0))
    assert z.shape == (3, 6, 5, 3) and z.default_origin == (0, 1, 1, 0)
    with pytest.raises(EnsembleError, match="cannot scatter"):
        batch.scatter_members(arrays, 2, template=b.member(0))


# ---------------------------------------------------------------------------
# statistics (IR-emitted)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_statistics_match_reference_and_numpy_oracle(backend):
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=(DOM[0] + 2, DOM[1] + 2, DOM[2])) for _ in range(N)]
    kw = {} if backend == "numpy" else {"device": "cpu"}
    out = EnsembleStatistics(N, backend)(batch.from_member_arrays(arrs, backend=backend, default_origin=(H, H, 0),
                                                                  **kw), threshold=0.5)
    ref = RefStatistics(N, "numpy")(r_batch.from_member_arrays(arrs, backend="numpy", default_origin=(H, H, 0)),
                                    threshold=0.5)
    stack = np.stack(arrs)
    for n in ("mean", "var", "spread", "mn", "mx", "prob"):
        np.testing.assert_allclose(out[n].to_numpy(), np.asarray(ref[n].data), rtol=1e-12, atol=1e-12, err_msg=n)
    np.testing.assert_array_equal(out["mn"].to_numpy(), stack.min(0))
    np.testing.assert_allclose(out["var"].to_numpy(), stack.var(0), rtol=1e-12, atol=1e-15)


def test_statistics_stencil_is_a_toolchain_artifact():
    stats = EnsembleStatistics(3, "cuda")
    st = stats.stencil
    assert st.fingerprint and [r["pass"] for r in st.pass_report]
    assert "__global__" in st.generated_source  # one generated kernel
    assert len(stats_definition(3).api_fields) == 3 + 6
    assert EnsembleStatistics(4, "cuda").stencil.fingerprint != st.fingerprint
    with pytest.raises(EnsembleError, match="members"):
        stats(batch.zeros(4, (6, 5, 3), backend="cuda", device="cpu"))


# ---------------------------------------------------------------------------
# caching / fingerprints / hooks / the member kernel's key
# ---------------------------------------------------------------------------


def test_member_count_and_pattern_fold_into_fingerprint(steps):
    f4, f2 = _batched("cuda", members=4), _batched("cuda", members=2)
    c4 = Ensemble(steps["cuda"], 4).compiled(f4, dict(SCALARS))
    c2 = Ensemble(steps["cuda"], 2).compiled(f2, dict(SCALARS))
    assert c4.cp is c2.cp  # the single-member program is shared…
    assert c4.fingerprint != c2.fingerprint  # …the batched artifact is not
    ens = Ensemble(steps["cuda"], 4)
    assert ens.compiled(f4, dict(SCALARS)) is ens.compiled(f4, dict(SCALARS))
    assert steps["cuda"].ensemble(6).members == 6


def test_member_kernel_keyed_on_its_per_member_scalars(steps):
    ce = Ensemble(steps["cuda"], N).compiled(_batched("cuda"), dict(SCALARS))
    shared, per_dt = ce.batched_runs({}), ce.batched_runs({"dt": True})
    assert ce.batched_runs({"dt": True}) is per_dt
    k0, k1 = shared[0].kernel, per_dt[0].kernel
    assert k0.member_scalars == () and k1.member_scalars == ("dt",)
    assert k0.key != k1.key != ce.cp.group_objects[0].kernel.key
    src = k1.module.CUDA_SOURCE
    assert "blockIdx.z" in src and "const double s_dt = sv_dt[blockIdx.z];" in src
    # the one-member kernel has no member axis
    assert "blockIdx.z" not in ce.cp.group_objects[0].kernel.module.CUDA_SOURCE
    with pytest.raises(TypeError, match="member-batched"):
        k1.prepare({}, {}, DOM, {})
