"""The port's kernels on a CUDA card, against their plain versions: the
generated stencil kernels, and the hand-written flash-attention and RG-LRU
kernels.  A failed build or launch fails the test.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.kernels.hdiff.ops import hdiff  # noqa: E402
from repro_torch.kernels.hdiff.ref import hdiff_ref  # noqa: E402
from repro_torch.kernels.vadv.ops import vadv  # noqa: E402
from repro_torch.kernels.vadv.ref import vadv_ref  # noqa: E402
from repro_torch.stencils import hdiff as t_hdiff  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    return torch.device("cuda")


def _tridiagonal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.1, 2.0 + rng.random(shape), rng.normal(size=shape) * 0.1,
            rng.normal(size=shape))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_kernels_match_plain_on_the_card(card, dtype, tol):
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(43, 59, 17))).to(card, tdt)
    st = t_hdiff.build_hdiff("cuda", lim=-1e30, dtype=dtype)
    plain = t_hdiff.build_hdiff("torch", lim=-1e30, dtype=dtype)
    outs = []
    for s in (st, plain):
        out = x.clone()
        s(x, out, alpha=0.05, origin=(3, 3, 0))
        outs.append(out)
    assert st.launches >= 1 and plain.launches == 0
    torch.testing.assert_close(outs[0], outs[1], rtol=tol, atol=tol)
    torch.testing.assert_close(hdiff(x, 0.05), hdiff_ref(x, 0.05), rtol=tol, atol=tol)
    a, b, c, d = (torch.from_numpy(v).to(card, tdt) for v in _tridiagonal((37, 53, 17), 1))
    torch.testing.assert_close(vadv(a, b, c, d), vadv_ref(a, b, c, d), rtol=tol, atol=tol)


def test_kernel_wrapper_refuses_out_of_bounds_fields(card):
    x = torch.zeros(43, 59, 17, dtype=torch.float64, device=card)
    st = t_hdiff.build_hdiff("cuda")
    with pytest.raises(ValueError, match="touches"):
        st(x[:-1], x.clone(), alpha=0.05, origin=(3, 3, 0), domain=(37, 53, 17), validate_args=False)


# ---------------------------------------------------------------------------
# the hand-written LM kernels: flash attention and the RG-LRU scan
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402

_FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
# (the kernel a dtype goes to, the one it must not touch)
_ROUTES = {torch.bfloat16: (flash_ops.KERNEL_BF16, flash_ops.KERNEL),
           torch.float32: (flash_ops.KERNEL, flash_ops.KERNEL_BF16)}


def _normal(shape, seed, device, dtype):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("b,s,h,kh,dh", [
    (1, 32, 4, 4, 32), (2, 64, 8, 2, 64), (1, 48, 6, 1, 128), (2, 16, 4, 2, 96),
    (1, 100, 4, 4, 16), (2, 130, 4, 1, 160), (1, 70, 2, 2, 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_the_card(card, b, s, h, kh, dh, dtype):
    q = _normal((b, s, h, dh), 1, card, dtype)
    k = _normal((b, s, kh, dh), 2, card, dtype)
    v = _normal((b, s, kh, dh), 3, card, dtype)
    route, other = _ROUTES[dtype]
    before, before_other = route.launches, other.launches
    o = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert route.launches == before + 1 and other.launches == before_other
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), flash_attention_ref(q, k, v, causal=True).float(), rtol=tol, atol=tol)


def test_flash_kernel_window_cap_noncausal_and_strided_inputs(card):
    qkv = _normal((2, 64, 12, 32), 4, card, torch.float32)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]  # strided views, head_dim contiguous
    for kw in ({"causal": True, "window": 16, "cap": 20.0}, {"causal": False}, {"causal": False, "window": 9}):
        torch.testing.assert_close(flash_ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw),
                                   rtol=2e-6, atol=2e-6)


def test_flash_kernel_decode_rows_with_device_offsets(card):
    q = _normal((1, 32, 4, 32), 5, card, torch.float32)
    k = _normal((1, 40, 2, 32), 6, card, torch.float32)
    v = _normal((1, 40, 2, 32), 7, card, torch.float32)
    full = flash_attention_ref(q, k[:, :32], v[:, :32], causal=True)
    for t in (0, 13, 31):
        pos = torch.tensor(t, dtype=torch.int32, device=card)
        for off, klen in ((t, t + 1), (pos, pos + 1)):
            o = flash_ops.flash_attention(q[:, t:t + 1], k, v, causal=True, q_offset=off, kv_len=klen)
            torch.testing.assert_close(o[:, 0], full[:, t], rtol=2e-6, atol=2e-6)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        flash_ops.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# the bfloat16 tensor-core flash kernel (csrc/flash_fwd_sm90.cu)
# ---------------------------------------------------------------------------


def _bf16_check(q, k, v, **kw):
    """One launch of the tensor-core kernel against the plain version in
    float32 on the same bfloat16 inputs, at the reference's 2e-2."""
    before, before_f32 = flash_ops.KERNEL_BF16.launches, flash_ops.KERNEL.launches
    o = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL_BF16.launches == before + 1 and flash_ops.KERNEL.launches == before_f32
    assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(o.float(), ref, rtol=2e-2, atol=2e-2)
    return o


@pytest.mark.parametrize("dh", flash_ops.HEAD_DIMS)
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (6, 1)], ids=["MHA", "GQA", "MQA"])
def test_flash_bf16_tensor_core_kernel_every_head_dim(card, dh, h, kh):
    # 300 rows: not a multiple of the 128-row q blocks nor of the 64/128-key tiles
    q = _normal((2, 300, h, dh), 11, card, torch.bfloat16)
    k, v = (_normal((2, 300, kh, dh), seed, card, torch.bfloat16) for seed in (12, 13))
    _bf16_check(q, k, v, causal=True)


@pytest.mark.parametrize("dh", [32, 96, 160, 256])
def test_flash_bf16_noncausal_window_cap_and_strided_views(card, dh):
    qkv = _normal((2, 200, 12, dh), 14, card, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]  # strided views, head_dim contiguous
    _bf16_check(q, k, v, causal=False)
    _bf16_check(q, k, v, causal=True, window=37, cap=20.0)
    _bf16_check(q, k, v, causal=False, window=50)
    _bf16_check(q[:, :77], k, v, causal=False)  # fewer queries than keys


def test_flash_bf16_decode_rows_with_host_and_device_offsets(card):
    q = _normal((2, 1, 8, 96), 15, card, torch.bfloat16)
    k, v = (_normal((2, 300, 2, 96), seed, card, torch.bfloat16) for seed in (16, 17))
    for t in (0, 13, 127, 128, 255, 299):
        pos = torch.tensor(t, dtype=torch.int32, device=card)
        a = _bf16_check(q, k, v, causal=True, q_offset=t, kv_len=t + 1)
        b = _bf16_check(q, k, v, causal=True, q_offset=pos, kv_len=pos + 1)
        assert torch.equal(a, b)


def test_flash_bf16_row_with_no_key_gives_zero(card):
    q = _normal((1, 130, 4, 64), 18, card, torch.bfloat16)
    k, v = (_normal((1, 64, 2, 64), seed, card, torch.bfloat16) for seed in (19, 20))
    for kw in ({"causal": False, "kv_len": 0}, {"causal": True, "kv_len": 0},
               {"causal": False, "kv_len": torch.tensor(0, dtype=torch.int32, device=card)}):
        o = flash_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, torch.zeros_like(o)), kw


def test_flash_float32_route_takes_the_float64_tensor_core_kernel(card):
    q = _normal((1, 96, 4, 64), 21, card, torch.float32)
    before, before_bf16 = flash_ops.KERNEL.launches, flash_ops.KERNEL_BF16.launches
    o = flash_ops.flash_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1 and flash_ops.KERNEL_BF16.launches == before_bf16
    torch.testing.assert_close(o.double(), flash_attention_ref(q.double(), q.double(), q.double()),
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# the float32 kernel (csrc/flash_fwd.cu: scores on the float64 tensor cores)
# ---------------------------------------------------------------------------


def _f32_check(q, k, v, **kw):
    """One launch of the float32 kernel against the plain version in float64
    on the same inputs, at the reference's 2e-6."""
    before, before_bf16 = flash_ops.KERNEL.launches, flash_ops.KERNEL_BF16.launches
    o = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1 and flash_ops.KERNEL_BF16.launches == before_bf16
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    ref = flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    torch.testing.assert_close(o.double(), ref, rtol=2e-6, atol=2e-6)
    return o


@pytest.mark.parametrize("dh", flash_ops.HEAD_DIMS)
@pytest.mark.parametrize("h,kh", [(4, 4), (32, 8), (6, 1)], ids=["MHA", "GQA 8:32", "MQA"])
def test_flash_float32_every_head_dim(card, dh, h, kh):
    # 300 rows: not a multiple of the 128/64/32-row q blocks nor of the 32/16-key tiles
    q = _normal((2, 300, h, dh), 31, card, torch.float32)
    k, v = (_normal((2, 300, kh, dh), seed, card, torch.float32) for seed in (32, 33))
    _f32_check(q, k, v, causal=True)


@pytest.mark.parametrize("dh", [32, 96, 160, 256])
def test_flash_float32_ragged_window_cap_and_strided_views(card, dh):
    qkv = _normal((2, 203, 12, dh), 34, card, torch.float32)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]  # strided views, head_dim contiguous
    _f32_check(q, k, v, causal=False)
    _f32_check(q, k, v, causal=True, window=37, cap=20.0)
    _f32_check(q, k, v, causal=False, window=50)
    _f32_check(q[:, :77], k, v, causal=False)  # fewer queries than keys
    # rows that do not start on 16-byte boundaries: the kernel's 4-byte copies
    flat = _normal((1, 130, 2 * dh + 1), 35, card, torch.float32)
    kv = flat[:, :, 1:].unflatten(-1, (2, dh))
    _f32_check(_normal((1, 130, 4, dh), 36, card, torch.float32), kv, kv, causal=True)


def test_flash_float32_decode_rows_with_host_and_device_offsets(card):
    q = _normal((2, 1, 32, 96), 37, card, torch.float32)
    k, v = (_normal((2, 300, 8, 96), seed, card, torch.float32) for seed in (38, 39))
    for t in (0, 13, 31, 32, 127, 299):
        pos = torch.tensor(t, dtype=torch.int32, device=card)
        a = _f32_check(q, k, v, causal=True, q_offset=t, kv_len=t + 1)
        b = _f32_check(q, k, v, causal=True, q_offset=pos, kv_len=pos + 1)
        assert torch.equal(a, b)


def test_flash_float32_row_with_no_key_gives_zero(card):
    q = _normal((1, 130, 4, 64), 40, card, torch.float32)
    k, v = (_normal((1, 64, 2, 64), seed, card, torch.float32) for seed in (41, 42))
    for kw in ({"causal": False, "kv_len": 0}, {"causal": True, "kv_len": 0},
               {"causal": False, "kv_len": torch.tensor(0, dtype=torch.int32, device=card)}):
        o = flash_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, torch.zeros_like(o)), kw


def test_flash_bf16_refuses_misaligned_rows(card):
    x = torch.zeros(1, 8, 2 * 32 + 4, device=card, dtype=torch.bfloat16)
    q = x[:, :, 4:].unflatten(-1, (2, 32))  # 8-byte offset: rows not 16-byte aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# the generated stencil kernels on card-layout and C-order fields
# ---------------------------------------------------------------------------


def _stencil_pairs():
    """name -> build(backend, dtype) of every generated stencil of the paths"""
    from repro_torch.core.stencil import build_retyped
    from repro_torch.stencils import forecast, vintg
    from repro_torch.stencils import vadv as t_vadv

    def climate(defs):
        return lambda be, dt: build_retyped(defs, be, dt)

    return {
        "hdiff": lambda be, dt: t_hdiff.build_hdiff(be, dtype=dt),
        "hdiff_nolimit": lambda be, dt: t_hdiff.build_hdiff(be, lim=-1e30, dtype=dt),
        "hdiff_smag": lambda be, dt: t_hdiff.build_hdiff_smag(be, dtype=dt),
        "vadv": lambda be, dt: t_vadv.build_vadv(be, dtype=dt),
        "vadv_boundary": lambda be, dt: t_vadv.build_vadv_boundary(be, dtype=dt),
        "vintg": lambda be, dt: vintg.build_vintg(be, dtype=dt),
        "climate.advect": climate(forecast.advect_defs),
        "climate.euler": climate(forecast.euler_defs),
        "climate.diffuse": climate(forecast.diffuse_defs),
        "climate.vadv_system": climate(t_vadv.vadv_system_defs),
        "climate.vadv": climate(t_vadv.vadv_defs),
    }


_STENCIL_SCALARS = {"alpha": 0.05, "dt": 0.1, "dz": 0.7, "dx": 1.1, "dy": 0.9, "weight": 0.6, "decay": 0.9}


@pytest.mark.parametrize("layout", ["card", "c_order"])
@pytest.mark.parametrize("name", sorted(_stencil_pairs()))
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_generated_kernels_on_both_layouts(card, name, layout, dtype, tol):
    from repro_torch.core import storage

    build = _stencil_pairs()[name]
    st, plain = build("cuda", dtype), build("torch", dtype)
    fdt = {n: str(info.dtype) for n, info in st.field_info.items()}
    h, domain = 3, (61, 45, 19)
    rng = np.random.default_rng(len(name))
    shape = (domain[0] + 2 * h, domain[1] + 2 * h, domain[2])
    data = {n: rng.normal(size=shape) for n in st.field_info}
    if "b" in data:
        data["a"], data["c"] = data["a"] * 0.1, data["c"] * 0.1
        data["b"] = np.abs(data["b"]) + 2.0
    scalars = {s.name: _STENCIL_SCALARS[s.name] for s in st.implementation_ir.scalars}
    outs, before = [], st.launches
    for s_, lay in ((st, layout), (plain, "c_order")):
        if lay == "card":
            f = {n: storage.from_array(a, backend="cuda", dtype=fdt[n]).data for n, a in data.items()}
            assert all(storage.is_card_layout(t) for t in f.values())
        else:
            f = {n: torch.from_numpy(a.astype(fdt[n])).to(card) for n, a in data.items()}
        s_(**f, **scalars, domain=domain, origin=(h, h, 0))
        outs.append(f)
    torch.cuda.synchronize()
    assert st.launches == before + 1 and plain.launches == 0
    for n in st.implementation_ir.written_api_fields():
        assert storage.is_card_layout(outs[0][n]) == (layout == "card")  # written in place
        torch.testing.assert_close(outs[0][n], outs[1][n], rtol=tol, atol=tol)


# strips of channels not a multiple of the 16-byte chunk (130) and step counts not a
# multiple of the ring (37, 1000), at the model width (2560) and off it (2600)
@pytest.mark.parametrize("b,s,d", [(1, 16, 8), (2, 64, 32), (3, 100, 48), (2, 37, 130),
                                   (1, 4096, 2560), (4, 1000, 2600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_on_the_card(card, b, s, d, dtype):
    rng = np.random.default_rng(b * 100 + s)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, size=(b, s, d)).astype(np.float32)).to(card, dtype)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(card, dtype)
    h0 = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(card, dtype)
    before = rglru_ops.KERNEL.launches
    y = rglru_ops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rglru_ops.KERNEL.launches == before + 1
    # the kernel rounds each multiply and add as the plain loop does: equal bits
    torch.testing.assert_close(y, rglru_scan_ref(a, x, h0), rtol=0, atol=0)
    torch.testing.assert_close(rglru_ops.rglru_scan(a, x), rglru_scan_ref(a, x), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 16, 8), (4, 1000, 2600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_zero_decay_is_identity(card, shape, dtype):
    x = _normal(shape, 9, card, dtype)
    assert torch.equal(rglru_ops.rglru_scan(torch.zeros_like(x), x), x)


# ---------------------------------------------------------------------------
# @program fusion and ensembles: one generated kernel per fused group, and its
# member grid axis
# ---------------------------------------------------------------------------

from repro_torch.core import codegen_cuda, storage  # noqa: E402
from repro_torch.ensemble import Ensemble, EnsembleStatistics, batch, normal_noise, uniform_noise  # noqa: E402
from repro_torch.stencils import climate  # noqa: E402

_CDOM = (40, 36, 12)  # ragged against the (8, 32) blocks


def _climate_fields(device, seed=7):
    ni, nj, nk = _CDOM
    shape = (ni + 2 * climate.HALO, nj + 2 * climate.HALO, nk)
    rng = np.random.default_rng(seed)
    arrays = {n: np.zeros(shape) for n in climate.FIELD_NAMES}
    arrays["phi"] = rng.normal(size=shape)
    arrays["u"] = np.full(shape, 0.8)
    arrays["v"] = np.full(shape, -0.4)
    arrays["w"] = 0.2 * rng.random(shape)
    return {n: storage.from_array(a, backend="cuda", default_origin=(climate.HALO, climate.HALO, 0), device=device)
            for n, a in arrays.items()}


def test_climate_program_two_launches_a_step_and_matches_eager(card):
    st = climate.build_stencils("cuda")
    prog = climate.build_program("cuda", _CDOM, stencils=st, name="gpu_climate_step")
    sc = climate.DEFAULT_SCALARS
    fp, fe = _climate_fields(card), _climate_fields(card)
    prog(**fp, **sc)
    climate.eager_step(st, fe, _CDOM, sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(fp["phi"].data, fe["phi"].data, rtol=1e-12, atol=1e-12)
    cp = next(iter(prog._cache.values()))
    assert cp.report["group_stencils"] == [["advect_defs", "euler_defs"],
                                           ["diffuse_defs", "vadv_system_defs", "vadv_defs"]]
    # the plain modules never run on CUDA tensors
    for obj in cp.group_objects:
        obj._run = None
    codegen_cuda.reset_launch_counts()
    prog.iterate(4, **fp, **sc)
    for _ in range(5):
        prog(**fp, **sc)
    for _ in range(9):
        climate.eager_step(st, fe, _CDOM, sc)
    torch.cuda.synchronize()
    counts = codegen_cuda.launch_counts()
    assert [counts[k.key] for k in cp.group_kernels] == [9, 9]
    assert sum(counts.values()) == 18 + 9 * 5  # the eager chain's five kernels a step
    # a group's bindings share one scratch set, held by its run and not by the kernel
    for run in cp._group_runs:
        sets = {tuple(b.data_ptr() for b in launch.scratch) for launch in run.launches._launchers.values()}
        assert len(sets) == 1 and not hasattr(run.kernel, "_scratch_sets")
    assert sum(len(s) for s in cp._group_runs[1].launches._scratch_sets.values()) == len(
        cp.group_kernels[1].module.SCRATCH) > 0
    scale = float(fe["phi"].data.abs().max())
    torch.testing.assert_close(fp["phi"].data, fe["phi"].data, rtol=1e-10, atol=1e-10 * scale)


def _member_inputs(device, members):
    rng = np.random.default_rng(11)
    shape = (_CDOM[0] + 2, _CDOM[1] + 2, _CDOM[2])
    mk = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "phi": storage.card_tensor((members,) + shape, torch.float64, device).copy_(mk(rng.normal(size=(members,) + shape))),
        "u": mk(np.full(shape, 0.8)),  # shared: member stride 0
        "v": mk(rng.normal(size=shape)),
        "adv": storage.card_tensor((members,) + shape, torch.float64, device).zero_(),
        "phi_star": storage.card_tensor((members,) + shape, torch.float64, device).zero_(),
        "phi_new": storage.card_tensor((members,) + shape, torch.float64, device).zero_(),
    }


def test_member_batched_kernel_bit_identical_to_member_loop(card):
    from repro_torch.stencils import forecast

    members = 5
    dts = np.linspace(0.05, 0.2, members)
    step = forecast.build_forecast_step("cuda", _CDOM, name="gpu_member_step")
    sc = dict(forecast.DEFAULT_SCALARS)
    fields = _member_inputs(card, members)
    ref = {n: t.clone() for n, t in fields.items()}
    origin = (1, 1, 0)
    batched = {n: storage.Storage(t, "cuda", (0,) + origin if t.dim() == 4 else origin,
                                  ("N", "I", "J", "K") if t.dim() == 4 else ("I", "J", "K"))
               for n, t in fields.items()}
    ens = Ensemble(step, members)
    codegen_cuda.reset_launch_counts()
    ens.iterate(3, **batched, **dict(sc, dt=dts))
    torch.cuda.synchronize()
    ce = next(iter(ens._cache.values()))
    runs = ce.batched_runs({"dt": True})
    # [advect, euler] reads dt per member; [diffuse] reads no dt
    assert [r.kernel.member_scalars for r in runs] == [("dt",), ()]
    assert sum(codegen_cuda.launch_counts().values()) == 3 * len(runs)  # one launch a group and step
    for m in range(members):
        one = {n: storage.Storage((t[m] if t.dim() == 4 else t).clone(), "cuda", origin) for n, t in ref.items()}
        for _ in range(3):
            step(**one, **dict(sc, dt=float(dts[m])))
        torch.cuda.synchronize()
        assert torch.equal(batched["phi"].data[m], one["phi"].data), m
    assert torch.equal(batched["u"].data, ref["u"])  # the shared field is left as it was


def test_member_kernel_refuses_a_shared_or_overlapping_output(card):
    euler = climate.build_stencils("cuda")["euler"]
    kernel = euler.block_kernel(None, ())
    f = _member_inputs(card, 3)
    origins = {n: (1, 1, 0) for n in ("phi", "adv", "out")}
    with pytest.raises(ValueError, match="shared"):
        kernel.prepare({"phi": f["phi"], "adv": f["adv"], "out": f["u"]}, {"dt": 0.1}, _CDOM, origins, members=3)
    with pytest.raises(ValueError, match="overlapping members"):
        kernel.prepare({"phi": f["phi"], "adv": f["adv"], "out": f["u"].expand(3, *f["u"].shape)}, {"dt": 0.1},
                       _CDOM, origins, members=3)


def test_statistics_kernel_matches_numpy_oracle(card):
    members = 6
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=(20, 18, 7)) for _ in range(members)]
    b = batch.from_member_arrays(arrs, backend="cuda", default_origin=(1, 1, 0), device=card)
    stats = EnsembleStatistics(members, "cuda")
    stats.stencil.launches = 0
    out = stats(b, threshold=0.5)
    torch.cuda.synchronize()
    assert stats.stencil.launches == 1
    stack = np.stack(arrs)
    np.testing.assert_allclose(out["mean"].to_numpy(), stack.mean(0), rtol=1e-13)
    np.testing.assert_allclose(out["var"].to_numpy(), stack.var(0), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(out["spread"].to_numpy(), stack.std(0), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(out["mn"].to_numpy(), stack.min(0))
    np.testing.assert_array_equal(out["mx"].to_numpy(), stack.max(0))
    np.testing.assert_allclose(out["prob"].to_numpy(), (stack > 0.5).mean(0), rtol=1e-13)


def test_noise_lands_on_the_card_by_default(card):
    for draw in (normal_noise, uniform_noise):
        a = draw(5, 3, (6, 4, 2))
        assert a.is_cuda and a.shape == (3, 6, 4, 2)
        assert torch.equal(a, draw(5, 5, (6, 4, 2))[:3])  # member m's noise whatever N
        assert draw(5, 3, (6, 4, 2), device="cpu").device.type == "cpu"
