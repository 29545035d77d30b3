"""The latent-attention decode kernel (``kernels/latent_attention``) and the
model's route to it.

On the CPU (tier 1): the wrapper runs the plain formula on CPU tensors in
every dtype, and a model's decode step on the CPU gives the plain numbers
and counts whichever ``attention_impl`` it has; ``prepare`` raises on what
the kernel does not take, and passes the model's own queries at Moonlight's
widths; the split count; the kernel's byte count, once a group of 16
heads.

On a card (marked ``gpu``, skipped elsewhere; this file imports neither JAX
nor the reference package):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_latent_decode.py

the kernel against the plain formula on rows 0 .. pos (the rows past pos
hold NaN, so any read of them shows), replays of one captured CUDA graph
with pos moved between them, and a model's decode step through the kernel:
its output against the plain route's and its counts against the hand count;
a CUDA cache the kernel does not take raises.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs.moonlight_16b_a3b import FULL, REDUCED
from repro_torch.kernels.latent_attention import ops as latent_ops
from repro_torch.kernels.latent_attention.ref import attend_latent_ref
from repro_torch.models import attention, build_model
from repro_torch.obs import trace as otrace

LAT, ROPE, HEADS = FULL.mla.kv_lora_rank, FULL.mla.qk_rope_head_dim, FULL.n_heads  # 512, 64, 16
SCALE = float((FULL.mla.qk_nope_head_dim + ROPE) ** -0.5)
# Tolerances of the kernel's bfloat16 output.  Against the float64 answer:
# the output's own rounding (2^-9 of a value) and P rounded to bfloat16
# before P.V (2^-9 of each weight), so 2^-7 of the largest output, twice
# their sum.  Against the plain formula: that formula rounds each product's
# scores to bfloat16 before the softmax, 2^-9 of scores of up to about ten
# units here, which moves a weight by up to 2%; so the reference's bfloat16
# tolerance, 2e-2, of the largest output.  (At the decode cell's shape the
# plain formula lands 0.036 from the float64 answer and the kernel 0.0077,
# outputs reaching 3.)  And the kernel is no further from the float64
# answer than the plain formula, but for the output's rounding.  (An
# absolute 2e-2 against the plain formula failed at outputs near 3: 0.0266.)
EXACT_REL = 2.0 ** -7
PLAIN_REL = 2e-2
OUT_ROUNDING = 2.0 ** -8  # bfloat16's spacing at 1, of the largest output


def _inputs(b, s, h=HEADS, lat=LAT, rope=ROPE, seed=0, dtype=torch.bfloat16, device="cpu"):
    """Queries spread as the model's (scores of a few units) and a cache of
    unit rows: q_lat (B, H, lat), q_pe (B, H, rope), ckv (B, s, lat), kpe (B, s, rope)."""
    g = torch.Generator().manual_seed(seed)
    q_lat = (1.5 * torch.randn(b, h, lat, generator=g)).to(dtype)
    q_pe = (1.5 * torch.randn(b, h, rope, generator=g)).to(dtype)
    ckv = torch.randn(b, s, lat, generator=g).to(dtype)
    kpe = torch.randn(b, s, rope, generator=g).to(dtype)
    return [t.to(device) for t in (q_lat, q_pe, ckv, kpe)]


def _small_moonlight(dtype="bfloat16", layers=2):
    """Moonlight's attention at its published widths (16 heads, latent 512,
    rope 64, nope and v 128) and its ``attention_impl`` ("flash") in a model
    of a CPU test's size."""
    return dataclasses.replace(REDUCED, n_layers=layers, n_heads=HEADS, n_kv_heads=HEADS, head_dim=FULL.head_dim,
                               mla=FULL.mla, dtype=dtype, param_dtype=dtype, attention_impl=FULL.attention_impl)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_the_dispatch_keeps_the_plain_formula_off_the_kernels_inputs():
    """On CPU tensors the wrapper is the plain formula whatever the dtype or
    widths, and launches nothing; a model whose ``attention_impl`` is not
    "flash" never calls the wrapper, on any device."""
    pos = torch.tensor(20, dtype=torch.int32)
    before = latent_ops.KERNEL.launches
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        for lat, rope in ((LAT, ROPE), (REDUCED.mla.kv_lora_rank, REDUCED.mla.qk_rope_head_dim), (576, 128)):
            q_lat, q_pe, ckv, kpe = _inputs(2, 30, lat=lat, rope=rope, dtype=dtype)
            got = latent_ops.latent_attention(q_lat, q_pe, ckv, kpe, pos, SCALE)
            assert torch.equal(got, attend_latent_ref(q_lat, q_pe, ckv, kpe, pos, SCALE))
    assert latent_ops.KERNEL.launches == before
    cfg = dataclasses.replace(_small_moonlight(), attention_impl="naive")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    cache = model.make_cache(2, 8, device="cpu")
    _, cache = model.prefill(params, {"tokens": torch.ones((2, 5), dtype=torch.long)}, cache)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "attend_latent", None)  # a call would raise
        model.decode_step(params, {"tokens": torch.ones((2, 1), dtype=torch.long)}, cache)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_attend_latent_on_the_cpu_is_the_plain_formula(dtype):
    q_lat, q_pe, ckv, kpe = _inputs(3, 40, dtype=dtype)
    pos = torch.tensor(17, dtype=torch.int32)
    got = attention.attend_latent(q_lat, q_pe, ckv, kpe, pos, SCALE)
    assert torch.equal(got, attend_latent_ref(q_lat, q_pe, ckv, kpe, pos, SCALE))
    assert got.dtype == dtype and got.shape == (3, HEADS, LAT)


def test_the_wrapper_runs_the_plain_formula_on_cpu_tensors():
    q_lat, q_pe, ckv, kpe = _inputs(2, 70, h=5)
    pos = torch.tensor(64, dtype=torch.int32)
    got = latent_ops.latent_attention(q_lat, q_pe, ckv, kpe, pos, SCALE)
    assert torch.equal(got, attend_latent_ref(q_lat, q_pe, ckv, kpe, pos, SCALE))


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    q_lat, q_pe, ckv, kpe = _inputs(2, 70)
    pos = torch.tensor(5, dtype=torch.int32)
    call = latent_ops.prepare  # the checks, before the device's
    with pytest.raises(TypeError, match="bfloat16"):
        call(*(t.float() for t in (q_lat, q_pe, ckv, kpe)), pos, SCALE)
    with pytest.raises(TypeError, match="bfloat16"):
        call(q_lat, q_pe, ckv.half(), kpe, pos, SCALE)
    with pytest.raises(ValueError, match="latent 32"):
        call(*_inputs(2, 70, lat=32, rope=8), pos, SCALE)
    with pytest.raises(ValueError, match="rope 8"):
        call(*_inputs(2, 70, rope=8), pos, SCALE)
    with pytest.raises(ValueError, match="contiguous"):  # a cache of every other row
        wide = torch.cat([ckv, ckv], 1)
        call(q_lat, q_pe, wide[:, ::2], kpe, pos, SCALE)
    with pytest.raises(ValueError, match="contiguous"):  # the rope key cut from a wider row
        call(q_lat, q_pe, ckv, torch.cat([kpe, kpe], -1)[..., :ROPE], pos, SCALE)
    with pytest.raises(ValueError, match="16-byte aligned rows"):  # a query row that starts mid-chunk
        call(torch.cat([q_lat, q_lat], -1)[..., 4:LAT + 4], q_pe, ckv, kpe, pos, SCALE)
    with pytest.raises(ValueError, match="fit"):
        call(q_lat, q_pe[:1], ckv, kpe, pos, SCALE)
    with pytest.raises(TypeError, match="0-d int32"):
        call(q_lat, q_pe, ckv, kpe, 5, SCALE)
    with pytest.raises(TypeError, match="0-d int32"):
        call(q_lat, q_pe, ckv, kpe, pos.long(), SCALE)
    with pytest.raises(TypeError, match="do not launch"):  # arguments it takes, on the CPU
        call(q_lat, q_pe, ckv, kpe, pos, SCALE)


@pytest.mark.parametrize("b,h,s,sms,want", [
    (64, 16, 7184, 132, 2),    # the decode cell: 128 blocks on 132 SMs
    (63, 16, 7184, 132, 2),
    (67, 16, 7184, 132, 1),    # one wave of one block a sequence
    (1, 16, 7184, 132, 56),    # one sequence: 56 splits of two tiles
    (3, 16, 100, 132, 1),      # two tiles: one split
    (64, 128, 7184, 132, 1),   # eight head groups a sequence
    (200, 16, 7184, 132, 1),
])
def test_the_split_count_follows_the_batch_the_rows_and_the_sms(b, h, s, sms, want):
    assert latent_ops.splits(b, h, s, sms) == want


def test_a_decode_step_at_moonlights_widths_goes_through_the_wrapper(monkeypatch):
    """A bfloat16 decode step at Moonlight's attention widths with
    ``attention_impl="flash"`` calls the wrapper once a layer: on the CPU it
    gives the plain route's logits and counts the plain formula's bytes and
    no fused call, and the kernel's checks pass on the model's own q_lat and
    q_pe (as they would on the card)."""
    cfg = _small_moonlight()
    assert cfg.attention_impl == "flash"
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    b, s = 2, 9
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=torch.Generator().manual_seed(4))
    cache = model.make_cache(b, s + 3, device="cpu")
    _, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
    plain, _ = build_model(dataclasses.replace(cfg, attention_impl="chunked")).decode_step(
        params, {"tokens": toks[:, s:]}, dict(cache))

    calls = []
    wrapper = latent_ops.latent_attention

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(latent_ops, "latent_attention", counted)
    probe = otrace.arm_probe("cpu")
    try:
        got, _ = model.decode_step(params, {"tokens": toks[:, s:]}, dict(cache))
    finally:
        assert otrace.disarm_probe() is probe
    assert len(calls) == cfg.n_layers
    assert torch.equal(got, plain)
    counts = probe.result()["counts"]
    assert counts["mla.decode_calls"] == cfg.n_layers and "mla.fused_calls" not in counts
    assert counts["mla.latent_bytes"] == cfg.n_layers * b * (s + 3) * (2 * LAT + ROPE) * 2
    for args in calls:  # the model's own query layouts pass the kernel's checks
        with pytest.raises(TypeError, match="do not launch"):
            latent_ops.prepare(*args)


@pytest.mark.parametrize("heads,groups", [(16, 1), (5, 1), (17, 2), (20, 2), (128, 8)])
def test_the_kernels_byte_count_is_the_rows_up_to_pos_once_a_head_group(heads, groups):
    b, s, pos = 3, 70, 40
    _q_lat, _q_pe, ckv, kpe = _inputs(b, s, h=1)
    got = latent_ops.bytes_read(ckv, kpe, torch.tensor(pos, dtype=torch.int32), heads)
    assert got.dtype == torch.int64 and int(got) == groups * b * (pos + 1) * (LAT + ROPE) * 2
    # pos past the allocated rows counts the rows there are
    assert int(latent_ops.bytes_read(ckv, kpe, torch.tensor(s + 5, dtype=torch.int32), heads)) == \
        groups * b * s * (LAT + ROPE) * 2


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the latent-decode kernel runs only on the card")
    return torch.device("cuda")


def _nan_past(t: torch.Tensor, pos: int) -> torch.Tensor:
    t = t.clone()
    t[:, pos + 1:] = float("nan")
    return t


def _hold(got, q_lat, q_pe, ckv, kpe, pos: int):
    """The kernel's output against the plain formula on rows 0 .. pos, and
    both against the float64 answer."""
    rows = slice(0, pos + 1)
    p = torch.tensor(pos, dtype=torch.int32, device=ckv.device)
    plain = attend_latent_ref(q_lat, q_pe, ckv[:, rows], kpe[:, rows], p, SCALE)
    exact = attend_latent_ref(*(t.double() for t in (q_lat, q_pe, ckv[:, rows], kpe[:, rows])), p, SCALE)
    assert got.shape == plain.shape and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    big = float(exact.abs().max())
    torch.testing.assert_close(got.double(), exact, atol=EXACT_REL * big, rtol=EXACT_REL)
    torch.testing.assert_close(got.float(), plain.float(), atol=PLAIN_REL * big, rtol=PLAIN_REL)
    err, err_plain = (got.double() - exact).abs().max(), (plain.double() - exact).abs().max()
    assert err <= err_plain + OUT_ROUNDING * big, (float(err), float(err_plain))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 67, 3])
@pytest.mark.parametrize("pos", [0, 63, 64, 1000, 7183])
def test_the_kernel_matches_the_plain_formula_on_rows_up_to_pos(card, b, pos):
    s = 7184
    q_lat, q_pe, ckv, kpe = _inputs(b, s, seed=pos + b, device=card)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    before = latent_ops.KERNEL.launches
    got = latent_ops.latent_attention(q_lat, q_pe, _nan_past(ckv, pos), _nan_past(kpe, pos), p, SCALE)
    torch.cuda.synchronize()
    assert latent_ops.KERNEL.launches == before + 1
    _hold(got, q_lat, q_pe, ckv, kpe, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("h,lat,rope", [(5, 512, 64), (20, 192, 32), (16, 64, 16)])
def test_the_kernel_takes_other_head_counts_and_widths(card, h, lat, rope):
    """A partial head group (5 heads; 20 = 16 + 4) and narrower latent and
    rope widths, on strided queries (q_lat as the model makes it: heads
    first in memory)."""
    b, s, pos = 9, 900, 700
    q_lat, q_pe, ckv, kpe = _inputs(b, s, h=h, lat=lat, rope=rope, seed=h, device=card)
    q_lat = q_lat.transpose(0, 1).contiguous().transpose(0, 1)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    got = latent_ops.latent_attention(q_lat, q_pe, _nan_past(ckv, pos), _nan_past(kpe, pos), p, SCALE)
    _hold(got, q_lat, q_pe, ckv, kpe, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 3])
def test_one_captured_graph_follows_pos_across_replays(card, b):
    s = 7184
    q_lat, q_pe, ckv, kpe = _inputs(b, s, seed=11, device=card)
    pos = torch.zeros((), dtype=torch.int32, device=card)
    latent_ops.latent_attention(q_lat, q_pe, ckv, kpe, pos, SCALE)  # loads the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # the launch binds the capture's stream
        out = latent_ops.latent_attention(q_lat, q_pe, ckv, kpe, pos, SCALE)
    for p in (5000, 63, 7183, 64, 0):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        _hold(out.clone(), q_lat, q_pe, ckv, kpe, p)


@pytest.mark.gpu
def test_a_decode_step_through_the_kernel_counts_what_it_reads(card):
    """A bfloat16 model at Moonlight's attention widths: a decode step launches
    the kernel once a layer, its probe counts rows 0 .. pos once and one
    fused call a layer, and its logits stay near the plain route's.  Its
    layers are dense (no experts): a router's discrete choice would turn
    the bf16 rounding of either route into another expert for some token,
    and so into logits far apart (a row in four did, with one MoE layer)."""
    cfg = dataclasses.replace(_small_moonlight(), family="dense", moe=None, n_dense_layers=0)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3), device=card)
    b, s = 4, 300
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=torch.Generator().manual_seed(4)).to(card)
    cache = model.make_cache(b, s + 40, device=card)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
        before = latent_ops.KERNEL.launches
        probe = otrace.arm_probe(card)
        try:
            got, _ = model.decode_step(params, {"tokens": toks[:, s:]}, dict(cache))
        finally:
            assert otrace.disarm_probe() is probe
        assert latent_ops.KERNEL.launches == before + cfg.n_layers
        counts = probe.result()["counts"]
        assert counts["mla.fused_calls"] == counts["mla.decode_calls"] == cfg.n_layers
        assert counts["mla.latent_bytes"] == cfg.n_layers * b * (s + 1) * (LAT + ROPE) * 2
        # the same step through the plain route (a model of another impl, the same cache)
        plain_model = build_model(dataclasses.replace(cfg, attention_impl="chunked"))
        before = latent_ops.KERNEL.launches
        plain, _ = plain_model.decode_step(params, {"tokens": toks[:, s:]}, dict(cache))
        assert latent_ops.KERNEL.launches == before
    torch.cuda.synchronize()
    # the logits at the plain formula's tolerance, of their own scale
    big = float(plain.float().abs().max())
    torch.testing.assert_close(got.float(), plain.float(), atol=PLAIN_REL * big, rtol=PLAIN_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lat,rope", [(torch.float32, LAT, ROPE), (torch.bfloat16, 32, 8)])
def test_a_cuda_cache_the_kernel_does_not_take_raises(card, dtype, lat, rope):
    """No CUDA call gives way to the plain formula: a float32 cache, or the
    small test configuration's widths, raise in the wrapper."""
    q_lat, q_pe, ckv, kpe = _inputs(2, 100, lat=lat, rope=rope, dtype=dtype, device=card)
    pos = torch.tensor(50, dtype=torch.int32, device=card)
    with pytest.raises((TypeError, ValueError)):
        attention.attend_latent(q_lat, q_pe, ckv, kpe, pos, SCALE)
