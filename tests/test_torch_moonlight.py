"""Moonlight-16B-A3B (DeepSeek-V3's decoder) through the port's LM path,
against the plain reference ``tests/moonlight_reference.py``, on the CPU at
a small config of the same shape (one dense layer, then two MoE layers; d
64, 4 heads, nope 16, rope 8, v 16, latent 32, 8 experts top-2, 2 shared;
vocab 512): the forward pass, prefill and decode through the latent cache,
the absorbed decode against expanded attention, the router's bias and
scaling, dropless dispatch, the published parameter count, the spans and
the device counters."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import moonlight_reference as ref  # noqa: E402

from bench.checks.logit_gap import reference_weights  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.moonlight_16b_a3b import FULL, REDUCED  # noqa: E402
from repro_torch.models import attention, build_model, moe  # noqa: E402
from repro_torch.models.layers import rope_pairs  # noqa: E402
from repro_torch.models.model import exact_param_count  # noqa: E402
from repro_torch.models.transformer import dense_block  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402

TOL = {torch.float64: dict(rtol=1e-10, atol=1e-10), torch.float32: dict(rtol=2e-4, atol=2e-4)}


def config(dtype: torch.dtype, **kw):
    name = str(dtype).removeprefix("torch.")
    return dataclasses.replace(REDUCED, dtype=name, param_dtype=name, **kw)


def ref_config(cfg) -> dict:
    """The reference's keys (the published config's names) of a port config."""
    m, e = cfg.mla, cfg.moe
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads, "kv_lora_rank": m.kv_lora_rank,
            "qk_nope_head_dim": m.qk_nope_head_dim, "qk_rope_head_dim": m.qk_rope_head_dim,
            "v_head_dim": m.v_head_dim, "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "n_routed_experts": e.n_experts, "num_experts_per_tok": e.top_k,
            "routed_scaling_factor": e.routed_scale, "first_k_dense_replace": cfg.n_dense_layers}


def cast(tree: dict, dtype) -> dict:
    return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def ref_model(params, dtype) -> dict:
    """The port's weights in the reference's layout (the check's mapping), in ``dtype``."""
    ends = cast({"embed": params["embed"]["embedding"].data, "final_norm": params["final_norm"]["scale"].data,
                 "lm_head": params["lm_head"]["kernel"].data}, dtype)
    return dict(ends, layers=[cast(reference_weights(lp), dtype) for lp in params["decoder"]["blocks"]])


def setup(dtype, seed=5, **kw):
    cfg = config(dtype, **kw)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(seed), device="cpu")
    return cfg, model, params


def tokens(b, s, seed=11):
    return torch.randint(0, REDUCED.vocab, (b, s), generator=torch.Generator().manual_seed(seed))


def reference_logits(cfg, params, toks, dtype):
    w, rc = ref_model(params, dtype), ref_config(cfg)
    return torch.stack([ref.forward(w, t, rc) for t in toks])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_the_reference(dtype):
    cfg, model, params = setup(dtype)
    toks = tokens(2, 20)
    got, aux = model.forward(params, {"tokens": toks}, remat=False)
    torch.testing.assert_close(got, reference_logits(cfg, params, toks, dtype), **TOL[dtype])
    assert set(aux) == {"load_balance_loss", "router_z_loss"}


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_prefill_then_decode_through_the_latent_cache_matches_the_reference(dtype, impl):
    cfg, model, params = setup(dtype, attention_impl=impl, attention_chunk=8)
    toks = tokens(3, 24)
    want = reference_logits(cfg, params, toks, dtype)
    cache = model.make_cache(3, 24, device="cpu")
    assert set(cache["layers"]) == {"ckv", "kpe"}
    assert cache["layers"]["ckv"].shape == (3, 3, 24, 32) and cache["layers"]["kpe"].shape == (3, 3, 24, 8)
    logits, cache = model.prefill(params, {"tokens": toks[:, :18]}, cache)
    torch.testing.assert_close(logits, want[:, 17], **TOL[dtype])
    for i in range(18, 24):
        logits, cache = model.decode_step(params, {"tokens": toks[:, i:i + 1]}, cache)
        torch.testing.assert_close(logits, want[:, i], **TOL[dtype])
    assert int(cache["pos"]) == 24


def _expanded_decode(params, x, m, cache, rope_theta):
    """One decode token's MLA by expanding the whole latent cache into
    per-head keys and values (the prompt's form) after writing the token."""
    out_a, _ = attention.mla_attention(params, x, m, rope_theta=rope_theta, impl="naive", cache=cache)
    pos = int(cache["pos"])
    ckv, kpe = cache["ckv"][:, :pos + 1], cache["kpe"][:, :pos + 1]
    nope, rp = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = attention._project(x, params["wq"]["kernel"])
    q_pe = rope_pairs(q[..., nope:], torch.full((1, 1), pos), rope_theta)
    kv = attention._project(ckv, params["wkv_b"]["kernel"])
    b, s, h, _ = kv.shape
    k = torch.cat([kv[..., :nope], kpe[:, :, None].expand(b, s, h, rp)], -1)
    o = attention.attend(torch.cat([q[..., :nope], q_pe], -1), k,
                         torch.nn.functional.pad(kv[..., nope:], (0, rp)), impl="naive", causal=True,
                         q_offset=pos)[..., :m.v_head_dim]
    return out_a, attention.out_project(params, o)


def test_absorbed_decode_matches_expanded_attention():
    cfg, model, params = setup(torch.float64)
    lp = params["decoder"]["blocks"][1]["attn"]
    cache = model.make_cache(2, 10, device="cpu")
    layer = {"ckv": cache["layers"]["ckv"][1], "kpe": cache["layers"]["kpe"][1],
             "pos": torch.zeros((), dtype=torch.int32)}
    x = torch.randn(2, 7, cfg.d_model, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    _, layer = attention.mla_attention(lp, x, cfg.mla, rope_theta=cfg.rope_theta, impl="naive", cache=layer)
    step = torch.randn(2, 1, cfg.d_model, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    absorbed, expanded = _expanded_decode(lp, step, cfg.mla, layer, cfg.rope_theta)
    torch.testing.assert_close(absorbed, expanded, rtol=1e-12, atol=1e-12)


def test_rope_pairs_is_the_references_rope():
    x = torch.randn(5, 3, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(100, 105)
    torch.testing.assert_close(rope_pairs(x[None], pos[None], 50000.0)[0], ref.rope(x, pos, 50000.0),
                               rtol=1e-12, atol=1e-12)


def test_the_bias_moves_the_choice_and_not_the_weights():
    cfg = config(torch.float64).moe
    d = 16
    gen = torch.Generator().manual_seed(4)
    params = {"router": {"kernel": torch.randn(d, cfg.n_experts, dtype=torch.float64, generator=gen),
                         "bias": torch.zeros(cfg.n_experts, dtype=torch.float64)}}
    x = torch.randn(1, 40, d, dtype=torch.float64, generator=gen)
    ids0, w0 = moe.sigmoid_route(params, x, cfg)
    scores = torch.sigmoid(x @ params["router"]["kernel"])
    torch.testing.assert_close(w0.sum(-1), torch.full((1, 40), cfg.routed_scale, dtype=torch.float64))
    # a large bias on expert 3 puts it in every token's choice
    params["router"]["bias"][3] = 10.0
    ids1, w1 = moe.sigmoid_route(params, x, cfg)
    assert bool((ids1 == 3).any(-1).all()) and not bool((ids0 == 3).any(-1).all())
    # its weight is its unbiased score, normalised over the chosen and scaled
    chosen = torch.gather(scores, -1, ids1)
    torch.testing.assert_close(w1, chosen / chosen.sum(-1, keepdim=True) * cfg.routed_scale)
    ref_ids, ref_w, _ = ref.route({"router": params["router"]["kernel"], "bias": params["router"]["bias"]}, x[0],
                                  {"num_experts_per_tok": cfg.top_k, "routed_scaling_factor": cfg.routed_scale})
    assert torch.equal(ref_ids, ids1[0])
    torch.testing.assert_close(ref_w, w1[0])


@pytest.mark.parametrize("tokens_in_call", [6, 276])
def test_no_token_is_dropped_when_one_expert_takes_every_token(tokens_in_call):
    """A bias that sends every token to expert 0 (and the same second
    expert): each token's output is still its two experts' and the shared
    ones', as a prompt (the sorted loop) and as a decode step of as many
    rows (the dense path)."""
    cfg, model, params = setup(torch.float64)
    mp = params["decoder"]["blocks"][1]["moe"]
    mp["router"]["bias"].data.zero_()
    mp["router"]["bias"].data[0] = 10.0
    mp["router"]["bias"].data[5] = 9.0
    x = torch.randn(1, tokens_in_call, cfg.d_model, dtype=torch.float64, generator=torch.Generator().manual_seed(9))
    w = cast(reference_weights(params["decoder"]["blocks"][1]), torch.float64)
    ids, weights, _ = ref.route(w, x[0], ref_config(cfg))
    assert bool((ids.sort(-1).values == torch.tensor([0, 5])).all())
    want = ref.experts(w, x[0], ids, weights)
    prompt, _ = moe.moe_layer(mp, x, cfg.moe, cfg.activation)
    step, _ = moe.moe_layer(mp, x.transpose(0, 1), cfg.moe, cfg.activation)
    torch.testing.assert_close(prompt[0], want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(step[:, 0], want, rtol=1e-12, atol=1e-12)


def test_a_decode_step_of_many_rows_dispatches_with_no_host_read():
    """A decode step of 300 rows (more than the cell's 64) runs the dropless
    layer on meta tensors, which hold no data: a read of a value on the host
    (``tolist``, ``item``, a count that sizes a tensor) cannot run there.
    A prompt of as many tokens does read its counts, and fails so."""
    cfg = config(torch.float32)
    mp = build_model(cfg).abstract_params()["decoder"]["blocks"][1]["moe"]  # meta tensors
    out, _ = moe.moe_layer(mp, torch.empty(300, 1, cfg.d_model, device="meta"), cfg.moe, cfg.activation)
    assert out.shape == (300, 1, cfg.d_model) and out.device.type == "meta"
    with pytest.raises((NotImplementedError, RuntimeError)):
        moe.moe_layer(mp, torch.empty(1, 300, cfg.d_model, device="meta"), cfg.moe, cfg.activation)


def test_the_published_config_counts_its_parameters_from_the_specs():
    assert exact_param_count(FULL) == 15_960_110_208
    tree = build_model(FULL).abstract_params()
    leaves = [t for _p, t in tree.leaves()]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == 15_960_110_208
    assert "moonlight-16b-a3b" not in list_archs()


def test_the_benchmark_holds_a_byte_copy_of_the_reference():
    assert (ROOT / "bench" / "reference" / "moonlight.py").read_bytes() == (ROOT / "tests" / "moonlight_reference.py").read_bytes()


def test_the_benchmark_builds_the_published_config():
    import json

    from bench.inputs.lm_tokens import arch

    cfg = json.loads((ROOT / "bench" / "configs" / "moonlight.json").read_text())
    assert dataclasses.replace(arch(cfg), name=FULL.name) == FULL


def _decode_once(model, params, cfg, b=2, s=9):
    cache = model.make_cache(b, s + 1, device="cpu")
    toks = tokens(b, s + 1)
    _, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
    return cache, toks[:, s:]


def test_the_spans_appear_as_profiler_annotations():
    cfg, model, params = setup(torch.float32)
    cache, tok = _decode_once(model, params, cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.decode_step(params, {"tokens": tok}, cache)
    names = {e.name for e in prof.events()}
    assert {"lm.decode_step", "mla.project", "mla.attend", "moe.route", "moe.experts", "moe.shared"} <= names


def test_the_probe_counts_equal_the_hand_count():
    cfg, model, params = setup(torch.float32)
    b, s = 2, 9
    cache, tok = _decode_once(model, params, cfg, b, s)
    probe = otrace.arm_probe("cpu")
    try:
        model.decode_step(params, {"tokens": tok}, cache)
    finally:
        assert otrace.disarm_probe() is probe
    got = probe.result()
    m, e = cfg.mla, cfg.moe
    # every allocated row (s + 1) of every layer: the latent twice, the rope key once, float32
    assert got["counts"]["mla.latent_bytes"] == cfg.n_layers * b * (s + 1) * (2 * m.kv_lora_rank + m.qk_rope_head_dim) * 4
    assert got["counts"]["mla.decode_calls"] == cfg.n_layers
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    assert got["counts"]["moe.layer_calls"] == moe_layers
    assert sum(got["counts"]["moe.expert_tokens"]) == moe_layers * b * e.top_k
    touched = got["counts"]["moe.experts_touched"]
    assert 2 <= touched <= moe_layers * min(e.n_experts, b * e.top_k)
    assert got["counts"]["moe.expert_bytes"] == touched * 3 * cfg.d_model * e.d_ff_expert * 4
    assert set(got["seconds"]) == {"lm.decode_step", "mla.project", "mla.attend", "moe.route", "moe.experts",
                                   "moe.shared"}
    assert got["calls"]["mla.attend"] == cfg.n_layers and got["calls"]["lm.decode_step"] == 1
    # disarmed: nothing more is counted
    model.decode_step(params, {"tokens": tok}, cache)
    assert probe.result()["counts"] == got["counts"]


def test_the_taps_hand_each_layer_input_and_choice_to_the_sink_while_set():
    """While a sink is set, a decode step taps each layer's input, the
    stack's output and each MoE layer's choice of experts: the layer inputs
    chain (each the previous layer's output) and the choices are the
    router's; with no sink set nothing is kept."""
    cfg, model, params = setup(torch.float32)
    cache, tok = _decode_once(model, params, cfg)
    kept = []
    with otrace.tapping(lambda name, t: kept.append((name, t.clone()))):
        model.decode_step(params, {"tokens": tok}, dict(cache))
    names = [n for n, _t in kept]
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    assert names.count("layer.input") == cfg.n_layers and names.count("stack.output") == 1
    assert names.count("moe.choice") == moe_layers and names[-1] == "stack.output"
    xs = [t for n, t in kept if n in ("layer.input", "stack.output")]
    assert all(x.shape == (2, 1, cfg.d_model) for x in xs)
    choices = [t for n, t in kept if n == "moe.choice"]
    assert all(c.shape == (2, 1, cfg.moe.top_k) for c in choices)
    # the first layer's output, run alone, is the second layer's input
    block0 = params["decoder"]["blocks"][0]
    c0 = {n: t[0] for n, t in cache["layers"].items()}
    c0["pos"] = cache["pos"]
    y0, _c, _aux = dense_block(block0, xs[0], cfg, cache=c0)
    torch.testing.assert_close(y0, xs[1], **TOL[torch.float32])
    kept.clear()
    model.decode_step(params, {"tokens": tok}, dict(cache))
    assert kept == []
