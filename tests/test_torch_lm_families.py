"""The port's non-dense LM families on the CPU, against the reference package.

The hybrid (RecurrentGemma: RG-LRU blocks and local attention), moe
(Moonlight, Phi-3.5-MoE), ssm (Mamba-2), enc-dec audio (Whisper) and vlm
(InternVL2) families at their reduced configs: the reference's
``init_params`` weights are carried into the port with
``repro_torch.models.convert`` (after the true-fan-in rescale of
``tests/test_torch_lm.py``, here for the cross-attention kernels too), and
the same numpy inputs go through both packages' ``forward``, ``loss``,
``prefill`` and ``decode_step``.  Models and layers are held at 1e-5 of the
largest output (``_near``): the port's RG-LRU recurrence is a sequential
loop where the reference folds an associative scan, and its MoE sums each
token's expert outputs in another order.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as r_get_arch
from repro.models import attention as r_attn
from repro.models import build_model as r_build_model
from repro.models import moe as r_moe
from repro.models import rglru as r_rglru
from repro.models import ssm as r_ssm
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model, exact_param_count
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import cache_from_reference, params_from_reference, to_tensor
from repro_torch.models.model import LM

FAMILIES = ["recurrentgemma-2b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "mamba2-370m",
            "whisper-medium", "internvl2-1b"]
WITH_ATTENTION = [a for a in FAMILIES if a != "mamba2-370m"]


def _ref_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _near(got: torch.Tensor, ref, rel: float = 1e-5):
    """max |got - ref| <= rel * max |ref| (in float64)."""
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got.double().numpy() - ref).max())
    assert tuple(got.shape) == ref.shape and err <= rel * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def _near_tree(got, ref, path=""):
    assert set(got) == set(ref), (path, sorted(got), sorted(ref))
    for k, v in ref.items():
        if isinstance(v, dict):
            _near_tree(got[k], v, f"{path}/{k}")
        elif k == "pos":
            assert int(got[k]) == int(np.asarray(v)), path
        else:
            _near(got[k], v)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _true_fan_in(tree, cfg):
    """The reference's weights with the self- and cross-attention kernels
    rescaled from the reference's fan-in (H into q/k/v, Dh into the output)
    to the true one (d_model, H·Dh), as the port's ``attention_spec``."""
    if not cfg.n_heads:  # attention-free (ssm)
        return tree
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    factor = {"wq": np.sqrt(h / d), "wk": np.sqrt(h / d), "wv": np.sqrt(h / d), "wo": np.sqrt(hd / (h * hd))}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if len(path) >= 3 and path[-3] in ("attn", "xattn") and path[-1] == "kernel":
            return (node * factor[path[-2]]).astype(node.dtype)
        return node

    return walk(tree, ())


def _configs(arch, impl=None):
    """Both packages' reduced configs; ``impl`` = (reference, port) attention
    impls, with a head_dim the port's flash kernel takes when it has none."""
    r_cfg, t_cfg = r_get_arch(arch).reduced, get_arch(arch).reduced
    if impl is not None:
        hd = {} if t_cfg.resolved_head_dim in HEAD_DIMS else {"head_dim": 16}
        r_cfg = dataclasses.replace(r_cfg, attention_impl=impl[0], **hd)
        t_cfg = dataclasses.replace(t_cfg, attention_impl=impl[1], **hd)
    return r_cfg, t_cfg


def _models(arch, impl=None):
    r_cfg, t_cfg = _configs(arch, impl)
    r_model, t_model = r_build_model(r_cfg), build_model(t_cfg)
    tree = _true_fan_in(_ref_tree(r_model.init_params(jax.random.PRNGKey(2))), r_cfg)
    return r_model, jax.tree_util.tree_map(jnp.asarray, tree), t_model, params_from_reference(tree, device="cpu")


def _batch(cfg, b, s, seed=0):
    """tokens and labels (B, S), plus seeded frames or patches."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the models on carried-over weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_reference(arch):
    r_model, r_params, t_model, t_params = _models(arch)
    r_batch, t_batch = _both(_batch(t_model.cfg, 2, 12))
    ref, r_aux = jax.jit(lambda p, b: r_model.forward(p, b, remat=False))(r_params, r_batch)
    got, t_aux = t_model.forward(t_params, t_batch)
    assert got.dtype == torch.float32
    _near(got, ref)
    assert sorted(t_aux) == sorted(r_aux)
    for k in r_aux:
        _near(t_aux[k], r_aux[k])
    r_loss, r_metrics = jax.jit(lambda p, b: r_model.loss(p, b, remat=False))(r_params, r_batch)
    t_loss, t_metrics = t_model.loss(t_params, t_batch)
    _near(t_loss, r_loss)
    assert sorted(t_metrics) == sorted(r_metrics)
    assert float(t_metrics["tokens"]) == float(r_metrics["tokens"]) == 22


def _serve_both(arch, impl, b=2, prompt=12, steps=4):
    """Prefill and ``steps`` decode steps through both packages; returns the
    pairs of logits (prefill first) and the final caches.  The prompt is
    longer than the hybrid's window (8), so prefill and decode both mask."""
    r_model, r_params, t_model, t_params = _models(arch, impl)
    cfg = t_model.cfg
    batch = _batch(cfg, b, prompt + steps, seed=1)
    r_cache = r_model.make_cache(batch=b, max_len=prompt + steps + (cfg.encoder_seq if cfg.frontend else 0) + 4)
    t_cache = cache_from_reference(_ref_tree(r_cache), device="cpu")
    first = {k: v for k, v in batch.items() if k != "labels"}
    first["tokens"] = batch["tokens"][:, :prompt]
    r_batch, t_batch = _both(first)
    r_logits, r_cache = jax.jit(r_model.prefill)(r_params, r_batch, r_cache)
    t_logits, t_cache = t_model.prefill(t_params, t_batch, t_cache)
    pairs = [(t_logits, r_logits)]
    r_step = jax.jit(r_model.decode_step)
    for t in range(prompt, prompt + steps):
        step = {"tokens": batch["tokens"][:, t:t + 1]}
        if cfg.is_encdec:
            step["frames"] = batch["frames"]
        r_batch, t_batch = _both(step)
        r_logits, r_cache = r_step(r_params, r_batch, r_cache)
        t_logits, t_cache = t_model.decode_step(t_params, t_batch, t_cache)
        pairs.append((t_logits, r_logits))
    return pairs, t_cache, r_cache


@pytest.mark.parametrize("arch,impl", [(a, None) for a in FAMILIES] + [(a, ("pallas", "flash")) for a in WITH_ATTENTION],
                         ids=[f"{a}-naive" for a in FAMILIES] + [f"{a}-pallas-vs-flash" for a in WITH_ATTENTION])
def test_prefill_and_decode_match_reference(arch, impl):
    pairs, t_cache, r_cache = _serve_both(arch, impl)
    for got, ref in pairs:
        _near(got, ref)
    _near_tree(t_cache, _ref_tree(r_cache))
    extra = r_get_arch(arch).reduced.encoder_seq if r_get_arch(arch).reduced.frontend == "vision" else 0
    assert int(t_cache["pos"]) == 16 + extra


def test_encoded_frames_serve_as_the_frames_do():
    """Whisper: ``encode`` once and pass 'enc_kv' gives the bits of passing
    'frames' to every step (the reference re-encodes them each step)."""
    _, _, model, params = _models("whisper-medium")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg, 2, 10, seed=3).items()}
    enc_kv = model.encode(params, batch["frames"])
    assert len(enc_kv) == model.cfg.n_layers
    outs = []
    for extra in ({"frames": batch["frames"]}, {"enc_kv": enc_kv}):
        cache = model.make_cache(2, 12, device="cpu")
        logits, cache = model.prefill(params, {"tokens": batch["tokens"][:, :8], **extra}, cache)
        steps = [model.decode_step(params, {"tokens": batch["tokens"][:, t:t + 1], **extra}, cache)[0] for t in (8, 9)]
        outs.append([logits] + steps + [cache["layers"]["k"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _module_params(spec_fn, *args, seed=4, scale=0.3, **overrides):
    """Random leaves for one module's ParamSpec tree, as numpy, for both packages."""
    from repro.models.layers import ParamSpec

    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32), spec_fn(*args),
                                  is_leaf=lambda s: isinstance(s, ParamSpec))
    tree.update(overrides)
    return jax.tree_util.tree_map(jnp.asarray, tree), jax.tree_util.tree_map(torch.from_numpy, tree)


def test_rglru_block_continues_its_cache_over_decode():
    """A prompt through the scan, then four tokens through ``rglru_step``,
    against the reference's block (a length-1 scan per token), with the conv
    tail and the state carried in the cache."""
    cfg = r_get_arch("recurrentgemma-2b").reduced.rglru
    d, b, prompt = 24, 2, 9
    cfg = dataclasses.replace(cfg, d_rnn=32)
    r_p, t_p = _module_params(r_rglru.rglru_block_spec, d, cfg)
    x = _rand((b, prompt + 4, d), 5)
    r_cache = r_rglru.make_rglru_cache(b, d, cfg, jnp.float32)
    t_cache = t_rglru.make_rglru_cache(b, d, cfg, torch.float32, device="cpu")
    for lo, hi in [(0, prompt)] + [(t, t + 1) for t in range(prompt, prompt + 4)]:
        r_y, r_cache = r_rglru.rglru_block(r_p, jnp.asarray(x[:, lo:hi]), cfg, cache=r_cache)
        t_y, t_cache = t_rglru.rglru_block(t_p, torch.from_numpy(x[:, lo:hi]), cfg, cache=t_cache)
        _near(t_y, r_y)
        _near_tree(t_cache, _ref_tree(r_cache))
    # without a cache the block is the same function of the whole sequence
    _near(t_rglru.rglru_block(t_p, torch.from_numpy(x), cfg)[0], r_rglru.rglru_block(r_p, jnp.asarray(x), cfg)[0])


def test_rglru_block_takes_the_scan_it_is_given():
    """The plain scan reached through the block's argument (the seam the
    card's comparisons use) gives the default op's bits on the CPU."""
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    cfg = r_get_arch("recurrentgemma-2b").reduced.rglru
    _, t_p = _module_params(r_rglru.rglru_block_spec, 80, cfg)
    x = torch.from_numpy(_rand((2, 7, 80), 6))
    calls = []

    def scan(a, b, h0):
        calls.append((a.dtype, b.dtype, a.is_contiguous() and b.is_contiguous()))
        return rglru_scan_ref(a, b, h0)

    assert torch.equal(t_rglru.rglru_block(t_p, x, cfg, scan=scan)[0], t_rglru.rglru_block(t_p, x, cfg)[0])
    assert calls == [(torch.float32, torch.float32, True)]


@pytest.mark.parametrize("capacity", [None, 3], ids=["dropless", "drops"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"])
def test_moe_layer_matches_reference(arch, capacity):
    """Routing, the aux losses, the capacity clamp (a capacity of 3 for 24
    assignments over 4-8 experts drops tokens) and the shared expert."""
    cfg = r_get_arch(arch).reduced
    r_p, t_p = _module_params(r_moe.moe_spec, cfg.d_model, cfg.moe, cfg.activation, cfg.use_bias)
    t_moe_cfg = get_arch(arch).reduced.moe  # the port's config of the same layer
    x = _rand((2, 12, cfg.d_model), 7)
    r_out, r_aux = r_moe.moe_layer(r_p, jnp.asarray(x), cfg.moe, cfg.activation, capacity=capacity)
    t_out, t_aux = t_moe.moe_layer(t_p, torch.from_numpy(x), t_moe_cfg, cfg.activation, capacity=capacity)
    _near(t_out, r_out)
    for k in ("load_balance_loss", "router_z_loss"):
        _near(t_aux[k], r_aux[k])
    # the clamp: with capacity 3 some token loses an expert, and its output differs from the dropless one
    dropless, _ = t_moe.moe_layer(t_p, torch.from_numpy(x), t_moe_cfg, cfg.activation, capacity=12)
    assert torch.equal(t_out, dropless) == (capacity is None)


def test_moe_dropped_tokens_get_only_the_shared_expert():
    """A capacity of 1 keeps the first assignment of each expert; every other
    token's routed output is 0 (the overflow slot adds nothing), so with no
    shared expert its output row is exactly 0."""
    cfg = dataclasses.replace(r_get_arch("phi3.5-moe-42b-a6.6b").reduced.moe, n_experts=2, top_k=1)
    _, t_p = _module_params(r_moe.moe_spec, 16, cfg, "swiglu", False)
    x = torch.from_numpy(_rand((1, 6, 16), 8))
    t_cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").reduced.moe, n_experts=2, top_k=1)
    out, _ = t_moe.moe_layer(t_p, x, t_cfg, "swiglu", capacity=1)
    assert int((out.abs().sum(-1) > 0).sum()) <= 2
    assert int((out.abs().sum(-1) == 0).sum()) >= 4


@pytest.mark.parametrize("s,chunk", [(13, 4), (8, 8), (5, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """A length that is not a multiple of the chunk, and a carried state0."""
    b, h, p, g, n = 2, 4, 8, 2, 6
    x, B, C = _rand((b, s, h, p), 1), _rand((b, s, g, n), 2, 0.5), _rand((b, s, g, n), 3, 0.5)
    dt = np.log1p(np.exp(_rand((b, s, h), 4)))
    A, D, state0 = -np.exp(_rand((h,), 5, 0.3)), _rand((h,), 6), _rand((b, h, n, p), 9)
    args = (x, dt, A, B, C, D)
    r_y, r_state = r_ssm._ssd_chunked(*map(jnp.asarray, args), chunk, state0=jnp.asarray(state0))
    t_y, t_state = t_ssm._ssd_chunked(*map(torch.from_numpy, args), chunk, state0=torch.from_numpy(state0))
    _near(t_y, r_y)
    _near(t_state, r_state)
    r_y0, _ = r_ssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    _near(t_ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)[0], r_y0)


def test_ssd_chunked_decays_hold_float64_recurrence():
    """At Mamba-2's chunk of 256, where the within-chunk log-decay sums reach
    ~|300|: the port's float32 chunked scan against the float64 step-by-step
    recurrence (the decode step's own form) within 1e-6 of the largest value,
    which the reference's exp(cum_i - cum_j) does not reach."""
    b, s, h, p, n, chunk = 1, 512, 4, 8, 16, 256
    x, B, C = _rand((b, s, h, p), 1), _rand((b, s, 1, n), 2), _rand((b, s, 1, n), 3)
    dt = np.log1p(np.exp(_rand((b, s, h), 4) + 1.0)).astype(np.float32)
    A, D = -np.exp(_rand((h,), 5, 0.3)), np.ones(h, np.float32)
    state, ys = np.zeros((b, h, n, p)), []
    for t in range(s):
        state = (state * np.exp(dt[:, t].astype(np.float64) * A)[..., None, None]
                 + np.einsum("bh,bn,bhp->bhnp", dt[:, t], B[:, t, 0], x[:, t]))
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t, 0], state) + x[:, t] * D[None, :, None])
    # one thread: a process's first multi-threaded float32 ``torch.exp`` has
    # been seen to miss by 1e-4 relative on some x86 CPUs, far past this limit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        y, final = t_ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C, D)), chunk)
    finally:
        torch.set_num_threads(threads)
    _near(y, np.stack(ys, 1), 1e-6)
    _near(final, state, 1e-6)


def test_ssd_block_continues_its_cache_over_decode():
    cfg = r_get_arch("mamba2-370m").reduced.ssm
    d, b, prompt = 64, 2, 11
    r_p, t_p = _module_params(r_ssm.ssd_spec, d, cfg, scale=0.2)
    x = _rand((b, prompt + 3, d), 10)
    r_cache = r_ssm.make_ssd_cache(b, d, cfg, jnp.float32)
    t_cache = t_ssm.make_ssd_cache(b, d, cfg, torch.float32, device="cpu")
    for lo, hi in [(0, prompt)] + [(t, t + 1) for t in range(prompt, prompt + 3)]:
        r_y, r_cache = r_ssm.ssd_block(r_p, jnp.asarray(x[:, lo:hi]), cfg, cache=r_cache)
        t_y, t_cache = t_ssm.ssd_block(t_p, torch.from_numpy(x[:, lo:hi]), cfg, cache=t_cache)
        _near(t_y, r_y)
        _near_tree(t_cache, _ref_tree(r_cache))


def test_ssd_block_float64_decode_is_its_forward():
    """Float64 activations run the SSD in float64 (float32 ones in float32, as
    the reference casts): the prompt and 3 decode steps through the cache
    give the full sequence's outputs to float64 rounding."""
    cfg = r_get_arch("mamba2-370m").reduced.ssm
    d, b, prompt = 64, 2, 11
    _, t_p = _module_params(r_ssm.ssd_spec, d, cfg, scale=0.2)
    x = torch.from_numpy(_rand((b, prompt + 3, d), 10)).double()
    full, _ = t_ssm.ssd_block(t_p, x, cfg)
    cache = t_ssm.make_ssd_cache(b, d, cfg, torch.float64, device="cpu")
    parts = []
    for lo, hi in [(0, prompt)] + [(t, t + 1) for t in range(prompt, prompt + 3)]:
        y, cache = t_ssm.ssd_block(t_p, x[:, lo:hi], cfg, cache=cache)
        parts.append(y)
    assert full.dtype == torch.float64
    _near(torch.cat(parts, dim=1), full.numpy(), 1e-12)


def test_mamba2_float64_serve_is_its_forward():
    """The reduced Mamba-2 in float64 (its norms too): prefill and 4 decode
    steps give the teacher-forced forward's logits to float64 rounding."""
    cfg = dataclasses.replace(get_arch("mamba2-370m").reduced, dtype="float64")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_batch(cfg, 2, 16, seed=3)["tokens"]).long()
    cache = model.make_cache(2, 20, device="cpu")
    logits, cache = model.prefill(params, {"tokens": tokens[:, :12]}, cache)
    got = [logits]
    for t in range(12, 16):
        logits, cache = model.decode_step(params, {"tokens": tokens[:, t:t + 1]}, cache)
        got.append(logits)
    full, _ = model.forward(params, {"tokens": tokens})
    _near(torch.stack(got, 1).double(), full[:, 11:].double().numpy(), 1e-12)


@pytest.mark.parametrize("impl", [("naive", "naive"), ("chunked", "chunked"), ("pallas", "flash")])
@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(impl, sq):
    """``encoder_kv`` over 19 encoder frames and ``cross_attention`` of a
    prompt (5 queries) or a decode row (1), GQA 4:2, non-causal."""
    d, h, kh, hd = 32, 4, 2, 16
    spec = r_attn.cross_attention_spec(d, h, kh, hd)
    r_p, t_p = _module_params(lambda: spec, scale=0.2)
    enc, x = _rand((2, 19, d), 11), _rand((2, sq, d), 12)
    r_kv = r_attn.encoder_kv(r_p, jnp.asarray(enc))
    t_kv = t_attn.encoder_kv(t_p, torch.from_numpy(enc))
    for got, ref in zip(t_kv, r_kv):
        _near(got, ref)
    ref = r_attn.cross_attention(r_p, jnp.asarray(x), r_kv, impl[0], chunk=8)
    _near(t_attn.cross_attention(t_p, torch.from_numpy(x), t_kv, impl[1], chunk=8), ref)


@pytest.mark.parametrize("t", [3, 8, 13, 20])
def test_naive_decode_masks_the_window(t):
    """One query row at position t against a cache of 24 keys, window 6:
    only keys t-5..t count (past the window the older keys are masked), as
    in the reference; keys outside the window do not move the output."""
    q, k, v = _rand((2, 1, 4, 16), 13), _rand((2, 24, 2, 16), 14), _rand((2, 24, 2, 16), 15)
    kw = dict(causal=True, q_offset=t, kv_len=t + 1, window=6)
    got = t_attn.attend_naive(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    _near(got, r_attn.attend_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    k2, v2 = k.copy(), v.copy()
    outside = [i for i in range(24) if not t - 6 < i <= t]
    k2[:, outside], v2[:, outside] = 50.0, -50.0
    assert torch.equal(t_attn.attend_naive(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), **kw), got)
    if t >= 6:  # past the window: the same row without the window differs
        no_window = {**kw, "window": None}
        assert not torch.equal(t_attn.attend_naive(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                                   **no_window), got)


# ---------------------------------------------------------------------------
# weights and caches: dtypes and devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "moonshot-v1-16b-a3b", "mamba2-370m"])
def test_bfloat16_init_is_the_serving_cast_of_the_float32_one(arch):
    """``param_dtype="bfloat16"`` draws each leaf as the float32 init does and
    rounds it once: the same tree as ``serving_params`` of the float32 init,
    with the leaves read in float32 (norms, the router, the RG-LRU gates,
    the SSM vectors) kept in float32; served logits are the same bits."""
    cfg = dataclasses.replace(get_arch(arch).reduced, dtype="bfloat16")
    model = build_model(cfg)
    master = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    served = model.serving_params(master)
    direct = build_model(dataclasses.replace(cfg, param_dtype="bfloat16")).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    kept = 0
    for (name, a), (_, b), (_, c) in zip(served.named_parameters(), direct.named_parameters(),
                                         master.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        kept += a.dtype == torch.float32
        assert a.dtype == (torch.float32 if a.dtype == c.dtype else torch.bfloat16), name
    assert kept > 0 and sum(p.numel() for p in direct.parameters()) == exact_param_count(cfg)
    tokens = torch.from_numpy(_batch(cfg, 2, 10, seed=3)["tokens"])
    outs = []
    for p in (master, served):
        cache = model.make_cache(2, 12, device="cpu")
        logits, cache = model.prefill(p, {"tokens": tokens[:, :8]}, cache)
        outs.append([logits] + [model.decode_step(p, {"tokens": tokens[:, t:t + 1]}, cache)[0] for t in (8, 9)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_new_entry_points_default_to_the_card():
    """``make_cache`` and the state caches put what they make on the card
    unless the caller names another device; without a GPU a call that names
    none raises instead of landing on the host."""
    for fn in (LM.make_cache, LM.init_params, t_rglru.make_rglru_cache, t_ssm.make_ssd_cache, to_tensor):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    for arch in FAMILIES:
        model = build_model(get_arch(arch).reduced)
        cache = model.make_cache(1, 4, device="cpu")
        assert all(t.device.type == "cpu" for t in jax.tree_util.tree_leaves(cache))
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                model.make_cache(1, 4)
