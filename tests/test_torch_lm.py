"""The port's LM (dense family) on the CPU, against the reference package.

The reference's ``init_params`` weights are carried into the port with
``repro_torch.models.convert``; the same token batches (numpy, seeded) go
through both packages' ``forward``, ``prefill`` and ``decode_step``.  The
layers are held at 1e-6 elementwise, the models at 1e-5 of the largest
output: max |port - reference| <= 1e-5 * max |reference| (float32).

Before they are carried across, the attention kernels of the reference's
weights are rescaled to their true fan-in (as the port's ``attention_spec``
initializes them; ROADMAP.md, Queue 3), in both packages alike.  With the
reference's own scales the scores run into the hundreds, the softmax is
one-hot, and last-bit differences between the packages (sums in another
order, XLA's own exp and rsqrt) flip near-ties: there the reference's own
float32 logits stray from a float64-activation run by up to 3.1e-5 of their
norm, so 1e-5 between the packages would test the rounding, not the model.
With the rescaled weights the packages agree to within 9e-7.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.models import build_model as r_build_model
from repro.models import layers as r_layers
from repro.models.model import exact_param_count as r_exact_param_count
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import build_model, exact_param_count, layers
from repro_torch.models.convert import cache_from_reference, params_from_reference

DENSE = ["phi3-mini-3.8b", "stablelm-12b", "deepseek-coder-33b", "command-r-35b"]


def _ref_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got: torch.Tensor, ref, rtol: float, atol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def _near(got: torch.Tensor, ref, rel: float = 1e-5):
    """max |got - ref| <= rel * max |ref| (in float64)."""
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got.double().numpy() - ref).max())
    assert got.shape == ref.shape and err <= rel * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_norms_match_reference():
    x = _x((2, 5, 24))
    scale, bias = _x((24,), 1) + 1.0, _x((24,), 2)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    p = {"scale": scale, "bias": bias}
    _close(layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
           r_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 8e6])
def test_rope_matches_reference(theta):
    x = _x((2, 7, 3, 32))
    pos = np.arange(3, 10, dtype=np.int32)[None, :]
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           r_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(activation):
    spec = r_layers.mlp_spec(16, 40, activation, use_bias=True)
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.3, spec,
                               is_leaf=lambda s: isinstance(s, r_layers.ParamSpec))
    x = _x((2, 3, 16))
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    _close(layers.mlp(tp, torch.from_numpy(x), activation),
           r_layers.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), activation), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the dense models on carried-over weights
# ---------------------------------------------------------------------------


def _true_fan_in(tree, cfg):
    """The reference's weights with the attention kernels rescaled from the
    reference's fan-in (H into q/k/v, Dh into the output) to the true one
    (d_model, H·Dh)."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    factor = {"wq": np.sqrt(h / d), "wk": np.sqrt(h / d), "wv": np.sqrt(h / d), "wo": np.sqrt(hd / (h * hd))}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if len(path) >= 3 and path[-3] == "attn" and path[-1] == "kernel":
            return (node * factor[path[-2]]).astype(node.dtype)
        return node

    return walk(tree, ())


def _models(arch, impl=None):
    r_cfg, t_cfg = r_get_arch(arch).reduced, get_arch(arch).reduced
    if impl is not None:
        r_cfg = dataclasses.replace(r_cfg, attention_impl=impl[0])
        t_cfg = dataclasses.replace(t_cfg, attention_impl=impl[1])
    r_model, t_model = r_build_model(r_cfg), build_model(t_cfg)
    tree = _true_fan_in(_ref_tree(r_model.init_params(jax.random.PRNGKey(2))), r_cfg)
    return r_model, jax.tree_util.tree_map(jnp.asarray, tree), t_model, params_from_reference(tree, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    r_model, r_params, t_model, t_params = _models(arch)
    tokens = _tokens(t_model.cfg, 2, 12)
    ref, _ = r_model.forward(r_params, {"tokens": jnp.asarray(tokens)}, remat=False)
    got, _ = t_model.forward(t_params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == ref.shape and got.dtype == torch.float32
    _near(got, ref)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    r_loss, _ = r_model.loss(r_params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, remat=False)
    t_loss, metrics = t_model.loss(t_params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    _near(t_loss, r_loss)
    assert float(metrics["tokens"]) == 22


def _serve_both(arch, impl, b=2, prompt=8, steps=4):
    """Prefill and ``steps`` decode steps through both packages; returns the
    pairs of logits (prefill first) and the final caches."""
    r_model, r_params, t_model, t_params = _models(arch, impl)
    tokens = _tokens(t_model.cfg, b, prompt + steps, seed=1)
    r_cache = r_model.make_cache(batch=b, max_len=prompt + steps + 4)
    t_cache = cache_from_reference(_ref_tree(r_cache), device="cpu")
    pairs = []
    r_logits, r_cache = jax.jit(r_model.prefill)(r_params, {"tokens": jnp.asarray(tokens[:, :prompt])}, r_cache)
    t_logits, t_cache = t_model.prefill(t_params, {"tokens": torch.from_numpy(tokens[:, :prompt])}, t_cache)
    pairs.append((t_logits, r_logits))
    r_step = jax.jit(r_model.decode_step)
    for t in range(prompt, prompt + steps):
        r_logits, r_cache = r_step(r_params, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, r_cache)
        t_logits, t_cache = t_model.decode_step(t_params, {"tokens": torch.from_numpy(tokens[:, t:t + 1])}, t_cache)
        pairs.append((t_logits, r_logits))
    return pairs, t_cache, r_cache


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", [None, ("pallas", "flash")], ids=["naive", "pallas-vs-flash"])
def test_prefill_and_decode_match_reference(arch, impl):
    pairs, t_cache, r_cache = _serve_both(arch, impl)
    for i, (got, ref) in enumerate(pairs):
        assert got.shape == ref.shape, i
        _near(got, ref)
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == 12
    for n in ("k", "v"):
        _near(t_cache["layers"][n], r_cache["layers"][n])


def test_serving_weights_cast_once_give_the_same_logits_bits():
    cfg = dataclasses.replace(get_arch("phi3-mini-3.8b").reduced, dtype="bfloat16", attention_impl="flash")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    served = model.serving_params(params)
    assert served["decoder"]["blocks"][0]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert served["decoder"]["blocks"][0]["ln1"]["scale"].dtype == torch.float32
    assert served["final_norm"]["scale"].dtype == torch.float32
    tokens = torch.from_numpy(_tokens(cfg, 2, 10, seed=3))
    outs = []
    for p in (params, served):
        cache = model.make_cache(2, 12, device="cpu")
        logits, cache = model.prefill(p, {"tokens": tokens[:, :8]}, cache)
        steps = [model.decode_step(p, {"tokens": tokens[:, t:t + 1]}, cache)[0] for t in (8, 9)]
        outs.append([logits] + steps + [cache["layers"]["k"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_attention_init_scales_by_the_true_fan_in():
    """q/k/v by d_model, the output projection by H·Dh (the reference reads
    shape[-2] of these 3-D kernels: H and Dh)."""
    cfg = get_arch("phi3-mini-3.8b").reduced
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    attn = params["decoder"]["blocks"][0]["attn"]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    for name, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", cfg.n_heads * hd)):
        std = float(attn[name]["kernel"].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, (name, std)


def test_init_params_is_seeded_per_leaf():
    model = build_model(get_arch("phi3-mini-3.8b").reduced)
    a = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    b = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    c = model.init_params(torch.Generator().manual_seed(1), device="cpu")
    wa, wb, wc = (p["decoder"]["blocks"][1]["mlp"]["wi"]["kernel"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert not torch.equal(a["decoder"]["blocks"][0]["mlp"]["wi"]["kernel"], wa)
    assert sum(p.numel() for p in a.parameters()) == exact_param_count(model.cfg)


def test_carried_weights_and_caches_default_to_the_card():
    """``convert`` puts what it carries on the card unless the caller names
    another device, like every entry point of the port; without a GPU a call
    that names none raises instead of landing on the host."""
    import inspect

    from repro_torch.models import convert

    for fn in (convert.to_tensor, convert.params_from_reference, convert.cache_from_reference):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    r_model = r_build_model(r_get_arch("phi3-mini-3.8b").reduced)
    tree = _ref_tree(r_model.init_params(jax.random.PRNGKey(0)))
    cache = _ref_tree(r_model.make_cache(batch=1, max_len=4))
    on_cpu = params_from_reference(tree, device="cpu")
    assert all(p.device.type == "cpu" for p in on_cpu.parameters())
    assert cache_from_reference(cache, device="cpu")["pos"].device.type == "cpu"
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in params_from_reference(tree).parameters())
        assert cache_from_reference(cache)["layers"]["k"].is_cuda
    else:
        for call in (lambda: params_from_reference(tree), lambda: cache_from_reference(cache),
                     lambda: convert.to_tensor(np.zeros(3))):
            with pytest.raises((RuntimeError, AssertionError)):
                call()


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------


def _port_only_fields(cls, ref_cls):
    """The fields the port's config class has and the reference's lacks (the
    latent attention, router and dense-layer options), with their defaults."""
    ref_names = {f.name for f in dataclasses.fields(ref_cls)}
    return {f.name: f.default for f in dataclasses.fields(cls) if f.name not in ref_names}


def test_configs_are_the_reference_configs():
    """Every registered config is the reference's, field for field, and
    holds each field the port adds at its default (today's behaviour)."""
    import repro.configs.base as r_base

    from repro_torch.configs import base as t_base

    extra_arch = _port_only_fields(t_base.ArchConfig, r_base.ArchConfig)
    extra_moe = _port_only_fields(t_base.MoEConfig, r_base.MoEConfig)
    assert set(extra_arch) == {"mla", "n_dense_layers", "norm_eps"}
    assert set(extra_moe) == {"scoring", "routed_scale", "dropless"}
    assert list_archs() == r_list_archs()
    for name in list_archs():
        for which in ("full", "reduced"):
            r_cfg, t_cfg = getattr(r_get_arch(name), which), getattr(get_arch(name), which)
            t_dict = dataclasses.asdict(t_cfg)
            assert {k: t_dict.pop(k) for k in extra_arch} == extra_arch, (name, which)
            if t_dict["moe"] is not None:
                assert {k: t_dict["moe"].pop(k) for k in extra_moe} == extra_moe, (name, which)
            assert dataclasses.asdict(r_cfg) == t_dict, (name, which)


@pytest.mark.parametrize("arch", sorted(r_list_archs()))
def test_exact_param_count_matches_reference(arch):
    assert exact_param_count(get_arch(arch).full) == r_exact_param_count(r_get_arch(arch).full)
    assert exact_param_count(get_arch(arch).reduced) == r_exact_param_count(r_get_arch(arch).reduced)
