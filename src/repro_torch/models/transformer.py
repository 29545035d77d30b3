"""Block definitions and layer stacks for every family.

A Python loop over layers replaces the reference's ``lax.scan``; each
layer's parameters are their own ``ParamTree`` (``stack_specs`` makes a list
of per-layer specs, where the reference stacks them along a leading axis).
Caches keep the reference's layout, each layer stack's state stacked along a
leading axis; layer ``i`` reads and writes its slice ``[i]`` in place.  The
hybrid (RecurrentGemma) stack repeats (rglru, rglru, attn) groups, then
runs the remainder as ``tail_*`` layers.

``remat`` (training) recomputes activations in the backward at the
reference's granularity (``jax.checkpoint`` around each scanned layer): one
layer of the uniform stacks, one (rglru, rglru, attn) group of the hybrid,
whose ``tail_*`` layers are not recomputed.  It is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, applied only
where a gradient is recorded and no cache is written; serving passes
``remat=False``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru import ops as rglru_ops

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from repro_torch.parallel.sharding import axis_rules, current_mesh, current_rules, spmd_scope, with_logical_constraint

from .layers import make_norm, mlp, mlp_spec


# ---------------------------------------------------------------------------
# spec stacking
# ---------------------------------------------------------------------------


def stack_specs(spec: Any, n: int) -> List[Any]:
    """``n`` layers of ``spec``, one entry per layer (the reference stacks
    them along a new leading axis)."""
    return [spec] * n


def _remat(fn, remat: bool, cache=None):
    """``fn``, recomputed in the backward when ``remat`` and a gradient is
    being recorded (never around a cache, which a layer writes in place)."""
    if not (remat and cache is None and torch.is_grad_enabled()):
        return fn
    rules, mesh = current_rules(), current_mesh()

    def scoped(*args):
        # the recompute runs in the backward, maybe on autograd's own thread:
        # under the forward's rules and mesh
        with axis_rules(rules, mesh), spmd_scope():
            return fn(*args)

    return lambda *args: checkpoint(scoped, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# blocks (params, x, cache) -> (x, cache, aux)
# ---------------------------------------------------------------------------


def dense_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    spec = {
        "ln1": norm_spec(d),
        "attn": attn_mod.attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd, cfg.use_bias),
    }
    if cfg.family == "moe":
        spec["moe"] = moe_mod.moe_spec(d, cfg.moe, cfg.activation, cfg.use_bias)
    else:
        spec["mlp"] = mlp_spec(d, cfg.d_ff, cfg.activation, cfg.use_bias)
    if not cfg.parallel_block:
        spec["ln2"] = norm_spec(d)
    return spec


def _ffn(params, h, cfg: ArchConfig):
    if cfg.family == "moe":
        return moe_mod.moe_layer(params["moe"], h, cfg.moe, cfg.activation)
    return mlp(params["mlp"], h, cfg.activation), {}


def dense_block(params, x, cfg: ArchConfig, *, cache=None, window=None, impl=None):
    _, norm = make_norm(cfg.norm)
    impl = impl or cfg.attention_impl
    h = norm(params["ln1"], x)
    if not cfg.parallel_block:
        # the sequence sharding pinned on the norm output
        h = with_logical_constraint(h, ("batch", "attn_seq", "embed"))
    attn_out, new_cache = attn_mod.self_attention(
        params["attn"], h, n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
        impl=impl, window=window, chunk=cfg.attention_chunk, cache=cache,
    )
    if cfg.parallel_block:
        ff_out, aux = _ffn(params, h, cfg)
        x = x + attn_out + ff_out
    else:
        attn_out = with_logical_constraint(attn_out, ("batch", "attn_seq", "embed"))
        x = x + attn_out
        h2 = with_logical_constraint(norm(params["ln2"], x), ("batch", "attn_seq", "embed"))
        ff_out, aux = _ffn(params, h2, cfg)
        x = x + with_logical_constraint(ff_out, ("batch", "attn_seq", "embed"))
    # sequence-parallel residual stream: sequence-sharded over the model axis
    return with_logical_constraint(x, ("batch", "attn_seq", "embed")), new_cache, aux


def ssm_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    return {"ln": norm_spec(cfg.d_model), "ssm": ssm_mod.ssd_spec(cfg.d_model, cfg.ssm)}


def ssm_block(params, x, cfg: ArchConfig, *, cache=None):
    _, norm = make_norm(cfg.norm)
    y, new_cache = ssm_mod.ssd_block(params["ssm"], norm(params["ln"], x), cfg.ssm, cache=cache)
    return x + y, new_cache, {}


def rglru_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    d = cfg.d_model
    return {
        "ln1": norm_spec(d),
        "rec": rglru_mod.rglru_block_spec(d, cfg.rglru),
        "ln2": norm_spec(d),
        "mlp": mlp_spec(d, cfg.d_ff, cfg.activation, cfg.use_bias),
    }


def rglru_block(params, x, cfg: ArchConfig, *, cache=None, scan: rglru_mod.Scan = rglru_ops.rglru_scan):
    _, norm = make_norm(cfg.norm)
    y, new_cache = rglru_mod.rglru_block(params["rec"], norm(params["ln1"], x), cfg.rglru, cache=cache, scan=scan)
    x = x + y
    x = x + mlp(params["mlp"], norm(params["ln2"], x), cfg.activation)
    return x, new_cache, {}


# ---------------------------------------------------------------------------
# decoder stack
# ---------------------------------------------------------------------------


def decoder_stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"blocks": stack_specs(ssm_block_spec(cfg), cfg.n_layers)}
    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern
        n_groups, rem = divmod(cfg.n_layers, len(pat))
        group = {f"{i}_{kind}": (rglru_block_spec(cfg) if kind == "rglru" else dense_block_spec(cfg))
                 for i, kind in enumerate(pat)}
        spec: Dict[str, Any] = {"groups": stack_specs(group, n_groups)}
        for r in range(rem):
            kind = pat[r % len(pat)]
            spec[f"tail_{r}_{kind}"] = rglru_block_spec(cfg) if kind == "rglru" else dense_block_spec(cfg)
        return spec
    return {"blocks": stack_specs(dense_block_spec(cfg), cfg.n_layers)}


def _layer_cache(tree: Dict[str, torch.Tensor], i, pos) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of a stacked cache subtree (the subtree itself when
    ``i`` is None); a KV cache also gets the global position."""
    c = dict(tree) if i is None else {n: t[i] for n, t in tree.items()}
    if "k" in c:
        c["pos"] = pos
    return c


def decoder_stack(params, x, cfg: ArchConfig, *, cache=None, remat: bool = True, impl=None,
                  scan: rglru_mod.Scan = rglru_ops.rglru_scan) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, aux_losses_summed).  ``cache`` is the model's (``LM.make_cache``,
    its 'pos' the tokens already in it), written in place; ``scan`` runs the
    hybrid's RG-LRU recurrence over a prompt."""
    pos = None if cache is None else cache["pos"]

    def layer_cache(*keys, i=None):
        """One layer's cache: ``cache[keys...]``, its slice ``[i]`` when stacked."""
        if cache is None:
            return None
        tree = cache
        for k in keys:
            tree = tree[k]
        return _layer_cache(tree, i, pos)

    def hybrid_layer(kind, lp, h, c):
        if kind == "rglru":
            return rglru_block(lp, h, cfg, cache=c, scan=scan)[0]
        return dense_block(lp, h, cfg, cache=c, window=cfg.sliding_window, impl=impl)[0]

    if cfg.family == "ssm":
        def ssm_layer(lp, h, c):
            return ssm_block(lp, h, cfg, cache=c)[0]

        step = _remat(ssm_layer, remat, cache)
        for i, lp in enumerate(params["blocks"]):
            x = step(lp, x, layer_cache("layers", i=i))
        return x, {}

    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern

        def group(g, gp, h):
            for i, kind in enumerate(pat):
                key = f"{i}_{kind}"
                h = hybrid_layer(kind, gp[key], h, layer_cache("groups", key, i=g))
            return h

        step = _remat(group, remat, cache)
        for g, gp in enumerate(params["groups"]):
            x = step(g, gp, x)
        for r in range(cfg.n_layers % len(pat)):
            kind = pat[r % len(pat)]
            key = f"tail_{r}_{kind}"
            x = hybrid_layer(kind, params[key], x, layer_cache(key))
        return x, {}

    # dense / moe / vlm backbone
    def dense_layer(lp, h, c):
        h, _, aux = dense_block(lp, h, cfg, cache=c, window=cfg.sliding_window, impl=impl)
        return h, aux

    step = _remat(dense_layer, remat, cache)
    auxes: List[Dict[str, torch.Tensor]] = []
    for i, lp in enumerate(params["blocks"]):
        x, aux = step(lp, x, layer_cache("layers", i=i))
        auxes.append(aux)
    if cfg.family != "moe":
        return x, {}
    return x, {k: torch.stack([a[k] for a in auxes]).sum() for k in ("load_balance_loss", "router_z_loss")}


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-style)
# ---------------------------------------------------------------------------


def encoder_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": norm_spec(d),
        "attn": attn_mod.attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd, cfg.use_bias),
        "ln2": norm_spec(d),
        "mlp": mlp_spec(d, cfg.d_ff, cfg.activation, cfg.use_bias),
    }


def encoder_block(params, x, cfg: ArchConfig, impl=None):
    _, norm = make_norm(cfg.norm)
    h, _ = attn_mod.self_attention(
        params["attn"], norm(params["ln1"], x), n_kv_heads=cfg.n_kv_heads,
        rope_theta=None, impl=impl or cfg.attention_impl, causal=False,
        chunk=cfg.attention_chunk,
    )
    x = x + h
    return x + mlp(params["mlp"], norm(params["ln2"], x), cfg.activation)


def xdec_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": norm_spec(d),
        "attn": attn_mod.attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd, cfg.use_bias),
        "ln_x": norm_spec(d),
        "xattn": attn_mod.cross_attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd),
        "ln2": norm_spec(d),
        "mlp": mlp_spec(d, cfg.d_ff, cfg.activation, cfg.use_bias),
    }


def xdec_block(params, x, cfg: ArchConfig, *, enc_kv, cache=None, impl=None):
    """Decoder block with cross-attention. enc_kv: this layer's (k, v) from the encoder."""
    _, norm = make_norm(cfg.norm)
    impl = impl or cfg.attention_impl
    h, _ = attn_mod.self_attention(
        params["attn"], norm(params["ln1"], x), n_kv_heads=cfg.n_kv_heads,
        rope_theta=None, impl=impl, chunk=cfg.attention_chunk, cache=cache,
    )
    x = x + h
    x = x + attn_mod.cross_attention(params["xattn"], norm(params["ln_x"], x), enc_kv, impl, cfg.attention_chunk)
    return x + mlp(params["mlp"], norm(params["ln2"], x), cfg.activation)


def encoder_stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {"blocks": stack_specs(encoder_block_spec(cfg), cfg.n_encoder_layers)}


def encoder_stack(params, x, cfg: ArchConfig, remat: bool = True, impl=None):
    step = _remat(lambda lp, h: encoder_block(lp, h, cfg, impl=impl), remat)
    for lp in params["blocks"]:
        x = step(lp, x)
    return x


def xdec_stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {"blocks": stack_specs(xdec_block_spec(cfg), cfg.n_layers)}


def xdec_stack(params, x, cfg: ArchConfig, *, enc_kv, cache=None, remat: bool = True, impl=None):
    """enc_kv: one (k, v) pair per decoder layer; ``cache`` the model's, written in place."""
    step = _remat(lambda lp, h, kv, c: xdec_block(lp, h, cfg, enc_kv=kv, cache=c, impl=impl), remat, cache)
    for i, lp in enumerate(params["blocks"]):
        c = None if cache is None else _layer_cache(cache["layers"], i, cache["pos"])
        x = step(lp, x, enc_kv[i], c)
    return x
