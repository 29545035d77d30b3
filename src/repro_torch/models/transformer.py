"""Block definitions and layer stacks.

A Python loop over layers replaces the reference's ``lax.scan``; each
layer's parameters are their own ``ParamTree`` (``stack_specs`` makes a list
of per-layer specs, where the reference stacks them along a leading axis).
The dense family (and command-r's parallel block) runs; the other families'
blocks are specified, so that parameter counts cover every config, and raise
``NotImplementedError`` when run.
"""

from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.configs.base import ArchConfig

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import make_norm, mlp, mlp_spec

_NOT_PORTED = {
    "moe": "the moe layer",
    "ssm": "the ssm (Mamba-2 SSD) block",
    "hybrid": "the hybrid model path (rglru block, local attention)",
}


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family whose blocks are not ported."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[cfg.family]} is not ported yet (ROADMAP.md, Queue 1, LM stack)")


# ---------------------------------------------------------------------------
# spec stacking
# ---------------------------------------------------------------------------


def stack_specs(spec: Any, n: int) -> List[Any]:
    """``n`` layers of ``spec``, one entry per layer (the reference stacks
    them along a new leading axis)."""
    return [spec] * n


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


def dense_block(params, x, cfg: ArchConfig, *, cache=None, window=None, impl=None):
    check_ported(cfg)
    _, norm = make_norm(cfg.norm)
    impl = impl or cfg.attention_impl
    h = norm(params["ln1"], x)
    attn_out, new_cache = attn_mod.self_attention(
        params["attn"], h, n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
        impl=impl, window=window, chunk=cfg.attention_chunk, cache=cache,
    )
    if cfg.parallel_block:
        x = x + attn_out + mlp(params["mlp"], h, cfg.activation)
    else:
        x = x + attn_out
        x = x + mlp(params["mlp"], norm(params["ln2"], x), cfg.activation)
    return x, new_cache, {}


def ssm_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    return {"ln": norm_spec(cfg.d_model), "ssm": ssm_mod.ssd_spec(cfg.d_model, cfg.ssm)}


def rglru_block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    norm_spec, _ = make_norm(cfg.norm)
    d = cfg.d_model
    return {
        "ln1": norm_spec(d),
        "rec": rglru_mod.rglru_block_spec(d, cfg.rglru),
        "ln2": norm_spec(d),
        "mlp": mlp_spec(d, cfg.d_ff, cfg.activation, cfg.use_bias),
    }


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


def decoder_stack(params, x, cfg: ArchConfig, *, cache=None, impl=None):
    """Returns (x, new_cache, aux_losses).  ``cache``: {'k', 'v': (L, B, Smax,
    Kh, Dh), 'pos': ()}; layer l reads and writes its slice ``[l]`` in place."""
    check_ported(cfg)
    for i, lp in enumerate(params["blocks"]):
        c = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
        x, _, _ = dense_block(lp, x, cfg, cache=c, window=cfg.sliding_window, impl=impl)
    new_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    return x, new_cache, {}


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-style): specs only
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


def encoder_stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {"blocks": stack_specs(encoder_block_spec(cfg), cfg.n_encoder_layers)}


def xdec_stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return {"blocks": stack_specs(xdec_block_spec(cfg), cfg.n_layers)}
