"""Attention: GQA + RoPE, causal / sliding-window / cross, three impls.

* ``naive``   — materializes the (S, S) scores; the reference for tests.
* ``chunked`` — a loop over KV chunks with an online softmax (flash-style in
  plain torch): O(S·C) live memory.  The default of the full configs.
* ``flash``   — the hand-written Hopper kernel in
  ``repro_torch.kernels.flash_attention`` (the counterpart of the
  reference's ``pallas`` impl), selected through the config.

Shapes: q (B, S, H, Dh); k/v (B, Skv, Kh, Dh) with H = G·Kh (GQA).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import ParamSpec, rope, softcap

NEG_INF = -1e30


def attention_spec(d: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   use_bias: bool = False) -> Dict[str, Any]:
    # init scales from the true fan-in (d into q/k/v, H·Dh into the output).
    # The reference's ParamSpec default reads the fan-in off shape[-2], which
    # for these 3-D kernels is H or Dh: a random model's q and k come out
    # ~10x too large, its scores ~100x, its softmax one-hot, and two
    # attention implementations that differ in the last bit then give
    # unrelated logits after a few layers (ROADMAP.md, Queue 3).
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(n_heads * head_dim)
    return {
        "wq": {"kernel": ParamSpec((d, n_heads, head_dim), ("embed", "heads", "head_dim"), scale=s_in)},
        "wk": {"kernel": ParamSpec((d, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), scale=s_in)},
        "wv": {"kernel": ParamSpec((d, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), scale=s_in)},
        "wo": {"kernel": ParamSpec((n_heads, head_dim, d), ("heads", "head_dim", "embed"), scale=s_out)},
        **({"bq": ParamSpec((n_heads, head_dim), ("heads", "head_dim"), init="zeros"),
            "bk": ParamSpec((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros"),
            "bv": ParamSpec((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")}
           if use_bias else {}),
    }


def cross_attention_spec(d: int, n_heads: int, n_kv_heads: int, head_dim: int) -> Dict[str, Any]:
    return attention_spec(d, n_heads, n_kv_heads, head_dim)


def _project(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = kernel.shape
    return (x @ kernel.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(params, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _project(x, params["wq"]["kernel"])
    k = _project(x, params["wk"]["kernel"])
    v = _project(x, params["wv"]["kernel"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def out_project(params, o) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    w = params["wo"]["kernel"]
    return o.flatten(-2) @ w.to(o.dtype).reshape(-1, w.shape[-1])


def _expand_gqa(q: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, S, H, Dh) → (B, S, Kh, G, Dh)."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, kh, h // kh, dh)


# ---------------------------------------------------------------------------
# naive reference
# ---------------------------------------------------------------------------


def attend_naive(q, k, v, *, causal: bool, q_offset=0, kv_len=None, window: Optional[int] = None,
                 cap: Optional[float] = None) -> torch.Tensor:
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qg = _expand_gqa(q, kh).float()
    scale = float(1.0 / np.sqrt(dh))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    scores = softcap(scores, cap)
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset  # (Sq,)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style, plain torch)
# ---------------------------------------------------------------------------


def attend_chunked(q, k, v, *, causal: bool, q_offset=0, kv_len=None, window: Optional[int] = None,
                   cap: Optional[float] = None, chunk: int = 1024) -> torch.Tensor:
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    skv = k.shape[1]
    chunk = min(chunk, skv)
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    eff_len = kv_len if kv_len is not None else skv

    qg = _expand_gqa(q, kh).float()  # (B, Sq, Kh, G, Dh)
    scale = float(1.0 / np.sqrt(dh))
    qpos = torch.arange(sq, device=q.device) + q_offset
    acc = torch.zeros((b, sq, kh, h // kh, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, kh, h // kh), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, sq, kh, h // kh), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]  # (B, C, Kh, Dh)
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float()) * scale
        s = softcap(s, cap)
        valid = kpos[None, :] < eff_len  # (Sq-broadcast, C)
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            valid = valid & (kpos[None, :] > (qpos[:, None] - window))
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb.float())
        m = m_new
    o = acc / torch.clamp_min(lsum[..., None], 1e-37)
    return o.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def attend(q, k, v, *, impl: str = "chunked", causal: bool = True, q_offset=0,
           kv_len=None, window=None, cap=None, chunk: int = 1024):
    if impl == "naive":
        return attend_naive(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                            window=window, cap=cap)
    if impl == "chunked":
        return attend_chunked(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                              window=window, cap=cap, chunk=chunk)
    if impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                               window=window, cap=cap)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# full attention layer (projections + rope + attend), with KV-cache support
# ---------------------------------------------------------------------------


def self_attention(
    params,
    x,
    *,
    n_kv_heads: int,
    rope_theta: Optional[float],
    impl: str,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    chunk: int = 1024,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
):
    """Returns (out, new_cache). ``cache``: {'k','v': (B, Smax, Kh, Dh), 'pos': ()}.

    The new k/v are written into the cache's tensors in place (the reference
    returns updated copies): the cache is the largest state of serving, and
    a copy per layer and step would move all of it every token.  The returned
    cache holds the same tensors and the advanced position.
    """
    b, s, _ = x.shape
    q, k, v = qkv_project(params, x)
    if positions is None:
        steps = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        positions = cache["pos"] + steps if cache is not None else steps
    if rope_theta is not None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    new_cache = None
    if cache is not None:
        idx = cache["pos"] + torch.arange(s, device=x.device)
        kc, vc = cache["k"], cache["v"]
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        new_cache = {"k": kc, "v": vc, "pos": cache["pos"] + s}
        if s > 1:
            # prefill: the cache was empty (pos = 0); attend against the
            # fresh k/v
            o = attend(q, k, v, impl=impl, causal=causal, window=window, cap=cap, chunk=chunk)
        else:
            # decode: one query row against the cache
            o = attend(q, kc, vc, impl="naive", causal=causal, q_offset=cache["pos"],
                       kv_len=cache["pos"] + s, window=window, cap=cap)
    else:
        o = attend(q, k, v, impl=impl, causal=causal, window=window, cap=cap, chunk=chunk)
    return out_project(params, o), new_cache


def cross_attention(params, x, enc_kv: Tuple[torch.Tensor, torch.Tensor], impl: str, chunk: int = 1024):
    """Decoder cross-attention against precomputed encoder K/V (non-causal;
    one query row a step in decode)."""
    q = _project(x, params["wq"]["kernel"])
    k, v = enc_kv
    o = attend(q, k, v, impl=impl, causal=False, chunk=chunk)
    return out_project(params, o)


def encoder_kv(params, enc_out) -> Tuple[torch.Tensor, torch.Tensor]:
    return _project(enc_out, params["wk"]["kernel"]), _project(enc_out, params["wv"]["kernel"])


def make_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int, dtype,
               device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
