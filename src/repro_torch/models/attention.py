"""Attention: GQA + RoPE, causal / sliding-window / cross, three impls.

* ``naive``   — materializes the (S, S) scores; the reference for tests.
* ``chunked`` — a loop over KV chunks with an online softmax (flash-style in
  plain torch): O(S·C) live memory.  The default of the full configs.
* ``flash``   — the hand-written Hopper kernel in
  ``repro_torch.kernels.flash_attention`` (the counterpart of the
  reference's ``pallas`` impl), selected through the config.

Shapes: q (B, S, H, Dh); k/v (B, Skv, Kh, Dh) with H = G·Kh (GQA).

Under a mesh (``parallel.sharding.axis_rules``) the operands are DTensors.
Every impl then runs in a ``local_map`` on the rank's own query rows: q
arrives sequence-sharded over 'model' (or head-sharded where the sequence
does not divide), k and v replicated but for the batch, and each rank
attends with ``q_offset`` moved by its first row, so causal masks and
windows see global positions.  A decode step against a cache whose rows are
sharded over 'model' combines the ranks' partial softmaxes by their
log-sum-exp (``_decode_sharded``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.latent_attention import ops as latent_ops
from repro_torch.kernels.latent_attention import ref as latent_ref
from repro_torch.obs import trace as otrace
from repro_torch.parallel.sharding import is_dtensor, matmul, to_local, with_logical_constraint

from .layers import ParamSpec, dense, rmsnorm, rope, rope_pairs, softcap

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


def _sharded_on(t: torch.Tensor, dim: int) -> bool:
    return is_dtensor(t) and any(p.is_shard(dim) for p in t.placements)


def _project(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product.  A kernel sharded on
    head_dim (the heads did not divide the mesh) is flattened as (k, h):
    the sharded dimension first, as DTensor can flatten it."""
    d, h, k = kernel.shape
    w = kernel.to(x.dtype)
    if _sharded_on(w, 2):
        return matmul(x, w.transpose(1, 2).reshape(d, k * h)).unflatten(-1, (k, h)).transpose(-1, -2)
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


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
    w = params["wo"]["kernel"].to(o.dtype)
    if _sharded_on(w, 1) or _sharded_on(o, 3):  # head_dim sharded: flatten (k, h), as ``_project``
        return matmul(o.transpose(-1, -2).flatten(-2), w.transpose(0, 1).reshape(-1, w.shape[-1]))
    return matmul(o.flatten(-2), w.reshape(-1, w.shape[-1]))


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
    ct = torch.promote_types(q.dtype, torch.float32)  # float32 (float64 for float64 inputs)
    qg = _expand_gqa(q, kh).to(ct)
    scale = float(1.0 / np.sqrt(dh))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) * scale
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
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(ct))
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

    ct = torch.promote_types(q.dtype, torch.float32)  # float32 (float64 for float64 inputs)
    qg = _expand_gqa(q, kh).to(ct)  # (B, Sq, Kh, G, Dh)
    scale = float(1.0 / np.sqrt(dh))
    qpos = torch.arange(sq, device=q.device) + q_offset
    acc = torch.zeros((b, sq, kh, h // kh, dh), dtype=ct, device=q.device)
    m = torch.full((b, sq, kh, h // kh), NEG_INF, dtype=ct, device=q.device)
    lsum = torch.zeros((b, sq, kh, h // kh), dtype=ct, device=q.device)
    for c in range(nchunks):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]  # (B, C, Kh, Dh)
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.to(ct)) * scale
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
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb.to(ct))
        m = m_new
    o = acc / torch.clamp_min(lsum[..., None], 1e-37)
    return o.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def attend(q, k, v, *, impl: str = "chunked", causal: bool = True, q_offset=0,
           kv_len=None, window=None, cap=None, chunk: int = 1024):
    if is_dtensor(q):
        return _attend_sharded(q, k, v, impl=impl, causal=causal, q_offset=q_offset, kv_len=kv_len,
                               window=window, cap=cap, chunk=chunk)
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
# under a mesh: local_map over the rank's rows (and heads)
# ---------------------------------------------------------------------------


def _kv_heads_of(h_first: int, h_local: int, h: int, kh: int):
    """(first kv head, count) serving q heads ``h_first ..`` (``h_local`` of
    them, of ``h``), or None when they do not form whole groups or one group."""
    g = h // kh
    if h_local % g == 0:
        return h_first // g, h_local // g
    if g % h_local == 0:
        return h_first // g, 1
    return None


def _attend_sharded(q, k, v, *, impl, causal, q_offset, kv_len, window, cap, chunk):
    """``attend`` on DTensors: each rank runs ``impl`` on its query rows (or
    heads) against the whole k and v of its batch rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, kh = q.shape[2], k.shape[2]
    q_pl, kv_pl, kv_grad_pl = [], [], []
    seq_dim = head_dim = None
    for i, p in enumerate(q.placements):
        if p == Shard(0):
            q_pl.append(p)
            kv_pl.append(p)
            kv_grad_pl.append(p)
            continue
        if p == Shard(1):
            seq_dim = i
        elif p == Shard(2):
            head_dim = i
        else:  # head_dim sharded, or partial: the scores need whole rows
            p = Replicate()
        q_pl.append(p)
        kv_pl.append(Replicate())
        # each rank's queries reach every key: the gradients of the
        # replicated k and v are the sum of the ranks'
        kv_grad_pl.append(Partial() if p != Replicate() else Replicate())

    def body(ql, kl, vl):
        off = q_offset
        if seq_dim is not None:
            off = off + mesh.get_local_rank(seq_dim) * ql.shape[1]
        if head_dim is not None:
            h_local = ql.shape[2]
            h_first = mesh.get_local_rank(head_dim) * h_local
            sel = _kv_heads_of(h_first, h_local, h, kh)
            if sel is None:  # per-head k and v for these heads
                idx = (h_first + torch.arange(h_local, device=kl.device)) // (h // kh)
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            else:
                kl, vl = kl.narrow(2, *sel), vl.narrow(2, *sel)
        return attend(ql, kl, vl, impl=impl, causal=causal, q_offset=off, kv_len=kv_len,
                      window=window, cap=cap, chunk=chunk)

    fn = local_map(body, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad_pl, kv_grad_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)


def _decode_sharded(q, kc, vc, *, causal, q_offset, kv_len, window, cap):
    """One decode step's attention against a cache sharded over the mesh
    (no gradient): each rank scores its own cache rows (and kv heads) in
    float32 (float64 for float64 inputs), and the partial softmaxes combine by all-reduces over the
    cache's row axis (max, then the sums of weights and of weighted values)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.staged import all_reduce

    mesh = kc.device_mesh
    q_offset, kv_len = to_local(q_offset), to_local(kv_len)
    b, sq, h, dh = q.shape
    kh = kc.shape[2]
    q_pl, c_pl, o_pl = [], [], []
    row_dim = head_dim = None
    for i, p in enumerate(kc.placements):
        if p == Shard(0):
            q_pl.append(p)
            c_pl.append(p)
            o_pl.append(p)
            continue
        if p == Shard(1):
            row_dim = i
        elif p == Shard(2) and h % kh == 0:
            head_dim = i
        else:
            p = Replicate()
        c_pl.append(p)
        q_pl.append(Replicate())
        o_pl.append(Shard(2) if head_dim == i else Replicate())

    def body(ql, kl, vl):
        if head_dim is not None:
            kh_l = kl.shape[2]
            g = h // kh
            ql = ql.narrow(2, mesh.get_local_rank(head_dim) * kh_l * g, kh_l * g)
        rows = kl.shape[1]
        row0 = 0 if row_dim is None else mesh.get_local_rank(row_dim) * rows
        ct = torch.promote_types(ql.dtype, torch.float32)
        qg = _expand_gqa(ql, kl.shape[2]).to(ct)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kl.to(ct)) * float(1.0 / np.sqrt(dh))
        scores = softcap(scores, cap)
        qpos = torch.arange(sq, device=ql.device) + q_offset
        kpos = row0 + torch.arange(rows, device=ql.device)
        mask = kpos[None, :] < kv_len
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > (qpos[:, None] - window))
        scores = torch.where(mask, scores, NEG_INF)
        m = scores.amax(dim=-1)
        if row_dim is not None:
            all_reduce(m, "max", mesh.get_group(row_dim))
        p = torch.exp(scores - m[..., None])
        lsum = p.sum(dim=-1)
        acc = torch.einsum("bkgqs,bskd->bqkgd", p, vl.to(ct))
        if row_dim is not None:
            all_reduce(lsum, "sum", mesh.get_group(row_dim))
            all_reduce(acc, "sum", mesh.get_group(row_dim))
        o = acc / lsum.permute(0, 3, 1, 2)[..., None]
        return o.reshape(ql.shape).to(ql.dtype)

    fn = local_map(body, out_placements=list(o_pl), in_placements=(q_pl, c_pl, c_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, kc, vc)


def _write_cache(cache_t, new, pos, s: int) -> None:
    """Write ``new`` (B, s, Kh, Dh) into rows ``pos ..`` of a cache tensor,
    in place; a DTensor cache writes each rank's own rows (a prefill's fresh
    cache has ``pos`` 0)."""
    pos = to_local(pos)
    idx = pos + torch.arange(s, device=pos.device)
    if not is_dtensor(cache_t):
        cache_t.index_copy_(1, idx, new.to(cache_t.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache_t.device_mesh
    new_pl = [Replicate() if p == Shard(1) else p for p in cache_t.placements]
    row_dim = next((i for i, p in enumerate(cache_t.placements) if p == Shard(1)), None)
    new_l = new.to(cache_t.dtype).redistribute(mesh, new_pl).to_local()
    local = cache_t.to_local()
    if row_dim is None:
        local.index_copy_(1, idx, new_l)
        return
    rows = local.shape[1]
    g = mesh.get_local_rank(row_dim) * rows + torch.arange(rows, device=local.device)  # global rows
    if s == 1:  # one row: at most one rank holds it
        j = torch.clamp(pos - g[0], 0, rows - 1).reshape(1)
        mine = ((pos >= g[0]) & (pos < g[0] + rows)).reshape(1, 1, 1, 1)
        local.index_copy_(1, j, torch.where(mine, new_l, local.index_select(1, j)))
        return
    src = torch.clamp(g - pos, 0, s - 1)
    mine = ((g >= pos) & (g < pos + s))[None, :, None, None]
    local.copy_(torch.where(mine, new_l.index_select(1, src), local))


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
    if s > 1:
        # context-parallel attention (train/prefill): q sequence-sharded over
        # the model axis, k and v replicated but for the batch
        q = with_logical_constraint(q, ("batch", "attn_seq", "heads", "head_dim"))
        k = with_logical_constraint(k, ("batch", None, None, None))
        v = with_logical_constraint(v, ("batch", None, None, None))
    new_cache = None
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        _write_cache(kc, k, cache["pos"], s)
        _write_cache(vc, v, cache["pos"], s)
        new_cache = {"k": kc, "v": vc, "pos": cache["pos"] + s}
        if s > 1:
            # prefill: the cache was empty (pos = 0); attend against the
            # fresh k/v
            o = attend(q, k, v, impl=impl, causal=causal, window=window, cap=cap, chunk=chunk)
        elif is_dtensor(kc):
            o = _decode_sharded(q, kc, vc, causal=causal, q_offset=cache["pos"], kv_len=cache["pos"] + s,
                                window=window, cap=cap)
        else:
            # decode: one query row against the cache
            o = attend(q, kc, vc, impl="naive", causal=causal, q_offset=cache["pos"],
                       kv_len=cache["pos"] + s, window=window, cap=cap)
        o = with_logical_constraint(o, ("batch", "attn_seq" if s > 1 else None, "heads", "head_dim"))
    else:
        o = attend(q, k, v, impl=impl, causal=causal, window=window, cap=cap, chunk=chunk)
        o = with_logical_constraint(o, ("batch", "attn_seq", "heads", "head_dim"))
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


# ---------------------------------------------------------------------------
# multi-head latent attention (DeepSeek-V2/V3 MLA) and its latent cache
# ---------------------------------------------------------------------------

# A random model's scores spread by about 1 (unit-variance q and k over
# sqrt(Dh)), so over thousands of keys its softmax is nearly flat: attention
# then adds almost nothing to the residual stream, and nothing downstream
# depends on what the cache holds.  A trained model's heads are held by a few
# keys.  MLA's queries are drawn this much wider, so that a random model's
# scores spread by about this much and a softmax over 7k keys is held by
# some tens of them.
MLA_Q_SPREAD = 2.5


def mla_spec(d: int, n_heads: int, m: MLAConfig) -> Dict[str, Any]:
    """MLA's weights, in the (in, ..., out) layout of the other projections:
    ``wq`` (d, H, nope + rope); ``wkv_a`` (d, latent + rope), the latent and
    the shared rope key; ``kv_norm`` the latent's RMSNorm; ``wkv_b`` (latent,
    H, nope + v), each head's key (no rope) and value from the latent; ``wo``
    (H, v, d)."""
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    return {
        "wq": {"kernel": ParamSpec((d, n_heads, qk), ("embed", "heads", "head_dim"), scale=MLA_Q_SPREAD / np.sqrt(d))},
        "wkv_a": {"kernel": ParamSpec((d, r + m.qk_rope_head_dim), ("embed", None), scale=1.0 / np.sqrt(d))},
        "kv_norm": {"scale": ParamSpec((r,), (None,), init="ones")},
        "wkv_b": {"kernel": ParamSpec((r, n_heads, m.qk_nope_head_dim + m.v_head_dim), (None, "heads", "head_dim"),
                                      scale=1.0 / np.sqrt(r))},
        "wo": {"kernel": ParamSpec((n_heads, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                                   scale=1.0 / np.sqrt(n_heads * m.v_head_dim))},
    }


def make_latent_cache(n_layers: int, batch: int, max_len: int, m: MLAConfig, dtype,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """MLA's cache of every layer: the normed latent ``ckv`` (L, B, S,
    latent) and the rotated shared rope key ``kpe`` (L, B, S, rope); no
    per-head keys or values."""
    return {"ckv": torch.zeros((n_layers, batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
            "kpe": torch.zeros((n_layers, batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device)}


def write_latent(cache_t: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, s, C) into rows ``pos ..`` of a latent cache tensor (B, S, C), in place."""
    idx = pos + torch.arange(new.shape[1], device=new.device)
    cache_t.index_copy_(1, idx, new.to(cache_t.dtype))


def _attend_expanded(q, k, v, *, impl: str, chunk: int) -> torch.Tensor:
    """Causal attention of a prompt against its own per-head keys and values
    (B, S, H, Dq / Dq / Dv), scaled by 1/sqrt(Dq).  The attention paths take
    one head width for all three: v is padded with zeros to Dq (and, for
    the flash kernel, all three to the next width it takes, with the scale
    kept), and the output cut back to Dv."""
    dq, dv = q.shape[-1], v.shape[-1]
    if impl == "flash":
        from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention

        width = min(w for w in HEAD_DIMS if w >= dq)
        q, k, v = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
        o = flash_attention(q, k, v, causal=True, scale=float(1.0 / np.sqrt(dq)))
    else:
        o = attend(q, k, F.pad(v, (0, dq - dv)), impl=impl, causal=True, chunk=chunk)
    return o[..., :dv]


def attend_latent(q_lat, q_pe, ckv, kpe, pos, scale: float) -> torch.Tensor:
    """One decode step's attention in the absorbed form, over the latent
    cache: q_lat (B, H, latent) is each head's no-rope query taken through
    its key up-projection, q_pe (B, H, rope) its rotated query; ckv (B, S,
    latent) and kpe (B, S, rope) the cache, rows up to ``pos`` (a 0-d
    tensor, read on the device) valid; returns the softmax-weighted latent
    (B, H, latent).  The decode route of ``impl="flash"``:
    ``latent_ops.latent_attention``, the hand-written kernel on CUDA tensors
    (rows 0 .. pos read once; a cache it does not take raises), the plain
    formula ``latent_ref.attend_latent_ref`` on CPU tensors."""
    return latent_ops.latent_attention(q_lat, q_pe, ckv, kpe, pos, scale)


def mla_attention(params, x, m: MLAConfig, *, rope_theta: float, impl: str, chunk: int = 1024,
                  eps: Optional[float] = None, cache: Optional[Dict[str, torch.Tensor]] = None):
    """Multi-head latent attention (DeepSeek-V3), causal.  Returns (out, new_cache).

    q = x·Wq split into q_nope and q_pe (rope); [c_kv, k_pe] = x·Wkv_a,
    c_kv RMS-normed, k_pe rotated and shared by the heads; [k_nope, v] =
    c_kv·Wkv_b per head; the score is (q_nope·k_nope + q_pe·k_pe) /
    sqrt(nope + rope); out = o·Wo.  Rope is ``layers.rope_pairs``.

    ``cache``: {'ckv': (B, Smax, latent), 'kpe': (B, Smax, rope), 'pos': ()},
    written in place.  A prompt (more than one token, into an empty cache)
    expands the latent into per-head keys and values and attends with
    ``impl``; a decode step (one token) takes Wkv_b's key half into the query
    and its value half into the output (the absorbed form) and attends over
    the latent cache itself (``attend_latent``), so no per-head key or value
    is ever held."""
    if is_dtensor(x):
        raise NotImplementedError("mla_attention: latent attention does not run under a mesh")
    b, s, _ = x.shape
    nope, rp, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    scale = float(1.0 / np.sqrt(nope + rp))
    probe = otrace.probe()
    with otrace.device_span("mla.project"):
        q = _project(x, params["wq"]["kernel"])  # (B, S, H, nope + rope)
        kva = dense(params["wkv_a"], x)  # (B, S, latent + rope)
        c_kv = rmsnorm(params["kv_norm"], kva[..., :r], 1e-6 if eps is None else eps)
        steps = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        positions = cache["pos"] + steps if cache is not None else steps
        q_pe = rope_pairs(q[..., nope:], positions, rope_theta)
        k_pe = rope_pairs(kva[..., None, r:], positions, rope_theta)  # (B, S, 1, rope)
        new_cache = None
        if cache is not None:
            write_latent(cache["ckv"], c_kv, cache["pos"])
            write_latent(cache["kpe"], k_pe[:, :, 0], cache["pos"])
            new_cache = {"ckv": cache["ckv"], "kpe": cache["kpe"], "pos": cache["pos"] + s}
        w_kvb = params["wkv_b"]["kernel"].to(x.dtype)  # (latent, H, nope + v)
        h = w_kvb.shape[1]
        decode = cache is not None and s == 1
        if decode:
            # q_lat[b, h] = q_nope[b, h] · W_uk[:, h]^T: one product a head
            q_lat = torch.bmm(q[:, 0, :, :nope].transpose(0, 1), w_kvb[..., :nope].permute(1, 2, 0))
    if decode:
        ckv, kpe = cache["ckv"], cache["kpe"]
        # "flash": the hand-written kernels' route; "naive" and "chunked": the
        # plain formula on any device, as for the prompt
        attend = attend_latent if impl == "flash" else latent_ref.attend_latent_ref
        launched = latent_ops.KERNEL.launches
        with otrace.device_span("mla.attend"):
            o_lat = attend(q_lat.transpose(0, 1), q_pe[:, 0], ckv, kpe, cache["pos"], scale)
        if probe is not None:
            if latent_ops.KERNEL.launches > launched:  # the kernel ran: rows 0 .. pos, once a head group
                probe.add("mla.latent_bytes", latent_ops.bytes_read(ckv, kpe, cache["pos"], h))
                probe.add("mla.fused_calls", 1)
            else:
                probe.add("mla.latent_bytes", latent_ref.bytes_read(ckv, kpe))
            probe.add("mla.decode_calls", 1)
        with otrace.device_span("mla.project"):
            # o[b, h] = o_lat[b, h] · W_uv[:, h]
            o = torch.bmm(o_lat.transpose(0, 1), w_kvb[..., nope:].permute(1, 0, 2)).transpose(0, 1)
            return out_project(params, o[:, None]), new_cache
    if cache is not None and impl == "flash" and x.is_cuda:
        latent_ops.KERNEL.start_build()  # the decode steps' kernel compiles while the prompt attends
    with otrace.device_span("mla.attend"):
        kv = _project(c_kv, w_kvb)  # (B, S, H, nope + v)
        k = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, rp)], dim=-1)
        qf = torch.cat([q[..., :nope], q_pe], dim=-1)
        o = _attend_expanded(qf, k, kv[..., nope:], impl=impl, chunk=chunk)
    with otrace.device_span("mla.project"):
        return out_project(params, o), new_cache
