"""A plain reference of Moonlight-16B-A3B: DeepSeek-V3's decoder at the
published config (https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json).

Plain torch in float32 (TF32 off for matrix products and cuDNN while it
runs), over whole sequences: no cache, no kernels, no batching tricks.  It
imports nothing but torch.  ``cfg`` is a dict of the published config's keys
(``hidden_size``, ``num_attention_heads``, ``kv_lora_rank``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``, ``rms_norm_eps``,
``rope_theta``, ``n_routed_experts``, ``num_experts_per_tok``,
``routed_scaling_factor``, ``first_k_dense_replace``).

The weights are a dict, every matrix as ``x @ W`` takes it (input first):

- ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V);
- ``layers``, one dict a layer: ``attn_norm`` (d,), ``wq`` (d, H, nope + rope),
  ``wkv_a`` (d, latent + rope), ``kv_norm`` (latent,), ``wkv_b`` (latent, H,
  nope + v), ``wo`` (H, v, d), ``ffn_norm`` (d,); then either ``mlp`` (the
  dense layers: ``gate``, ``up`` (d, f), ``down`` (f, d)), or ``router``
  (d, E), ``bias`` (E,), ``experts`` (``gate``, ``up`` (E, d, f), ``down``
  (E, f, d)) and ``shared`` (``gate``, ``up``, ``down``, as ``mlp``).

A layer, after DeepSeek-V3's equations:

- h = RMSNorm(x); q = h·Wq split into q_nope and q_pe; [c_kv, k_pe] = h·Wkv_a;
  c_kv = RMSNorm(c_kv); q_pe and k_pe rotated (``rope``; k_pe is one head that
  all heads share); [k_nope, v] = c_kv·Wkv_b; scores (q_nope·k_nope +
  q_pe·k_pe) / sqrt(nope + rope), causal softmax; x += o·Wo;
- h = RMSNorm(x); x += SwiGLU(h) in a dense layer, else the routed experts
  plus the shared experts: scores = sigmoid(h·Wg), the experts the top k of
  scores + bias, each weighted by its score over the sum of the k scores,
  times ``routed_scaling_factor``; SwiGLU(h) = (silu(h·gate) * (h·up))·down.

Departures from the published model, each for the benchmark's comparison:

- the weights and the selection bias are random (from a seed, outside this
  file): the trained ones are not part of the config;
- ``choose`` lets a caller pick a token's experts where its own choice is a
  near tie (``route``), so that a comparison with a lower-precision run can
  follow that run's choice there; without it the choice is the top k;
- ``prefix`` lets a layer start after positions whose latents are given
  (``attention``), so that a comparison can run one layer from another
  run's input to it; without it a layer runs over the whole sequence;
- the group-limited choice (``n_group`` 1, ``topk_group`` 1) is the plain
  top k over all experts, which it equals with one group; no auxiliary loss,
  no multi-token prediction layers (``num_nextn_predict_layers`` 0).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Q_CHUNK = 1024  # query rows scored at once: (H, Q_CHUNK, S) float32 scores


class exact_products:
    """float32 matrix products in float32 (no TF32) while inside."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
        return False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding: x (S, heads, Dr) at positions ``pos``
    (S,).  As its modelling code does, the adjacent pairs (2i, 2i+1) are
    first de-interleaved (even channels, then odd) and the halves then
    rotated (rotate-half), at frequencies theta^(-2i/Dr).  The output stays
    de-interleaved, for queries and keys alike."""
    dr = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    freq = theta ** (-torch.arange(0, dr, 2, dtype=torch.float32, device=x.device) / dr)
    ang = pos.to(torch.float32)[:, None] * freq[None, :]  # (S, Dr/2)
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None, :]
    rotated = torch.cat([-x[..., dr // 2:], x[..., :dr // 2]], dim=-1)
    return x * cos + rotated * sin


def swiglu(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w["gate"]) * (x @ w["up"])) @ w["down"]


def attention(w: Dict[str, Any], h: torch.Tensor, cfg: Dict[str, Any], prefix=None):
    """MLA over one sequence h (S, d), causal.  Returns (out (S, d), the
    normed latent c_kv (S, latent), the rotated rope key k_pe (S, rope)).
    ``prefix``, where given, is the (c_kv (P, latent), k_pe (P, rope)) of P
    positions before h's: h's positions are then P .. P + S - 1, and its
    queries attend to the prefix's keys and values as to their own."""
    s = h.shape[0]
    nope, rp, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["kv_lora_rank"]
    start = 0 if prefix is None else prefix[0].shape[0]
    pos = torch.arange(start, start + s, device=h.device)
    q = torch.einsum("sd,dhk->shk", h, w["wq"])
    kva = h @ w["wkv_a"]
    c_kv = rms_norm(kva[:, :r], w["kv_norm"], cfg["rms_norm_eps"])
    k_pe = rope(kva[:, None, r:], pos, cfg["rope_theta"])[:, 0]
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, cfg["rope_theta"])
    all_c, all_pe = (c_kv, k_pe) if prefix is None else (torch.cat([prefix[0], c_kv]), torch.cat([prefix[1], k_pe]))
    kv = torch.einsum("sc,chk->shk", all_c, w["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    kpos = torch.arange(start + s, device=h.device)
    scale = (nope + rp) ** -0.5
    out = torch.empty_like(h)
    wo = w["wo"].reshape(-1, w["wo"].shape[-1])
    for a in range(0, s, Q_CHUNK):
        b = min(s, a + Q_CHUNK)
        scores = (torch.einsum("qhn,shn->hqs", q_nope[a:b], k_nope)
                  + torch.einsum("qhr,sr->hqs", q_pe[a:b], all_pe)) * scale
        masked = kpos[None, None, :] > pos[a:b, None][None]
        p = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqs,shv->qhv", p, v).reshape(b - a, -1) @ wo
    return out, c_kv, k_pe


def route(w: Dict[str, Any], h: torch.Tensor, cfg: Dict[str, Any],
          choose: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None):
    """The router over tokens h (S, d): (expert ids (S, k), their weights (S,
    k), the biased scores (S, E)).  ``choose(biased, ids)`` may replace the
    top-k ids."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(h @ w["router"])
    biased = scores + w["bias"]
    ids = torch.topk(biased, k, dim=-1).indices
    if choose is not None:
        ids = choose(biased, ids)
    weights = torch.gather(scores, -1, ids)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return ids, weights, biased


def experts(w: Dict[str, Any], h: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each expert on the tokens routed to it, weighted and summed; plus the shared experts."""
    out = swiglu(w["shared"], h)
    ex = w["experts"]
    for e in range(ex["gate"].shape[0]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            one = {n: ex[n][e] for n in ("gate", "up", "down")}
            out.index_add_(0, tok, swiglu(one, h[tok]) * weights[tok, slot, None])
    return out


def layer(w: Dict[str, Any], x: torch.Tensor, cfg: Dict[str, Any], choose=None, prefix=None):
    """One layer over one sequence x (S, d), after ``prefix`` (``attention``)
    if given: (x, what it computed on the way: ``c_kv``, ``k_pe`` and, in a
    MoE layer, ``ids`` and ``biased``)."""
    eps = cfg["rms_norm_eps"]
    a, c_kv, k_pe = attention(w, rms_norm(x, w["attn_norm"], eps), cfg, prefix)
    x = x + a
    h = rms_norm(x, w["ffn_norm"], eps)
    info = {"c_kv": c_kv, "k_pe": k_pe}
    if "mlp" in w:
        return x + swiglu(w["mlp"], h), info
    ids, weights, biased = route(w, h, cfg, choose)
    info.update(ids=ids, biased=biased)
    return x + experts(w, h, ids, weights), info


def embed(weights: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return weights["embed"][tokens]


def logits(weights: Dict[str, Any], x: torch.Tensor, cfg: Dict[str, Any]) -> torch.Tensor:
    return rms_norm(x, weights["final_norm"], cfg["rms_norm_eps"]) @ weights["lm_head"]


def forward(weights: Dict[str, Any], tokens: torch.Tensor, cfg: Dict[str, Any], choose=None) -> torch.Tensor:
    """The logits (S, V) of one sequence of token ids (S,)."""
    with exact_products():
        x = embed(weights, tokens)
        for w in weights["layers"]:
            x, _ = layer(w, x, cfg, choose)
        return logits(weights, x, cfg)
