"""The yardstick of an LM decode cell's per-layer shares: the bytes and
operations one decode step of the batch needs, from the configuration's
published keys, and the least time they take on the card.

A decode step of ``batch`` sequences at position ``p`` (each attends to
rows 0 .. p) in the absorbed form of latent attention (DeepSeek-V3):

- bytes: every weight read once in its serving dtype (bfloat16; the norms
  and the router in float32), but the embedding (one row a sequence) and
  the routed experts (only those the step's tokens chose: the touched
  experts' bytes, counted on the device); and the latent cache, each row
  0 .. p of every layer read once (latent + rope key, bfloat16);
- operations: two a multiply-add of every product the absorbed step needs:
  the projections, Wkv_b's key half into the query and its value half into
  the output, the scores and the weighted sum over p + 1 rows, the router,
  the k chosen experts and the shared ones, the dense layers, the head.

Peaks: NVIDIA H100 SXM data sheet, 3.35 TB/s and 989 TFLOP/s dense bf16
(at the full 700 W).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
BF16, F32 = 2, 4


def _sizes(cfg: Dict[str, Any]):
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    nope, rp, r, dv = (int(cfg[k]) for k in ("qk_nope_head_dim", "qk_rope_head_dim", "kv_lora_rank", "v_head_dim"))
    return d, h, nope, rp, r, dv


def expert_bytes(cfg: Dict[str, Any]) -> int:
    """One routed expert's weights (gate, up, down), bfloat16."""
    return 3 * int(cfg["hidden_size"]) * int(cfg["moe_intermediate_size"]) * BF16


def other_weight_bytes(cfg: Dict[str, Any]) -> int:
    """Every weight a decode step of ``cfg["batch"]`` sequences reads but the routed experts'."""
    d, h, nope, rp, r, dv = _sizes(cfg)
    layers, dense = int(cfg["num_hidden_layers"]), int(cfg["first_k_dense_replace"])
    moe_layers = layers - dense
    attn = (d * h * (nope + rp) + d * (r + rp) + r * h * (nope + dv) + h * dv * d) * BF16 + r * F32
    norms = 2 * d * F32
    dense_mlp = 3 * d * int(cfg["intermediate_size"]) * BF16
    shared = 3 * d * int(cfg["n_shared_experts"]) * int(cfg["moe_intermediate_size"]) * BF16
    router = (d + 1) * int(cfg["n_routed_experts"]) * F32
    vocab = int(cfg["vocab_size"])
    ends = int(cfg["batch"]) * d * BF16 + d * vocab * BF16 + d * F32  # embedding rows, head, final norm
    return layers * (attn + norms) + dense * dense_mlp + moe_layers * (shared + router) + ends


def positions(cfg: Dict[str, Any], steps: int) -> Sequence[int]:
    """The positions of a call's decode steps."""
    p0 = int(cfg["prompt"])
    return range(p0, p0 + steps)


def latent_bytes(cfg: Dict[str, Any], steps: int) -> float:
    """The latent cache a step needs, averaged over a call's steps: rows 0 .. p
    of every layer, each once: batch * mean(p + 1) * layers * (latent + rope) * 2 B."""
    _d, _h, _nope, rp, r, _dv = _sizes(cfg)
    mean_rows = sum(p + 1 for p in positions(cfg, steps)) / steps
    return int(cfg["batch"]) * mean_rows * int(cfg["num_hidden_layers"]) * (r + rp) * BF16


def decode_flops(cfg: Dict[str, Any], steps: int) -> float:
    """Operations of one decode step in the absorbed form, averaged over a call's steps."""
    d, h, nope, rp, r, dv = _sizes(cfg)
    layers, dense = int(cfg["num_hidden_layers"]), int(cfg["first_k_dense_replace"])
    mean_rows = sum(p + 1 for p in positions(cfg, steps)) / steps
    attn = d * h * (nope + rp) + d * (r + rp) + h * nope * r + h * dv * r + h * dv * d
    attn += h * (r + rp) * mean_rows + h * r * mean_rows
    f = int(cfg["moe_intermediate_size"])
    moe = d * int(cfg["n_routed_experts"]) + 3 * d * f * (int(cfg["num_experts_per_tok"]) + int(cfg["n_shared_experts"]))
    per_token = layers * attn + dense * 3 * d * int(cfg["intermediate_size"]) + (layers - dense) * moe
    per_token += d * int(cfg["vocab_size"])
    return 2.0 * int(cfg["batch"]) * per_token


def least_seconds(cfg: Dict[str, Any], steps: int, touched_expert_bytes: float) -> Dict[str, Any]:
    """The least time of one decode step: the larger of its bytes over the
    card's bandwidth and its operations over its bf16 peak; the experts'
    bytes are those the step's tokens touched."""
    nbytes = touched_expert_bytes + other_weight_bytes(cfg) + latent_bytes(cfg, steps)
    flops = decode_flops(cfg, steps)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return {"seconds": max(t_bytes, t_ops), "bound": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": flops}
