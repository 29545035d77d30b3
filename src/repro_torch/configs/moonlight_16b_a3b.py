"""Moonlight-16B-A3B [moe] at its published widths
(https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json,
``model_type: deepseek_v3``).

27 layers of hidden size 2048 and 16 heads; vocabulary 163840 (untied);
RMSNorm eps 1e-5; rope theta 50000, no scaling.  Latent attention (MLA): no
query latent (``q_lora_rank: null``), a 512-wide KV latent, heads of 128
(no rope) + 64 (rope) for queries and keys and 128 for values.  Layer 0 is a
dense SwiGLU of width 11264 (``first_k_dense_replace: 1``); layers 1-26 hold
64 routed SwiGLU experts of width 1408, 6 a token, beside 2 shared experts
(one SwiGLU of width 2816).  The router is DeepSeek-V3's: sigmoid scores,
the top 6 of scores plus a selection bias (``noaux_tc``, one group),
weighted by the unbiased scores normalised over the 6 and times 2.446.

Not registered in ``list_archs()``: the registry mirrors the reference
package's, whose ``moonshot-v1-16b-a3b`` is a table-derived stand-in of
this model (48 plain-attention layers).  ``FULL`` serves in bfloat16 and
prefills through the flash kernel; ``REDUCED`` is the same shape at a CPU
test's size.
"""

from dataclasses import replace

from .base import ArchConfig, MLAConfig, MoEConfig

FULL = ArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab=163840,
    head_dim=192,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, shared_d_ff=2 * 1408, scoring="sigmoid",
                  routed_scale=2.446, dropless=True),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    n_dense_layers=1,
    norm_eps=1e-5,
    attention_impl="flash",
    dtype="bfloat16",
    param_dtype="bfloat16",
)

# one dense layer, then two MoE layers; 8 experts, 2 a token, 2 shared
REDUCED = replace(
    FULL,
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    head_dim=24,
    moe=replace(FULL.moe, n_experts=8, top_k=2, d_ff_expert=16, shared_d_ff=32),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    attention_impl="naive",
    dtype="float32",
    param_dtype="float32",
)
