"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
(per expert), vocab=32064, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, MoEConfig, register

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    norm="layernorm",
    activation="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    # dropless (capacity ≥ T) so decode matches forward exactly in tests
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=2.0),
    attention_impl="naive",
    dtype="float32",
)

ENTRY = register(
    ArchEntry(
        full=FULL,
        reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skips=(("long_500k", "pure full attention; 500k decode needs sub-quadratic attention"),),
    )
)
