"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, parallel attn∥mlp block, no-bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    activation="swiglu",
    use_bias=False,
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=352,
    vocab=512,
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
