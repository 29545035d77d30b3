"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT tower stubbed, Qwen2-0.5B-style backbone (qkv-bias,
tied embeddings).  [arXiv:2404.16821; hf]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    norm="rmsnorm",
    activation="swiglu",
    use_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    frontend="vision",
    encoder_seq=256,  # patch embeddings per image (stub)
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=56,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    encoder_seq=4,
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
