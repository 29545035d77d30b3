"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
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
