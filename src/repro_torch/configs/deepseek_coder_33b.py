"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch.  [arXiv:2401.14196; hf]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=100000.0,
)

REDUCED = replace(
    FULL,
    n_layers=3,
    d_model=56 * 2,  # keep head_dim divisible
    n_heads=4,
    n_kv_heads=2,
    d_ff=224,
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
