"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-12b; hf]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    norm="layernorm",
    activation="swiglu",
    use_bias=False,
    rope_theta=10000.0,
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
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
