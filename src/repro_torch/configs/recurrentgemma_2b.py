"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention in a (rglru, rglru, attn) pattern.
[arXiv:2402.19427; hf]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, RGLRUConfig, register

FULL = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    norm="rmsnorm",
    activation="geglu",
    tie_embeddings=True,  # gemma family ties input/output embeddings
    sliding_window=2048,
    logit_softcap=30.0,
    rglru=RGLRUConfig(d_rnn=2560, d_conv=4, pattern=("rglru", "rglru", "attn")),
    rope_theta=10000.0,
    quadratic_attention=False,  # local attention + linear recurrence
)

REDUCED = replace(
    FULL,
    n_layers=4,  # 1 full (rglru, rglru, attn) group + 1 tail rglru
    d_model=80,
    n_heads=4,
    n_kv_heads=1,
    d_ff=160,
    vocab=512,
    sliding_window=8,
    rglru=RGLRUConfig(d_rnn=80, d_conv=4, pattern=("rglru", "rglru", "attn")),
    attention_impl="naive",
    dtype="float32",
)

ENTRY = register(
    ArchEntry(
        full=FULL,
        reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    )
)
