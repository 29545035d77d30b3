"""whisper-medium [audio] — enc-dec, conv frontend stubbed.
24L (enc+dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356; unverified]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, register

FULL = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    activation="gelu",
    use_bias=True,
    tie_embeddings=True,
    rope_theta=10000.0,  # unused: enc-dec blocks use learned/sinusoidal positions
    n_encoder_layers=24,
    encoder_seq=1500,
    frontend="audio",
    quadratic_attention=True,
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    n_encoder_layers=2,
    encoder_seq=16,
    attention_impl="naive",
    dtype="float32",
)

ENTRY = register(
    ArchEntry(
        full=FULL,
        reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skips=(("long_500k", "pure full attention (enc-dec); 500k decode needs sub-quadratic attention"),),
    )
)
