"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128 (SSD, state-space duality).  [arXiv:2405.21060; unverified]
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, SSMConfig, register

FULL = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    quadratic_attention=False,
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=64,
    vocab=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1, chunk=8),
    dtype="float32",
)

ENTRY = register(
    ArchEntry(
        full=FULL,
        reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    )
)
