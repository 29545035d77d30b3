"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16) expert d_ff=1408,
vocab=163840, 64 experts top-6 + shared expert (Moonlight/DeepSeek-V3-style).
[hf:moonshotai/Moonlight-16B-A3B; hf]

The reference package's table-derived stand-in, mirrored here: plain
multi-head attention, a softmax router and no dense first layer.  The
published model (27 layers, latent attention, the sigmoid router, a dense
first layer) is ``moonlight_16b_a3b.py``.
"""

from dataclasses import replace

from .base import ArchConfig, ArchEntry, MoEConfig, register

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, shared_d_ff=2816),
)

REDUCED = replace(
    FULL,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    # dropless (capacity ≥ T) so decode matches forward exactly in tests
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, shared_d_ff=128, capacity_factor=4.0),
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
