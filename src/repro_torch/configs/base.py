"""Architecture/config system.

One :class:`ArchConfig` per assigned architecture (see sibling modules);
``reduced()`` yields the CPU-smoke-test variant of the same family.
Input-shape sets (train_4k / prefill_32k / decode_32k / long_500k) are
declared in :mod:`repro_torch.configs.shapes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # number of dense (non-MoE) d_ff units run in parallel with experts
    shared_d_ff: int = 0
    # the router's scores: 'softmax' (top-k of the softmax, renormalised) or
    # 'sigmoid' (DeepSeek-V3: top-k of the sigmoid scores plus a selection
    # bias, weighted by the unbiased scores renormalised over the k and
    # scaled by ``routed_scale``; ``moe.sigmoid_route``)
    scoring: str = "softmax"
    routed_scale: float = 1.0
    # every expert computes every token routed to it (no capacity clamp)
    dropless: bool = False


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3): keys and values come
    from one ``kv_lora_rank``-wide latent a token, which is what the cache
    holds, beside one ``qk_rope_head_dim``-wide rotated key all heads share.
    Queries project straight from the hidden state (no query latent)."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: Optional[int] = None  # default: round(expand*d_model) per RecurrentGemma
    d_conv: int = 4
    # block pattern: how many recurrent blocks per attention block
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | geglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style attn ∥ mlp
    sliding_window: Optional[int] = None  # local attention width
    logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    # latent attention in place of the per-head K/V projections
    mla: Optional[MLAConfig] = None
    # a moe family's first layers are dense MLPs of width d_ff
    n_dense_layers: int = 0
    # the norms' epsilon (None: each norm's own default)
    norm_eps: Optional[float] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (audio) / vlm frontends
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend sequence length (frames / patches)
    frontend: Optional[str] = None  # 'audio' | 'vision' | None
    # attention impl: naive | chunked | flash (the hand-written CUDA kernel,
    # the counterpart of the reference's 'pallas'); default: chunked
    attention_impl: str = "chunked"
    attention_chunk: int = 1024
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # full attention everywhere? (False for ssm/hybrid) — drives long_500k skip
    quadratic_attention: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embedding/logits shard on any TP axis
        (pad logits are masked to −inf in the head — exact semantics)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6·N·D."""
        d = self.d_model
        hd = self.resolved_head_dim if self.n_heads else 0
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def mlp_params(ff: int) -> int:
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            return mult * d * ff

        if self.family == "moe":
            assert self.moe is not None
            per_layer = attn + self.moe.n_experts * mlp_params(self.moe.d_ff_expert) + d * self.moe.n_experts
            if self.moe.shared_d_ff:
                per_layer += mlp_params(self.moe.shared_d_ff)
        elif self.family == "ssm":
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nh) + di * d \
                + self.ssm.d_conv * (di + 2 * self.ssm.n_groups * self.ssm.d_state)
        elif self.family == "hybrid":
            assert self.rglru is not None
            drnn = self.rglru.d_rnn or int(1.5 * d)
            rec = d * 2 * drnn + drnn * d + self.rglru.d_conv * drnn + 2 * drnn
            pattern = self.rglru.pattern
            n_attn = sum(1 for p in pattern for _ in [0] if p == "attn")
            frac_attn = n_attn / len(pattern)
            per_layer = frac_attn * attn + (1 - frac_attn) * rec + mlp_params(self.d_ff)
        else:
            per_layer = attn + mlp_params(self.d_ff)

        n = emb + self.n_layers * per_layer
        if self.is_encdec:
            # encoder blocks + decoder cross-attention
            n += self.n_encoder_layers * (attn + mlp_params(self.d_ff))
            n += self.n_layers * attn  # cross-attn per decoder layer
        return int(n)

    def n_active_params(self) -> int:
        """Active parameters per token (≠ n_params for MoE)."""
        if self.family != "moe":
            return self.n_params()
        assert self.moe is not None
        total = self.n_params()
        d = self.d_model
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        all_experts = self.n_layers * self.moe.n_experts * mult * d * self.moe.d_ff_expert
        active_experts = self.n_layers * self.moe.top_k * mult * d * self.moe.d_ff_expert
        return int(total - all_experts + active_experts)


_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclass(frozen=True)
class ArchEntry:
    full: ArchConfig
    reduced: ArchConfig
    shapes: Tuple[str, ...]  # applicable shape ids
    skips: Tuple[Tuple[str, str], ...] = ()  # (shape_id, reason)


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.full.name] = entry
    return entry


def get_arch(name: str) -> ArchEntry:
    if name not in _REGISTRY:
        # import sibling config modules lazily
        from . import all_archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    from . import all_archs  # noqa: F401

    return tuple(sorted(_REGISTRY))
