"""Mixture-of-experts layer: its parameter spec only.

The layer itself (router, capacity dispatch, expert FFNs) is not ported yet
(ROADMAP Queue 1, LM stack: moe); the spec lets ``LM.param_specs`` and
``exact_param_count`` cover the moe configs.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import MoEConfig

from .layers import ParamSpec, mlp_spec


def moe_spec(d: int, cfg: MoEConfig, activation: str, use_bias: bool) -> Dict[str, Any]:
    e, f = cfg.n_experts, cfg.d_ff_expert
    mult_gated = activation in ("swiglu", "geglu")
    spec: Dict[str, Any] = {
        "router": {"kernel": ParamSpec((d, e), ("embed", "experts"), dtype="float32")},
        "wi": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }
    if mult_gated:
        spec["wg"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
    if cfg.shared_d_ff:
        spec["shared"] = mlp_spec(d, cfg.shared_d_ff, activation, use_bias)
    return spec
