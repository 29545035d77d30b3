"""Mamba-2 SSD block: its parameter spec only.

The block itself (chunked SSD scan, causal conv, decode step) is not ported
yet (ROADMAP Queue 1, LM stack: ssm); the spec lets ``LM.param_specs`` and
``exact_param_count`` cover the ssm configs.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import SSMConfig

from .layers import ParamSpec


def ssd_spec(d_model: int, cfg: SSMConfig) -> Dict[str, Any]:
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    d_xbc = di + 2 * gn
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": {"kernel": ParamSpec((d_model, di + d_xbc + nh), ("embed", "mlp"))},
        "conv_w": ParamSpec((cfg.d_conv, d_xbc), (None, "conv_io")),
        "conv_b": ParamSpec((d_xbc,), ("conv_io",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "norm_scale": ParamSpec((di,), ("mlp",), init="ones"),
        "w_out": {"kernel": ParamSpec((di, d_model), ("mlp", "embed"))},
    }
