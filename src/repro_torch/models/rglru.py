"""RecurrentGemma's RG-LRU block: its parameter spec only.

The block itself (gates, causal conv, the recurrence) is not ported yet
(ROADMAP Queue 1, LM stack: the hybrid model path); the spec lets
``LM.param_specs`` and ``exact_param_count`` cover the hybrid config.  The
recurrence's kernel is ported: ``repro_torch.kernels.rglru.ops.rglru_scan``.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import RGLRUConfig

from .layers import ParamSpec


def rglru_block_spec(d_model: int, cfg: RGLRUConfig) -> Dict[str, Any]:
    dr = cfg.d_rnn or int(1.5 * d_model)
    return {
        # two input branches (recurrent + gate), GeGLU-style
        "w_x": {"kernel": ParamSpec((d_model, dr), ("embed", "mlp"))},
        "w_gate": {"kernel": ParamSpec((d_model, dr), ("embed", "mlp"))},
        "conv_w": ParamSpec((cfg.d_conv, dr), (None, "conv_io")),
        "conv_b": ParamSpec((dr,), ("conv_io",), init="zeros"),
        # RG-LRU gates
        "w_input_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "b_input_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "w_rec_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "b_rec_gate": ParamSpec((dr,), ("mlp",), init="zeros"),
        "lambda_param": ParamSpec((dr,), ("mlp",), init="ones"),
        "w_out": {"kernel": ParamSpec((dr, d_model), ("mlp", "embed"))},
    }
