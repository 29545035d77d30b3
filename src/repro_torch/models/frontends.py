"""Modality frontends (audio, vision): their parameter specs only.

The frontends themselves are not ported yet (ROADMAP Queue 1, LM stack:
enc-dec/vlm frontends); the spec lets ``LM.param_specs`` and
``exact_param_count`` cover the audio and vlm configs.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ArchConfig

from .layers import ParamSpec


def frontend_spec(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.frontend in ("audio", "vision"):
        # a linear adapter over precomputed frame / patch embeddings
        return {"adapter": {"kernel": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed"))}}
    return {}
