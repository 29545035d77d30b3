"""Modality frontends (audio, vision), stubs as in the reference.

``[audio]``/``[vlm]`` architectures specify the transformer backbone only;
frame and patch embeddings arrive precomputed.  The stubs are a linear
adapter, plus fixed sinusoidal positions for audio, standing in for the conv
feature extractor and the ViT tower.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import matmul

from .layers import ParamSpec, sinusoidal_positions


def frontend_spec(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.frontend in ("audio", "vision"):
        # a linear adapter over precomputed frame / patch embeddings
        return {"adapter": {"kernel": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed"))}}
    return {}


def apply_frontend(params, cfg: ArchConfig, feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, S_enc, d_model) precomputed embeddings → backbone inputs."""
    dt = getattr(torch, cfg.dtype)
    x = matmul(feats.to(dt), params["adapter"]["kernel"].to(dt))
    if cfg.frontend == "audio":
        pos = torch.from_numpy(sinusoidal_positions(feats.shape[1], cfg.d_model)).to(x.device, dt)
        x = x + pos[None]
    return x
