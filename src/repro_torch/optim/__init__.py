"""Optimizer substrate of the port: AdamW with float32 moments, updated in
place; learning-rate schedules; global-norm clipping (the reference's
``repro.optim``)."""

from .adamw import OptState, adamw_init, adamw_update, decays
from .clip import clip_by_global_norm, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "decays",
    "global_norm",
    "linear_warmup_cosine",
]
