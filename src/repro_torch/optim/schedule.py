"""LR schedules as functions of the step, in float32 (as the reference's
traced ones); each returns a 0-d float32 tensor on the CPU."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def cosine_schedule(step, base_lr: float, total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


def linear_warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, device="cpu")
    warm = base_lr * (_f32(step) + 1.0) / max(warmup_steps, 1)
    cos = cosine_schedule(step - warmup_steps, base_lr, max(total_steps - warmup_steps, 1), final_frac)
    return torch.where(step < warmup_steps, warm, cos)
