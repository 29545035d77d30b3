"""LR schedules as functions of the step, in float32 (as the reference's
traced ones); each returns a 0-d float32 tensor on the CPU.  A schedule is a
host scalar: under a ``FakeTensorMode`` (the dry run) it is still computed."""

from __future__ import annotations

import functools
import math

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily


def host_step(step) -> int:
    """A step counter (an int, a 0-d tensor, a DTensor's local one) as a host
    int, also under a ``FakeTensorMode`` (whose step counters stay real)."""
    with unset_fake_temporarily():
        return int(step.to_local() if hasattr(step, "to_local") else step)


def _host(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)

    return wrapped


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


@_host
def cosine_schedule(step, base_lr: float, total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


@_host
def linear_warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, device="cpu")
    warm = base_lr * (_f32(step) + 1.0) / max(warmup_steps, 1)
    cos = cosine_schedule(step - warmup_steps, base_lr, max(total_steps - warmup_steps, 1), final_frac)
    return torch.where(step < warmup_steps, warm, cos)
