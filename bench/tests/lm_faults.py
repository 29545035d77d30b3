"""Faults planted under an LM decode cell's timed path, and its check's
control, one function each: ``lm_rehearse.py`` calls the one a run names
with the run's spec before the harness builds the entry, so the fault sits
in the program (the port's model modules) and the harness runs unchanged
above it.  Each patches a point the program passes on the CPU and on the
card alike, so that it can be read at the cell's own size."""

from __future__ import annotations


def control(spec) -> None:
    """The check's control: the latent cache held in float8_e4m3fn, a
    precision below the configuration's bfloat16: every row the prefill
    and the decode steps write is rounded through it."""
    import torch

    from repro_torch.models import attention

    write = attention.write_latent

    def low(cache_t, new, pos):
        write(cache_t, new.to(torch.float8_e4m3fn).to(new.dtype), pos)

    attention.write_latent = low


def no_shared(spec) -> None:
    """The shared experts left out of every MoE layer."""
    import torch

    from repro_torch.models import moe

    moe.mlp = lambda params, x, activation: torch.zeros_like(x)


def _route(bias: bool, scale: bool):
    import torch

    from repro_torch.models import moe

    def route(params, x, cfg):
        ct = torch.promote_types(x.dtype, torch.float32)
        scores = torch.sigmoid(x.to(ct) @ params["router"]["kernel"].to(ct))
        ids = torch.topk(scores + params["router"]["bias"].to(ct) if bias else scores, cfg.top_k, dim=-1).indices
        w = torch.gather(scores, -1, ids)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return ids, w * cfg.routed_scale if scale else w

    moe.sigmoid_route = route


def no_bias(spec) -> None:
    """The router's selection bias ignored in the choice of experts."""
    _route(bias=False, scale=True)


def no_scale(spec) -> None:
    """The routed experts' weights without the routed scaling factor."""
    _route(bias=True, scale=False)


def other_row(spec) -> None:
    """Each decode step's latent attention reads the next row's cache."""
    from repro_torch.models import attention

    attend = attention.attend_latent
    attention.attend_latent = lambda q_lat, q_pe, ckv, kpe, pos, scale: attend(
        q_lat, q_pe, ckv.roll(1, 0), kpe.roll(1, 0), pos, scale)


def unrotated_kpe(spec) -> None:
    """A decode step's rope key left unrotated (cached and attended so)."""
    from repro_torch.models import attention

    rotate = attention.rope_pairs

    def rope_pairs(x, positions, theta):
        if x.shape[1] == 1 and x.shape[-2] == 1:  # one position, one head: a decode step's k_pe
            dh = x.shape[-1]
            return x.unflatten(-1, (dh // 2, 2)).transpose(-1, -2).flatten(-2)
        return rotate(x, positions, theta)

    attention.rope_pairs = rope_pairs


FAULTS = ("no_shared", "no_bias", "no_scale", "other_row", "unrotated_kpe")
