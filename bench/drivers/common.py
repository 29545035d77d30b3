"""What the drivers share: the session a driver hands the harness, the
port's counters, and the port's storages filled from the benchmark's inputs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch



def inputs_for(cfg: Dict[str, Any], seed: int, device):
    """The configuration's inputs (``bench/inputs/<inputs>.py``) from the seed."""
    from bench import harness

    return harness.module("inputs", cfg["inputs"]).Inputs(cfg["domain"], seed, device)


def port_counters() -> Dict[str, Dict[str, int]]:
    """The port's own counters since their last reset: generated-kernel
    launches by kernel (``codegen_cuda.launch_counts``) and halo-exchange
    messages (``parallel.halo.message_counts``)."""
    from repro_torch.core import codegen_cuda
    from repro_torch.parallel import halo

    return {"launches": dict(codegen_cuda.launch_counts()), "messages": dict(halo.message_counts())}


def reset_port_counters() -> None:
    from repro_torch.core import codegen_cuda
    from repro_torch.parallel import halo

    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()


@dataclass
class Session:
    """One built entry point on its fields.

    ``call(exec_info)`` runs one call of the entry (``steps`` steps of every
    member); ``state()`` is what the check compares, by name, each an
    (M, K, I, J) view of this rank's members and block; ``where`` places
    them in the whole ensemble and domain (``member``, ``i``, ``j``: the
    first member and the block's offset); ``counters()`` reads the
    program's counters since ``reset_counters()``; ``free()`` drops the
    program's fields."""

    call: Callable[[Optional[dict]], Any]
    state: Callable[[], Dict[str, torch.Tensor]]
    steps: int
    free: Callable[[], None]
    where: Dict[str, int] = field(default_factory=lambda: {"member": 0, "i": 0, "j": 0})
    counters: Callable[[], Dict[str, Any]] = port_counters
    reset_counters: Callable[[], None] = reset_port_counters


def level_view(t: torch.Tensor) -> torch.Tensor:
    """A port field (I, J, K) or (N, I, J, K) as a (K, I, J) or
    (N, K, I, J) view: in the card layout, level planes are contiguous."""
    return t.permute(2, 0, 1) if t.dim() == 3 else t.permute(0, 3, 1, 2)


def interior(t: torch.Tensor, halo: int) -> torch.Tensor:
    v = level_view(t)
    return v[..., halo:v.shape[-2] - halo, halo:v.shape[-1] - halo]


def member_view(t: torch.Tensor) -> torch.Tensor:
    """(M, K, I, J) of a batched or a one-member field."""
    return t if t.dim() == 4 else t.unsqueeze(0)


def single_domain_fields(cfg: Dict[str, Any], seed: int, device, names, members: Optional[int] = None,
                         shared=()) -> Dict[str, Any]:
    """The program's fields on one domain, as the port's storages (the card
    layout, zero halos): ``phi`` (every member), ``u``, ``v`` and ``w`` from
    the inputs, zeros elsewhere.  ``members`` batches every field but the
    ``shared`` ones."""
    from repro_torch.core import storage

    dom = tuple(int(d) for d in cfg["domain"])
    h = int(cfg["halo"])
    inputs = inputs_for(cfg, seed, device)
    fields = {}
    for n in names:
        m = None if (members is None or n in shared) else members
        fields[n] = storage.storage_for_domain(dom, (h, h, 0), dtype=cfg["dtype"], backend="cuda",
                                               fill="zeros", members=m, device=device)
    for n in ("u", "v", "w"):
        interior(fields[n].data, h).copy_(getattr(inputs, n)())
    phi = member_view(interior(fields["phi"].data, h))
    for m in range(phi.shape[0]):
        phi[m].copy_(inputs.phi(m))
    return fields
