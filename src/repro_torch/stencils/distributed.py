"""Distributed stencils: domain decomposition over a device mesh.

The reference package's ``repro/stencils/distributed.py``.  A DSL-compiled
stencil (``torch`` or ``cuda`` backend) becomes a per-rank step over the
rank's block of mesh-decomposed fields::

    hd = build_hdiff("cuda")
    dist = DistributedStencil(hd, mesh, i_axis="data", j_axis="model")
    out = dist(local_fields, scalars)   # this rank's (ni, nj, nk) blocks

The step: halo exchange (``parallel.halo``) → the stencil on the haloed
block at origin ``(h, h, 0)`` (``(h, h)`` for ``(I, J)`` fields; a ``cuda``
stencil on CUDA tensors launches its kernel once) → the interiors of the
written fields.  ``K``-only fields pass through unpadded.

The reference is one controller: ``shard_map`` takes GLOBAL arrays and
returns global results.  The port runs one process per rank: every rank of
the mesh calls with its own LOCAL blocks (``parallel.halo.shard_blocks``)
and gets its own interiors back (``gather_blocks`` assembles the global
array).  The caller's blocks are not written: the stencil runs on fresh
haloed copies, laid out as the backend's storages are (the card layout on
``cuda``).  ``overlap`` is stored and not used, as in the reference.
``lower`` is the reference's ``lower`` for the dry run: one rank's step on
fake tensors under a cost walk, on the fake process group
(``launch.dryrun.lower_stencil_cell``), with an exchange whose messages go
to the walk and are not posted.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.stencil import StencilObject
from repro_torch.core.storage import TORCH_BACKENDS
from repro_torch.parallel.halo import HaloExchange, interior, padded_like


def local_domain(fields: Dict[str, Any]) -> Tuple[int, int, int]:
    """(ni, nj, nk) of local blocks: nk from a 3-D field, so that an (I, J)
    field listed first does not collapse the vertical to 1 level."""
    sample = next((v for v in fields.values() if v.dim() == 3),
                  next(v for v in fields.values() if v.dim() >= 2))
    nk = int(sample.shape[2]) if sample.dim() == 3 else 1
    return int(sample.shape[0]), int(sample.shape[1]), nk


class DistributedStencil:
    def __init__(
        self,
        stencil: StencilObject,
        mesh,
        *,
        i_axis: str = "data",
        j_axis: str = "model",
        periodic: Sequence[bool] = (False, False),
        overlap: bool = False,
    ):
        if stencil.backend not in TORCH_BACKENDS:
            raise TypeError("DistributedStencil requires a torch/cuda-backend stencil")
        self.stencil = stencil
        self.mesh = mesh
        self.i_axis, self.j_axis = i_axis, j_axis
        self.exchange = HaloExchange(mesh, i_axis, j_axis, periodic)
        self.periodic = tuple(periodic)
        self.overlap = overlap
        impl = stencil.implementation_ir
        self.halo = max(impl.max_halo[0], impl.max_halo[1])
        self.written = set(impl.written_api_fields())

    def __call__(self, fields: Dict[str, torch.Tensor], scalars: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """fields: this rank's LOCAL blocks, (ni, nj, nk) or (ni, nj) or (nk,).
        Returns the written fields' local interiors."""
        scalars = dict(scalars or {})
        h = self.halo
        ni, nj, nk = local_domain(fields)
        padded, origins = {}, {}
        for name, x in fields.items():
            if self.stencil.field_info[name].axes == ("K",):
                padded[name], origins[name] = (x.clone() if name in self.written else x), (0, 0, 0)
                continue
            p = padded_like(x, h, card=self.stencil.backend == "cuda")
            interior(p, h).copy_(x)
            self.exchange.fill(p, h)
            padded[name], origins[name] = p, (h, h, 0)
        self.stencil(**padded, **scalars, domain=(ni, nj, nk), origin=origins)
        return {name: (padded[name] if origins[name] == (0, 0, 0) else interior(padded[name], h))
                for name in fields if name in self.written}

    def lower(self, field_specs: Dict[str, torch.Tensor], scalars: Optional[Dict] = None,
              device="cuda") -> Dict[str, Any]:
        """Run this rank's step (exchange, stencil, interiors) once on fake
        tensors of ``field_specs``' LOCAL shapes and dtypes (meta tensors, say)
        on ``device``, under a ``launch.hlo_count.CostWalk``, and return the
        walk's totals: ``flops``, ``bytes``, ``collectives`` (bytes by kind),
        ``counts`` (messages by kind), ``messages`` (peer, bytes, axis each),
        ``output_bytes`` (alive at the end) and ``temp_bytes`` (the rest of
        the peak).  The exchange hands its messages to the walk
        (``CostWalk.record_messages``), which takes only the dry run's fake
        process group's."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.launch.hlo_count import CostWalk

        fake = FakeTensorMode(allow_non_fake_inputs=True)
        walk = CostWalk(fake)
        real = self.exchange
        self.exchange = HaloExchange(self.mesh, self.i_axis, self.j_axis, self.periodic, post=walk.record_messages)
        try:
            with fake:
                fields = {n: torch.empty(tuple(s.shape), dtype=s.dtype, device=device)
                          for n, s in field_specs.items()}
                with walk:
                    out = self(fields, scalars)
                live_at_end = walk.live_bytes
                del out
        finally:
            self.exchange = real
        return {**walk.totals(), "counts": dict(walk.counts), "messages": list(walk.messages),
                "output_bytes": int(live_at_end), "temp_bytes": int(walk.peak_bytes - live_at_end)}
