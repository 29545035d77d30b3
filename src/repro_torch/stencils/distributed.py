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
``cuda``).  ``overlap`` is stored and not used, as in the reference.  The
reference's ``lower`` (HLO text) has no counterpart: ``parallel.halo
.message_counts()`` counts the messages an exchange posts instead.
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
