"""The cells' inputs, made on the device from ``--seed``.

Every field is drawn at the whole domain's size in the (K, I, J) order of a
level plane, from a generator of its own on the device, so that any member,
and any rank's block of it, is drawn alike wherever it is needed: the
program's fields, the reference's, and a decomposed domain's blocks.

- ``phi`` of member m: a gaussian blob ``exp(-8 (x^2 + y^2)) (1 + 0.1 z)``
  plus 1e-2 of seeded noise, and for m > 0 a further 1e-3 of seeded noise
  of its own (member 0 is the unperturbed member, as an ensemble's control run);
- ``u`` and ``v``: uniform in (-1, 1), so the upwind branch goes either way;
- ``w``: 0.2 times uniform in (0, 1).

Every halo is zero.  A seed is any whole number; it is taken modulo 2**64.
"""

from __future__ import annotations

from typing import Sequence

import torch

_GOLDEN = 0x9E3779B97F4A7C15
_PHI, _U, _V, _W, _MEMBER = 0, 1, 2, 3, 4


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + stream * _GOLDEN) % 2**64)
    return g


class Inputs:
    """The fields of one cell: ``domain`` (ni, nj, nk), float64 on ``device``."""

    def __init__(self, domain: Sequence[int], seed: int, device):
        self.ni, self.nj, self.nk = (int(d) for d in domain)
        self.seed = int(seed)
        self.device = torch.device(device)

    @property
    def shape(self):
        return (self.nk, self.ni, self.nj)

    def _normal(self, stream: int) -> torch.Tensor:
        return torch.randn(self.shape, generator=_gen(self.seed, stream, self.device), dtype=torch.float64,
                           device=self.device)

    def _uniform(self, stream: int) -> torch.Tensor:
        return torch.rand(self.shape, generator=_gen(self.seed, stream, self.device), dtype=torch.float64,
                          device=self.device)

    def phi(self, member: int = 0) -> torch.Tensor:
        """Member ``member``'s tracer, (K, I, J)."""
        kw = {"dtype": torch.float64, "device": self.device}
        x = torch.linspace(-1.0, 1.0, self.ni, **kw)[None, :, None]
        y = torch.linspace(-1.0, 1.0, self.nj, **kw)[None, None, :]
        z = torch.linspace(0.0, 1.0, self.nk, **kw)[:, None, None]
        out = torch.exp(-8.0 * (x * x + y * y)) * (1.0 + 0.1 * z)
        out += 1e-2 * self._normal(_PHI)
        if member:
            out += 1e-3 * self._normal(_MEMBER + int(member))
        return out

    def u(self) -> torch.Tensor:
        return 2.0 * self._uniform(_U) - 1.0

    def v(self) -> torch.Tensor:
        return 2.0 * self._uniform(_V) - 1.0

    def w(self) -> torch.Tensor:
        return 0.2 * self._uniform(_W)
