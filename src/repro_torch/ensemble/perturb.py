"""Counter-based, reproducible ensemble member perturbations.

The reference draws member ``m``'s noise from ``jax.random.fold_in(key, m)``
(threefry), so every member's noise is a pure function of ``(seed, member
index)``.  Torch has no bit-equal twin of that stream; the port keeps the
property with one generator per member: an explicit ``torch.Generator`` on
the target device (Philox on the card), seeded from ``(seed, m)`` alone.
Member 7 of an 8-member ensemble draws exactly what member 7 of a 64-member
ensemble would, independent of member count and order, which is what makes
ensemble experiments extendable and restartable.  The numbers differ from the
reference's, and between the CPU and the card: tests that compare the two
packages feed the reference's perturbed arrays to the port.

Generators return member-batched :class:`~repro_torch.core.storage.Storage`
(leading ``N`` axis) on the base field's backend and device.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.storage import TORCH_BACKENDS, Storage, resolve_device

from .batch import EnsembleError, from_member_arrays


def member_keys(seed: Any, members: int) -> List[int]:
    """The per-member generator seeds: a hash of ``(seed, m)`` for each
    member ``m`` (the counterpart of the reference's ``fold_in(key, m)``)."""
    out = []
    for m in range(int(members)):
        digest = hashlib.sha256(f"repro_torch.ensemble|{int(seed)}|{m}".encode()).digest()
        out.append(int.from_bytes(digest[:8], "little") & (2**63 - 1))
    return out


def _member_noise(draw, seed: Any, members: int, shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    tdt = getattr(torch, np.dtype(dtype).name)
    out = torch.empty((int(members),) + tuple(shape), dtype=tdt, device=device)
    for m, key in enumerate(member_keys(seed, members)):
        gen.manual_seed(key)
        out[m] = draw(tuple(shape), gen, tdt, device)
    return out


def normal_noise(seed: Any, members: int, shape: Tuple[int, ...], dtype="float64", device=None) -> torch.Tensor:
    """Standard-normal noise of shape ``(members, *shape)``, counter-based,
    drawn on ``device`` (the card unless a device is named)."""
    return _member_noise(lambda s, g, t, d: torch.randn(s, generator=g, dtype=t, device=d),
                         seed, members, shape, dtype, device)


def uniform_noise(seed: Any, members: int, shape: Tuple[int, ...], dtype="float64", device=None) -> torch.Tensor:
    """Uniform noise in [-1, 1) of shape ``(members, *shape)``, drawn on
    ``device`` (the card unless a device is named)."""
    return _member_noise(lambda s, g, t, d: 2.0 * torch.rand(s, generator=g, dtype=t, device=d) - 1.0,
                         seed, members, shape, dtype, device)


_KINDS = {"normal": normal_noise, "uniform": uniform_noise}


def perturb(
    base: Any,
    members: int,
    *,
    seed: Any = 0,
    amplitude: float = 1e-3,
    kind: str = "normal",
    relative: bool = False,
    perturb_member0: bool = True,
) -> Storage:
    """``members`` perturbed copies of ``base`` as one batched storage.

    ``base`` is a Storage or array holding the control initial condition;
    member ``m`` becomes ``base + amplitude · noise_m`` (``relative=True``
    scales the noise by ``|base|`` pointwise).  ``perturb_member0=False``
    keeps member 0 as the unperturbed control run — the usual operational
    ensemble layout.  The noise is drawn on the base field's device.
    """
    gen = _KINDS.get(kind)
    if gen is None:
        raise EnsembleError(f"unknown perturbation kind {kind!r}; expected one of {sorted(_KINDS)}")
    members = int(members)
    if members <= 0:
        raise EnsembleError(f"members must be positive, got {members}")
    if isinstance(base, Storage):
        backend = base.backend
        origin: Tuple[int, ...] = tuple(base.default_origin)
        axes = tuple(base.axes)
        raw = base.data
    else:
        backend = "numpy"
        raw = base
        origin = (0,) * raw.ndim
        axes = ("I", "J", "K")[: raw.ndim]
    if axes and axes[0] == "N":
        raise EnsembleError("perturb() expects an unbatched base field")
    arr = raw if isinstance(raw, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(raw))
    noise = gen(seed, members, tuple(arr.shape), dtype=str(arr.dtype).replace("torch.", ""), device=arr.device)
    if relative:
        noise = noise * arr.abs()[None]
    if not perturb_member0:
        noise[0] = 0.0
    data = arr[None] + float(amplitude) * noise
    return from_member_arrays(list(data), backend=backend, default_origin=origin, axes=axes,
                              device=arr.device if backend in TORCH_BACKENDS else None)


def spread_inflation(batched: Storage, factor: float) -> Storage:
    """Inflate member deviations about the ensemble mean by ``factor`` —
    the standard covariance-inflation knob, host-side (initialization-time).
    """
    if not batched.is_member_batched:
        raise EnsembleError("spread_inflation() expects a member-batched storage")
    arr = batched.data
    mean = arr.mean(axis=0, keepdims=True) if isinstance(arr, np.ndarray) else arr.mean(dim=0, keepdim=True)
    inflated = mean + float(factor) * (arr - mean)
    return from_member_arrays(list(inflated), backend=batched.backend, default_origin=batched.default_origin[1:],
                              axes=batched.axes[1:])
