"""Member-batched storages: allocation and member-axis plumbing.

An ensemble field is one :class:`repro_torch.core.storage.Storage` whose
leading axis is the member axis ``N`` (``axes=("N", "I", "J", "K")``, origin
0 along ``N``).  Stencils and programs never see the member axis — the
ensemble compiler slices per-member views for compilation and batches
execution over the members — so everything the single-member toolchain knows
(halos, origins, dtypes) is computed per member and is identical between
batched and unbatched allocations.  On the ``cuda`` backend the member axis
is outermost in the card layout (``storage.card_tensor``): member ``m`` is one
contiguous block, itself in the one-member card layout.

(The reference package's ``repro/ensemble/batch.py``; the reference's TPU
``alignment`` padding has no counterpart, and torch-backed allocations take
``device=``, the card unless named.)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import storage as core_storage
from repro_torch.core.storage import TORCH_BACKENDS, Storage
from repro_torch.program.trace import ProgramError


class EnsembleError(ProgramError):
    """An ensemble was constructed or called inconsistently."""


MEMBER_AXIS = "N"


def batched_axes(axes: Sequence[str]) -> Tuple[str, ...]:
    if axes and axes[0] == MEMBER_AXIS:
        raise EnsembleError(f"axes {tuple(axes)} already carry a member axis")
    return (MEMBER_AXIS,) + tuple(axes)


def is_member_batched(value: Any) -> bool:
    return isinstance(value, Storage) and value.is_member_batched


def member_count(value: Any) -> Optional[int]:
    return value.members if isinstance(value, Storage) else None


def zeros(members, shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc_batched("zeros", members, shape, dtype, backend, default_origin, axes, device)


def ones(members, shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc_batched("ones", members, shape, dtype, backend, default_origin, axes, device)


def empty(members, shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc_batched("empty", members, shape, dtype, backend, default_origin, axes, device)


def _alloc_batched(fill, members, shape, dtype, backend, default_origin, axes, device) -> Storage:
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("I", "J", "K")[: len(shape)]
    if default_origin is None:
        default_origin = (0,) * len(shape)
    return core_storage._alloc(
        (int(members),) + shape,
        dtype,
        backend,
        (0,) + tuple(default_origin),
        fill,
        batched_axes(axes),
        device,
    )


def storage_for_domain(
    members: int,
    domain: Tuple[int, int, int],
    halo: Tuple[int, int, int],
    dtype="float64",
    backend="cuda",
    fill="zeros",
    axes=("I", "J", "K"),
    device=None,
) -> Storage:
    """Member-batched twin of ``core.storage.storage_for_domain``."""
    return core_storage.storage_for_domain(
        domain, halo, dtype=dtype, backend=backend, fill=fill, axes=axes, members=int(members), device=device
    )


def _empty_batched(data_shape, backend: str, origin, axes, dtype, device) -> Storage:
    """An empty batched storage for ``backend`` (on ``device``, in the card
    layout on ``cuda``)."""
    if backend in TORCH_BACKENDS:
        return core_storage._alloc(data_shape, dtype, backend, origin, "empty", axes, device)
    return Storage(np.empty(data_shape, dtype=dtype), backend=backend, default_origin=origin, axes=axes)


def from_member_arrays(arrays, backend="cuda", default_origin=None, dtype=None, axes=None, device=None) -> Storage:
    """Stack per-member arrays (NumPy arrays, tensors or per-member
    ``Storage``) into one batched storage — members must agree on shape and
    dtype.  Torch-backed members stay on their device unless ``device`` names
    another."""
    if not len(arrays):
        raise EnsembleError("from_member_arrays() needs at least one member")
    raws = [a.data if isinstance(a, Storage) else a for a in arrays]
    shapes = sorted({tuple(r.shape) for r in raws})
    if len(shapes) > 1:
        raise EnsembleError(f"member shapes disagree: {shapes}")
    first = arrays[0]
    if isinstance(first, Storage):
        default_origin = default_origin if default_origin is not None else first.default_origin
        axes = axes if axes is not None else first.axes
    ndim = len(shapes[0])
    if axes is None:
        axes = ("I", "J", "K")[:ndim]
    if default_origin is None:
        default_origin = (0,) * ndim
    if dtype is None:
        dtype = str(raws[0].dtype).replace("torch.", "")
    if device is None and isinstance(raws[0], torch.Tensor) and backend in TORCH_BACKENDS:
        device = raws[0].device
    out = _empty_batched((len(raws),) + shapes[0], backend, (0,) + tuple(default_origin),
                         batched_axes(axes), dtype, device)
    for m, r in enumerate(raws):
        if isinstance(out.data, torch.Tensor):
            src = r if isinstance(r, torch.Tensor) else torch.from_numpy(np.array(r))
            out.data[m].copy_(src)
        else:
            out.data[m] = r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
    return out


def broadcast(value: Any, members: int, backend=None) -> Storage:
    """Replicate one field across ``members`` identical members (the batched
    form of an unperturbed initial condition)."""
    if isinstance(value, Storage):
        return from_member_arrays([value] * int(members), backend=backend or value.backend)
    return from_member_arrays([value] * int(members), backend=backend or "numpy")


def scatter_members(arrays, members: int, *, template: Storage, backend=None) -> Storage:
    """Scatter request-shaped arrays onto member slots of one batched storage.

    The serving path: ``arrays[i]`` (a plain per-request array shaped like
    ``template``) lands in member slot ``i``; slots ``len(arrays)..members-1``
    are padded with copies of the LAST array.  Padding is free correctness-wise
    because members are independent — padded members compute garbage nobody
    gathers — and it lets a partial batch reuse the kernels of the nearest
    member count instead of preparing new ones per batch size.
    """
    arrays = list(arrays)
    if not arrays:
        raise EnsembleError("scatter_members() needs at least one request array")
    if len(arrays) > int(members):
        raise EnsembleError(f"cannot scatter {len(arrays)} requests onto {members} member slots")
    for i, a in enumerate(arrays):
        shape = tuple(a.shape)
        if shape != tuple(template.shape):
            raise EnsembleError(
                f"request array {i} has shape {shape}, template field expects {tuple(template.shape)}"
            )
    pad = [arrays[-1]] * (int(members) - len(arrays))
    return from_member_arrays(
        arrays + pad,
        backend=backend or template.backend,
        default_origin=template.default_origin,
        dtype=str(template.dtype),
        axes=template.axes,
        device=template.device,
    )


def gather_member(batched, m: int) -> np.ndarray:
    """Gather member ``m`` back out as a host numpy copy.

    The inverse of :func:`scatter_members` — used by the serving engine to
    peel request ``m``'s state out of a batched storage for streaming, so the
    returned array must not alias device or batch memory."""
    if isinstance(batched, Storage):
        if not batched.is_member_batched:
            raise EnsembleError(f"storage with axes {batched.axes} has no member axis to gather")
        return np.array(batched.member(int(m)).to_numpy(), copy=True)
    if isinstance(batched, torch.Tensor):
        return batched[int(m)].detach().cpu().numpy().copy()
    return np.array(np.asarray(batched)[int(m)], copy=True)


def member_view(batched: Storage, m: int) -> Storage:
    """The per-member storage for member ``m`` (copy-free)."""
    return batched.member(m)


def member_sample(value: Any):
    """The member-0 view used to key/compile the single-member program."""
    if is_member_batched(value):
        return value.member(0)
    return value
