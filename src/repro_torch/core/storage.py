"""Field storage: the paper's backend-aware NumPy-like containers, on torch.

A :class:`Storage` owns a buffer (NumPy for the ``debug``/``numpy`` backends,
a ``torch.Tensor`` for ``torch``/``cuda``), carries a ``default_origin`` (the
position of the compute-domain origin inside the buffer — i.e. the halo) and
implements ``__array__`` so it inter-operates with the rest of the Python
ecosystem (the paper's buffer-protocol point).

Layout: the logical shape and indexing are the reference's (I, J, K), so
that the port and the reference package compare like with like.  The
physical order is chosen per backend, as GT4Py's storages do: ``debug``,
``numpy`` and ``torch`` keep C order (K fastest); ``cuda`` fields are laid
out for the card, K slowest, then I, then J with stride 1
(``torch.empty((nk, ni, nj)).permute(1, 2, 0)``, strides ``(nj, 1, ni*nj)``),
because the generated kernel's threads walk J (``codegen_cuda``): a warp's
loads and stores are then contiguous rows.  A member-batched (N, I, J, K)
field keeps N outermost.  (I, J) and K fields are the same in both orders.
No alignment padding: the reference's TPU (8, 128) register-tile padding has
no counterpart here.

Device: the torch-backed allocators put fields on the card (``device="cuda"``)
unless the caller names another device, and raise when no GPU is present —
they never quietly fall back to host memory.  ``from_array`` and
``to_numpy`` carry state across from the reference package: a reference
field's ``to_numpy()`` and ``default_origin`` become a port field, and back.

Ensemble member batching: a storage whose leading axis is ``N`` holds one
field for every ensemble member (``axes=("N", "I", "J", "K")``, origin 0
along ``N``); ``member(m)`` is a copy-free view of one member.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

TORCH_BACKENDS = ("torch", "cuda")
_ALL_BACKENDS = ("debug", "numpy") + TORCH_BACKENDS


def resolve_device(device=None) -> torch.device:
    """The device a torch-backed entry point puts its data on: ``device``, or
    the card when none is named; raises when that is the card and no GPU is
    present (nothing falls back to the host)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "storage: no CUDA device is available for a torch-backed field; "
            "pass device='cpu' to allocate on the host explicitly"
        )
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


_FILL = {"zeros": torch.zeros, "ones": torch.ones, "empty": torch.empty}
# the physical order of the cuda backend's (I, J, K) and (N, I, J, K) fields,
# by rank, outermost axis first
_CARD_AXES = (("I", "J", "K"), ("N", "I", "J", "K"))
_CARD_ORDER = {3: (2, 0, 1), 4: (0, 3, 1, 2)}


def card_tensor(shape, dtype: torch.dtype, device, fill: str = "empty") -> torch.Tensor:
    """A tensor of logical shape (I, J, K) or (N, I, J, K) in the card layout:
    K slowest, then I, then J with stride 1 (N outermost)."""
    shape = tuple(int(s) for s in shape)
    order = _CARD_ORDER[len(shape)]
    data = _FILL[fill](tuple(shape[a] for a in order), dtype=dtype, device=device)
    return data.permute(*np.argsort(order).tolist())


def is_card_layout(t: torch.Tensor) -> bool:
    """True when ``t`` (I, J, K) or (N, I, J, K) has the card layout's strides."""
    if t.dim() not in (3, 4):
        return False
    return t.stride() == card_tensor(t.shape, t.dtype, "meta").stride()


class Storage:
    """A field container bound to a backend."""

    def __init__(
        self,
        data: Any,
        backend: str = "numpy",
        default_origin: Tuple[int, ...] = (0, 0, 0),
        axes: Tuple[str, ...] = ("I", "J", "K"),
    ):
        if backend not in _ALL_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {_ALL_BACKENDS}")
        self.backend = backend
        self.axes = tuple(axes)
        self.default_origin = tuple(default_origin)[: len(self.axes)]
        if backend in TORCH_BACKENDS:
            if not isinstance(data, torch.Tensor):
                raise TypeError(f"backend {backend!r} storage needs a torch.Tensor, got {type(data)}")
            self.data = data
        else:
            self.data = np.asarray(data)

    # -- NumPy-like surface ----------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return np.dtype(str(self.data.dtype).replace("torch.", ""))

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self) -> Optional[torch.device]:
        return self.data.device if isinstance(self.data, torch.Tensor) else None

    def __array__(self, dtype=None, copy=None):
        arr = self.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, idx):
        return self.data[idx]

    def __setitem__(self, idx, value):
        self.data[idx] = value

    def __repr__(self) -> str:
        dev = f", device={self.device}" if self.device is not None else ""
        return (
            f"Storage(shape={self.shape}, dtype={self.dtype}, backend={self.backend!r}{dev}, "
            f"default_origin={self.default_origin})"
        )

    # -- ensemble member axis --------------------------------------------------

    @property
    def is_member_batched(self) -> bool:
        """True when the storage carries a leading ensemble member axis ``N``."""
        return bool(self.axes) and self.axes[0] == "N"

    @property
    def members(self) -> Optional[int]:
        return int(self.shape[0]) if self.is_member_batched else None

    def member(self, m: int) -> "Storage":
        """The per-member ``(I, J, K)`` storage for member ``m`` — a copy-free
        view on every backend."""
        if not self.is_member_batched:
            raise ValueError(f"storage with axes {self.axes} has no member axis")
        return Storage(
            self.data[m],
            backend=self.backend,
            default_origin=self.default_origin[1:],
            axes=self.axes[1:],
        )

    def synchronize(self) -> None:
        """Block until pending device work on this storage is done."""
        if isinstance(self.data, torch.Tensor) and self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)

    def to_numpy(self) -> np.ndarray:
        if isinstance(self.data, torch.Tensor):
            # the logical array in C order, whatever the tensor's layout
            return self.data.detach().cpu().contiguous().numpy()
        return np.asarray(self.data)


def _default_axes(ndim: int) -> Tuple[str, ...]:
    return ("I", "J", "K")[:ndim] if ndim <= 3 else tuple(f"D{i}" for i in range(ndim))


def _torch_alloc(shape, tdt, backend, axes, fill, dev) -> torch.Tensor:
    if backend == "cuda" and axes in _CARD_AXES:
        return card_tensor(shape, tdt, dev, fill)
    return _FILL[fill](shape, dtype=tdt, device=dev)


def _alloc(shape, dtype, backend, default_origin, fill, axes, device) -> Storage:
    shape = tuple(int(s) for s in shape)
    if default_origin is None:
        default_origin = (0,) * len(shape)
    if axes is None:
        axes = _default_axes(len(shape))
    if backend in TORCH_BACKENDS:
        data = _torch_alloc(shape, _torch_dtype(dtype), backend, tuple(axes), fill, resolve_device(device))
    else:
        if device is not None:
            raise ValueError(f"backend {backend!r} storage lives in host memory; device= does not apply")
        alloc = {"zeros": np.zeros, "ones": np.ones, "empty": np.empty}[fill]
        data = alloc(shape, dtype=dtype)
    return Storage(data, backend=backend, default_origin=default_origin, axes=axes)


def zeros(shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc(shape, dtype, backend, default_origin, "zeros", axes, device)


def ones(shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc(shape, dtype, backend, default_origin, "ones", axes, device)


def empty(shape, dtype="float64", backend="cuda", default_origin=None, axes=None, device=None) -> Storage:
    return _alloc(shape, dtype, backend, default_origin, "empty", axes, device)


def from_array(array, backend="cuda", default_origin=None, dtype=None, axes=None, device=None) -> Storage:
    """A storage holding a copy of ``array`` (a NumPy array, a reference
    ``Storage.to_numpy()``, or a tensor)."""
    if isinstance(array, torch.Tensor):
        arr = array.detach().cpu().numpy()
    else:
        arr = np.array(array, copy=True)
    if dtype is not None:
        arr = arr.astype(dtype)
    if default_origin is None:
        default_origin = (0,) * arr.ndim
    if axes is None:
        axes = _default_axes(arr.ndim)
    if backend in TORCH_BACKENDS:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        data = _torch_alloc(arr.shape, src.dtype, backend, tuple(axes), "empty", resolve_device(device))
        data.copy_(src)
    else:
        if device is not None:
            raise ValueError(f"backend {backend!r} storage lives in host memory; device= does not apply")
        data = arr
    return Storage(data, backend=backend, default_origin=default_origin, axes=axes)


def storage_for_domain(
    domain: Tuple[int, int, int],
    halo: Tuple[int, int, int],
    dtype="float64",
    backend="cuda",
    fill="zeros",
    axes=("I", "J", "K"),
    members: Optional[int] = None,
    device=None,
) -> Storage:
    """Allocate a storage sized domain+2·halo with origin at the halo.

    ``members=N`` prepends an ensemble member axis (``axes=("N", ...)``,
    origin 0 along it).
    """
    ni, nj, nk = domain
    hi, hj, hk = halo
    full = []
    origin = []
    for ax, (n, h) in zip(("I", "J", "K"), ((ni, hi), (nj, hj), (nk, hk))):
        if ax in axes:
            full.append(n + 2 * h)
            origin.append(h)
    out_axes = tuple(a for a in ("I", "J", "K") if a in axes)
    if members is not None:
        full.insert(0, int(members))
        origin.insert(0, 0)
        out_axes = ("N",) + out_axes
    return _alloc(tuple(full), dtype, backend, tuple(origin), fill, out_axes, device)
