"""Field storage: the paper's backend-aware NumPy-like containers, on torch.

A :class:`Storage` owns a buffer (NumPy for the ``debug``/``numpy`` backends,
a ``torch.Tensor`` for ``torch``/``cuda``), carries a ``default_origin`` (the
position of the compute-domain origin inside the buffer — i.e. the halo) and
implements ``__array__`` so it inter-operates with the rest of the Python
ecosystem (the paper's buffer-protocol point).

Layout: the reference's (I, J, K) C order, K fastest, so that the port and
the reference package compare like with like.  No alignment padding: the
reference's TPU (8, 128) register-tile padding has no counterpart here.

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


def _resolve_device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "storage: no CUDA device is available for a torch-backed field; "
            "pass device='cpu' to allocate on the host explicitly"
        )
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


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
            return self.data.detach().cpu().numpy()
        return np.asarray(self.data)


def _default_axes(ndim: int) -> Tuple[str, ...]:
    return ("I", "J", "K")[:ndim] if ndim <= 3 else tuple(f"D{i}" for i in range(ndim))


def _alloc(shape, dtype, backend, default_origin, fill, axes, device) -> Storage:
    shape = tuple(int(s) for s in shape)
    if default_origin is None:
        default_origin = (0,) * len(shape)
    if axes is None:
        axes = _default_axes(len(shape))
    if backend in TORCH_BACKENDS:
        dev = _resolve_device(device)
        tdt = _torch_dtype(dtype)
        if fill == "ones":
            data = torch.ones(shape, dtype=tdt, device=dev)
        elif fill == "zeros":
            data = torch.zeros(shape, dtype=tdt, device=dev)
        else:
            data = torch.empty(shape, dtype=tdt, device=dev)
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
        data = torch.from_numpy(np.ascontiguousarray(arr)).to(_resolve_device(device))
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
