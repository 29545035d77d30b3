"""One decode step of latent attention (MLA) in the absorbed form, on the card.

``latent_attention`` dispatches by device alone.  On CUDA tensors it
launches the hand-written Hopper kernel ``csrc/latent_decode_sm90.cu``
(``KERNEL``): each cache row 0 .. pos read once, both products on the tensor
cores, the scores and the softmax kept on the chip in float32.  What the
kernel does not take raises there (``prepare``): another dtype than
bfloat16, another width, a cache that is not contiguous; so do a failed
build and a failed launch.  A CUDA call never takes another route.  On CPU
tensors it runs the plain formula (``ref.attend_latent_ref``), in any dtype,
as the flash wrapper does.  ``bytes_read`` counts what the kernel reads.

Any number of heads is taken, in groups of 16 (the last one padded on the
chip); each group's blocks read the rows again.  A sequence's rows are cut
into ``splits`` runs, one a block, from the batch, the allocated rows and
the card's SM count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable

import torch

from repro_torch.kernels._build import HandKernel

from .ref import attend_latent_ref

LATENT_WIDTHS = tuple(range(64, 513, 64))
ROPE_WIDTHS = (16, 32, 48, 64)
HEAD_GROUP = 16  # heads a block: the N of both products
TILE_ROWS = 64  # cache rows a tile
MIN_TILES = 2  # tiles a split takes at least
_CSRC = Path(__file__).resolve().parent / "csrc"
# (q_lat, q_pe, ckv, kpe, pos, o, o_part, ml_part, 4 strides, b, h, s_alloc, latent, rope, splits, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])

# -Xptxas -v reports registers and spills in the library's log
KERNEL = HandKernel("latent_decode_sm90", _CSRC / "latent_decode_sm90.cu", "latent_decode_sm90", _ARGTYPES,
                    flags=("-Xptxas", "-v"))

_SMS: dict = {}


def splits(b: int, h: int, s_alloc: int, sms: int) -> int:
    """Runs of tiles a sequence's rows are cut into: as many as let the
    blocks fill the card's SMs once (one block an SM), at least one and at
    most what leaves each run ``MIN_TILES`` tiles of the allocated rows."""
    blocks = b * -(-h // HEAD_GROUP)
    return max(1, min(sms // blocks, -(-s_alloc // TILE_ROWS) // MIN_TILES))


def bytes_read(ckv: torch.Tensor, kpe: torch.Tensor, pos: torch.Tensor, heads: int) -> torch.Tensor:
    """Bytes of cache the kernel reads for ``heads`` heads: rows 0 .. pos of
    every sequence, latent and rope key, once for each group of
    ``HEAD_GROUP`` heads; an int64 tensor on ``pos``'s device (no host read)."""
    b, s = ckv.shape[:2]
    groups = -(-heads // HEAD_GROUP)
    row = ckv.shape[-1] * ckv.element_size() + kpe.shape[-1] * kpe.element_size()
    return (pos.to(torch.int64) + 1).clamp(max=s) * (b * groups * row)


def _check(q_lat, q_pe, ckv, kpe, pos) -> None:
    if q_lat.dim() != 3 or q_pe.dim() != 3 or ckv.dim() != 3 or kpe.dim() != 3:
        raise ValueError(f"latent_attention: q_lat (B, H, latent), q_pe (B, H, rope), ckv (B, S, latent) and kpe "
                         f"(B, S, rope); got {tuple(q_lat.shape)}, {tuple(q_pe.shape)}, {tuple(ckv.shape)}, "
                         f"{tuple(kpe.shape)}")
    b, h, lat = q_lat.shape
    s, rope = ckv.shape[1], kpe.shape[-1]
    if q_pe.shape != (b, h, rope) or ckv.shape != (b, s, lat) or kpe.shape != (b, s, rope):
        raise ValueError(f"latent_attention: shapes do not fit: q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, ckv {tuple(ckv.shape)}, kpe {tuple(kpe.shape)}")
    if lat not in LATENT_WIDTHS or rope not in ROPE_WIDTHS:
        raise ValueError(f"latent_attention: latent {lat} not in {LATENT_WIDTHS} or rope {rope} not in "
                         f"{ROPE_WIDTHS}")
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("ckv", ckv), ("kpe", kpe)):
        if t.dtype != torch.bfloat16 or t.device != ckv.device:
            raise TypeError(f"latent_attention: {name} is {t.dtype} on {t.device}; the kernel takes bfloat16, "
                            f"all on the cache's device ({ckv.device})")
    for name, t in (("ckv", ckv), ("kpe", kpe)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"latent_attention: the cache's {name} must be contiguous and 16-byte aligned, got "
                             f"strides {t.stride()}")
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe)):  # the kernel copies 16-byte chunks of rows
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:2], t.shape[:2]) if n > 1):
            raise ValueError(f"latent_attention: {name} needs 16-byte aligned rows (contiguous along its last axis, "
                             f"strides multiples of 8), got strides {t.stride()}")
    if not isinstance(pos, torch.Tensor) or pos.dim() != 0 or pos.dtype != torch.int32 or pos.device != ckv.device:
        raise TypeError(f"latent_attention: pos must be a 0-d int32 tensor on {ckv.device}")


def latent_attention(q_lat, q_pe, ckv, kpe, pos, scale: float) -> torch.Tensor:
    """The softmax-weighted latent (B, H, latent) of ``ref.attend_latent_ref``
    over rows 0 .. ``pos`` of the cache (a 0-d int32 tensor, read on the
    device): the kernel on CUDA tensors, the plain formula on others."""
    if not ckv.is_cuda:
        return attend_latent_ref(q_lat, q_pe, ckv, kpe, pos, scale)
    return prepare(q_lat, q_pe, ckv, kpe, pos, scale)()


def prepare(q_lat, q_pe, ckv, kpe, pos, scale: float) -> Callable[[], torch.Tensor]:
    """Check CUDA arguments, allocate the output and the splits' partials and
    return a callable that launches the kernel on them (each call one
    launch of the entry point) and returns the output."""
    _check(q_lat, q_pe, ckv, kpe, pos)
    if not ckv.is_cuda:
        raise TypeError(f"latent_attention: tensors on {ckv.device} do not launch the kernel")
    b, h, lat = q_lat.shape
    s, rope = ckv.shape[1], kpe.shape[-1]
    dev = ckv.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n = splits(b, h, s, _SMS[dev])
    o = torch.empty((b, h, lat), dtype=q_lat.dtype, device=dev)
    if b == 0 or h == 0 or s == 0:
        return lambda: o
    part = ml = None
    if n > 1:
        part = torch.empty((b, n, h, lat), dtype=torch.float32, device=dev)
        ml = torch.empty((b, n, h, 2), dtype=torch.float32, device=dev)
    args = (
        q_lat.data_ptr(), q_pe.data_ptr(), ckv.data_ptr(), kpe.data_ptr(), pos.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(), None if ml is None else ml.data_ptr(),
        *q_lat.stride()[:2], *q_pe.stride()[:2],
        b, h, s, lat, rope, n, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )

    def launch() -> torch.Tensor:
        KERNEL.launch(*args)
        return o

    # the inputs and the scratch live as long as the launcher
    launch.keep = (q_lat, q_pe, ckv, kpe, pos, part, ml)
    return launch
