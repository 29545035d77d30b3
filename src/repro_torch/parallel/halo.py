"""Halo exchange on the device mesh, over ``torch.distributed``.

The reference package's ``repro/parallel/halo.py``.  The horizontal (i, j)
plane is block-decomposed over two mesh axes; each exchange ships H-deep
stripes to the 4 neighbours, and the corners come with the second axis'
stripes, which span the rims the first axis just filled.

The reference is one controller: ``lax.ppermute`` inside ``shard_map`` moves
the stripes of every shard at once.  The port runs one process per rank:
each rank posts its own sends and receives, both directions of an axis in
one ``dist.batch_isend_irecv`` over the axis' process group
(``mesh.get_group(axis)``), to the peers the reference's ``_perm_up`` /
``_perm_down`` pairs name, translated from group-local to global ranks.
Every rank posts the same sequence of exchanges (the plan is SPMD), so the
messages match in posting order.

Transport follows the axis group's backend, never the hardware the code
finds: ``nccl`` sends device tensors; ``gloo`` sends host tensors, so a CUDA
block's stripes go through pinned host buffers (copied out, the stream
synchronised, sent; received, copied back in); any other backend raises
when the exchange runs.  A ``post`` hook, where given, takes each axis'
messages in place of the transport: the dry run's cost walk records them
there (``launch.hlo_count.CostWalk.record_messages``) and posts nothing.
Stripes of a card-layout field are strided, so every message goes through a
contiguous buffer, allocated once per stripe shape and reused.

Edges: a rank no pair names as a sender's receiver receives nothing, and its
rim keeps the zeros it was allocated with (the reference's ``ppermute`` gives
zeros there); an axis of size 1 exchanges nothing, even when periodic.

``message_counts()`` reads, like ``codegen_cuda.launch_counts()``, the
exchanges this process ran, the point-to-point messages it posted and the
bytes of their stripes.

Each exchange is a ``halo.exchange`` device span (``obs.trace.device_span``),
and each axis of it four: ``halo.pack`` (the stripes copied into the send
buffers), ``halo.post`` (``batch_isend_irecv``), ``halo.wait`` (the wait on
the transfer) and ``halo.unpack`` (the rims copied back).  While a device
probe is armed they are timed there: the rank step's ``rank_timings`` are
read from them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.storage import card_tensor, is_card_layout
from repro_torch.launch.mesh import axis_size
from repro_torch.obs import trace as otrace

_COUNTS: Dict[str, int] = {"exchanges": 0, "send": 0, "recv": 0, "send_bytes": 0, "recv_bytes": 0}


def message_counts() -> Dict[str, int]:
    """Exchanges run, messages sent and received, and the bytes of the
    stripes sent and received, by this process."""
    return dict(_COUNTS)


def reset_message_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _perm_up(n: int, periodic: bool):
    """sender r → receiver r+1 (shifting data toward higher indices)."""
    pairs = [(r, r + 1) for r in range(n - 1)]
    if periodic and n > 1:
        pairs.append((n - 1, 0))
    return pairs


def _perm_down(n: int, periodic: bool):
    pairs = [(r + 1, r) for r in range(n - 1)]
    if periodic and n > 1:
        pairs.append((0, n - 1))
    return pairs


def request_exchange(field, halo: Optional[int] = None):
    """Mark a halo-exchange point for ``field`` inside a ``@program`` trace
    (``repro_torch.program.trace.request_exchange``); a no-op returning
    ``field`` outside a trace."""
    from repro_torch.program.trace import request_exchange as _impl

    return _impl(field, halo)


class _Axis:
    """This rank's peers along one mesh axis: global ranks, or None where the
    reference's pairs name no partner."""

    def __init__(self, mesh, name: str, periodic: bool):
        self.name = name
        self.group = mesh.get_group(name)
        self.size = axis_size(mesh, name)
        self.backend = str(dist.get_backend(self.group))
        ranks = dist.get_process_group_ranks(self.group)
        c, n = int(mesh.get_local_rank(name)), self.size
        up, down = set(_perm_up(n, periodic)), set(_perm_down(n, periodic))
        nxt, prv = (c + 1) % n, (c - 1) % n
        self.send_next = ranks[nxt] if (c, nxt) in up else None  # my high stripe → next's low rim
        self.recv_prev = ranks[prv] if (prv, c) in up else None  # previous' high stripe → my low rim
        self.send_prev = ranks[prv] if (c, prv) in down else None  # my low stripe → previous' high rim
        self.recv_next = ranks[nxt] if (nxt, c) in down else None  # next's low stripe → my high rim


class HaloExchange:
    """The halo exchange of one mesh decomposition, run by this rank.

    ``fill(padded, halo, depth)`` fills, in place, the ``halo``-deep rims
    around the interior of ``padded``, whose interior starts ``depth``
    (>= ``halo``) rows and columns in along its i and j dimensions (the
    first two, or the two after a leading member axis with ``lead=1``).
    One exchange of a member-batched buffer carries every local member.

    ``post(axis, sends)``, where given, is called with each axis' messages,
    ``(peer, stripe, tag)`` each, in place of the transport: nothing is
    posted and the rims keep what they hold.
    """

    def __init__(self, mesh, i_axis: str = "data", j_axis: str = "model",
                 periodic: Sequence[bool] = (False, False),
                 post: Optional[Callable[[_Axis, list], None]] = None):
        self.mesh = mesh
        self.post = post
        self.i_axis, self.j_axis = i_axis, j_axis
        self.periodic = tuple(bool(p) for p in periodic)
        self.axes = (_Axis(mesh, i_axis, self.periodic[0]), _Axis(mesh, j_axis, self.periodic[1]))
        self._buffers: Dict[Tuple, torch.Tensor] = {}

    def _buffer(self, role: str, stripe: torch.Tensor, staged: bool) -> torch.Tensor:
        """A contiguous buffer of the stripe's shape: on its device, or pinned
        host memory when the transport stages through the host."""
        device = torch.device("cpu") if staged else stripe.device
        key = (role, tuple(stripe.shape), stripe.dtype, str(device))
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(stripe.shape, dtype=stripe.dtype, device=device,
                              pin_memory=staged and stripe.is_cuda)
            self._buffers[key] = buf
        return buf

    def _exchange_axis(self, axis: _Axis, lo_send, hi_send, lo_rim, hi_rim) -> None:
        """Post both directions of one axis in one batch and wait for it."""
        if self.post is None and axis.backend not in ("gloo", "nccl"):
            raise ValueError(f"halo exchange: axis {axis.name!r} runs on backend {axis.backend!r}; "
                             "expected 'gloo' or 'nccl'")
        if axis.backend == "nccl" and not lo_send.is_cuda:
            raise ValueError(f"halo exchange: axis {axis.name!r} runs on nccl, which sends CUDA tensors; "
                             f"the field is on {lo_send.device}")
        staged = axis.backend == "gloo" and lo_send.is_cuda
        sends = []  # (peer, stripe, tag): the same order on every rank, so messages match
        if axis.send_next is not None:
            sends.append((axis.send_next, hi_send, 1))
        if axis.send_prev is not None:
            sends.append((axis.send_prev, lo_send, 2))
        recvs = []
        if axis.recv_prev is not None:
            recvs.append((axis.recv_prev, lo_rim, 1))
        if axis.recv_next is not None:
            recvs.append((axis.recv_next, hi_rim, 2))
        if not sends and not recvs:
            return
        if self.post is not None:
            self.post(axis, sends)
            return
        ops = []
        with otrace.device_span("halo.pack"):
            for k, (peer, stripe, tag) in enumerate(sends):
                buf = self._buffer(f"send{k}", stripe, staged)
                buf.copy_(stripe, non_blocking=staged)
                ops.append(dist.P2POp(dist.isend, buf, peer, axis.group, tag))
            if staged:
                torch.cuda.current_stream(lo_send.device).synchronize()  # the stripes are in host memory
        landing = []
        for k, (peer, rim, tag) in enumerate(recvs):
            buf = self._buffer(f"recv{k}", rim, staged)
            ops.append(dist.P2POp(dist.irecv, buf, peer, axis.group, tag))
            landing.append((rim, buf))
        with otrace.device_span("halo.post"):
            works = dist.batch_isend_irecv(ops)
        with otrace.device_span("halo.wait"):
            for work in works:
                work.wait()
        _COUNTS["send"] += len(sends)
        _COUNTS["recv"] += len(recvs)
        _COUNTS["send_bytes"] += sum(s.numel() * s.element_size() for _p, s, _t in sends)
        _COUNTS["recv_bytes"] += sum(r.numel() * r.element_size() for _p, r, _t in recvs)
        with otrace.device_span("halo.unpack"):
            for rim, buf in landing:
                rim.copy_(buf, non_blocking=staged)

    def fill(self, padded: torch.Tensor, halo: int, depth: Optional[int] = None, lead: int = 0) -> None:
        h = int(halo)
        d = h if depth is None else int(depth)
        if h == 0:
            return
        if d < h:
            raise ValueError(f"halo exchange: a {h}-deep exchange into a {d}-deep padding")
        si, sj = lead, lead + 1
        ni, nj = padded.shape[si] - 2 * d, padded.shape[sj] - 2 * d
        if ni < h or nj < h:
            raise ValueError(f"halo exchange: a local block of {ni} x {nj} cannot send {h}-deep stripes")
        _COUNTS["exchanges"] += 1
        with otrace.device_span("halo.exchange"):
            # i stripes: the interior's j columns
            rows = padded.narrow(sj, d, nj)
            self._exchange_axis(self.axes[0], rows.narrow(si, d, h), rows.narrow(si, d + ni - h, h),
                                rows.narrow(si, d - h, h), rows.narrow(si, d + ni, h))
            # j stripes of the i-padded rows: they carry the corners
            cols = padded.narrow(si, d - h, ni + 2 * h)
            self._exchange_axis(self.axes[1], cols.narrow(sj, d, h), cols.narrow(sj, d + nj - h, h),
                                cols.narrow(sj, d - h, h), cols.narrow(sj, d + nj, h))


def padded_like(x: torch.Tensor, depth: int, lead: int = 0, card: Optional[bool] = None) -> torch.Tensor:
    """Zeros of ``x``'s shape grown by ``depth`` on both sides of its i and j
    dimensions (at ``lead`` and ``lead + 1``), on ``x``'s device; in the card
    layout when ``card`` (default: when ``x`` is in it), else C order."""
    shape = list(x.shape)
    shape[lead] += 2 * depth
    shape[lead + 1] += 2 * depth
    if card is None:
        card = is_card_layout(x)
    if card and len(shape) in (3, 4) and len(shape) - lead == 3:
        return card_tensor(shape, x.dtype, x.device, "zeros")
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def interior(padded: torch.Tensor, depth: int, lead: int = 0) -> torch.Tensor:
    """The view of ``padded`` without its ``depth``-deep rims."""
    ni, nj = padded.shape[lead] - 2 * depth, padded.shape[lead + 1] - 2 * depth
    return padded.narrow(lead, depth, ni).narrow(lead + 1, depth, nj)


def exchange_halo_2d(x: torch.Tensor, halo: int, mesh, i_axis: str = "data", j_axis: str = "model",
                     periodic: Sequence[bool] = (False, False)) -> torch.Tensor:
    """Local block (ni, nj, ...) → a new haloed block (ni+2H, nj+2H, ...),
    laid out as ``x`` is (the card layout, or C order).

    The reference's ``exchange_halo_2d`` for one rank: every rank of ``mesh``
    calls it with its own block.  ``halo == 0`` returns ``x``.  Callers that
    exchange every step keep a ``HaloExchange`` and padded buffers instead.
    """
    if int(halo) == 0:
        return x
    padded = padded_like(x, int(halo))
    interior(padded, int(halo)).copy_(x)
    HaloExchange(mesh, i_axis, j_axis, periodic).fill(padded, int(halo))
    return padded


# ---------------------------------------------------------------------------
# Block decomposition (tests, drivers)
# ---------------------------------------------------------------------------


def _coords(mesh, axes: Sequence[Optional[str]]) -> List[Tuple[int, int]]:
    """(index, count) of this rank along each named axis ((0, 1) for None)."""
    out = []
    for a in axes:
        if a is None:
            out.append((0, 1))
        else:
            out.append((int(mesh.get_local_rank(a)), axis_size(mesh, a)))
    return out


def shard_blocks(x: torch.Tensor, mesh, i_axis: str = "data", j_axis: str = "model",
                 member_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's block (a view) of the global array ``x``: (I, J[, K]), or
    (N, I, J[, K]) with the members split over ``member_axis``."""
    axes = ([member_axis] if member_axis is not None else []) + [i_axis, j_axis]
    out = x
    for dim, (c, n) in enumerate(_coords(mesh, axes)):
        if x.shape[dim] % n:
            raise ValueError(f"shard_blocks: dimension {dim} of size {x.shape[dim]} does not tile over {n} ranks")
        size = x.shape[dim] // n
        out = out.narrow(dim, c * size, size)
    return out


def gather_blocks(local: torch.Tensor, mesh, i_axis: str = "data", j_axis: str = "model",
                  member_axis: Optional[str] = None) -> torch.Tensor:
    """The global array (on the host, C order) assembled from every rank's
    block; every rank of the mesh calls it and gets the whole array."""
    axes = ([member_axis] if member_axis is not None else []) + [i_axis, j_axis]
    names = list(mesh.mesh_dim_names)
    # nccl gathers device tensors, gloo host ones
    moved = local.detach() if dist.get_backend() == "nccl" else local.detach().to("cpu")
    blocks = [torch.empty_like(moved.contiguous()) for _ in range(dist.get_world_size())]
    dist.all_gather(blocks, moved.contiguous())
    blocks = [b.to("cpu") for b in blocks]
    host = blocks[0]
    counts = [axis_size(mesh, a) for a in axes]
    shape = [s * c for s, c in zip(host.shape, counts)] + list(host.shape[len(axes):])
    out = torch.empty(shape, dtype=host.dtype)
    grid = mesh.mesh
    for r, block in enumerate(blocks):
        pos = (grid == r).nonzero()[0].tolist()
        idx = tuple(slice(pos[names.index(a)] * s, (pos[names.index(a)] + 1) * s)
                    for a, s in zip(axes, host.shape))
        out[idx] = block
    return out
