"""Cost walk of a step's operations: flops, bytes and collectives.

The reference package's ``repro/launch/hlo_count.py`` re-walks compiled HLO
text, because XLA's ``cost_analysis`` counts a ``while`` body once.  PyTorch
has no HLO: the module keeps its name so that a reader finds the
counterpart, and walks the aten operations a step dispatches instead
(:class:`CostWalk`, a ``TorchDispatchMode``), with the reference's keys:

* **flops** — 2·|out|·|contraction| for every ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` and convolution;
* **bytes** — the operands plus the outputs of every operation that is not
  a view;
* **collectives** — payload bytes (the collective's output) by kind
  (all-reduce / all-gather / reduce-scatter / all-to-all /
  collective-permute, and broadcast), both ``c10d`` and functional; and
  the point-to-point messages a halo exchange would post on the dry run's
  fake process group (``record_messages``, the exchange's ``post`` hook:
  one ``collective-permute`` a message, its payload's bytes, as XLA counts
  a ``ppermute`` a device).

Eager dispatch runs every iteration of a Python loop over layers or
microbatches, so the walk sees each one: the reference's trip-count problem
does not arise.  On DTensors the walk sees the rank's own local operations
(DTensor dispatch runs inside it), so every number is one rank's.  Under a
``FakeTensorMode`` it also tracks the live bytes the operations allocate
(``live_bytes``, ``peak_bytes``): the dry run's memory.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_COLLECTIVES = {
    # functional collectives
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all", "broadcast": "broadcast",
    # c10d
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
}
# collectives whose payload is their input (in-place c10d ops and sends)
_PAYLOAD_IS_INPUT = {"allreduce_", "broadcast_", "send", "all_reduce", "broadcast", "all_reduce_coalesced"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    """The tensors in ``x``, through tuples, lists and dicts: what an aten
    operation's arguments and outputs nest them in (cheaper than
    ``tree_flatten``, which the walk would run on every operation)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def dot_flops(name: str, args, out) -> float:
    """2·|out|·|contraction| of one matrix product or convolution."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":  # weight (C_out, C_in / groups, *kernel)
        w = args[1]
        return 2.0 * out.numel() * w[0].numel()
    return 0.0


class CostWalk(TorchDispatchMode):
    """Counts flops, bytes and collectives of the operations dispatched while
    active, and the bytes their outputs hold while alive.  ``fake_mode``: the
    ``FakeTensorMode`` whose tensors are the step's; operations on other fake
    tensors (DTensor's own shape propagation, on global shapes) run uncounted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.messages: List[Dict[str, Any]] = []
        self.live_bytes = 0
        self.peak_bytes = 0

    def _count(self, kind: str, nbytes: float) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def record_messages(self, axis, sends) -> None:
        """A ``parallel.halo.HaloExchange`` ``post`` hook for the dry run's
        fake process group: each message ``(peer, stripe, tag)`` this rank
        would send along ``axis`` is one ``collective-permute`` of the
        stripe's bytes (the payload, once), and nothing is posted.  A real
        group's exchange posts its messages, so any other backend raises."""
        if axis.backend != "fake":
            raise ValueError(f"cost walk: axis {axis.name!r} runs on backend {axis.backend!r}; "
                             "only the dry run's 'fake' group's messages are recorded, not posted")
        for peer, stripe, _tag in sends:
            self.messages.append({"peer": int(peer), "bytes": _nbytes(stripe), "axis": axis.name})
            self._count("collective-permute", _nbytes(stripe))

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches its local operations back through the walk
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode for t in ins + outs):
            return out
        name = func._overloadpacket.__name__
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self._count(kind, sum(map(_nbytes, _tensors(args[0] if name in _PAYLOAD_IS_INPUT else out))))
            return out
        if name in _DOTS:
            self.flops += dot_flops(name, args, out)
        if not func.is_view and name not in ("wait_tensor", "detach", "alias", "lift_fresh"):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            inputs = {id(t) for t in ins}
            for t in outs:  # a fresh output holds memory until it dies
                if id(t) not in inputs:
                    n = _nbytes(t)
                    self.live_bytes += n
                    self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                    weakref.finalize(t, self._release, n)
        return out

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes, "collectives": dict(self.collectives)}


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """The walk's totals over one call of ``fn(*args, **kwargs)``."""
    with CostWalk() as walk:
        fn(*args, **kwargs)
    return walk.totals()
