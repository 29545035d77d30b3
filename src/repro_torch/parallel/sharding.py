"""Logical-axis sharding rules (MaxText/T5X-style), over DTensor.

The reference package's ``repro/parallel/sharding.py``.  Model code names
the axes of activations and parameters logically ('batch', 'heads',
'embed', ...); a :class:`LogicalAxisRules` context maps those names to the
axes of a mesh ('pod', 'data', 'model') per deployment, so one model
definition runs on one device (no mesh), on a (2, 2) mesh of four ranks or
on the production 16 x 16 mesh without edits.

Where the reference builds ``jax.sharding.PartitionSpec``s for GSPMD, the
port's spec is a plain tuple with one entry per tensor dimension: a mesh
axis name, a tuple of names, or None.  :class:`NamedSharding` pairs it with
a mesh and gives the DTensor placements (``Shard``/``Replicate``) per mesh
dimension, and ``with_logical_constraint`` is a ``redistribute`` of a
DTensor.  A mesh is a ``torch.distributed`` ``DeviceMesh`` or an
:class:`AbstractMesh` (axis names and sizes only, no process group), so
rules can be checked without ranks.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed.device_mesh

AxisName = Union[str, None, Tuple[str, ...]]
Spec = Tuple[AxisName, ...]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind it."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


def mesh_axes_and_sizes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of a ``DeviceMesh``, an :class:`AbstractMesh` or
    any object with ``axis_names`` and ``devices.shape`` (a jax mesh)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names, mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(int(s) for s in mesh.shape)
    return tuple(mesh.axis_names), tuple(int(s) for s in mesh.devices.shape)


def axis_size(mesh, axis: str) -> int:
    """The size of the named axis of ``mesh`` (1 when absent or no mesh)."""
    if mesh is None:
        return 1
    names, sizes = mesh_axes_and_sizes(mesh)
    return dict(zip(names, sizes)).get(axis, 1)


class LogicalAxisRules:
    """Ordered mapping logical-axis-name → mesh axis (or tuple of axes, or None)."""

    def __init__(self, rules: Sequence[Tuple[str, AxisName]]):
        self.rules: Dict[str, AxisName] = dict(rules)

    def mesh_axes(self, logical: Sequence[Optional[str]], mesh=None,
                  shape: Optional[Sequence[int]] = None) -> Spec:
        """Translate logical axes to a spec, one entry per dimension.

        Rules apply left to right with three safeguards that make one rule
        set serve every architecture:

        * axes not present in the mesh are dropped,
        * one mesh axis is never used for two tensor dims,
        * if ``shape`` is given, a mapping whose dim is not divisible by the
          mesh-axis size is dropped: e.g. 10 query heads on a 4-way model
          axis fall through, letting a later dim (head_dim) pick the axis up.
        """
        used: set = set()
        out: List[AxisName] = []
        if mesh is not None:
            names, sizes_t = mesh_axes_and_sizes(mesh)
            mesh_axis_names, sizes = set(names), dict(zip(names, sizes_t))
        else:
            mesh_axis_names, sizes = None, {}

        def divides(dim_size: Optional[int], axes: Tuple[str, ...]) -> bool:
            if dim_size is None or mesh is None:
                return True
            total = 1
            for a in axes:
                total *= sizes.get(a, 1)
            return total > 0 and dim_size % total == 0

        for i, name in enumerate(logical):
            dim = None if shape is None else int(shape[i])
            axis = None if name is None else self.rules.get(name)
            if axis is None:
                out.append(None)
            elif isinstance(axis, tuple):
                ax = tuple(a for a in axis if a not in used and (mesh_axis_names is None or a in mesh_axis_names))
                if ax and divides(dim, ax):
                    used.update(ax)
                    out.append(ax if len(ax) > 1 else ax[0])  # as PartitionSpec writes ('data',)
                else:
                    out.append(None)
            elif axis in used or (mesh_axis_names is not None and axis not in mesh_axis_names) \
                    or not divides(dim, (axis,)):
                out.append(None)
            else:
                used.add(axis)
                out.append(axis)
        return tuple(out)


# Default production rules: batch over (pod, data); model-parallel dims over
# model; the reference's rules entry for entry.
DEFAULT_RULES = LogicalAxisRules(
    [
        ("batch", ("pod", "data")),
        ("seq", None),  # sequence usually replicated (activations)
        # context-parallel attention: q sequence over the model axis when
        # head counts don't divide it
        ("attn_seq", "model"),
        # decode KV caches: sequence-parallel over model (flash-decode style)
        ("kv_seq", "model"),
        ("embed", None),
        ("heads", "model"),
        ("kv_heads", "model"),
        # fallback TP axis: picks up 'model' when a head count does not
        # divide it — contraction-dim sharding
        ("head_dim", "model"),
        ("mlp", "model"),
        ("experts", "model"),
        ("vocab", "model"),
        ("conv_io", None),
        ("ssm_heads", "model"),
        ("ssm_state", None),
        ("stage", "pipe"),
        # distributed stencils: horizontal plane decomposed over the mesh
        ("field_i", ("pod", "data")),
        ("field_j", "model"),
        # ensemble member axis: members shard over the pod axis when present
        ("member", "pod"),
    ]
)

_local = threading.local()


def current_rules() -> LogicalAxisRules:
    return getattr(_local, "rules", DEFAULT_RULES)


def current_mesh():
    return getattr(_local, "mesh", None)


@contextmanager
def axis_rules(rules: LogicalAxisRules, mesh=None):
    """Make ``rules`` (and ``mesh``, when given) current in this thread."""
    prev_rules = getattr(_local, "rules", None)
    prev_mesh = getattr(_local, "mesh", None)
    _local.rules = rules
    _local.mesh = mesh
    try:
        yield
    finally:
        if prev_rules is None:
            del _local.rules
        else:
            _local.rules = prev_rules
        _local.mesh = prev_mesh


def logical_spec(logical: Sequence[Optional[str]], mesh=None, shape: Optional[Sequence[int]] = None) -> Spec:
    return current_rules().mesh_axes(logical, mesh or current_mesh(), shape)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (one entry per tensor dimension), the counterpart
    of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    def placements(self) -> Tuple[Any, ...]:
        """DTensor placements, one per mesh dimension: ``Shard(d)`` where the
        spec puts that mesh axis on tensor dim ``d`` (a tuple of axes on one
        dim shards it over each of them, in mesh order), else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names, _sizes = mesh_axes_and_sizes(self.mesh)
        out = []
        for name in names:
            dims = [d for d, ax in enumerate(self.spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def logical_sharding(logical: Sequence[Optional[str]], mesh=None,
                     shape: Optional[Sequence[int]] = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("logical_sharding requires a mesh (use axis_rules(..., mesh=...))")
    return NamedSharding(mesh, logical_spec(logical, mesh, shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def to_local(x):
    """A DTensor's local tensor; anything else as it is."""
    return x.to_local() if isinstance(x, torch.Tensor) and is_dtensor(x) else x


def replicate_inner(x):
    """A DTensor with a dimension between its first and its last sharded (a
    sequence-parallel activation), those dimensions gathered: a matrix
    product flattens them, and DTensor (before torch 2.13) cannot flatten a
    sharded inner dimension.  Anything else is returned as it is."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


class _InnerReplicatedGrad(torch.autograd.Function):
    """Identity forward; the gradient comes back with its inner dimensions
    gathered (``replicate_inner``), for the matrix product that made ``x``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return replicate_inner(grad)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  On a DTensor of 3 or more dimensions, the inner ones are
    gathered first, and so are those of the gradient that flows back into
    the product (a sequence-sharded residual stream hands it one): the
    product flattens them, forward and backward."""
    if not is_dtensor(x) or x.dim() < 3:
        return x @ w
    return _InnerReplicatedGrad.apply(replicate_inner(x) @ w)


def to_full(x):
    """A DTensor's full tensor (a collective); anything else as it is."""
    return x.full_tensor() if isinstance(x, torch.Tensor) and is_dtensor(x) else x


@contextmanager
def spmd_scope():
    """The context a step under a mesh runs in (its backward too): DTensor
    ops then take plain tensors made inside the model (positions, masks,
    zeros) as replicated, as ``implicit_replication`` does; unlike it, the
    scope nests (a remat recompute inside a backward).  Without a mesh it
    does nothing."""
    if not isinstance(current_mesh(), torch.distributed.device_mesh.DeviceMesh):
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def with_logical_constraint(x, logical: Sequence[Optional[str]]):
    """Redistribute a DTensor over its own mesh to the placements the
    current rules give for ``logical``; a plain tensor is returned as it is.
    Model code calls this everywhere; on one device it vanishes."""
    if not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    placements = logical_sharding(logical, x.device_mesh, x.shape).placements()
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
