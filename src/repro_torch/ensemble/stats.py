"""Fused ensemble statistics, emitted through the stencil IR.

The spread of the ensemble *is* the forecast product, so the reductions over
the member axis (mean, variance, spread, member min/max, threshold-exceedance
probability) are not ad-hoc numpy: a statistics stencil is synthesized as a
normal Definition IR — one API input per member, all statistics computed in
one fused pointwise pass — and built through ``build_from_definition``, so it
rides the whole existing toolchain: the pass pipeline (constant folding, CSE,
temp demotion), the fingerprint cache, every backend, and ``exec_info``.  On
the ``cuda`` backend it is one generated kernel with N inputs and six outputs.

The member unroll is exact: N is a compile-time constant of the ensemble, so
``mean = (m0 + … + mN−1)/N`` is straight-line IR the backends vectorize, and
a different N is simply a different (cached) stencil.

(The reference package's ``repro/ensemble/stats.py``.)
"""

from __future__ import annotations

from functools import reduce
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core import ir
from repro_torch.core import stencil as stencil_mod
from repro_torch.core import storage as core_storage
from repro_torch.core.storage import Storage

from .batch import EnsembleError

#: statistics fields written by the synthesized stencil, in declaration order
STAT_FIELDS = ("mean", "var", "spread", "mn", "mx", "prob")


def _member_names(members: int):
    return [f"m{i}" for i in range(int(members))]


def stats_definition(
    members: int, dtype: str = "float64", name: Optional[str] = None
) -> ir.StencilDefinition:
    """The Definition IR of the fused N-member statistics stencil."""
    members = int(members)
    if members < 1:
        raise EnsembleError(f"statistics need at least one member, got {members}")
    mem = [ir.FieldAccess(n, (0, 0, 0)) for n in _member_names(members)]
    inv_n = ir.Literal(1.0 / members, "float")

    def acc(n: str) -> ir.FieldAccess:
        return ir.FieldAccess(n, (0, 0, 0))

    def total(terms) -> ir.Expr:
        return reduce(lambda a, b: ir.BinOp("+", a, b), terms)

    dev = [ir.BinOp("-", m, acc("mean")) for m in mem]
    exceed = [
        ir.TernaryOp(
            ir.BinOp(">", m, ir.ScalarRef("threshold")),
            ir.Literal(1.0, "float"),
            ir.Literal(0.0, "float"),
        )
        for m in mem
    ]
    body = (
        ir.Assign(acc("mean"), ir.BinOp("*", total(mem), inv_n)),
        ir.Assign(acc("var"), ir.BinOp("*", total([ir.BinOp("*", d, d) for d in dev]), inv_n)),
        ir.Assign(acc("spread"), ir.NativeCall("sqrt", (acc("var"),))),
        ir.Assign(acc("mn"), reduce(lambda a, b: ir.NativeCall("min", (a, b)), mem)),
        ir.Assign(acc("mx"), reduce(lambda a, b: ir.NativeCall("max", (a, b)), mem)),
        ir.Assign(acc("prob"), ir.BinOp("*", total(exceed), inv_n)),
    )
    member_decls = tuple(ir.FieldDecl(n, dtype, ir.AXES_IJK, is_api=True) for n in _member_names(members))
    stat_decls = tuple(ir.FieldDecl(n, dtype, ir.AXES_IJK, is_api=True) for n in STAT_FIELDS)
    return ir.StencilDefinition(
        name=name or f"ensemble_stats_{members}",
        api_fields=member_decls + stat_decls,
        scalars=(ir.ScalarDecl("threshold", dtype),),
        computations=(
            ir.ComputationBlock(
                ir.IterationOrder.PARALLEL,
                (ir.IntervalBlock(ir.VerticalInterval.full(), body),),
            ),
        ),
        docstring=f"fused {members}-member ensemble statistics",
    )


def build_ensemble_stats(
    members: int,
    backend: str,
    dtype: str = "float64",
    *,
    name: Optional[str] = None,
    validate_args: bool = True,
    **backend_opts: Any,
) -> stencil_mod.StencilObject:
    """Compile the fused statistics stencil for ``members`` members."""
    defn = stats_definition(members, dtype=dtype, name=name)
    return stencil_mod.build_from_definition(
        defn, backend, validate_args=validate_args, backend_opts=dict(backend_opts)
    )


class EnsembleStatistics:
    """Callable wrapper: member-batched storage → statistics storages.

    ``stats(batched, threshold=2.0)`` slices the N member views out of the
    batched storage, allocates (or reuses, via ``out=``) statistics storages
    of the same per-member geometry, and runs the fused stencil once over the
    full buffer — mean, variance, spread, member min/max, and
    P(member > threshold) in a single dispatch.
    """

    def __init__(self, members: int, backend: str, dtype: str = "float64", **backend_opts: Any):
        self.members = int(members)
        self.backend = backend
        self.dtype = dtype
        self.stencil = build_ensemble_stats(self.members, backend, dtype=dtype, **backend_opts)

    def __call__(
        self,
        batched: Storage,
        *,
        threshold: float = 0.0,
        out: Optional[Dict[str, Storage]] = None,
        exec_info: Optional[dict] = None,
    ) -> Dict[str, Storage]:
        if not isinstance(batched, Storage) or not batched.is_member_batched:
            raise EnsembleError("statistics expect a member-batched Storage (leading 'N' axis)")
        if batched.members != self.members:
            raise EnsembleError(
                f"storage holds {batched.members} members, statistics compiled for {self.members}"
            )
        if tuple(batched.axes[1:]) != ("I", "J", "K"):
            raise EnsembleError(
                f"statistics support ('N', 'I', 'J', 'K') storages, got axes {batched.axes}"
            )
        shape = tuple(batched.shape[1:])
        origin = tuple(batched.default_origin[1:])
        if out is None:
            kw = {} if self.backend in ("debug", "numpy") else {"device": batched.device}
            out = {
                n: core_storage.zeros(shape, dtype=self.dtype, backend=self.backend, default_origin=origin, **kw)
                for n in STAT_FIELDS
            }
        fields: Dict[str, Any] = {n: batched.member(i) for i, n in enumerate(_member_names(self.members))}
        fields.update(out)
        # statistics are pointwise (extent zero): run over the whole buffer,
        # halo included, so downstream stencils can read stats in their halos
        self.stencil(
            **fields,
            threshold=np.dtype(self.dtype).type(threshold),
            domain=shape,
            origin=(0, 0, 0),
            exec_info=exec_info,
        )
        return out
