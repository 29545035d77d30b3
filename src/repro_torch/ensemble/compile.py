"""Ensemble compiler: N members of a ``@program`` advanced together.

``Ensemble(prog, members=N)`` runs the per-member step for all N members:

1. the single-member program is compiled (and cached) exactly as if it were
   called on one member — ``Ensemble`` slices member-0 views out of the
   batched storages and reuses ``ProgramObject.compiled``, so the traced
   graph, program passes, fused groups, and generated orchestrator are all
   shared with the unbatched path;
2. on the ``cuda`` backend and CUDA tensors, each fused group is ONE launch
   for all N members: the group's member-batched kernel
   (``StencilObject.block_kernel(block, member_scalars)``), whose third grid axis is the member —
   the counterpart of what ``jax.vmap`` does to the reference's
   ``pallas_call``.  Elsewhere (the ``torch`` backend, or CPU tensors) the
   plain modules run member by member over member views: the plain version
   of the batched kernel, not a fallback from it;
3. ``iterate(n)`` loops that step on the host: n steps × N members, one
   launch per group and step;
4. the batched specialization is cached under a fingerprint that folds the
   member count and the batch pattern into the program fingerprint.

Fields may be member-batched (leading ``N`` axis — state being forecast) or
shared (no member axis — static forcing like winds or orography, read by
every member at member stride 0, never copied N times).  Everything the
program *writes* must be batched: members would otherwise race on one buffer.

Scalars are shared by default; a 1-D array of length N is a *per-member*
scalar (e.g. a perturbed physics constant), read by the kernel at the
member's index.

With ``autotune=True`` each member-batched group re-resolves its block for
the BATCHED operand shapes (the tune store keys on the full geometry), so a
member-batched launch never reuses a block tuned for one member
(``_CompiledEnsemble.batched_runs``).

(The reference package's ``repro/ensemble/compile.py``; ``distribute()``
waits for the distributed programs.)
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import caching
from repro_torch.core.storage import TORCH_BACKENDS, Storage
from repro_torch.obs import trace as otrace
from repro_torch.program.compile import CompiledProgram, CudaGroupRun, ProgramObject
from repro_torch.program.trace import ProgramError

from .batch import EnsembleError, member_sample
from .stats import EnsembleStatistics


class Ensemble:
    """N perturbed members of one program, advanced together."""

    def __init__(self, prog: ProgramObject, members: int, *, name: Optional[str] = None):
        if not isinstance(prog, ProgramObject):
            raise EnsembleError(f"Ensemble wraps a @program object, got {type(prog).__name__}")
        if prog.backend not in TORCH_BACKENDS:
            raise EnsembleError(
                f"Ensemble requires the torch/cuda backends (member-batched launches), not {prog.backend!r}"
            )
        self.prog = prog
        self.members = int(members)
        if self.members < 1:
            raise EnsembleError(f"members must be positive, got {members}")
        self.name = name or f"{prog.name}_ens{self.members}"
        self._cache: Dict[Any, "_CompiledEnsemble"] = {}

    # -- binding / batching ------------------------------------------------

    def _bind(self, args, kwargs) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return self.prog._bind(args, kwargs)

    def _batch_pattern(self, fields: Dict[str, Any]) -> Dict[str, bool]:
        pattern: Dict[str, bool] = {}
        for n, v in fields.items():
            batched = isinstance(v, Storage) and v.is_member_batched
            if batched and v.members != self.members:
                raise EnsembleError(f"field {n!r} holds {v.members} members, ensemble has {self.members}")
            pattern[n] = batched
        if not any(pattern.values()):
            raise EnsembleError(
                f"ensemble {self.name!r} called with no member-batched field: allocate "
                "state with repro_torch.ensemble.batch (axes ('N', 'I', 'J', 'K')) or perturb()"
            )
        return pattern

    def _scalar_pattern(self, scalars: Dict[str, Any]) -> Dict[str, bool]:
        out: Dict[str, bool] = {}
        for n, v in scalars.items():
            per_member = getattr(v, "ndim", 0) == 1
            if per_member and int(v.shape[0]) != self.members:
                raise EnsembleError(
                    f"per-member scalar {n!r} has length {int(v.shape[0])}, "
                    f"ensemble has {self.members}"
                )
            out[n] = per_member
        return out

    # -- compilation -------------------------------------------------------

    def _key(self, fields: Dict[str, Any], pattern: Dict[str, bool]):
        """Cache key from metadata only — the hot path must not slice
        member-0 views just to look up the compiled artifact."""
        parts = []
        for name in self.prog.field_params:
            v = fields[name]
            shape = tuple(v.shape)
            origin = tuple(v.default_origin) if isinstance(v, Storage) else None
            if pattern[name]:
                shape = shape[1:]
                origin = origin[1:] if origin is not None else None
            parts.append((name, shape, str(v.dtype), origin))
        return (tuple(parts), tuple(sorted(pattern.items())))

    def compiled(self, fields: Dict[str, Any], scalars: Dict[str, Any]) -> "_CompiledEnsemble":
        pattern = self._batch_pattern(fields)
        key = self._key(fields, pattern)
        ce = self._cache.get(key)
        if ce is None:
            samples = {n: member_sample(v) for n, v in fields.items()}
            cp = self.prog.compiled(samples, scalars)
            ce = _CompiledEnsemble(self, cp, pattern)
            self._cache[key] = ce
        return ce

    # -- execution ---------------------------------------------------------

    @staticmethod
    def _raw(value):
        return value.data if isinstance(value, Storage) else value

    def __call__(self, *args, exec_info: Optional[dict] = None, **kwargs) -> Dict[str, Any]:
        fields, scalars = self._bind(args, kwargs)
        ce = self.compiled(fields, scalars)
        raw = {n: self._raw(v) for n, v in fields.items()}
        final = ce.execute_iterate(1, raw, dict(scalars), exec_info, report_steps=False)
        ProgramObject._writeback(fields, {b: final[b] for b in fields if b in final})
        return {o: final[o] for o in ce.cp.outputs}

    def iterate(self, n: int, *args, exec_info: Optional[dict] = None, **kwargs) -> Dict[str, Any]:
        """n fused steps of all N members: one launch per group and step."""
        fields, scalars = self._bind(args, kwargs)
        ce = self.compiled(fields, scalars)
        if ce.cp.iterable_reason is not None:
            raise ProgramError(f"ensemble {self.name!r} cannot iterate: {ce.cp.iterable_reason}")
        raw = {n_: self._raw(v) for n_, v in fields.items()}
        final = ce.execute_iterate(int(n), raw, dict(scalars), exec_info)
        ProgramObject._writeback(fields, {b: final[b] for b in fields if b in final})
        return {o: final[o] for o in ce.cp.outputs}

    # -- companions --------------------------------------------------------

    def statistics(self, dtype: str = "float64", **backend_opts: Any) -> EnsembleStatistics:
        """The fused statistics stencil sized for this ensemble."""
        return EnsembleStatistics(self.members, self.prog.backend, dtype=dtype, **backend_opts)

    def distribute(self, mesh, **kwargs):
        raise NotImplementedError(
            "distribute(): members x domain sharding (the reference's DistributedEnsemble) is not "
            "ported yet; see ROADMAP.md, Queue 1, distribution"
        )

    def __repr__(self) -> str:
        return f"Ensemble({self.prog.name!r}, members={self.members}, backend={self.prog.backend!r})"


class _CompiledEnsemble:
    """One batched specialization: (program geometry, batch pattern)."""

    def __init__(self, ensemble: Ensemble, cp: CompiledProgram, pattern: Dict[str, bool]):
        self.ensemble = ensemble
        self.cp = cp
        self.pattern = dict(pattern)
        self.members = ensemble.members
        shared = sorted(n for n, b in pattern.items() if not b)
        written = set(cp.written_buffers) | set(cp.outputs.values())
        # output names that rebind program fields receive batched values on
        # writeback, so they must be batched exactly like written buffers
        written |= {o for o in cp.outputs if o in pattern}
        bad = sorted(b for b in written if not pattern.get(b, False))
        if bad:
            raise EnsembleError(
                f"ensemble {ensemble.name!r}: program writes {bad}, but those fields are "
                "not member-batched — members would race on one shared buffer; allocate "
                "them with a leading 'N' axis (repro_torch.ensemble.batch)"
            )
        self.fingerprint = caching.program_fingerprint(
            ensemble.name,
            cp.fingerprint,
            [cp.fingerprint],
            cp.backend,
            {"members": self.members, "batched": tuple(sorted(pattern.items()))},
        )
        # the member-batched group runs of the cuda backend, by scalar pattern
        self._batched_runs: Dict[Any, List[CudaGroupRun]] = {}
        self.report = {
            "members": self.members,
            "batched_fields": sorted(n for n, b in pattern.items() if b),
            "shared_fields": shared,
            "fingerprint": self.fingerprint,
            "program_report": dict(cp.report),
        }

    def batched_runs(self, scalar_pattern: Dict[str, bool]) -> List[CudaGroupRun]:
        """One member-batched kernel a group, its per-member scalars those of
        ``scalar_pattern`` (``cuda`` only).  A group that autotunes resolves
        its block for the BATCHED operand shapes (the tune store keys on the
        full geometry), so it never reuses a block tuned for one member."""
        key = tuple(sorted(n for n, per in scalar_pattern.items() if per))
        runs = self._batched_runs.get(key)
        if runs is None:
            runs = [CudaGroupRun(obj, members=self.members,
                                 member_scalars=[n for n in key if n in obj.scalar_info],
                                 domain=g.domain, operand_shapes=self._operand_shapes(obj, g))
                    for obj, g in zip(self.cp.group_objects, self.cp.groups)]
            self._batched_runs[key] = runs
        return runs

    def _operand_shapes(self, obj, group) -> Optional[List[Tuple[str, Tuple[int, ...]]]]:
        """The group's API fields with their shapes as the batched call has
        them: a member axis in front of each batched field."""
        shapes = []
        for b in group.buffers():
            info = self.cp.graph.buffers.get(b)
            if b not in obj.field_info or info is None:
                continue
            shape = tuple(int(x) for x in info.shape)
            if self.pattern.get(b, False):
                shape = (self.members,) + shape
            shapes.append((b, shape))
        return shapes or None

    def _device(self, raw_fields: Dict[str, Any]) -> torch.device:
        devices = {v.device for v in raw_fields.values() if isinstance(v, torch.Tensor)}
        if len(devices) != 1:
            raise EnsembleError(f"ensemble {self.ensemble.name!r}: fields lie on devices {sorted(map(str, devices))}")
        return devices.pop()

    def _step_members(self, vals, scalars, per_member) -> Dict[str, Any]:
        """One step of every member, member by member through the plain
        modules over member views; returns the next batched binding."""
        plain = [obj._run for obj in self.cp.group_objects]
        for m in range(self.members):
            mf = {n: (v[m] if self.pattern.get(n, False) else v) for n, v in vals.items()}
            ms = {n: (v[m] if n in per_member else v) for n, v in scalars.items()}
            self.cp._module.run(mf, ms, plain)
        # the groups wrote in place into the batched tensors: rebind like the
        # orchestrator does (written buffers, then the output binding)
        outs = {o: vals[b] for o, b in self.cp.outputs.items()}
        return {**vals, **outs}

    def execute_iterate(
        self,
        n: int,
        raw_fields: Dict[str, Any],
        scalar_values: Dict[str, Any],
        exec_info: Optional[dict] = None,
        report_steps: bool = True,
    ) -> Dict[str, Any]:
        """``n`` steps of every member; returns the final binding of the
        batched fields and the outputs (shared fields never leave: they are
        not N-replicated)."""
        scalar_pattern = self.ensemble._scalar_pattern(scalar_values)
        per_member = {s for s, per in scalar_pattern.items() if per}
        scalars = self.cp.runtime_scalars(scalar_values)
        device = self._device(raw_fields)
        on_card = self.cp.backend == "cuda" and device.type == "cuda"
        if self.cp.backend == "cuda" and device.type not in ("cuda", "cpu"):
            raise EnsembleError(f"ensemble {self.ensemble.name!r}: backend 'cuda' runs on CUDA or CPU tensors")
        if on_card:
            # per-member scalars go to the kernel as host values (copied to
            # the card once, when a launcher is prepared)
            scalars = {k: (tuple(float(x) for x in v) if k in per_member else v) for k, v in scalars.items()}
            runs = self.batched_runs(scalar_pattern)
        if exec_info is not None:
            exec_info["ensemble_report"] = dict(self.report)
            if report_steps:
                exec_info["ensemble_report"]["iterated_steps"] = int(n)
            exec_info["run_start_time"] = time.perf_counter()
        vals = dict(raw_fields)
        with otrace.span(
            "ensemble.iterate", category="ensemble",
            ensemble=self.ensemble.name, members=self.members, steps=int(n),
        ):
            for _ in range(int(n)):
                if on_card:
                    outs, writes = self.cp._module.run(vals, scalars, runs, self.members)
                    vals = {**vals, **writes, **outs}
                else:
                    vals = self._step_members(vals, scalars, per_member)
        if exec_info is not None:
            if on_card:
                torch.cuda.synchronize(device)
            exec_info["run_end_time"] = time.perf_counter()
        keep = {b for b, batched in self.pattern.items() if batched} | set(self.cp.outputs)
        return {b: vals[b] for b in keep}
