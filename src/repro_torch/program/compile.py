"""Program compiler: dataflow graph → one fused step of generated kernels.

The compilation pipeline (every stage reuses the single-stencil toolchain —
the merged groups go through ``analysis.analyze`` + the ``passes.py``
pipeline + the normal backends, so cross-stencil fusion, CSE and temporary
demotion all fire on the *merged* IR for free):

1. dead-store elimination + grouping (``program.passes``);
2. each group's stencil definitions are **spliced** into one merged
   ``StencilDefinition``: field params rename to program buffer names,
   per-stencil temporaries get a ``_p<node>_`` prefix, scalars rename to
   program scalar names (or ``_c<node>_<param>`` runtime-bound constants),
   and program-internal buffers demote to stencil temporaries
   (``is_api=False``) — the *eliminated temporaries*;
3. an orchestration module is generated (real, inspectable Python source,
   cached by ``core.caching`` under the program fingerprint) that threads
   the buffer dict through the group ``run`` functions and applies the
   output binding — double-buffer rotation is a dict re-wiring, not a copy.

Every backend of the port runs the group stencils in place on the caller's
fields.  On ``cuda`` a group is one generated Hopper kernel
(``core.codegen_cuda``): on CUDA tensors its run launches that kernel through
launchers prepared once per tensor binding (a rotation has two); on CPU
tensors it runs the group's plain ``torch`` module.  ``cuda`` splits a group
where a write meets a later halo read of the same field, as the reference
does for ``pallas`` (the kernel has the same limit).  ``iterate(n)`` is a
host loop over the same launches; the reference's ``jax.jit`` has no
counterpart here, PyTorch runs eagerly.

Fusing never changes values: spliced statements keep their order, crossing
buffers that any later node reads off-center stay API fields of the merged
stencil (so their stale-halo semantics — reads of points no stencil wrote —
are byte-for-byte those of the eager call sequence).

``distribute(mesh)`` runs the program on a device mesh
(``DistributedProgram``): every rank runs the same per-rank step on its own
block, the fused groups with the minimal halo exchanges of ``program.halo``
between them (``parallel.halo``).

(The reference package's ``repro/program/compile.py``.)
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import caching, codegen_cuda, ir
from repro_torch.core import stencil as stencil_mod
from repro_torch.core.storage import TORCH_BACKENDS, Storage, card_tensor
from repro_torch.launch.mesh import axis_size
from repro_torch.obs import trace as otrace
from repro_torch.parallel import halo as halo_exchange
from repro_torch.parallel.halo import HaloExchange

from . import halo as halo_planning
from .graph import ProgramGraph
from .passes import (
    Group,
    check_not_empty,
    eliminate_dead_stores,
    plan_groups,
    rotation_plan,
    validate_iterable,
)
from .trace import ProgramError, Trace, tracing


class ProgramCompileError(ProgramError):
    """The traced graph cannot be compiled as requested."""


# ---------------------------------------------------------------------------
# Definition splicing
# ---------------------------------------------------------------------------


def _map_stmt_scalars(stmt: ir.Stmt, smap: Dict[str, str]) -> ir.Stmt:
    def fn(e: ir.Expr) -> ir.Expr:
        if isinstance(e, ir.ScalarRef) and e.name in smap:
            return ir.ScalarRef(smap[e.name])
        return e

    return ir.map_stmt_exprs(stmt, fn)


def splice_group_definition(
    name: str,
    graph: ProgramGraph,
    group: Group,
    node_index: Dict[int, int],
    internals: set,
) -> Tuple[ir.StencilDefinition, Dict[str, Any]]:
    """Merge the group's stencil definitions into one; returns the merged
    definition and the runtime values of its ``_c*`` constant scalars."""
    field_decls: Dict[str, ir.FieldDecl] = {}
    temp_decls: List[ir.FieldDecl] = []
    scalar_decls: Dict[str, ir.ScalarDecl] = {}
    const_values: Dict[str, Any] = {}
    computations: List[ir.ComputationBlock] = []
    externals: List[Tuple[str, Any]] = []

    for node in group.nodes:
        idx = node_index[id(node)]
        defn = node.stencil.definition_ir
        fmap: Dict[str, str] = {}
        for decl in defn.api_fields:
            if decl.is_api:
                buf = node.field_bind[decl.name]
                fmap[decl.name] = buf
                if buf not in field_decls:
                    field_decls[buf] = ir.FieldDecl(buf, decl.dtype, decl.axes, is_api=buf not in internals)
            else:
                new = f"_p{idx}_{decl.name}"
                fmap[decl.name] = new
                temp_decls.append(ir.FieldDecl(new, decl.dtype, decl.axes, is_api=False))
        smap: Dict[str, str] = {}
        for sdecl in defn.scalars:
            kind, ref = node.scalar_bind[sdecl.name]
            if kind == "scalar":
                smap[sdecl.name] = ref
                prev = scalar_decls.get(ref)
                if prev is not None and prev.dtype != sdecl.dtype:
                    raise ProgramCompileError(
                        f"program scalar {ref!r} bound with conflicting dtypes "
                        f"{prev.dtype} / {sdecl.dtype}"
                    )
                scalar_decls[ref] = ir.ScalarDecl(ref, sdecl.dtype)
            else:
                cname = f"_c{idx}_{sdecl.name}"
                smap[sdecl.name] = cname
                scalar_decls[cname] = ir.ScalarDecl(cname, sdecl.dtype)
                const_values[cname] = ref
        for block in defn.computations:
            intervals = tuple(
                ir.IntervalBlock(
                    ib.interval,
                    tuple(_map_stmt_scalars(ir.rename_fields(s, fmap), smap) for s in ib.body),
                )
                for ib in block.intervals
            )
            computations.append(ir.ComputationBlock(block.order, intervals))
        externals.extend((f"_n{idx}_{k}", v) for k, v in defn.externals)

    merged = ir.StencilDefinition(
        name=name,
        api_fields=tuple(field_decls.values()) + tuple(temp_decls),
        scalars=tuple(scalar_decls.values()),
        computations=tuple(computations),
        externals=tuple(externals),
        docstring=f"spliced from {[n.stencil.name for n in group.nodes]}",
    )
    return merged, const_values


# ---------------------------------------------------------------------------
# Orchestrator source generation
# ---------------------------------------------------------------------------


def _generate_orchestrator(
    name: str,
    backend: str,
    group_domains: List[Tuple[int, int, int]],
    group_fields: List[List[str]],
    group_origins: List[Dict[str, Tuple[int, int, int]]],
    alloc_internal: Dict[str, Tuple[Tuple[int, ...], str, Tuple[str, ...]]],  # name -> (shape, dtype, axes)
    outputs: Dict[str, str],  # output name -> buffer to return
    written_buffers: List[str],  # written program buffers (not temporaries)
) -> str:
    """Every backend runs its groups in place.  On torch/cuda ``members``
    prepends a member axis to the cross-group temporaries (an ensemble's
    batched step); they go on the fields' device, in the card layout on cuda."""
    on_torch = backend in TORCH_BACKENDS
    lines: List[str] = [
        f'"""Auto-generated by repro_torch.program — program {name!r}, backend {backend!r}."""',
    ]
    if on_torch:
        lines += ["import torch", "", "from repro_torch.core.storage import card_tensor", ""]
        lines.append("def run(fields, scalars, group_runs, members=None):")
        lines.append("    vals = dict(fields)")
        if alloc_internal:
            lines.append("    device = next(v.device for v in fields.values() if isinstance(v, torch.Tensor))")
            lines.append("    lead = () if members is None else (members,)")
    else:
        lines += ["import numpy as np", ""]
        lines.append("def run(fields, scalars, group_runs):")
        lines.append("    vals = dict(fields)")
    for b, (shape, dtype, axes) in sorted(alloc_internal.items()):
        if not on_torch:
            alloc = f"np.zeros({tuple(shape)!r}, dtype={dtype!r})"
        elif backend == "cuda" and tuple(axes) == ("I", "J", "K"):
            alloc = f"card_tensor(lead + {tuple(shape)!r}, torch.{dtype}, device, 'zeros')"
        else:
            alloc = f"torch.zeros(lead + {tuple(shape)!r}, dtype=torch.{dtype}, device=device)"
        lines.append(f"    vals[{b!r}] = {alloc}  # cross-group program temporary")
    for gi, fields in enumerate(group_fields):
        origins = {b: tuple(group_origins[gi][b]) for b in fields}
        dom = tuple(group_domains[gi])
        lines.append(f"    group_runs[{gi}](vals, scalars, {dom!r}, {origins!r})")
    ret = ", ".join(f"{o!r}: vals[{b!r}]" for o, b in outputs.items())
    # written (non-temporary) buffers come back alongside the output binding
    # so every backend persists them into the caller's storages — matching
    # the eager per-stencil path, where each call writes its fields back
    wrt = ", ".join(f"{b!r}: vals[{b!r}]" for b in written_buffers)
    lines.append(f"    return {{{ret}}}, {{{wrt}}}")
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Group runs
# ---------------------------------------------------------------------------


def _group_device(obj: stencil_mod.StencilObject, fields: Dict[str, Any]) -> torch.device:
    for n in obj.field_info:
        v = fields.get(n)
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"{obj.name}: backend {obj.backend!r} runs on torch tensors")


class CudaGroupRun:
    """One ``cuda`` group: on CUDA tensors its generated kernel, launched
    through launchers prepared once per tensor binding; on CPU tensors its
    plain ``torch`` module.  It never falls back from one to the other.
    ``members`` selects the group's member-batched kernel (one launch for
    every member of an ensemble), with ``member_scalars`` read per member.

    A group built with ``autotune=True`` resolves its block for ``domain``
    and ``operand_shapes`` (the member-batched shapes of an ensemble) at its
    first launch on the card, as the reference resolves a Pallas group's
    tile when it binds it; ``autotune`` then holds the tuner's record."""

    def __init__(self, obj: stencil_mod.StencilObject, members: Optional[int] = None, member_scalars=(),
                 domain=None, operand_shapes=None):
        self.obj = obj
        self.members = members
        self.member_scalars = None if members is None else tuple(member_scalars)
        self.domain = None if domain is None else tuple(domain)
        self.operand_shapes = operand_shapes
        self.autotune: Optional[dict] = None
        self.launches: Optional[codegen_cuda.PreparedLaunches] = None
        if not obj.tunes:  # no search can change the kernel: bind it now
            self.resolve()

    def resolve(self) -> codegen_cuda.PreparedLaunches:
        """Bind the kernel of the group's block (tuned on the card when the
        group autotunes, at most once per geometry and fingerprint)."""
        if self.launches is None:
            block = None
            if self.obj.tunes:
                block, self.autotune = self.obj._resolve_block(self.domain, self.operand_shapes,
                                                               self.member_scalars)
            kernel = self.obj.block_kernel(block, self.member_scalars)
            self.launches = codegen_cuda.PreparedLaunches(kernel, members=self.members)
        return self.launches

    @property
    def kernel(self) -> codegen_cuda.CudaKernel:
        return self.resolve().kernel

    def __call__(self, fields, scalars, domain, origins) -> None:
        device = _group_device(self.obj, fields)
        if device.type == "cuda":
            self.resolve()(fields, scalars, domain, origins)
        elif device.type == "cpu" and self.members is None:
            self.obj._run(fields, scalars, domain, origins)
        else:
            raise ValueError(f"{self.obj.name}: a cuda group runs on CUDA tensors, or on CPU tensors "
                             f"one member at a time; not on {device}"
                             + ("" if self.members is None else " with a member axis"))


# ---------------------------------------------------------------------------
# Shared planning
# ---------------------------------------------------------------------------


class ProgramPlan:
    """The shared front half of program compilation: dead-store elimination,
    grouping, buffer internalization, and the spliced+built group stencils.
    The single-rank and the distributed compilers consume this one object,
    so their planning cannot drift; they differ in what they execute (a
    generated orchestrator, or a per-rank step with halo exchanges)."""

    def __init__(
        self,
        name: str,
        graph: ProgramGraph,
        backend: str,
        backend_opts,
        validate_args: bool,
        *,
        distributed: bool,
    ):
        nodes, dropped = eliminate_dead_stores(graph)
        check_not_empty(nodes)
        graph.nodes = nodes  # classification and grouping see live nodes only
        self.nodes = nodes
        self.dropped = dropped
        self.stencil_nodes = graph.stencil_nodes()
        self.node_index = {id(n): i for i, n in enumerate(self.stencil_nodes)}
        self.groups, self.markers = plan_groups(
            graph,
            nodes,
            distributed=distributed,
            split_halo_crossing=distributed or backend == "cuda",
        )
        _inputs, _out_buffers, internals = graph.classify()
        if not distributed:
            # internalizing a buffer is only value-preserving when every
            # access agrees on geometry (same compute domain, same buffer
            # origin): the eager path addresses one shared allocation, and
            # positional agreement is what lets a bare domain-sized temporary
            # replace it.  On a mesh geometry is planner-controlled (uniform
            # local domain, per-field padding), so the filter does not apply.
            geo: Dict[str, set] = {}
            for n in self.stencil_nodes:
                for b in set(n.field_bind.values()):
                    geo.setdefault(b, set()).add((n.domain, n.origins[b]))
            internals = [b for b in internals if len(geo.get(b, set())) <= 1]
        # a buffer only becomes a stencil temporary when one group owns every
        # access; internals crossing groups are materialized by the runtime
        # instead (they still never escape the program)
        touching: Dict[str, set] = {}
        for gi, g in enumerate(self.groups):
            for b in g.buffers():
                touching.setdefault(b, set()).add(gi)
        self.temp_internals = sorted(b for b in internals if len(touching.get(b, ())) <= 1)
        self.alloc_internals = sorted(b for b in internals if len(touching.get(b, ())) > 1)
        self.outputs = {o: b for o, (b, _v) in graph.outputs.items()}
        self.const_scalars: Dict[str, Any] = {}
        self.group_objects: List[stencil_mod.StencilObject] = []
        temp_set = set(self.temp_internals)
        for gi, g in enumerate(self.groups):
            merged, consts = splice_group_definition(f"{name}_g{gi}", graph, g, self.node_index, temp_set)
            self.const_scalars.update(consts)
            obj = stencil_mod.build_from_definition(
                merged, backend, validate_args=validate_args, backend_opts=dict(backend_opts or {})
            )
            self.group_objects.append(obj)

    def base_report(self) -> Dict[str, Any]:
        return {
            "nodes": len(self.stencil_nodes),
            "groups": len(self.groups),
            "fused_stencils": len(self.stencil_nodes) - len(self.groups),
            "group_stencils": [[n.stencil.name for n in g.nodes] for g in self.groups],
            "dead_stores_eliminated": self.dropped,
            "eliminated_temporaries": self.temp_internals + self.alloc_internals,
        }


# ---------------------------------------------------------------------------
# Compiled program (single device)
# ---------------------------------------------------------------------------


class CompiledProgram:
    """One traced+compiled specialization of a program (per shapes/origins)."""

    def __init__(self, name: str, graph: ProgramGraph, backend: str, backend_opts, validate_args: bool):
        self.name = name
        self.graph = graph
        self.backend = backend
        t0 = time.perf_counter()
        plan = ProgramPlan(name, graph, backend, backend_opts, validate_args, distributed=False)
        self.nodes = plan.nodes
        self._node_index = plan.node_index
        groups = plan.groups
        self.temp_internals = plan.temp_internals
        self.alloc_internals = plan.alloc_internals
        self.rotation = rotation_plan(graph, plan.nodes)
        self.iterable_reason = validate_iterable(graph)

        self.domain = groups[0].domain
        self.groups = groups
        self.const_scalars = plan.const_scalars
        self.group_objects = plan.group_objects
        self.outputs = plan.outputs
        temp_set = set(self.temp_internals)
        group_fields = [
            [b for b in g.buffers() if b not in temp_set] for g in groups
        ]
        alloc_set = set(self.alloc_internals)
        group_origins = []
        for gi, g in enumerate(groups):
            org = {b: o for b, o in g.origins().items() if b not in temp_set}
            for b in group_fields[gi]:
                org.setdefault(b, (0, 0, 0))
            # orchestrator-allocated temporaries are bare domain-sized arrays
            for b in alloc_set:
                if b in org:
                    org[b] = (0, 0, 0)
            group_origins.append(org)
        alloc = {}
        for b in self.alloc_internals:
            bi = graph.buffers[b]
            dom = next(g.domain for g in groups if b in g.buffers())
            alloc[b] = (_domain_shape(dom, bi.axes), bi.dtype, bi.axes)
        self.written_buffers = [
            b
            for g in groups
            for n in g.nodes
            for b in graph.node_writes(n)
            if b not in temp_set and b not in alloc_set
        ]
        self.written_buffers = list(dict.fromkeys(self.written_buffers))
        source = _generate_orchestrator(
            name,
            backend,
            [g.domain for g in groups],
            group_fields,
            group_origins,
            alloc,
            self.outputs,
            self.written_buffers,
        )
        self.fingerprint = caching.program_fingerprint(
            name,
            graph.structural_repr(),
            [o.fingerprint for o in self.group_objects],
            backend,
            dict(backend_opts or {}),
        )
        self.generated_source = source
        self._module = caching.load_generated_module(f"{name}_prog", self.fingerprint, source)
        self._group_runs = [
            CudaGroupRun(o, domain=g.domain) if backend == "cuda" else o._run
            for o, g in zip(self.group_objects, groups)
        ]
        self.report = {
            **plan.base_report(),
            "backend": backend,
            "fingerprint": self.fingerprint,
            "group_multi_stages": [
                len(o.implementation_ir.multi_stages) for o in self.group_objects
            ],
            "rotation": dict(self.rotation),
            "elided_exchanges": len(plan.markers),
            "compile_seconds": 0.0,
        }
        if backend == "cuda":  # each group kernel's k-walks (codegen_cuda's SCHEDULE)
            self.report["group_k_walks"] = [o.kernel.module.SCHEDULE["k_walks"] for o in self.group_objects]
        self.report["compile_seconds"] = time.perf_counter() - t0
        otrace.current_tracer().add_span(
            "program.compile",
            t0,
            time.perf_counter(),
            category="compile",
            program=name,
            backend=backend,
            groups=len(groups),
            fused_stencils=self.report["fused_stencils"],
            fingerprint=self.fingerprint,
        )

    # -- execution ---------------------------------------------------------

    @property
    def group_kernels(self) -> List[codegen_cuda.CudaKernel]:
        """The one-member kernel each group launches (``cuda`` only): the
        kernel of its tuned block when the program autotunes."""
        return [r.kernel for r in self._group_runs]

    def runtime_scalars(self, scalar_values: Dict[str, Any]) -> Dict[str, Any]:
        merged = dict(self.const_scalars)
        merged.update(scalar_values)
        return merged

    def step(self, vals: Dict[str, Any], scalars: Dict[str, Any]) -> Dict[str, Any]:
        """One step on ``vals`` (runtime scalars already merged): the next
        step's buffer binding — written buffers updated, then the output
        binding rebinds (the rotation wins over the write)."""
        outs, writes = self._module.run(vals, scalars, self._group_runs)
        return {**vals, **writes, **outs}

    def execute(
        self,
        raw_fields: Dict[str, Any],
        scalar_values: Dict[str, Any],
        exec_info: Optional[dict] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Returns (output binding, written program buffers) — the latter so
        the caller can persist every written field's storage, matching the
        eager per-stencil path on all backends."""
        scalars = self.runtime_scalars(scalar_values)
        if exec_info is not None:
            exec_info["program_report"] = dict(self.report)
            exec_info["run_start_time"] = time.perf_counter()
            out = self._execute_profiled(raw_fields, scalars, exec_info)
            exec_info["run_end_time"] = time.perf_counter()
            return out
        return self._module.run(raw_fields, scalars, self._group_runs)

    def _execute_profiled(self, raw_fields, scalars, exec_info) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Same generated orchestrator, with each group run in a
        ``program.group`` device span of a probe armed for the call: on the
        card ``seconds`` is device time between CUDA events, read with one
        synchronisation after the run, else the host clock."""
        order: List[int] = []

        def timed(gi: int, fn: Callable) -> Callable:
            def _run(fields, scalars, domain, origins):
                order.append(gi)
                with otrace.device_span("program.group"):
                    fn(fields, scalars, domain, origins)

            return _run

        device = next((v.device for v in raw_fields.values() if isinstance(v, torch.Tensor)), "cpu")
        runs = [timed(gi, fn) for gi, fn in enumerate(self._group_runs)]
        with otrace.probing(device) as probe:
            out = self._module.run(raw_fields, scalars, runs)
        r = probe.result()
        stencils = self.report["group_stencils"]
        exec_info["program_report"]["node_timings"] = [
            {"group": gi, "stencils": stencils[gi], "seconds": seconds, "clock": r["clock"]}
            for gi, seconds in zip(order, r["durations"].get("program.group", []))
        ]
        return out


def _domain_shape(domain: Tuple[int, int, int], axes: Tuple[str, ...]) -> Tuple[int, ...]:
    m = dict(zip(("I", "J", "K"), domain))
    return tuple(m[a] for a in axes)


# ---------------------------------------------------------------------------
# The user-facing @program object
# ---------------------------------------------------------------------------


class ProgramObject:
    """A traced, compiled multi-stencil step function.

    Calling mirrors the stencil convention: fields positional-or-keyword,
    scalars keyword-only.  The first call per argument geometry traces the
    step function and compiles the fused program; later calls run the cached
    groups directly.  Outputs follow the step function's return binding;
    ``Storage`` arguments named by an output are rebound in place, so a
    time loop is just ``for _ in range(nt): prog(phi, ...)``.
    """

    def __init__(
        self,
        definition: Callable,
        backend: str = "cuda",
        *,
        name: Optional[str] = None,
        validate_args: bool = True,
        **backend_opts: Any,
    ):
        import inspect

        self.definition = definition
        self.backend = backend
        self.name = name or definition.__name__
        self.validate_args = validate_args
        self.backend_opts = dict(backend_opts)
        self._cache: Dict[Any, CompiledProgram] = {}
        self.field_params: List[str] = []
        self.scalar_params: List[str] = []
        for p in inspect.signature(definition).parameters.values():
            if p.kind == p.POSITIONAL_OR_KEYWORD:
                self.field_params.append(p.name)
            elif p.kind == p.KEYWORD_ONLY:
                self.scalar_params.append(p.name)
            else:
                raise ProgramError(
                    f"program {self.name!r}: unsupported parameter kind for {p.name!r} "
                    "(fields are positional-or-keyword, scalars keyword-only)"
                )

    # -- binding -----------------------------------------------------------

    def _bind(self, args, kwargs) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        fields: Dict[str, Any] = {}
        if len(args) > len(self.field_params):
            raise TypeError(f"{self.name}() takes {len(self.field_params)} field arguments, got {len(args)}")
        for pname, val in zip(self.field_params, args):
            fields[pname] = val
        scalars: Dict[str, Any] = {}
        for key, val in kwargs.items():
            if key in self.field_params:
                if key in fields:
                    raise TypeError(f"{self.name}() got duplicate field argument {key!r}")
                fields[key] = val
            elif key in self.scalar_params:
                scalars[key] = val
            else:
                raise TypeError(f"{self.name}() got unexpected argument {key!r}")
        missing = [p for p in self.field_params if p not in fields]
        if missing:
            raise TypeError(f"{self.name}() missing field arguments: {missing}")
        missing_s = [p for p in self.scalar_params if p not in scalars]
        if missing_s:
            raise TypeError(f"{self.name}() missing scalar arguments: {missing_s}")
        return fields, scalars

    @staticmethod
    def _raw(value):
        return value.data if isinstance(value, Storage) else value

    def _key(self, fields: Dict[str, Any]):
        parts = []
        for name in self.field_params:  # canonical order: kwargs order must not re-key
            v = fields[name]
            origin = tuple(v.default_origin) if isinstance(v, Storage) else None
            parts.append((name, tuple(v.shape), str(v.dtype), origin))
        return tuple(parts)

    # -- tracing / compiling ------------------------------------------------

    def trace(self, fields: Dict[str, Any], scalars: Dict[str, Any]) -> Trace:
        with otrace.span("program.trace", category="compile", program=self.name) as tsp:
            t = Trace(self.name)
            handles = [t.add_field(n, fields[n]) for n in self.field_params]
            scalar_handles = {n: t.add_scalar(n, scalars[n]) for n in self.scalar_params}
            with tracing(t):
                result = self.definition(*handles, **scalar_handles)
            t.finish(result)
            tsp.set("nodes", len(t.nodes))
        return t

    def compiled(self, fields: Dict[str, Any], scalars: Dict[str, Any]) -> CompiledProgram:
        key = self._key(fields)
        cp = self._cache.get(key)
        if cp is None:
            graph = ProgramGraph(self.trace(fields, scalars))
            cp = CompiledProgram(self.name, graph, self.backend, self.backend_opts, self.validate_args)
            self._validate_fields(cp, fields)
            self._cache[key] = cp
        return cp

    def _validate_fields(self, cp: CompiledProgram, fields: Dict[str, Any]) -> None:
        if not self.validate_args:
            return
        for obj, group in zip(cp.group_objects, cp.groups):
            sub = {n: fields[n] for n in obj.field_info if n in fields}
            origins = obj._resolve_origins(sub, None)
            obj._validate(sub, {}, group.domain, origins)

    # -- execution ----------------------------------------------------------

    def __call__(self, *args, exec_info: Optional[dict] = None, **kwargs):
        fields, scalars = self._bind(args, kwargs)
        cp = self.compiled(fields, scalars)
        raw = {n: self._raw(v) for n, v in fields.items()}
        with otrace.span(
            "program.run", category="program", program=self.name, backend=self.backend
        ):
            outs, writes = cp.execute(raw, dict(scalars), exec_info)
        # every written program buffer persists into its storage (eager
        # parity on all backends), then the output binding rebinds — so a
        # rotation like {"phi": phi_new} wins over phi_new's own write
        self._writeback(fields, writes)
        self._writeback(fields, outs)
        return outs

    @staticmethod
    def _writeback(fields, updates) -> None:
        for name, arr in updates.items():
            store = fields.get(name)
            if isinstance(store, Storage) and store.data is not arr:
                store.data = arr

    def iterate(self, n: int, *args, exec_info: Optional[dict] = None, **kwargs):
        """Run ``n`` fused steps: a host loop over the groups' launches.

        Requires the torch/cuda backends and a *rotation-closed* output
        binding: every output name rebinds a program field of identical
        geometry, so the step composes with itself.
        """
        if self.backend not in TORCH_BACKENDS:
            raise ProgramError(f"iterate() requires the torch/cuda backends, not {self.backend!r}")
        fields, scalars = self._bind(args, kwargs)
        cp = self.compiled(fields, scalars)
        if cp.iterable_reason is not None:
            raise ProgramError(f"program {self.name!r} cannot iterate: {cp.iterable_reason}")
        vals = {name: self._raw(v) for name, v in fields.items()}
        values = cp.runtime_scalars(dict(scalars))
        with otrace.span(
            "program.iterate", category="program", program=self.name,
            backend=self.backend, steps=int(n),
        ):
            for _ in range(int(n)):
                vals = cp.step(vals, values)
        if exec_info is not None:
            exec_info["program_report"] = dict(cp.report)
            exec_info["program_report"]["iterated_steps"] = n
        self._writeback(fields, {b: vals[b] for b in fields if b in vals})
        return {o: vals[o] for o in cp.outputs}

    def distribute(self, mesh, **kwargs) -> "DistributedProgram":
        """This program on ``mesh``, one process per rank: see :class:`DistributedProgram`."""
        return DistributedProgram(self, mesh, **kwargs)

    def ensemble(self, members: int, **kwargs):
        """An :class:`repro_torch.ensemble.Ensemble` of this program:
        ``members`` perturbed copies advanced by one launch per group."""
        from repro_torch.ensemble import Ensemble

        return Ensemble(self, members, **kwargs)

    def __repr__(self) -> str:
        return f"ProgramObject({self.name!r}, backend={self.backend!r})"


def program(
    backend: str = "cuda",
    definition: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    validate_args: bool = True,
    **backend_opts: Any,
):
    """Decorator: trace a multi-stencil step function into a fused program.

    Mirrors ``gtscript.stencil``'s surface (and its default backend,
    ``cuda``)::

        @program(backend="cuda")
        def step(phi, u, v, adv, phi_new, *, dt, dx, dy):
            advect(phi, u, v, adv, dx=dx, dy=dy)
            euler(phi, adv, phi_new, dt=dt)
            return {"phi": phi_new, "phi_new": phi}

    ``backend_opts`` pass through to the merged stencils' build (the whole
    pass pipeline / codegen option surface of ``build_from_definition``).
    """

    def _impl(func: Callable) -> ProgramObject:
        return ProgramObject(func, backend, name=name, validate_args=validate_args, **backend_opts)

    if definition is not None:
        return _impl(definition)
    return _impl


# ---------------------------------------------------------------------------
# Distributed programs (one process per rank, planned halo exchanges)
# ---------------------------------------------------------------------------


class DistributedStepPlan:
    """A distributed program planned for one local geometry: the groups
    (built once), the minimal halo-exchange plan (``program.halo``) and what
    each group reads and writes; shared by ``DistributedProgram`` (calls and
    ``iterate``) and the ensemble layer's member-batched step."""

    def __init__(self, prog: "ProgramObject", fields: Dict[str, Any], scalars: Dict[str, Any],
                 local_domain: Tuple[int, int, int], mesh_shape: Dict[str, int]):
        graph = ProgramGraph(prog.trace(fields, scalars))
        # geometry is planner-controlled: per-rank validation is meaningless
        pplan = ProgramPlan(f"{prog.name}_dist", graph, prog.backend, prog.backend_opts, False, distributed=True)
        temp = set(pplan.temp_internals)
        self.backend = prog.backend
        self.buffers = graph.buffers
        self.local_domain = tuple(int(d) for d in local_domain)
        self.group_objects = pplan.group_objects
        self.halo = halo_planning.plan_halo_exchanges(graph, pplan.groups, pplan.markers)
        self.depth = max((op.halo for op in self.halo.exchanges), default=0)  # of every padded buffer
        self.const_scalars = dict(pplan.const_scalars)
        self.outputs = dict(pplan.outputs)
        self.alloc_internals = list(pplan.alloc_internals)
        self.group_buffers = [[b for b in g.buffers() if b not in temp] for g in pplan.groups]
        self.group_writes = [{b for n in g.nodes for b in graph.node_writes(n)} - temp for g in pplan.groups]
        self.iterable_reason = validate_iterable(graph)
        self.report = {**pplan.base_report(), "backend": prog.backend, "mesh": dict(mesh_shape),
                       "halo_plan": self.halo.summary()}


class _Padded:
    """A padded buffer of a rank step: zeros at allocation, its interior a
    fixed view.  ``source`` is the tensor the interior was last copied from
    while both still agree (None once a group writes either)."""

    def __init__(self, padded: torch.Tensor, depth: int, lead: int):
        self.padded, self.depth, self.lead = padded, depth, lead
        self.view = halo_exchange.interior(padded, depth, lead)
        self.origin = (depth, depth, 0)
        self.source: Optional[torch.Tensor] = None

    def fits(self, x: torch.Tensor, lead: int) -> bool:
        v = self.view
        return lead == self.lead and v.shape == x.shape and v.dtype == x.dtype and v.device == x.device


class _RankStep:
    """One rank's step of a ``DistributedStepPlan`` on one device.

    The step runs the plan's exchanges and groups in place.  A buffer the
    plan exchanges is copied once into a padded buffer of this step (depth
    ``plan.depth``, in the backend's storage layout) and the name is rebound
    to the padded buffer's interior; groups read and write it there, so from
    then on an exchange only fills rims: in an ``iterate`` the padded
    buffers rotate with the names and no interior is copied.  Padded buffers
    are allocated once and reused by whichever name needs one while no other
    name holds it.  ``release`` binds every name back to a caller's tensor.

    ``members`` (an ensemble's local members) puts a member axis in front of
    the ``batched`` buffers: one exchange and, on the card, one launch a group
    cover every member; the plain modules run member by member.
    """

    def __init__(self, plan: DistributedStepPlan, exchange, device: torch.device,
                 members: Optional[int] = None, batched: Optional[Dict[str, bool]] = None):
        self.plan, self.exchange = plan, exchange
        self.members = members
        self.batched = dict(batched or {})
        if members is not None:
            self.batched.update({b: True for b in plan.alloc_internals})
        self.card_layout = plan.backend == "cuda"
        if plan.backend == "cuda" and device.type == "cuda":
            self.runs = [CudaGroupRun(obj, members=members, member_scalars=(), domain=plan.local_domain)
                         for obj in plan.group_objects]
        elif members is None:
            self.runs = [obj._run for obj in plan.group_objects]
        else:
            self.runs = [self._member_by_member(obj) for obj in plan.group_objects]
        self._pool: List[_Padded] = []
        self._by_view: Dict[int, _Padded] = {}
        self._alloc: Dict[str, torch.Tensor] = {}
        self.device = device

    def _member_by_member(self, obj) -> Callable:
        def run(fields, scalars, domain, origins):
            for m in range(self.members):
                obj._run({b: (v[m] if self.batched.get(b) else v) for b, v in fields.items()},
                         scalars, domain, origins)

        return run

    def _entry(self, x) -> Optional[_Padded]:
        e = self._by_view.get(id(x))
        return e if e is not None and e.view is x else None

    def _padded(self, vals: Dict[str, Any], b: str) -> _Padded:
        """The padded buffer that holds ``b``: the one it is bound to, else a
        free one with the interior copied in."""
        x = vals[b]
        e = self._entry(x)
        if e is not None:
            return e
        lead = 1 if self.batched.get(b) else 0
        live = {id(v) for v in vals.values()}
        e = next((p for p in self._pool if id(p.view) not in live and p.fits(x, lead)), None)
        if e is None:
            e = _Padded(halo_exchange.padded_like(x, self.plan.depth, lead, card=self.card_layout),
                        self.plan.depth, lead)
            self._pool.append(e)
            self._by_view[id(e.view)] = e
        with otrace.device_span("rank_step.pad"):
            e.view.copy_(x)
        e.source = x
        vals[b] = e.view
        return e

    def _internal(self, b: str) -> torch.Tensor:
        """A cross-group temporary, zeroed every step (the reference's fresh zeros)."""
        t = self._alloc.get(b)
        if t is None:
            info = self.plan.buffers[b]
            shape = (() if self.members is None else (self.members,)) + _domain_shape(self.plan.local_domain,
                                                                                      info.axes)
            dtype = getattr(torch, info.dtype)
            if self.card_layout and info.axes == ("I", "J", "K"):
                t = card_tensor(shape, dtype, self.device, "zeros")
            else:
                t = torch.zeros(shape, dtype=dtype, device=self.device)
            self._alloc[b] = t
        else:
            t.zero_()
        return t

    def step(self, vals: Dict[str, Any], scalars: Dict[str, Any], _unused: Any = None) -> None:
        """One step on ``vals`` (name → tensor), in place: exchanged names
        end up bound to padded buffers' interiors.  A third argument is
        taken and ignored."""
        plan = self.plan
        for b in plan.alloc_internals:
            vals[b] = self._internal(b)
        for gi, run in enumerate(self.runs):
            for op in plan.halo.before_group(gi):
                e = self._padded(vals, op.buffer)
                self.exchange.fill(e.padded, op.halo, e.depth, e.lead)
            fields, origins = {}, {}
            for b in plan.group_buffers[gi]:
                e = self._entry(vals[b])
                fields[b], origins[b] = (e.padded, e.origin) if e is not None else (vals[b], (0, 0, 0))
            with otrace.device_span("rank_step.group"):
                run(fields, scalars, plan.local_domain, origins)
            written = {id(vals[b]) for b in plan.group_writes[gi]}
            for e in self._pool:  # a write ends the agreement of a copy and its source
                if id(e.view) in written or (e.source is not None and id(e.source) in written):
                    e.source = None

    def release(self, vals: Dict[str, Any], fields: Dict[str, Any]) -> Dict[str, Any]:
        """``vals`` with every caller's name bound to a caller's tensor again.

        A name held by a padded buffer gets back the tensor its interior was
        copied from when the two still agree (no copy); else its own tensor,
        or, after a rotation moved tensors between names, another free one,
        into which the interior is copied."""
        names = [n for n in fields if n in vals]
        pooled = [n for n in names if self._entry(vals[n]) is not None]
        if not pooled:
            return vals
        held = {id(vals[n]) for n in names if n not in pooled}
        free = {id(fields[n]): fields[n] for n in names if id(fields[n]) not in held}
        out = dict(vals)
        rest = []
        for n in pooled:
            src = self._entry(vals[n]).source
            if src is not None and id(src) in free:
                out[n] = free.pop(id(src))
            else:
                rest.append(n)
        for n in rest:
            view = vals[n]
            t = free.pop(id(fields[n]), None)
            if t is None:
                t = free.popitem()[1] if free else torch.empty_like(fields[n])
            with otrace.device_span("rank_step.release"):
                t.copy_(view)
            out[n] = t
        return out


class DistributedProgram:
    """A traced program run on a device mesh, one process per rank.

    The horizontal plane is block-decomposed exactly as
    ``stencils.distributed.DistributedStencil`` does, but the whole step runs
    with the minimal halo-exchange schedule of ``program.halo``: a field is
    exchanged only before the first group that reads it off-center since its
    last write, at exactly the depth that group needs.

    The reference is one controller (one ``shard_map`` jit over GLOBAL
    arrays).  Here every rank of ``mesh`` calls with its own LOCAL blocks,
    ``(ni, nj, nk)`` (``parallel.halo.shard_blocks``), and runs the same
    per-rank step: the planned exchanges (``parallel.halo.HaloExchange``)
    and one run per group, which on the ``cuda`` backend and CUDA tensors is
    one launch of the group's kernel.  As the port's single-rank programs do,
    the step runs in place: the caller's tensor of each written field holds
    its new value, and the returned output binding hands back the caller's
    tensors.  ``iterate(n)`` is a host loop over the same step.
    """

    def __init__(
        self,
        prog: "ProgramObject",
        mesh,
        *,
        i_axis: str = "data",
        j_axis: str = "model",
        periodic: Tuple[bool, bool] = (False, False),
    ):
        if prog.backend not in TORCH_BACKENDS:
            raise ProgramError("DistributedProgram requires a torch/cuda-backend program")
        self.prog = prog
        self.mesh = mesh
        self.i_axis, self.j_axis = i_axis, j_axis
        self.exchange = HaloExchange(mesh, i_axis, j_axis, periodic)
        self.periodic = tuple(periodic)
        self._plans: Dict[Any, DistributedStepPlan] = {}
        self._steps: Dict[Any, _RankStep] = {}

    # -- planning ----------------------------------------------------------

    def mesh_shape(self) -> Dict[str, int]:
        return {n: axis_size(self.mesh, n) for n in self.mesh.mesh_dim_names}

    def _geometry(self, fields: Dict[str, Any]):
        """(local domain, cache key) of this rank's interior-only blocks."""
        from repro_torch.stencils.distributed import local_domain

        for n, v in fields.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"distributed program {self.prog.name!r}: field {n!r} must be this rank's "
                                f"local block as a tensor, got {type(v).__name__}")
        local = local_domain(fields)
        key = (tuple(sorted((n, tuple(v.shape), str(v.dtype)) for n, v in fields.items())), local)
        return local, key

    def _plan_for(self, fields, scalars, local, key) -> DistributedStepPlan:
        if key not in self._plans:
            self._plans[key] = DistributedStepPlan(self.prog, fields, scalars, local, self.mesh_shape())
        return self._plans[key]

    def _step_for(self, plan: DistributedStepPlan, key, device, members=None, batched=None) -> _RankStep:
        skey = (key, str(device), members, tuple(sorted((batched or {}).items())))
        step = self._steps.get(skey)
        if step is None:
            step = self._steps[skey] = _RankStep(plan, self.exchange, device, members, batched)
        return step

    def plan(self, fields: Dict[str, Any], scalars: Optional[Dict[str, Any]] = None) -> DistributedStepPlan:
        """The step planned for these local blocks (once per geometry): its
        groups' stencil objects count their launches."""
        local, key = self._geometry(fields)
        return self._plan_for(fields, dict(scalars or {}), local, key)

    def _prepare(self, fields, scalars):
        local, key = self._geometry(fields)
        plan = self._plan_for(fields, scalars, local, key)
        device = next(iter(fields.values())).device
        return plan, self._step_for(plan, key, device)

    # -- execution ---------------------------------------------------------

    def __call__(
        self,
        fields: Dict[str, Any],
        scalars: Optional[Dict[str, Any]] = None,
        *,
        exec_info: Optional[dict] = None,
    ) -> Dict[str, Any]:
        """``fields``: this rank's LOCAL (interior-only) blocks keyed by
        program field name.  Returns the output binding, local blocks."""
        return self._run(1, fields, scalars, exec_info, iterate=False)

    def iterate(
        self,
        n: int,
        fields: Dict[str, Any],
        scalars: Optional[Dict[str, Any]] = None,
        *,
        exec_info: Optional[dict] = None,
    ) -> Dict[str, Any]:
        """``n`` steps, the minimal exchange plan applied on every one.

        Requires a rotation-closed output binding (the contract of
        ``ProgramObject.iterate``): every output name rebinds a program field
        of identical geometry.  Returns the output binding after step ``n``.
        """
        return self._run(int(n), fields, scalars, exec_info, iterate=True)

    def _run(self, n: int, fields, scalars, exec_info, iterate: bool) -> Dict[str, Any]:
        scalars = dict(scalars or {})
        plan, step = self._prepare(fields, scalars)
        if iterate and plan.iterable_reason is not None:
            raise ProgramError(f"distributed program {self.prog.name!r} cannot iterate: {plan.iterable_reason}")
        return run_rank_steps(step, n, fields, {**plan.const_scalars, **scalars}, exec_info, iterate,
                              "program_report", plan.report)


def run_rank_steps(step: _RankStep, n: int, fields: Dict[str, Any], scalars: Dict[str, Any],
                   exec_info: Optional[dict], iterate: bool, report_key: str, report: Dict[str, Any]):
    """``n`` steps of ``step`` from ``fields``; the output binding after the
    last.  ``exec_info`` gets ``report`` under ``report_key`` (with
    ``iterated_steps`` for an ``iterate``), and ``rank_timings``
    (:func:`_rank_timings`), read from a device probe armed for the run
    (``obs.trace.probing``): the ``dist.iterate``, ``rank_step.*`` and
    ``halo.*`` spans, on the card CUDA events on the compute stream, else
    the host clock.  Without ``exec_info`` no probe is armed."""
    plan = step.plan
    probing = nullcontext()
    if exec_info is not None:
        exec_info[report_key] = dict(report)
        if iterate:
            exec_info[report_key]["iterated_steps"] = int(n)
        exec_info["run_start_time"] = time.perf_counter()
        scratch0 = sum(codegen_cuda.scratch_counts().values())
        probing = otrace.probing(step.device)
    vals = dict(fields)
    with probing as probe, otrace.device_span("dist.iterate", category="program", steps=int(n)):
        for i in range(n):
            step.step(vals, scalars)
            if iterate or i + 1 < n:
                vals.update({o: vals[b] for o, b in plan.outputs.items()})
        vals = step.release(vals, fields)
    if iterate:
        outs = {o: vals[o] for o in plan.outputs}
    else:
        outs = {o: vals[b] for o, b in plan.outputs.items()}
    if exec_info is not None:
        timings = _rank_timings(probe.result(), n)
        timings["scratch_bytes"] = sum(codegen_cuda.scratch_counts().values()) - scratch0
        exec_info["rank_timings"] = timings
        exec_info["run_end_time"] = time.perf_counter()
    return outs


#: ``rank_timings``' phases but the exchange, each the probe's spans it sums a call
_PHASES = {"pack": ("halo.pack",), "wait": ("halo.post", "halo.wait"), "unpack": ("halo.unpack",),
           "groups": ("rank_step.group",), "pad": ("rank_step.pad",), "release": ("rank_step.release",)}


def _rank_timings(result: Dict[str, Any], steps: int) -> Dict[str, Any]:
    """A rank run's timings from its probe's ``result``: ``seconds`` (the
    run, the release included), and the seconds and count of the exchanges
    and of each of ``_PHASES``.  ``wait`` runs from the post to the end of
    the wait on the transfer, the peers' lateness included; the exchanges'
    seconds are the sum of their phases.  ``steady_wait_seconds`` is the
    wait of the run's exchanges but its first, scaled to all of them: the
    first absorbs the ranks' skew at the run's start (each rank begins the
    run when its host gets there), the later ones wait for the transfer and
    the peers' step."""
    durations = result["durations"]
    per_call = {phase: [sum(d) for d in zip(*(durations.get(name, []) for name in names))]
                for phase, names in _PHASES.items()}
    n = result["calls"].get("halo.exchange", 0)
    out = {"clock": result["clock"], "steps": int(steps), "seconds": result["seconds"]["dist.iterate"],
           "exchange_count": n}
    for phase, seconds in per_call.items():
        out[f"{phase}_seconds"], out[f"{phase}_count"] = sum(seconds), len(seconds)
    out["exchange_seconds"] = out["pack_seconds"] + out["wait_seconds"] + out["unpack_seconds"]
    waits = per_call["wait"]
    first = len(waits) // n if n else 0  # every exchange of a rank posts on the same axes
    out["steady_wait_seconds"] = sum(waits[first:]) * n / (n - 1) if n > 1 else out["wait_seconds"]
    return out
