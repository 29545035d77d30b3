"""StencilObject: the compiled, callable artifact produced by @gtscript.stencil.

Implements the paper's call conventions: fields (Storage or bare arrays) are
positional-or-keyword in declaration order, scalar parameters are
keyword-only, and the iteration space is implicit — deduced from field sizes
and the stencil shape — with optional ``domain=`` / ``origin=`` overrides
(§2.2).  ``validate_args`` reproduces the run-time storage checks whose cost
is the paper's Fig. 3 dashed-vs-solid gap; ``exec_info`` captures the same
timings the paper reports.

Backends: ``debug`` and ``numpy`` run on NumPy fields, ``torch`` and ``cuda``
on torch tensors.  ``torch``, ``cuda`` and ``numpy`` mutate the caller's
fields in place and return ``None``; ``apply`` is the functional twin.
``cuda`` launches the generated Hopper kernel (``codegen_cuda``) when the
fields are CUDA tensors and runs the plain ``torch`` module when they lie on
the CPU; it never falls back from one to the other.  Calls are eager.

``autotune=True`` (``cuda`` and tiled ``numpy``) picks the block a call
runs with through ``core/autotune.py``; a pinned ``block=`` (``cuda``) or
``tile=`` (``numpy``) always wins.  On the card each tuned block is its own
generated kernel (``StencilObject.block_kernel``).  A ``cuda`` stencil on
CPU tensors runs its plain module: there is no block to tune, and
``exec_info["autotune"]`` says so.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as otrace

from . import analysis, caching, frontend, ir, passes
from .storage import TORCH_BACKENDS, Storage

_AXIS_INDEX = {"I": 0, "J": 1, "K": 2}

# distinguishes "tile not given" (schedule-pass default applies) from an
# explicit ``tile=None`` (tiling off) in backend_opts
_TILE_UNSET = object()

# Orchestration-tracing hook (installed by ``repro_torch.program.trace``):
# called at the top of ``StencilObject.__call__`` so a ``@program`` tracer can
# intercept calls made on traced field handles and record a dataflow node
# instead of executing.  Returning :data:`NOT_TRACED` means "not tracing — run
# eagerly".
NOT_TRACED = object()
_trace_hook = None


def set_trace_hook(hook) -> None:
    """Install (or clear, with ``None``) the program-tracer call hook."""
    global _trace_hook
    _trace_hook = hook


class FieldInfo:
    def __init__(self, decl: ir.FieldDecl, extent: ir.Extent, k_extent: Tuple[int, int]):
        self.name = decl.name
        self.dtype = np.dtype(decl.dtype)
        self.axes = decl.axes
        self.extent = extent
        self.k_extent = k_extent

    @property
    def halo_lo(self) -> Tuple[int, int, int]:
        (ilo, _), (jlo, _), (klo, _) = self.extent.as_tuple()
        return (max(0, -ilo), max(0, -jlo), max(0, -klo))

    @property
    def halo_hi(self) -> Tuple[int, int, int]:
        (_, ihi), (_, jhi), (_, khi) = self.extent.as_tuple()
        return (max(0, ihi), max(0, jhi), max(0, khi))

    def __repr__(self) -> str:
        return f"FieldInfo({self.name}, dtype={self.dtype}, axes={self.axes}, extent={self.extent.as_tuple()})"


class StencilObject:
    """A compiled stencil. See module docstring for call conventions."""

    def __init__(
        self,
        name: str,
        backend: str,
        definition_ir: ir.StencilDefinition,
        implementation_ir: ir.StencilImplementation,
        generated_source: str,
        run_fn: Callable,
        validate_args: bool = True,
        fingerprint: str = "",
        pass_report: Optional[list] = None,
        module=None,
        kernel=None,
        autotune_cfg: Optional[Dict[str, Any]] = None,
        pinned_block: Optional[Tuple[int, int]] = None,
    ):
        self.name = name
        self.backend = backend
        self.definition_ir = definition_ir
        self.implementation_ir = implementation_ir
        self.generated_source = generated_source
        self._run = run_fn
        self.validate_args_default = validate_args
        self.fingerprint = fingerprint
        # per-pass compile-time instrumentation (passes.PassContext.records)
        self.pass_report = list(pass_report or [])
        # the generated module (the cuda one exports SCHEDULE / _smem_bytes)
        self._module = module
        # cuda: the compiled kernel (``_run`` is then the plain torch module's)
        self.kernel = kernel
        # numpy stage tiling on: run() takes block=
        self._numpy_tiled = backend == "numpy" and hasattr(module, "_BLOCK_DEFAULT")
        # the autotune configuration, and an explicit user-pinned block (the
        # cuda ``block=`` or the numpy ``tile=``), which always wins over it
        self._autotune_cfg = dict(autotune_cfg or {})
        self._pinned_block = tuple(pinned_block) if pinned_block is not None else None
        self._block_cache: Dict[Any, Any] = {}

        impl = implementation_ir
        kext = dict(impl.k_extents)
        self.field_info: Dict[str, FieldInfo] = {
            f.name: FieldInfo(f, impl.extent_of(f.name), kext.get(f.name, (0, 0)))
            for f in impl.api_fields
        }
        self.scalar_info = {s.name: np.dtype(s.dtype) for s in impl.scalars}
        self._field_order = [f.name for f in impl.api_fields]
        # cuda kernels by (block, per-member scalars): block variants and
        # member-batched kernels
        self._kernels: Dict[Tuple[Any, Any], Any] = {}

    @property
    def launches(self) -> int:
        """Launches of this stencil's CUDA kernel (0 on other backends)."""
        return self.kernel.launches if self.kernel is not None else 0

    @launches.setter
    def launches(self, value: int) -> None:
        if self.kernel is not None:
            self.kernel.launches = int(value)

    @property
    def tunes(self) -> bool:
        """True when calls pick their block through the autotuner."""
        return bool(self._autotune_cfg.get("autotune")) and self._pinned_block is None and (
            self.backend == "cuda" or self._numpy_tiled
        )

    def block_kernel(self, block=None, member_scalars=None):
        """This ``cuda`` stencil's kernel for thread block ``block`` (``None``:
        the module's own).  ``BI``/``BJ`` are constants of the generated
        source, so another block is another source: its module name carries
        the block and its fingerprint is ``caching.block_fingerprint`` of the
        stencil's, so variants never overwrite each other in the cache.

        When ``member_scalars`` is a tuple the kernel is member-batched: one
        launch runs every member of an ensemble, ``blockIdx.z`` the member
        (``codegen_cuda.generate_cuda_module_source(member_scalars=...)``).
        ``member_scalars`` names the scalars that take one value a member;
        they are part of the kernel's source and of its fingerprint."""
        if self.backend != "cuda":
            raise TypeError(f"block_kernel() needs the cuda backend, not {self.backend!r}")
        block = tuple(int(b) for b in block) if block is not None else tuple(self._module.BLOCK)
        mkey = None if member_scalars is None else tuple(sorted(member_scalars))
        if block == tuple(self._module.BLOCK) and mkey is None:
            return self.kernel
        kernel = self._kernels.get((block, mkey))
        if kernel is None:
            from .codegen_cuda import CudaKernel, generate_cuda_module_source

            name, fp = self.name, self.fingerprint
            if block != tuple(self._module.BLOCK):
                name, fp = f"{self.name}_b{block[0]}x{block[1]}", caching.block_fingerprint(fp, block)
            if mkey is not None:
                fp = caching.member_fingerprint(fp, mkey)
            source = generate_cuda_module_source(self.implementation_ir, block, member_scalars=mkey)
            module = caching.load_generated_module(name, fp, source)
            kernel = CudaKernel(module, caching.module_key(name, fp), caching.cache_dir())
            self._kernels[(block, mkey)] = kernel
        return kernel

    def _resolve_block(
        self, domain, operand_shapes=None, member_scalars=None
    ) -> Tuple[Optional[Tuple[int, int]], Optional[dict]]:
        """The block for this domain + operand geometry: a pinned block wins,
        otherwise the autotuner's (cached) choice, otherwise ``None`` (the
        module's own).  ``operand_shapes`` carries the FULL argument shapes
        (member/batch axes included) so a batched run never reuses a block
        tuned for unbatched shapes; on ``cuda`` a batched search times the
        member-batched kernel with ``member_scalars`` per member."""
        if not self.tunes:
            return self._pinned_block, None
        if operand_shapes is not None:
            operand_shapes = tuple(
                sorted((str(n), tuple(int(x) for x in s)) for n, s in operand_shapes)
            )
        key = (tuple(domain), operand_shapes)
        cached = self._block_cache.get(key)
        if cached is None:
            from . import autotune

            kwargs: Dict[str, Any] = {}
            if self._autotune_cfg.get("autotune_candidates") is not None:
                kwargs["candidates"] = self._autotune_cfg["autotune_candidates"]
            if self._autotune_cfg.get("autotune_iters") is not None:
                kwargs["iters"] = int(self._autotune_cfg["autotune_iters"])
            if self._autotune_cfg.get("autotune_warmup") is not None:
                kwargs["warmup"] = int(self._autotune_cfg["autotune_warmup"])
            if self.backend == "cuda":
                batched = autotune.batch_count(self._module, operand_shapes) is not None
                mkey = tuple(member_scalars or ()) if batched else None
                kwargs["kernels"] = lambda b: self.block_kernel(b, mkey)
                kwargs["member_scalars"] = mkey or ()
            cached = autotune.select_block(
                self._module,
                self.name,
                self.fingerprint,
                tuple(domain),
                operand_shapes=operand_shapes,
                **kwargs,
            )
            self._block_cache[key] = cached
        return cached

    # ------------------------------------------------------------------ binding

    def _bind(self, args, kwargs):
        fields: Dict[str, Any] = {}
        scalars: Dict[str, Any] = {}
        for name, val in zip(self._field_order, args):
            fields[name] = val
        if len(args) > len(self._field_order):
            raise TypeError(
                f"{self.name}() takes {len(self._field_order)} positional field arguments, "
                f"got {len(args)}"
            )
        for key, val in kwargs.items():
            if key in self.field_info:
                if key in fields:
                    raise TypeError(f"{self.name}() got duplicate field argument {key!r}")
                fields[key] = val
            elif key in self.scalar_info:
                scalars[key] = val
            else:
                raise TypeError(f"{self.name}() got unexpected argument {key!r}")
        missing = [n for n in self._field_order if n not in fields]
        if missing:
            raise TypeError(f"{self.name}() missing field arguments: {missing}")
        missing_s = [n for n in self.scalar_info if n not in scalars]
        if missing_s:
            raise TypeError(f"{self.name}() missing scalar arguments: {missing_s}")
        return fields, scalars

    @staticmethod
    def _raw(value):
        return value.data if isinstance(value, Storage) else value

    def _axes_shape(self, name: str, shape: Tuple[int, ...]) -> Dict[str, int]:
        axes = self.field_info[name].axes
        if len(shape) != len(axes):
            raise ValueError(
                f"{self.name}(): field {name!r} has axes {axes} but a {len(shape)}-d array was passed"
            )
        return dict(zip(axes, shape))

    def _default_origin(self, name: str, value) -> Tuple[int, ...]:
        if isinstance(value, Storage) and value.default_origin is not None and any(value.default_origin):
            return tuple(value.default_origin)
        info = self.field_info[name]
        lo = info.halo_lo
        # K origin defaults to 0: vertical reads stay in-domain by construction
        return tuple(0 if a == "K" else lo[_AXIS_INDEX[a]] for a in info.axes)

    def _resolve_origins(self, fields, origin) -> Dict[str, Tuple[int, int, int]]:
        origins: Dict[str, Tuple[int, int, int]] = {}
        for name, val in fields.items():
            info = self.field_info[name]
            if origin is None:
                o = self._default_origin(name, val)
            elif isinstance(origin, dict):
                o = origin.get(name, self._default_origin(name, val))
                o = tuple(o)[: len(info.axes)] if len(o) >= len(info.axes) else tuple(o)
            else:
                o = tuple(origin)
                o = tuple(o[_AXIS_INDEX[a]] for a in info.axes)
            if len(o) != len(info.axes):
                raise ValueError(f"{self.name}(): origin {o} rank mismatch for field {name!r}")
            # expand to 3-tuple (I, J, K) with zeros on missing axes
            o3 = [0, 0, 0]
            for a, v in zip(info.axes, o):
                o3[_AXIS_INDEX[a]] = int(v)
            origins[name] = tuple(o3)
        return origins

    def _deduce_domain(self, fields, origins) -> Tuple[int, int, int]:
        dom = [None, None, None]
        for name, val in fields.items():
            info = self.field_info[name]
            shape = self._axes_shape(name, tuple(self._raw(val).shape))
            hi = info.halo_hi
            o3 = origins[name]
            for a, n in shape.items():
                ax = _AXIS_INDEX[a]
                avail = n - o3[ax] - hi[ax]
                dom[ax] = avail if dom[ax] is None else min(dom[ax], avail)
        # K axis when only IJ fields: no constraint → default 1 level
        result = tuple(d if d is not None else 1 for d in dom)
        return result  # type: ignore[return-value]

    # --------------------------------------------------------------- validation

    def _validate(self, fields, scalars, domain, origins) -> None:
        ni, nj, nk = domain
        if min(ni, nj, nk) <= 0:
            raise ValueError(f"{self.name}(): empty compute domain {domain}")
        if nk < self.implementation_ir.min_k_levels:
            raise ValueError(
                f"{self.name}(): domain has {nk} vertical levels but the stencil's intervals "
                f"require at least {self.implementation_ir.min_k_levels}"
            )
        for name, val in fields.items():
            info = self.field_info[name]
            arr = self._raw(val)
            if np.dtype(str(arr.dtype).replace("torch.", "")) != info.dtype:
                raise TypeError(
                    f"{self.name}(): field {name!r} expects dtype {info.dtype}, got {arr.dtype}"
                )
            shape = self._axes_shape(name, tuple(arr.shape))
            o3 = origins[name]
            lo, hi = info.halo_lo, info.halo_hi
            dom3 = {"I": ni, "J": nj, "K": nk}
            for a, n in shape.items():
                ax = _AXIS_INDEX[a]
                # vertical reads are checked statically to stay inside the
                # domain (analysis._check_vertical_bounds) — no K halo needed
                lo_ax = 0 if a == "K" else lo[ax]
                hi_ax = 0 if a == "K" else hi[ax]
                if o3[ax] < lo_ax:
                    raise ValueError(
                        f"{self.name}(): field {name!r} origin {o3[ax]} along {a} is smaller than "
                        f"the required halo {lo_ax}"
                    )
                need = o3[ax] + dom3[a] + hi_ax
                if n < need:
                    raise ValueError(
                        f"{self.name}(): field {name!r} extends to {n} along {a} but needs "
                        f"{need} (origin {o3[ax]} + domain {dom3[a]} + halo {hi_ax})"
                    )
        for name, val in scalars.items():
            if not np.isscalar(val) and not (hasattr(val, "ndim") and val.ndim == 0):
                raise TypeError(f"{self.name}(): parameter {name!r} must be a scalar, got {type(val)}")

    # ------------------------------------------------------------------ calling

    def __call__(
        self,
        *args,
        domain: Optional[Tuple[int, int, int]] = None,
        origin=None,
        validate_args: Optional[bool] = None,
        exec_info: Optional[dict] = None,
        **kwargs,
    ):
        if _trace_hook is not None:
            traced = _trace_hook(self, args, kwargs, domain=domain, origin=origin)
            if traced is not NOT_TRACED:
                return traced
        if exec_info is not None and exec_info.get("trace") is True:
            # per-call trace opt-in: capture this call's spans into a fresh
            # tracer and hand back Chrome-trace JSON under exec_info["trace"]
            from repro_torch.obs import export as obs_export

            del exec_info["trace"]
            with otrace.capture() as cap:
                result = self.__call__(
                    *args, domain=domain, origin=origin,
                    validate_args=validate_args, exec_info=exec_info, **kwargs,
                )
            exec_info["trace"] = obs_export.chrome_trace(cap.snapshot())
            return result
        if exec_info is not None:
            exec_info["call_start_time"] = time.perf_counter()
            exec_info["pass_report"] = list(self.pass_report)
        fields, scalars = self._bind(args, kwargs)
        origins = self._resolve_origins(fields, origin)
        if domain is None:
            domain = self._deduce_domain(fields, origins)
        domain = tuple(int(d) for d in domain)  # type: ignore[assignment]

        do_validate = self.validate_args_default if validate_args is None else validate_args
        if do_validate:
            self._validate(fields, scalars, domain, origins)

        raw_fields = {n: self._raw(v) for n, v in fields.items()}

        block, autotune_record = self._call_block(raw_fields, domain)
        if exec_info is not None:
            if self._numpy_tiled:
                exec_info["numpy_tile"] = dict(
                    self._module._TILING, block=tuple(block or self._module._BLOCK_DEFAULT)
                )
            if self.backend == "cuda":
                exec_info["schedule"] = self._module.SCHEDULE
            if autotune_record is not None:
                exec_info["autotune"] = autotune_record
            exec_info["run_start_time"] = time.perf_counter()

        with otrace.span(
            "stencil.run", category="stencil",
            stencil=self.name, backend=self.backend, domain=list(domain),
        ):
            self._execute(raw_fields, scalars, domain, origins, block)

        if exec_info is not None:
            # the kernel runs asynchronously: the end time waits for the card
            for v in raw_fields.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    torch.cuda.synchronize(v.device)
                    break
            exec_info["run_end_time"] = time.perf_counter()
        return None

    def _call_block(self, raw_fields, domain) -> Tuple[Optional[Tuple[int, int]], Optional[dict]]:
        """The block this call runs with, and the autotune record when the
        tuner chose it.  A ``cuda`` call on CPU tensors runs the plain module:
        nothing to tune."""
        if self.backend == "cuda" and self.tunes and not any(
            isinstance(v, torch.Tensor) and v.is_cuda for v in raw_fields.values()
        ):
            return None, {"tuned": False, "reason": "CPU tensors run the plain torch module: no kernel to tune"}
        if self.backend != "cuda" and not self._numpy_tiled:
            return None, None
        return self._resolve_block(domain, [(n, tuple(v.shape)) for n, v in raw_fields.items()])

    def _execute(self, raw_fields, scalars, domain, origins, block) -> None:
        """Run in place on the fields' own memory: NumPy arrays for
        debug/numpy, tensors (all on one device) for torch/cuda."""
        if self.backend in ("debug", "numpy"):
            for n, v in raw_fields.items():
                if not isinstance(v, np.ndarray):
                    raise TypeError(
                        f"{self.name}(): backend {self.backend!r} requires NumPy-backed fields; "
                        f"{n!r} is {type(v)} (use storage backend={self.backend!r})"
                    )
            if block is not None:
                self._run(raw_fields, scalars, domain, origins, block=block)
            else:
                self._run(raw_fields, scalars, domain, origins)
            return
        devices = set()
        for n, v in raw_fields.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"{self.name}(): backend {self.backend!r} requires torch tensors; "
                    f"{n!r} is {type(v)} (use storage backend={self.backend!r})"
                )
            devices.add(v.device)
        if len(devices) != 1:
            raise ValueError(f"{self.name}(): fields lie on more than one device: {sorted(map(str, devices))}")
        (device,) = devices
        if self.backend == "cuda" and device.type == "cuda":
            self.block_kernel(block).launch(raw_fields, scalars, domain, origins)
        elif self.backend == "cuda" and device.type != "cpu":
            raise ValueError(f"{self.name}(): backend 'cuda' runs on CUDA or CPU tensors, not {device}")
        else:
            # torch on any device; cuda on CPU tensors: the plain torch module
            self._run(raw_fields, scalars, domain, origins)

    def apply(
        self,
        fields: Dict[str, Any],
        scalars: Optional[Dict[str, Any]] = None,
        *,
        domain: Optional[Tuple[int, int, int]] = None,
        origin=None,
        validate_args: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """Functional protocol: ``fields dict -> updated-fields dict``.

        The pure twin of the mutating ``__call__``, for every backend: the
        fields are copied (NumPy arrays, or tensors on their own device) and
        the stencil runs in place on the copies, which come back for every
        written field.
        """
        scalars = dict(scalars or {})
        missing = [n for n in self._field_order if n not in fields]
        if missing:
            raise TypeError(f"{self.name}.apply() missing field arguments: {missing}")
        # a superset dict is fine — only this stencil's own fields participate
        fields = {n: fields[n] for n in self._field_order}
        missing_s = [n for n in self.scalar_info if n not in scalars]
        if missing_s:
            raise TypeError(f"{self.name}.apply() missing scalar arguments: {missing_s}")
        origins = self._resolve_origins(fields, origin)
        if domain is None:
            domain = self._deduce_domain(fields, origins)
        domain = tuple(int(d) for d in domain)
        do_validate = self.validate_args_default if validate_args is None else validate_args
        if do_validate:
            self._validate(fields, scalars, domain, origins)
        work = {}
        for n, v in fields.items():
            raw = self._raw(v)
            work[n] = raw.clone() if isinstance(raw, torch.Tensor) else np.array(raw, copy=True)
        block, _ = self._call_block(work, domain)
        self._execute(work, scalars, domain, origins, block)
        written = set(self.implementation_ir.written_api_fields())
        return {n: work[n] for n in self._field_order if n in written}

    def as_torch_function(self, domain: Tuple[int, int, int], origin=None) -> Callable:
        """A pure ``fn(fields_dict, scalars_dict) -> updated-fields dict`` over
        torch tensors, for composing this stencil in larger torch programs.
        Only available for the torch-family backends."""
        if self.backend not in TORCH_BACKENDS:
            raise TypeError(f"as_torch_function() requires the torch/cuda backends, not {self.backend!r}")

        def _fn(fields: Dict[str, Any], scalars: Optional[Dict[str, Any]] = None):
            return self.apply(fields, scalars, domain=domain, origin=origin)

        return _fn

    def __repr__(self) -> str:
        return f"StencilObject({self.name!r}, backend={self.backend!r}, fingerprint={self.fingerprint})"


# ---------------------------------------------------------------------------
# build pipeline: definition function → StencilObject
# ---------------------------------------------------------------------------


def build_stencil_object(
    definition: Callable,
    backend: str,
    externals: Dict[str, Any],
    name: str,
    rebuild: bool = False,
    validate_args: bool = True,
    backend_opts: Optional[Dict[str, Any]] = None,
) -> StencilObject:
    with otrace.span("stencil.frontend", category="compile", stencil=name or "", backend=backend):
        definition_ir = frontend.parse_stencil_definition(definition, externals=externals, name=name)
    return build_from_definition(definition_ir, backend, rebuild=rebuild,
                                 validate_args=validate_args, backend_opts=backend_opts)


def build_retyped(
    definition: Callable,
    backend: str,
    dtype: str,
    *,
    externals: Optional[Dict[str, Any]] = None,
    name: Optional[str] = None,
    validate_args: bool = True,
    **backend_opts: Any,
) -> StencilObject:
    """Build a stencil from a float64 definition function with every field,
    scalar, and explicit cast dtype rewritten to ``dtype``
    (``ir.retype_definition``) — the shared path the benchmark stencils use
    to derive float32 variants without duplicating definitions.
    ``dtype="float64"`` is the identity and builds the definition as-is."""
    definition_ir = frontend.parse_stencil_definition(
        definition, externals=dict(externals or {}), name=name
    )
    if dtype != "float64":
        definition_ir = ir.retype_definition(definition_ir, {"float64": dtype})
    return build_from_definition(
        definition_ir, backend, validate_args=validate_args, backend_opts=backend_opts
    )


def build_from_definition(
    definition_ir: ir.StencilDefinition,
    backend: str,
    *,
    rebuild: bool = False,
    validate_args: bool = True,
    backend_opts: Optional[Dict[str, Any]] = None,
) -> StencilObject:
    """Build directly from a Definition IR (used by property tests and any
    alternative frontends — the IR is the toolchain interface, paper §2.3).

    ``backend_opts`` carries the pass-pipeline configuration (``opt_level``,
    ``disable_passes``, ``enable_passes`` — see ``passes.py``) alongside any
    codegen options: the numpy ``tile`` and the cuda ``block`` shape, and
    the autotuner configuration (``autotune=True`` plus optional
    ``autotune_candidates`` / ``autotune_iters`` / ``autotune_warmup`` — see
    ``autotune.py``).  The autotune keys deliberately stay *out* of the
    cache fingerprint: they change which block a call runs with, never the
    generated module, and the tuning store is keyed on the fingerprint so
    identical IR + options always share one tuning record."""
    pass_cfg, codegen_opts = passes.split_backend_opts(backend_opts)
    autotune_cfg = {
        k: codegen_opts.pop(k)
        for k in ("autotune", "autotune_candidates", "autotune_iters", "autotune_warmup")
        if k in codegen_opts
    }
    user_tile = codegen_opts.get("tile", _TILE_UNSET)
    if backend == "numpy":
        # numpy stage tiling (a backend-schedule pass, codegen_array.py):
        # explicit ``tile=(TI, TJ)`` pins it, ``tile=None`` disables it,
        # otherwise it rides opt_level / disable_passes like every pass.
        # The effective tile lands in ``codegen_opts`` before fingerprinting.
        from .codegen_array import DEFAULT_NUMPY_TILE

        if user_tile is _TILE_UNSET:
            on = passes.schedule_pass_enabled(
                "numpy_stage_tiling",
                pass_cfg["opt_level"],
                pass_cfg["disable"],
                pass_cfg["enable"],
            )
            codegen_opts["tile"] = DEFAULT_NUMPY_TILE if on else None
    allowed = {"numpy": {"tile"}, "cuda": {"block"}}.get(backend, set())
    unknown = set(codegen_opts) - allowed
    if unknown:
        raise TypeError(f"backend {backend!r} takes no options {sorted(unknown)}")
    name = definition_ir.name
    with otrace.span("stencil.analyze", category="compile", stencil=name, backend=backend):
        impl = analysis.analyze(definition_ir)
    with otrace.span("stencil.passes", category="compile", stencil=name, backend=backend) as psp:
        impl, pass_report = passes.run_pipeline(impl, **pass_cfg)
        # fold the pass report into span attributes: which passes fired and
        # what each cost, correlated with this build
        psp.set(
            "pass_report",
            [
                {"pass": r["pass"], "seconds": r["seconds"], "changed": r["changed"]}
                for r in pass_report
            ],
        )
    fp = caching.fingerprint(definition_ir, backend, codegen_opts, pass_config=pass_cfg)

    kernel = None
    with otrace.span(
        "stencil.codegen", category="compile", stencil=name, backend=backend, fingerprint=fp
    ):
        if backend == "numpy":
            from .codegen_array import generate_numpy_source, tiling_plan

            tile = codegen_opts.get("tile")
            source = generate_numpy_source(impl, tile=tile)
            stats = passes.impl_stats(impl)
            plan = tiling_plan(impl)
            pass_report = list(pass_report) + [
                {
                    "pass": "numpy_stage_tiling",
                    "seconds": 0.0,
                    "before": stats,
                    "after": stats,
                    "changed": tile is not None and plan["tiled_multistages"] > 0,
                    "detail": dict(
                        plan, tile=tuple(tile) if tile else None, enabled=tile is not None
                    ),
                }
            ]
        elif backend == "torch":
            from .codegen_array import generate_torch_source

            source = generate_torch_source(impl)
        elif backend == "debug":
            from .codegen_debug import generate_debug_source

            source = generate_debug_source(impl)
        elif backend == "cuda":
            from .codegen_array import generate_torch_source
            from .codegen_cuda import DEFAULT_BLOCK, generate_cuda_module_source

            block = tuple(codegen_opts.get("block") or DEFAULT_BLOCK)
            source = generate_cuda_module_source(impl, block)
            plain_source = generate_torch_source(impl)
        else:
            raise ValueError(f"unknown backend {backend!r} (expected debug|numpy|torch|cuda)")

    with otrace.span(
        "stencil.load_module", category="compile", stencil=name, backend=backend, fingerprint=fp
    ):
        module = caching.load_generated_module(name, fp, source, rebuild=rebuild)
        run_fn = getattr(module, "run", None)
        generated_source = source
        if backend == "cuda":
            from .codegen_cuda import CudaKernel

            # the plain torch module runs the same stencil on CPU tensors
            plain_fp = caching.fingerprint(definition_ir, "torch", {}, pass_config=pass_cfg)
            run_fn = caching.load_generated_module(name, plain_fp, plain_source, rebuild=rebuild).run
            kernel = CudaKernel(module, caching.module_key(name, fp), caching.cache_dir())
            generated_source = module.CUDA_SOURCE
    if backend == "cuda":
        pinned = codegen_opts.get("block")
    elif backend == "numpy" and user_tile is not _TILE_UNSET:
        pinned = user_tile  # explicit tile pin always wins over the autotuner
    else:
        pinned = None
    return StencilObject(
        name=name,
        backend=backend,
        definition_ir=definition_ir,
        implementation_ir=impl,
        generated_source=generated_source,
        run_fn=run_fn,
        validate_args=validate_args,
        fingerprint=fp,
        pass_report=pass_report,
        module=module,
        kernel=kernel,
        autotune_cfg=autotune_cfg,
        pinned_block=pinned,
    )
