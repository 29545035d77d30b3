"""Program tracer: record the stencil calls of a Python step function.

The ``@program`` decorator (``repro_torch.program``) runs the user's step function
*once* with :class:`TracedField` handles in place of its field arguments.
Every :class:`~repro_torch.core.stencil.StencilObject` call made on those
handles is intercepted through the ``core.stencil`` trace hook and recorded as
a :class:`StencilNode` in an inter-stencil dataflow trace instead of being
executed; explicit halo-exchange requests (:func:`request_exchange`) become
:class:`ExchangeNode` markers.  The trace is the input of
``repro_torch.program.graph`` / ``compile``.  (The reference package's
``repro/program/trace.py``, over the port's storages and stencil objects.)

Field handles carry *versions* (bumped on every write) so the graph layer
can reason about dataflow SSA-style while the user code keeps the eager,
mutating call convention of the paper's API — ``advect(phi, u, v, adv,
...)`` reads ``phi@0`` and produces ``adv@1``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import stencil as _stencil_mod
from repro_torch.core.stencil import NOT_TRACED, StencilObject
from repro_torch.core.storage import Storage


class ProgramError(Exception):
    """Base class for program-orchestration errors."""


class ProgramTraceError(ProgramError):
    """The step function did something the tracer cannot record."""


# ---------------------------------------------------------------------------
# Traced handles
# ---------------------------------------------------------------------------


def _blocked(op: str):
    def _fn(self, *_a, **_k):
        raise ProgramTraceError(
            f"cannot apply {op!r} to traced program field {self.name!r}: inside a @program "
            "step function fields may only be passed to compiled stencils (or to "
            "request_exchange); do array math in a stencil, or outside "
            "the program."
        )

    return _fn


class TracedField:
    """A placeholder for one program field argument during tracing."""

    def __init__(self, name: str, value: Any):
        self.name = name
        self.value = value  # the concrete Storage / array the user passed
        self.version = 0

    @property
    def storage(self) -> Optional[Storage]:
        return self.value if isinstance(self.value, Storage) else None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return np.dtype(str(self.value.dtype).replace("torch.", ""))

    @property
    def axes(self) -> Tuple[str, ...]:
        if isinstance(self.value, Storage):
            return tuple(self.value.axes)
        return ("I", "J", "K")[: self.value.ndim]

    def __repr__(self) -> str:
        return f"TracedField({self.name}@{self.version}, shape={self.shape}, dtype={self.dtype})"

    __add__ = __radd__ = __sub__ = __rsub__ = _blocked("+/-")
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _blocked("*//")
    __neg__ = __pos__ = __abs__ = _blocked("unary op")
    __getitem__ = __setitem__ = _blocked("indexing")

    def __array__(self, dtype=None):
        raise ProgramTraceError(
            f"traced program field {self.name!r} has no concrete values during tracing; "
            "convert to an array outside the @program step function."
        )


class TracedScalar:
    """A placeholder for one program scalar (keyword-only) argument."""

    def __init__(self, name: str, value: Any):
        self.name = name
        self.value = value

    @property
    def dtype(self) -> str:
        return str(np.dtype(type(self.value)) if not hasattr(self.value, "dtype") else self.value.dtype)

    def __repr__(self) -> str:
        return f"TracedScalar({self.name}={self.value!r})"

    def _no_math(self, *_a, **_k):
        raise ProgramTraceError(
            f"arithmetic on traced program scalar {self.name!r} is not recordable; "
            "precompute derived scalars outside the @program step function and pass "
            "them as their own keyword arguments."
        )

    __add__ = __radd__ = __sub__ = __rsub__ = _no_math
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _no_math
    __neg__ = __float__ = __int__ = _no_math


# ---------------------------------------------------------------------------
# Trace nodes
# ---------------------------------------------------------------------------


class StencilNode:
    """One recorded stencil call: bindings of stencil params to program buffers."""

    def __init__(
        self,
        stencil: StencilObject,
        field_bind: Dict[str, str],  # stencil field param -> program buffer
        read_versions: Dict[str, int],  # buffer -> version consumed
        write_versions: Dict[str, int],  # buffer -> version produced
        scalar_bind: Dict[str, Tuple[str, Any]],  # param -> ('scalar', name) | ('const', value)
        domain: Tuple[int, int, int],
        origins: Dict[str, Tuple[int, int, int]],  # buffer -> resolved origin
    ):
        self.stencil = stencil
        self.field_bind = dict(field_bind)
        self.read_versions = dict(read_versions)
        self.write_versions = dict(write_versions)
        self.scalar_bind = dict(scalar_bind)
        self.domain = tuple(domain)
        self.origins = dict(origins)

    def __repr__(self) -> str:
        return (
            f"StencilNode({self.stencil.name}, bind={self.field_bind}, "
            f"writes={self.write_versions}, domain={self.domain})"
        )

    def structural_repr(self) -> str:
        """Stable description for the program fingerprint."""
        return "|".join(
            [
                self.stencil.name,
                self.stencil.fingerprint,
                repr(sorted(self.field_bind.items())),
                repr(sorted(self.read_versions.items())),
                repr(sorted(self.write_versions.items())),
                # const *values* are runtime-bound (never baked into generated
                # source), so only the binding kind participates in the hash
                repr(sorted((k, v[0], "" if v[0] == "const" else v[1]) for k, v in self.scalar_bind.items())),
                repr(self.domain),
                repr(sorted(self.origins.items())),
            ]
        )


class ExchangeNode:
    """An explicit halo-exchange request recorded mid-trace."""

    def __init__(self, buffer: str, version: int, halo: Optional[int]):
        self.buffer = buffer
        self.version = version
        self.halo = halo

    def __repr__(self) -> str:
        return f"ExchangeNode({self.buffer}@{self.version}, halo={self.halo})"

    def structural_repr(self) -> str:
        return f"exchange|{self.buffer}|{self.version}|{self.halo}"


# ---------------------------------------------------------------------------
# The trace itself
# ---------------------------------------------------------------------------


class Trace:
    def __init__(self, name: str):
        self.name = name
        self.fields: Dict[str, TracedField] = {}
        self.scalars: Dict[str, TracedScalar] = {}
        self.nodes: List[Any] = []
        # set by finish(): output name -> (buffer, version)
        self.outputs: Dict[str, Tuple[str, int]] = {}

    # -- handle creation ---------------------------------------------------

    def add_field(self, name: str, value: Any) -> TracedField:
        if name in self.fields or name in self.scalars:
            raise ProgramTraceError(f"duplicate program argument {name!r}")
        h = TracedField(name, value)
        self.fields[name] = h
        return h

    def add_scalar(self, name: str, value: Any) -> TracedScalar:
        if name in self.fields or name in self.scalars:
            raise ProgramTraceError(f"duplicate program argument {name!r}")
        s = TracedScalar(name, value)
        self.scalars[name] = s
        return s

    # -- recording ---------------------------------------------------------

    def record_stencil_call(self, st: StencilObject, args, kwargs, domain, origin) -> None:
        fields, scalars = st._bind(args, kwargs)
        field_bind: Dict[str, str] = {}
        read_versions: Dict[str, int] = {}
        concrete_values: Dict[str, Any] = {}
        for param, val in fields.items():
            if not isinstance(val, TracedField):
                raise ProgramTraceError(
                    f"stencil {st.name!r} called inside program {self.name!r} with a "
                    f"non-traced value for field {param!r} ({type(val).__name__}); every "
                    "field passed to a stencil inside a @program step must be one of the "
                    "program's field arguments."
                )
            if val is not self.fields.get(val.name):
                raise ProgramTraceError(
                    f"field handle {val.name!r} does not belong to program {self.name!r}"
                )
            field_bind[param] = val.name
            read_versions[val.name] = val.version
            concrete_values[param] = val.value
        scalar_bind: Dict[str, Tuple[str, Any]] = {}
        for param, val in scalars.items():
            if isinstance(val, TracedScalar):
                if val is not self.scalars.get(val.name):
                    raise ProgramTraceError(
                        f"scalar handle {val.name!r} does not belong to program {self.name!r}"
                    )
                scalar_bind[param] = ("scalar", val.name)
            elif isinstance(val, TracedField):
                raise ProgramTraceError(
                    f"program field {val.name!r} passed as scalar parameter {param!r} "
                    f"of stencil {st.name!r}"
                )
            else:
                scalar_bind[param] = ("const", val)
        # resolve geometry now (no validation — that happens per compiled key):
        # concrete sample values give shapes; Storage origins are honoured
        # exactly like the eager call path.
        origins3 = st._resolve_origins(concrete_values, origin)
        if domain is None:
            domain = st._deduce_domain(concrete_values, origins3)
        domain = tuple(int(d) for d in domain)
        buffer_origins = {field_bind[p]: o for p, o in origins3.items()}
        write_versions: Dict[str, int] = {}
        for param in _written_params(st):
            buf = field_bind[param]
            handle = self.fields[buf]
            handle.version += 1
            write_versions[buf] = handle.version
        self.nodes.append(
            StencilNode(st, field_bind, read_versions, write_versions, scalar_bind, domain, buffer_origins)
        )

    def record_exchange(self, field: TracedField, halo: Optional[int]) -> None:
        if field is not self.fields.get(field.name):
            raise ProgramTraceError(
                f"field handle {field.name!r} does not belong to program {self.name!r}"
            )
        self.nodes.append(ExchangeNode(field.name, field.version, halo))

    # -- finishing ---------------------------------------------------------

    def finish(self, result: Any) -> None:
        """Interpret the step function's return value as the output binding."""
        if result is None:
            raise ProgramTraceError(
                f"program {self.name!r} returned None: a @program step function must "
                "return its outputs (a field handle, a tuple of handles, or a dict "
                "mapping next-step argument names to handles for buffer rotation)."
            )
        if isinstance(result, TracedField):
            result = (result,)
        if isinstance(result, (tuple, list)):
            mapping = {}
            for h in result:
                if not isinstance(h, TracedField):
                    raise ProgramTraceError(
                        f"program {self.name!r} returned a non-field value {type(h).__name__}"
                    )
                mapping[h.name] = h
            result = mapping
        if not isinstance(result, dict):
            raise ProgramTraceError(
                f"program {self.name!r} returned {type(result).__name__}; expected field "
                "handle(s) or a dict of them"
            )
        outputs: Dict[str, Tuple[str, int]] = {}
        for out_name, h in result.items():
            if not isinstance(h, TracedField):
                raise ProgramTraceError(
                    f"program {self.name!r} output {out_name!r} is not a field handle"
                )
            if h is not self.fields.get(h.name):
                raise ProgramTraceError(
                    f"program {self.name!r} output {out_name!r} is a foreign field handle"
                )
            outputs[out_name] = (h.name, h.version)
        if not outputs:
            raise ProgramTraceError(f"program {self.name!r} returned no outputs")
        self.outputs = outputs

    def structural_repr(self) -> str:
        parts = [self.name]
        for name, h in sorted(self.fields.items()):
            parts.append(f"field|{name}|{h.shape}|{h.dtype}|{h.axes}")
        for name, s in sorted(self.scalars.items()):
            parts.append(f"scalar|{name}|{s.dtype}")
        parts.extend(n.structural_repr() for n in self.nodes)
        parts.append(repr(sorted(self.outputs.items())))
        return "\n".join(parts)


def _written_params(st: StencilObject) -> List[str]:
    """Stencil field params written by the stencil, in declaration order."""
    written = set(st.implementation_ir.written_api_fields())
    return [n for n in st.field_info if n in written]


# ---------------------------------------------------------------------------
# Hook plumbing (installed into repro_torch.core.stencil on import of this module)
# ---------------------------------------------------------------------------

_active: List[Trace] = []


def active_trace() -> Optional[Trace]:
    return _active[-1] if _active else None


def _call_hook(st: StencilObject, args, kwargs, *, domain, origin):
    t = active_trace()
    if t is None:
        return NOT_TRACED
    if not any(isinstance(a, (TracedField, TracedScalar)) for a in (*args, *kwargs.values())):
        return NOT_TRACED  # fully concrete call made inside a trace: run eagerly
    # any traced value routes the call into the recorder — a mix of traced
    # scalars with concrete fields then gets the tracer's diagnostic instead
    # of a confusing validation error deep inside the eager path
    t.record_stencil_call(st, args, kwargs, domain, origin)
    return None


_stencil_mod.set_trace_hook(_call_hook)


def request_exchange(field: Any, halo: Optional[int] = None) -> Any:
    """Record an explicit halo exchange for ``field`` inside a @program trace.

    Outside a trace (or on a concrete array) this is a no-op returning the
    value unchanged — single-device eager semantics.  The distributed
    compiler honours the marker as a forced exchange point; the single-device
    compiler elides it.
    """
    t = active_trace()
    if t is not None and isinstance(field, TracedField):
        t.record_exchange(field, halo)
    return field


class tracing:
    """Context manager activating ``trace`` for the dynamic extent of a call."""

    def __init__(self, trace: Trace):
        self.trace = trace

    def __enter__(self) -> Trace:
        _active.append(self.trace)
        return self.trace

    def __exit__(self, *exc) -> None:
        _active.pop()
