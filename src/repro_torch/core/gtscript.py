"""User-facing GTScript symbols (the embedded DSL surface).

This module defines the names that appear *inside* stencil definition
functions (``computation``, ``interval``, ``PARALLEL``, ...) and the two
decorators ``@function`` and ``@stencil``.  Per the paper, GTScript is a
strict syntactic subset of Python: definition functions are parsed with the
stock ``ast`` module and are **never executed** as Python — the symbols here
exist so the source is importable, introspectable and IDE-friendly.
"""

from __future__ import annotations

import inspect
import textwrap
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .ir import IterationOrder

__all__ = [
    "Field",
    "IJK",
    "IJ",
    "K",
    "PARALLEL",
    "FORWARD",
    "BACKWARD",
    "computation",
    "interval",
    "function",
    "stencil",
    "lazy_stencil",
    "GTScriptFunction",
    "GTScriptSyntaxError",
    "GTScriptSemanticError",
]


class GTScriptSyntaxError(SyntaxError):
    """Raised when a definition function uses Python outside the GTScript subset."""


class GTScriptSemanticError(ValueError):
    """Raised when a syntactically valid stencil has invalid semantics
    (e.g. a race in a PARALLEL computation, paper §2.2)."""


# ---------------------------------------------------------------------------
# Axes / field type annotations
# ---------------------------------------------------------------------------

IJK = ("I", "J", "K")
IJ = ("I", "J")
K = ("K",)


class _FieldType:
    """Result of ``Field[dtype]`` / ``Field[dtype, axes]`` used in annotations."""

    def __init__(self, dtype: Any, axes: Tuple[str, ...] = IJK):
        self.dtype = np.dtype(dtype)
        self.axes = tuple(axes)

    def __repr__(self) -> str:
        return f"Field[{self.dtype}, {self.axes}]"


class _FieldMeta(type):
    def __getitem__(cls, item) -> _FieldType:
        if isinstance(item, tuple) and len(item) == 2 and isinstance(item[1], tuple):
            dtype, axes = item
            return _FieldType(dtype, axes)
        return _FieldType(item)


class Field(metaclass=_FieldMeta):
    """Annotation type for stencil field parameters: ``Field[np.float64]``."""


# ---------------------------------------------------------------------------
# In-body keywords (parsed, never executed)
# ---------------------------------------------------------------------------

PARALLEL = IterationOrder.PARALLEL
FORWARD = IterationOrder.FORWARD
BACKWARD = IterationOrder.BACKWARD


def _never_executed(name: str):
    def _fn(*_args, **_kwargs):
        raise RuntimeError(
            f"gtscript.{name}() is a DSL keyword: it is parsed from the stencil "
            "source and must not be called outside a stencil definition."
        )

    return _fn


computation = _never_executed("computation")
interval = _never_executed("interval")


# ---------------------------------------------------------------------------
# @gtscript.function
# ---------------------------------------------------------------------------


class GTScriptFunction:
    """A pure, inlinable GTScript function (paper Fig. 1, line 3).

    The wrapped Python function is parsed on demand; calls inside stencils
    are inlined by the frontend with additive offset composition (calling
    ``f(phi[1, 0, 0])`` where ``f`` reads ``arg[0, 1, 0]`` yields a read of
    ``phi[1, 1, 0]``).
    """

    def __init__(self, definition: Callable):
        self.definition = definition
        self.__name__ = definition.__name__
        self.__doc__ = definition.__doc__
        self._source: Optional[str] = None

    @property
    def source(self) -> str:
        if self._source is None:
            self._source = textwrap.dedent(inspect.getsource(self.definition))
        return self._source

    def __call__(self, *args, **kwargs):
        raise RuntimeError(
            f"GTScript function {self.__name__!r} can only be called from inside "
            "a stencil definition (it is inlined at compile time)."
        )

    def __repr__(self) -> str:
        return f"GTScriptFunction({self.__name__})"


def function(definition: Callable) -> GTScriptFunction:
    return GTScriptFunction(definition)


# ---------------------------------------------------------------------------
# @gtscript.stencil
# ---------------------------------------------------------------------------


def stencil(
    backend: str = "cuda",
    definition: Optional[Callable] = None,
    *,
    externals: Optional[Dict[str, Any]] = None,
    name: Optional[str] = None,
    rebuild: bool = False,
    validate_args: bool = True,
    **backend_opts: Any,
):
    """Compile a definition function into a :class:`StencilObject`.

    Parameters mirror the paper: ``backend`` selects the code generator
    (``debug`` | ``numpy`` | ``torch`` | ``cuda``, default ``cuda``: the
    generated Hopper kernel of ``codegen_cuda``), ``externals`` are
    compile-time constants, and ``rebuild`` bypasses the fingerprint cache.
    ``validate_args`` reproduces the run-time storage checks whose cost is
    the dashed-vs-solid gap in the paper's Fig. 3; pass ``False`` to skip.

    Extra ``backend_opts`` configure the optimization pass pipeline
    (``opt_level=0..3``, ``disable_passes=(...)``, ``enable_passes=(...)`` —
    see ``repro_torch.core.passes``) and backend codegen.  ``cuda`` only:
    ``block=(bi, bj)`` pins the thread-block tile.  ``autotune=True`` lets the
    tile autotuner (``core/autotune.py``) pick it at the first launch.
    """

    def _impl(func: Callable):
        # Imported lazily: frontend/codegen pull in heavier deps.
        from .stencil import build_stencil_object

        return build_stencil_object(
            definition=func,
            backend=backend,
            externals=dict(externals or {}),
            name=name or func.__name__,
            rebuild=rebuild,
            validate_args=validate_args,
            backend_opts=backend_opts,
        )

    if definition is not None:
        return _impl(definition)
    return _impl


def lazy_stencil(backend: str = "cuda", **kwargs):
    """Like :func:`stencil` but defers parsing/codegen to first call."""

    def _impl(func: Callable):
        class _Lazy:
            def __init__(self):
                self._obj = None
                self.__name__ = func.__name__

            def _build(self):
                if self._obj is None:
                    self._obj = stencil(backend, **kwargs)(func)
                return self._obj

            def __call__(self, *a, **kw):
                return self._build()(*a, **kw)

            def __getattr__(self, item):
                return getattr(self._build(), item)

        return _Lazy()

    return _impl
