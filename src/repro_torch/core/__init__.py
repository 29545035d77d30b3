"""repro_torch.core — the paper's primary contribution: a GTScript-style embedded
stencil DSL with an IR-based analysis pipeline and code-generating backends
(debug | numpy | torch | cuda), on PyTorch and a generated Hopper kernel.
"""

from . import gtscript, passes, storage
from .gtscript import (
    BACKWARD,
    FORWARD,
    IJ,
    IJK,
    K,
    PARALLEL,
    Field,
    GTScriptSemanticError,
    GTScriptSyntaxError,
    computation,
    function,
    interval,
    lazy_stencil,
    stencil,
)
from .stencil import StencilObject, build_stencil_object

__all__ = [
    "gtscript",
    "passes",
    "storage",
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
    "StencilObject",
    "build_stencil_object",
    "GTScriptSyntaxError",
    "GTScriptSemanticError",
]
