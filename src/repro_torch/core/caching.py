"""Structural fingerprint cache for generated stencil modules.

Per the paper (§2.3): stencils are hashed so that *reformatting* the Python
source does not trigger re-codegen — the fingerprint is computed from the
(normalized) Definition IR, not from source text.  Generated modules are
written to a cache directory as real ``.py`` files (inspectable, steppable)
and re-imported on subsequent runs if the fingerprint matches.

The port keeps its own cache directory (``REPRO_TORCH_GT_CACHE``, default
``<repo>/.gt_cache_torch/``) and prefixes every generated module name with
``rt_``: the reference package computes identical fingerprints for the same
IR, backend and options, and both packages' modules may live in one process.
The ``cuda`` backend's fingerprint also carries ``codegen_cuda.CODEGEN_VERSION``
so that a change to the kernel generator rebuilds the shared libraries.
Programs (``program_fingerprint``), member-batched kernels
(``member_fingerprint``) and the autotuner's block variants
(``block_fingerprint``) are keyed on top of their stencils' fingerprints;
tuning records (``tuning_path``) on the stencil's own.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys
import threading
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Optional

from . import ir

_CACHE_VERSION = "repro-gt-2"
_MODULE_PREFIX = "rt_"
_lock = threading.Lock()
_memory_cache: Dict[str, ModuleType] = {}


def cache_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_GT_CACHE")
    if root:
        p = Path(root)
    else:
        p = Path(__file__).resolve().parents[3] / ".gt_cache_torch"
    p.mkdir(parents=True, exist_ok=True)
    return p


def fingerprint(
    definition: ir.StencilDefinition,
    backend: str,
    options: Optional[Dict[str, Any]] = None,
    pass_config: Optional[Dict[str, Any]] = None,
) -> str:
    """Cache key for a generated module.

    Keyed on the normalized Definition IR (so reformatting the python source
    does not re-codegen), the backend, its codegen options, AND the
    optimization-pass configuration: the same definition at a different
    ``opt_level`` / pass set is a different generated module.  The names of
    the registered passes participate too, so adding a pass to the pipeline
    invalidates stale artifacts.
    """
    from . import passes  # local import: passes depends on analysis/ir only

    version = _CACHE_VERSION
    if backend == "cuda":
        from .codegen_cuda import CODEGEN_VERSION

        version = f"{version}+{CODEGEN_VERSION}"
    payload = "|".join(
        [
            version,
            backend,
            repr(definition),
            repr(sorted((options or {}).items())),
            repr(sorted((pass_config or {}).items())),
            repr(passes.PASS_NAMES),
        ]
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def member_fingerprint(fp: str, member_scalars) -> str:
    """The fingerprint of a stencil's member-batched kernel: the stencil's own
    fingerprint and which of its scalars take one value a member."""
    payload = "|".join([fp, "members", repr(tuple(sorted(member_scalars)))])
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def program_fingerprint(
    name: str,
    graph_repr: str,
    part_fingerprints,
    backend: str,
    options: Optional[Dict[str, Any]] = None,
) -> str:
    """Cache key for a compiled *program* (``repro_torch.program``).

    Keyed on the structural dataflow-graph hash plus the fingerprints of the
    constituent (merged) stencils — so a program re-generates exactly when
    one of its stencils, the graph wiring, or the orchestration options
    change, and never when the step function is merely reformatted (the
    graph repr is built from IR-level facts, not source text)."""
    payload = "|".join(
        [
            _CACHE_VERSION,
            "program",
            name,
            backend,
            hashlib.sha256(graph_repr.encode()).hexdigest(),
            repr(tuple(part_fingerprints)),
            repr(sorted((options or {}).items())),
        ]
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def block_fingerprint(fp: str, block) -> str:
    """The fingerprint of a ``cuda`` stencil's kernel for another thread
    block than the one its module was generated for: ``BI`` and ``BJ`` are
    constants of the generated source, so each block the autotuner times is
    its own source, module and build."""
    payload = "|".join([fp, "block", "x".join(str(int(b)) for b in block)])
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def tuning_path(name: str, fp: str) -> Path:
    """Where the tile autotuner persists its result for a module.

    Lives alongside the generated ``rt_<name>_<fp>.py`` in the port's cache
    and shares its fingerprint, so a tuning record can never outlive the
    exact IR + options it was measured for (``core/autotune.py``)."""
    return cache_dir() / f"{module_key(name, fp)}.tune.json"


def module_key(name: str, fp: str) -> str:
    """The file stem of a generated module (and of its built kernel)."""
    return f"{_MODULE_PREFIX}{name}_{fp}"


def load_generated_module(name: str, fp: str, source: str, rebuild: bool = False) -> ModuleType:
    """Write ``source`` to the cache (if needed) and import it as a module."""
    key = module_key(name, fp)
    with _lock:
        if not rebuild and key in _memory_cache:
            return _memory_cache[key]
        module_name = f"_repro_gt_{key}"
        try:
            path = cache_dir() / f"{key}.py"
            if rebuild or not path.exists() or path.read_text() != source:
                # atomic: another process may import the same module meanwhile
                tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                tmp.write_text(source)
                os.replace(tmp, path)
            spec = importlib.util.spec_from_file_location(module_name, path)
            assert spec and spec.loader
            module = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = module
            spec.loader.exec_module(module)
        except OSError:
            # read-only filesystem: exec in-memory
            module = ModuleType(module_name)
            module.__dict__["__file__"] = f"<generated {key}>"
            exec(compile(source, f"<generated {key}>", "exec"), module.__dict__)
        _memory_cache[key] = module
        return module
