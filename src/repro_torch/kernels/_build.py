"""The port's hand-written CUDA kernels: build, load, launch, count.

Each kernel is one source file under ``kernels/<name>/csrc/`` with a plain C
entry point that launches on the stream it is given and returns
``cudaGetLastError()``.  :class:`HandKernel` compiles it with ``nvcc`` for
``sm_90a`` (``codegen_cuda.NvccLibrary``) into the port's cache directory
(``REPRO_TORCH_GT_CACHE``, default ``.gt_cache_torch/``) at first use, the
library named by a hash of the source so a stale build is never loaded.

Nothing is read, compiled or loaded when this module is imported: the CPU
tests import every module of the port, and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path
from typing import Any, Optional, Sequence

from repro_torch.core import caching, codegen_cuda


class HandKernel(codegen_cuda.CountedKernel):
    """One hand-written CUDA source and its C entry point ``symbol``.

    ``launches`` counts the calls that launched the kernel, and nothing else;
    ``codegen_cuda.launch_counts()``/``reset_launch_counts()`` see it beside
    the generated stencil kernels.
    """

    def __init__(self, key: str, source: Path, symbol: str, argtypes: Sequence[Any], flags: Sequence[str] = ()):
        self.key = key
        self.source = Path(source)
        self.flags = tuple(flags)  # nvcc flags beyond codegen_cuda.NVCC_FLAGS
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._library: Optional[codegen_cuda.NvccLibrary] = None
        self._fn = None
        codegen_cuda.register_kernel(self)

    @property
    def library(self) -> codegen_cuda.NvccLibrary:
        if self._library is None:
            digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode()).hexdigest()[:12]
            self._library = codegen_cuda.NvccLibrary(self.source, caching.cache_dir() / f"{self.key}.{digest}.so",
                                                     flags=self.flags)
        return self._library

    def start_build(self) -> None:
        self.library.start_build()

    def finish_build(self) -> None:
        self.library.finish_build()

    def launch(self, *args) -> None:
        """Call the entry point (one launch) and raise if CUDA refused it."""
        if self._fn is None:
            fn = getattr(self.library.load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.key}: launch failed with cudaError {rc}")
        self.launches += 1
