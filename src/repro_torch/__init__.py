"""repro_torch — the GT4Py-style stencil toolchain on PyTorch and CUDA.

The PyTorch port of the ``repro`` package: the same GTScript frontend, IR,
analysis and pass pipeline, with ``torch`` (plain tensor code) and ``cuda``
(a generated Hopper kernel per stencil) backends; and the LM substrate's
serving path (``configs``, ``models``) with hand-written Hopper kernels for
flash attention and the RG-LRU scan (``kernels``).  It imports neither JAX
nor the ``repro`` package.
"""
