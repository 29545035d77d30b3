"""Hand-facing kernel entry points of the port, each beside a plain torch
oracle (``ref.py``): the DSL-generated CUDA kernels for the paper's hdiff and
vadv motifs, and the hand-written CUDA kernels (``*/csrc/*.cu``, built by
``_build.py``) for flash attention and the RG-LRU scan."""
