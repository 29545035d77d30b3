"""Hand-facing kernel entry points of the port: the DSL-generated CUDA
kernels for the paper's hdiff and vadv motifs (``ops.py``), each beside a
plain torch oracle (``ref.py``)."""
