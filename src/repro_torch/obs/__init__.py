"""Tracing for the port: the reference's span tracer and head sampler.

:mod:`repro_torch.obs.trace` (nested spans on one monotonic clock, a no-op
fast path while off) and :mod:`repro_torch.obs.sampling` (deterministic head
sampling) are copies of the reference's modules; stencil builds and calls
open spans (``stencil.frontend`` … ``stencil.run``).
"""

from . import sampling, trace
from .sampling import SamplingPolicy, head_sampled
from .trace import NOOP_SPAN, Span, Tracer, capture, configure, monotonic, span, use_tracer

__all__ = [
    "NOOP_SPAN",
    "SamplingPolicy",
    "Span",
    "Tracer",
    "capture",
    "configure",
    "head_sampled",
    "monotonic",
    "sampling",
    "span",
    "trace",
    "use_tracer",
]
