"""Telemetry for the port: the reference's tracer, sampler, metrics,
exporters, SLOs and flight recorder.

* :mod:`repro_torch.obs.trace` — nested spans on one monotonic clock, a
  no-op fast path while off, per-request trace-id correlation; while a
  ``torch.profiler`` session records, every span is also a
  ``record_function`` range in the profile, whether the tracer is on or off.
* :mod:`repro_torch.obs.sampling` — deterministic head sampling per request id.
* :mod:`repro_torch.obs.metrics` — counters, gauges and streaming-quantile
  histograms with Prometheus text export (the serving engine's ``stats()``).
* :mod:`repro_torch.obs.slo` — per-program objectives with multi-window
  burn-rate alerts and the autoscaling recommendation.
* :mod:`repro_torch.obs.flight` — the failure flight recorder (JSON bundles
  carrying the torch version, its CUDA version and the card's name).
* :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON.

Copies of the reference package's ``repro/obs`` modules, except for the
profiler bridge and the flight recorder's version snapshot.  The tracer's
buffer is off by default; arm it with ``REPRO_TRACE=1``, ``serve
--trace-out``, or per stencil call via ``exec_info={"trace": True}``.  The
profiler bridge needs no arming: a ``torch.profiler`` session turns it on.
"""

from . import export, flight, metrics, sampling, slo, trace
from .export import chrome_trace, validate_chrome_trace, write_chrome_trace
from .flight import FlightRecorder, load_bundle, validate_flight_bundle
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .sampling import SamplingPolicy, head_sampled
from .slo import Autoscaler, BurnRule, Objective, SloEngine
from .trace import NOOP_SPAN, Span, Tracer, capture, configure, monotonic, span, use_tracer

__all__ = [
    "Autoscaler",
    "BurnRule",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOOP_SPAN",
    "Objective",
    "SamplingPolicy",
    "SloEngine",
    "Span",
    "Tracer",
    "capture",
    "chrome_trace",
    "configure",
    "export",
    "flight",
    "head_sampled",
    "load_bundle",
    "metrics",
    "monotonic",
    "sampling",
    "slo",
    "span",
    "trace",
    "use_tracer",
    "validate_chrome_trace",
    "validate_flight_bundle",
    "write_chrome_trace",
]
