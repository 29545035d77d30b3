"""Forecast-as-a-service: compiled programs held hot, requests batched as
ensemble members, per-step state streamed back.

BEYOND PAPER.  The paper argues that embedding the stencil DSL in Python
buys "integration in complex workflows"; this package cashes that in by
*serving* compiled programs the way operational centers run them — a
persistent compute server instead of a batch script::

    from repro_torch.serving import ServingEngine
    from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields

    engine = ServingEngine(window_ms=2.0)
    fields, scalars = make_forecast_fields("cuda", (48, 48, 16))  # on the card
    step = build_forecast_step("cuda", (48, 48, 16))
    engine.register(step, fields=fields, scalars=scalars, request_fields=("phi",))
    # async context: engine.forecast("forecast_step", {"phi": state}, steps=10)

Modules: ``engine`` (admission + dynamic batching onto the ensemble member
axis, plus the resilience policies: backpressure, deadlines, retry-with-
bisect, health states), ``faults`` (deterministic fault injection for chaos
tests), ``protocol`` (JSON/base64 wire format, bit-exact float64), ``server``
(aiohttp websocket transport, optional dependency), ``client`` (in-process
and websocket drivers + the deterministic load generator).

The contract: serving K concurrent requests through one member-batched
launch per fused group is bit-identical (float64) to K sequential
per-request program runs (tests/test_torch_serving.py on the CPU,
tests/test_torch_serving_gpu.py on the card) — and that identity survives
dispatch failures, because retry-with-bisect resumes half-batches from
exactly-gathered member states (tests/test_torch_serving_faults.py).
(The reference package's ``repro/serving``; programs on the ``torch`` and
``cuda`` backends.)
"""

from . import client, faults, protocol
from .client import LoadReport, RequestResult, RequestSpec, drive_engine, drive_server, percentile
from .engine import (
    DEFAULT_MEMBER_COUNTS,
    DEGRADED,
    DRAINING,
    SERVING,
    ForecastRequest,
    ProgramEntry,
    ServingEngine,
    tuned_member_counts,
)
from .faults import FaultInjector, InjectedFault
from .scheduler import BatchingScheduler, EdfScheduler, FifoScheduler, make_scheduler
from .protocol import (
    DEADLINE_EXCEEDED,
    OVERLOADED,
    ServingError,
    decode_array,
    encode_array,
)

__all__ = [
    "BatchingScheduler",
    "DEADLINE_EXCEEDED",
    "DEFAULT_MEMBER_COUNTS",
    "DEGRADED",
    "DRAINING",
    "EdfScheduler",
    "FaultInjector",
    "FifoScheduler",
    "ForecastRequest",
    "InjectedFault",
    "LoadReport",
    "OVERLOADED",
    "ProgramEntry",
    "RequestResult",
    "RequestSpec",
    "SERVING",
    "ServingEngine",
    "ServingError",
    "client",
    "decode_array",
    "drive_engine",
    "drive_server",
    "encode_array",
    "faults",
    "make_scheduler",
    "percentile",
    "protocol",
    "tuned_member_counts",
]
