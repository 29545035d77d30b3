"""Wire protocol for the forecast server: JSON text frames, bit-exact arrays.

Every frame is one JSON object with a ``"type"`` discriminator.  Arrays cross
the wire as ``{"shape", "dtype", "data"}`` where ``data`` is the base64 of the
raw C-order bytes — float64 state survives the round trip *bit-identically*,
which the serving contract (batched == sequential, exactly) depends on; a
decimal text encoding would quietly round it.

Client → server:

``forecast``
    ``{"type": "forecast", "request_id", "program", "steps", "stream_every",
    "fields": {name: array}, "scalars": {name: float}, "fingerprint"?,
    "stats"?, "deadline_ms"?, "priority"?}`` — submit one forecast request.
    ``priority`` is an integer urgency class in ``[0, priority_classes)``
    (lower is more urgent; the engine defaults omitted priorities to the
    normal class and rejects out-of-range values with 422); deadline-aware
    schedulers order the backlog by ``(priority, deadline)``.
``programs``
    ``{"type": "programs"}`` — ask for the catalog of registered programs.

Server → client (per request, in this order):

``accepted`` → ``step``* → ``done``, or ``error`` at any point.  ``step``
carries the streamed fields (encoded arrays), optional per-field statistics,
and the batch the dispatch rode (members / live requests / occupancy).
``done`` carries end-to-end telemetry: ``latency_s`` (submit → done on the
engine's monotonic clock) and ``queue_wait_s`` (submit → batching-window
pickup) — the same quantities the engine's metrics registry tracks as the
``serving_request_latency_seconds`` / ``serving_queue_wait_seconds``
summaries on ``GET /metrics``.

Admission errors reuse HTTP flavors so clients can switch on ``code``:
400 malformed frame, 404 unknown program, 409 fingerprint mismatch,
413 field shape/dtype mismatch, 422 bad scalars, step counts, or priority,
503 overloaded/draining (the frame carries ``retry_after_ms``), 504 deadline
exceeded — either at window pickup (the request died waiting in the queue and
was never dispatched) or at a segment boundary mid-horizon.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Optional

import numpy as np

#: admission / protocol error codes (HTTP-flavored, carried in "error" frames)
BAD_REQUEST = 400
UNKNOWN_PROGRAM = 404
FINGERPRINT_MISMATCH = 409
SHAPE_MISMATCH = 413
INVALID_VALUE = 422
INTERNAL = 500
OVERLOADED = 503  # admission queue full, or the engine is draining
DEADLINE_EXCEEDED = 504  # deadline expired at window pickup or a segment boundary


class ServingError(Exception):
    """An admission- or protocol-level rejection with an HTTP-flavored code.

    503 rejections carry ``retry_after_ms`` — the engine's estimate (from the
    watchdog's median dispatch wall and the queue depth) of when capacity
    frees up; well-behaved clients back off that long before retrying."""

    def __init__(self, code: int, reason: str, *, retry_after_ms: Optional[float] = None):
        super().__init__(f"[{code}] {reason}")
        self.code = int(code)
        self.reason = reason
        self.retry_after_ms = None if retry_after_ms is None else float(retry_after_ms)


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    """Array → JSON-safe spec; raw C-order bytes in base64 (bit-exact)."""
    arr = np.ascontiguousarray(arr)
    return {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "data": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def decode_array(spec: Any) -> np.ndarray:
    """JSON spec → array; structural problems are 400s, never exceptions."""
    if not isinstance(spec, dict) or not {"shape", "dtype", "data"} <= set(spec):
        raise ServingError(BAD_REQUEST, "array spec must be a {shape, dtype, data} object")
    try:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        raw = base64.b64decode(spec["data"])
        arr = np.frombuffer(raw, dtype=dtype)
    except (TypeError, ValueError) as e:
        raise ServingError(BAD_REQUEST, f"undecodable array spec: {e}") from None
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise ServingError(BAD_REQUEST, f"array payload holds {arr.size} elements, shape says {shape}")
    return arr.reshape(shape)


def parse_forecast(msg: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a ``forecast`` frame and decode it into ``engine.submit``
    keyword arguments.  Only structure is checked here — semantic admission
    (program existence, shapes, scalar names) belongs to the engine."""
    if not isinstance(msg.get("program"), str):
        raise ServingError(BAD_REQUEST, "forecast frame needs a string 'program'")
    fields_spec = msg.get("fields")
    if not isinstance(fields_spec, dict):
        raise ServingError(BAD_REQUEST, "forecast frame needs a 'fields' object")
    fields = {str(n): decode_array(spec) for n, spec in fields_spec.items()}
    scalars = msg.get("scalars", {})
    if not isinstance(scalars, dict):
        raise ServingError(BAD_REQUEST, "'scalars' must be an object of numbers")
    return {
        "program": msg["program"],
        "fields": fields,
        "scalars": {str(n): v for n, v in scalars.items()},
        "steps": msg.get("steps", 1),
        "stream_every": msg.get("stream_every", 1),
        "fingerprint": msg.get("fingerprint"),
        "request_id": msg.get("request_id"),
        "stats": bool(msg.get("stats", False)),
        "deadline_ms": msg.get("deadline_ms"),
        "priority": msg.get("priority"),
    }


def encode_event(ev: Dict[str, Any]) -> Dict[str, Any]:
    """Engine event → wire frame: numpy arrays in ``fields`` get encoded,
    everything else passes through as-is."""
    if "fields" not in ev:
        return ev
    out = dict(ev)
    out["fields"] = {n: encode_array(a) for n, a in ev["fields"].items()}
    return out


def decode_event(frame: Dict[str, Any]) -> Dict[str, Any]:
    """Wire frame → engine-shaped event (arrays decoded back to numpy)."""
    if "fields" not in frame:
        return frame
    out = dict(frame)
    out["fields"] = {n: decode_array(spec) for n, spec in frame["fields"].items()}
    return out


def error_frame(
    code: int,
    reason: str,
    request_id: Optional[str] = None,
    *,
    retry_after_ms: Optional[float] = None,
) -> Dict[str, Any]:
    frame: Dict[str, Any] = {"type": "error", "code": int(code), "reason": reason}
    if request_id is not None:
        frame["request_id"] = request_id
    if retry_after_ms is not None:
        frame["retry_after_ms"] = float(retry_after_ms)
    return frame


def loads(text: str) -> Dict[str, Any]:
    """Parse one frame; anything that is not a JSON object is a 400."""
    try:
        msg = json.loads(text)
    except ValueError as e:
        raise ServingError(BAD_REQUEST, f"frame is not valid JSON: {e}") from None
    if not isinstance(msg, dict) or "type" not in msg:
        raise ServingError(BAD_REQUEST, "frame must be a JSON object with a 'type'")
    return msg


def dumps(frame: Dict[str, Any]) -> str:
    return json.dumps(frame, separators=(",", ":"))
