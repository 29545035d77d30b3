"""Process supervision and the straggler watchdog of the forecast server
(``supervise.py``).  The reference's training loop and gradient compression
(``runtime/loop.py``, ``runtime/compression.py``) are not ported yet."""

from .supervise import (
    RestartPolicy,
    StragglerWatchdog,
    Supervisor,
    SupervisorGaveUp,
    WatchdogStats,
    http_ready,
    serve_command,
)

__all__ = [
    "RestartPolicy",
    "StragglerWatchdog",
    "Supervisor",
    "SupervisorGaveUp",
    "WatchdogStats",
    "http_ready",
    "serve_command",
]
