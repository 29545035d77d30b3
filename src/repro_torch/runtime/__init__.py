"""Fault-tolerant runtime of the port: train state and step, the restartable
loop, the straggler watchdog, process supervision and gradient compression
(the reference's ``repro.runtime``)."""

from .compression import int8_compress, int8_decompress
from .loop import TrainState, Trainer, make_train_step
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
    "TrainState",
    "Trainer",
    "WatchdogStats",
    "http_ready",
    "int8_compress",
    "int8_decompress",
    "make_train_step",
    "serve_command",
]
