"""Serving: the retrieval engine and the continuous-batching runtime."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.runtime import (
    DeadlineExceeded,
    FleetServeMonitor,
    QueueFull,
    RuntimeConfig,
    ServeReply,
    ServeRuntime,
)

__all__ = ["ServeEngine", "DeadlineExceeded", "FleetServeMonitor", "QueueFull",
           "RuntimeConfig", "ServeReply", "ServeRuntime"]
