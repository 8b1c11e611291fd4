"""repro_torch.serve — continuous-batching greedy serving over a slot pool
(contiguous stripes or a paged block arena), with a deterministic
event-clock scheduler. Port of the core of ``repro.serve``."""

from .engine import EngineStats, ServeEngine, generate_offline, run_static
from .kv_pool import BlockManager, SlotPool
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket

__all__ = [
    "BlockManager", "CostModel", "EngineStats", "EventClock", "Request",
    "Scheduler", "ServeEngine", "SlotPool", "generate_offline", "next_bucket",
    "run_static",
]
