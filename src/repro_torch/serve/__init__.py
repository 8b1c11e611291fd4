"""repro_torch.serve — continuous-batching greedy serving over a slot pool
(contiguous stripes or a paged block arena), with a deterministic
event-clock scheduler and speculative decoding (draft, then verify, with
an adaptive draft length). Port of the core of ``repro.serve``."""

from .engine import EngineStats, ServeEngine, generate_offline, run_static
from .kv_pool import BlockManager, SlotPool
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket
from .speculative import DraftRunner, GammaPlan, SpecController, hedged_round_cost

__all__ = [
    "BlockManager", "CostModel", "DraftRunner", "EngineStats", "EventClock",
    "GammaPlan", "Request", "Scheduler", "ServeEngine", "SlotPool", "SpecController",
    "generate_offline", "hedged_round_cost", "next_bucket", "run_static",
]
