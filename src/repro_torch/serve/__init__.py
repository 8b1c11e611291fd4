"""repro_torch.serve — continuous-batching greedy serving over a slot pool
(contiguous stripes or a paged block arena), with a deterministic
event-clock scheduler, speculative decoding (draft, then verify, with an
adaptive draft length), copy-on-write prefix sharing with
preempt-and-requeue, and request migration between engines by
checksummed slot snapshots. Port of the core of ``repro.serve``."""

from .engine import (
    EngineStats,
    MigrationTicket,
    ServeEngine,
    TicketIntegrityError,
    generate_offline,
    run_static,
    ticket_checksum,
)
from .kv_pool import ArenaExhausted, BlockManager, PrefixIndex, SlotPool, SlotSnapshot
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket
from .speculative import DraftRunner, GammaPlan, SpecController, hedged_round_cost

__all__ = [
    "ArenaExhausted", "BlockManager", "CostModel", "DraftRunner", "EngineStats",
    "EventClock", "GammaPlan", "MigrationTicket", "PrefixIndex", "Request", "Scheduler",
    "ServeEngine", "SlotPool", "SlotSnapshot", "SpecController", "TicketIntegrityError",
    "generate_offline", "hedged_round_cost", "next_bucket", "run_static", "ticket_checksum",
]
