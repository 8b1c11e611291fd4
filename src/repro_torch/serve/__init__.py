"""repro_torch.serve — continuous-batching greedy serving over a slot pool
(contiguous stripes or a paged block arena), with a deterministic
event-clock scheduler, speculative decoding (draft, then verify, with an
adaptive draft length), copy-on-write prefix sharing with
preempt-and-requeue, request migration between engines by checksummed
slot snapshots, and the multi-replica fleet: replicas with faultable
clocks (replica) behind a frontend (frontend) that dispatches hedged
copies priced by order statistics (router) over a faultable,
at-least-once message transport (transport). Port of ``repro.serve``."""

from .engine import (
    EngineStats,
    MigrationTicket,
    ServeEngine,
    TicketIntegrityError,
    generate_offline,
    run_static,
    ticket_checksum,
)
from .frontend import Frontend, FrontendRequest
from .kv_pool import ArenaExhausted, BlockManager, PrefixIndex, SlotPool, SlotSnapshot
from .replica import FaultyClock, Replica, ReplicaPort
from .router import DispatchOutcome, HedgedRouter, HedgePlan, ReplicaSet
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket
from .speculative import DraftRunner, GammaPlan, SpecController, hedged_round_cost
from .transport import FaultDirective, Partition, Transport, TransportFaults, TransportGaveUp

__all__ = [
    "ArenaExhausted", "BlockManager", "CostModel", "DispatchOutcome", "DraftRunner",
    "EngineStats", "EventClock", "FaultDirective", "FaultyClock", "Frontend",
    "FrontendRequest", "GammaPlan", "HedgePlan", "HedgedRouter", "MigrationTicket",
    "Partition", "PrefixIndex", "Replica", "ReplicaPort", "ReplicaSet", "Request",
    "Scheduler", "ServeEngine", "SlotPool", "SlotSnapshot", "SpecController",
    "TicketIntegrityError", "Transport", "TransportFaults", "TransportGaveUp",
    "generate_offline", "hedged_round_cost", "next_bucket", "run_static", "ticket_checksum",
]
