"""Step functions, the adaptive-(k, beta) training loop, checkpoints,
fault schedules and straggler telemetry of the port."""

from .checkpoint import CheckpointError, CheckpointManager
from .faults import FaultEvent, schedule_by_step
from .steps import make_slot_decode_step, make_slot_prefill_step, make_train_step
from .telemetry import StragglerTracker
from .train_loop import TrainLoopConfig, train

__all__ = [
    "CheckpointError", "CheckpointManager", "FaultEvent", "StragglerTracker",
    "TrainLoopConfig", "make_slot_decode_step", "make_slot_prefill_step",
    "make_train_step", "schedule_by_step", "train",
]
