"""Optimizers of the training slice (plain tensor code)."""

from .optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    sgd,
)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm", "get_optimizer",
           "global_norm", "sgd"]
