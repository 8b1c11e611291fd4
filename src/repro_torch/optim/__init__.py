"""Optimizers of the training slices (plain tensor code)."""

from .optimizers import (
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    chunked_global_norm,
    clip_by_global_norm,
    clip_scale,
    get_optimizer,
    global_norm,
    momentum,
    sgd,
    tree_step,
)

__all__ = ["Optimizer", "adafactor", "adamw", "apply_updates", "chunked_global_norm",
           "clip_by_global_norm", "clip_scale", "get_optimizer", "global_norm", "momentum",
           "sgd", "tree_step"]
