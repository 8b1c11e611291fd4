"""Assigned input-shape presets and per-(arch, shape) applicability (port
of ``repro.configs.shapes``).

Shapes are (seq_len, global_batch) with a step kind:
  train_4k    : train_step    seq 4096,   batch 256
  prefill_32k : prefill_step  seq 32768,  batch 32
  decode_32k  : decode_step   1 new token, KV/state cache of 32768, batch 128
  long_500k   : decode_step   1 new token, cache of 524288, batch 1
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "cell_status"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_status(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    spec = SHAPES[shape]
    if cfg.is_encoder and spec.kind == "decode":
        return "encoder-only arch has no autoregressive decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch; long_500k requires sub-quadratic "
            "attention (assignment directive; see DESIGN.md §6)"
        )
    return None
