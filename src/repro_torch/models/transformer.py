"""Segmented decoder stack (port of ``repro.models.transformer``, the
``dense`` block kind).

A model is a sequence of SEGMENTS, each a homogeneous run of blocks. The
reference stacks a segment's parameters along a leading 'layers' axis
for ``lax.scan``; the port keeps one parameter dict per layer in a list
and walks it with a Python loop (``bridge.params_from_numpy`` unstacks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import mlp_specs, norm_specs

__all__ = ["Segment", "segment_plan", "block_specs"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm") and not cfg.parallel_block:
        return [Segment("dense", cfg.n_layers)]
    raise ValueError(
        f"the port serves dense GQA decoders only (family {cfg.family!r}, "
        f"parallel_block={cfg.parallel_block} is not ported yet)"
    )


def block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Pre-norm GQA attention + pre-norm (gated) MLP."""
    if kind != "dense":
        raise ValueError(f"block kind {kind!r} is not ported yet")
    d, dt = cfg.d_model, cfg.dtype
    return {
        "attn_norm": norm_specs(d, cfg.norm, dt),
        "attn": attn.gqa_specs(cfg),
        "mlp_norm": norm_specs(d, cfg.norm, dt),
        "ffn": mlp_specs(d, cfg.d_ff, cfg.glu, dt),
    }
