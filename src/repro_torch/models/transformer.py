"""Segmented decoder stack (port of ``repro.models.transformer``, the
``dense`` block kind).

A model is a sequence of SEGMENTS, each a homogeneous run of blocks. The
reference stacks a segment's parameters along a leading 'layers' axis
for ``lax.scan``; the port keeps one parameter dict per layer in a list
and walks it with a Python loop (``bridge.params_from_numpy`` unstacks).
Rematerialisation follows ``cfg.remat``: ``"full"`` recomputes each
block's forward in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``), ``"none"`` keeps every activation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import mlp_apply, mlp_specs, norm_apply, norm_specs

__all__ = ["Segment", "segment_plan", "block_specs", "block_apply", "run_segments"]


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


def block_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward of one block -> (x_out, aux_loss): pre-norm GQA
    attention through K1, then the pre-norm (gated) MLP; both norms K2."""
    if kind != "dense":
        raise ValueError(f"block kind {kind!r} is not ported yet")
    h = norm_apply(params["attn_norm"], x, cfg.norm)
    a, _ = attn.gqa_apply(params["attn"], h, cfg, positions=positions)
    x = x + a
    h = norm_apply(params["mlp_norm"], x, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_apply(params["ffn"], h, cfg.act, cfg.glu), aux


def _remat_wrap(fn: Callable, cfg: ModelConfig) -> Callable:
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "selective":
        raise NotImplementedError("remat='selective' is not ported yet")
    raise ValueError(f"unknown remat {cfg.remat}")


def run_segments(seg_params: List[List[Dict]], segs: List[Segment], x: torch.Tensor,
                 cfg: ModelConfig, *, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward through all segments, one (rematerialised) block at a time."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layers, seg in zip(seg_params, segs):
        body = _remat_wrap(
            lambda p, h, kind=seg.kind: block_apply(p, h, cfg, kind, positions=positions),
            cfg,
        )
        for layer in layers:
            x, aux = body(layer, x)
            total_aux = total_aux + aux
    return x, total_aux
