"""Segmented decoder or encoder stack (port of ``repro.models.transformer``,
its decoder and encoder block kinds).

Block kinds:
  dense      : pre-norm GQA attn + pre-norm (G)MLP    (llama/qwen/smollm/chameleon)
  parallel   : one norm, attn + MLP in parallel        (command-r)
  moe        : pre-norm GQA attn + pre-norm MoE FFN    (qwen3-moe)
  mla_dense  : pre-norm MLA attn + pre-norm (G)MLP     (deepseek's first k)
  mla_moe    : pre-norm MLA attn + pre-norm MoE FFN    (deepseek)
  mlstm/slstm: pre-norm xLSTM block, residual          (xlstm)
  encoder    : bidirectional attn + MLP, pre-norm      (hubert; conv-pos input)

A model is a sequence of SEGMENTS, each a homogeneous run of blocks. The
reference stacks a segment's parameters along a leading 'layers' axis
for ``lax.scan``; the port keeps one parameter dict per layer in a list
and walks it with a Python loop (``bridge.params_from_numpy`` unstacks).
Rematerialisation follows ``cfg.remat``: ``"full"`` recomputes each
block's forward in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``), ``"selective"`` saves the products
without batch dimensions and recomputes the rest (``save_unbatched_products``,
the reference's ``dots_with_no_batch_dims_saveable``), ``"none"`` keeps
every activation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from . import moe, xlstm
from .layers import mlp_apply, mlp_specs, norm_apply, norm_specs

__all__ = ["Segment", "RECURRENT_KINDS", "segment_plan", "block_specs", "block_apply",
           "recurrent_block", "block_ffn", "ffn_apply",
           "run_segments", "save_unbatched_products"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


#: Block kinds whose state is recurrent (no sequence axis to rewind or page).
RECURRENT_KINDS = ("mlstm", "slstm")


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("parallel" if cfg.parallel_block else "dense", cfg.n_layers)]
    if cfg.family == "moe":
        k = cfg.moe.first_k_dense
        dense, sparse = ("mla_dense", "mla_moe") if cfg.mla is not None else ("dense", "moe")
        return ([Segment(dense, k)] if k else []) + [Segment(sparse, cfg.n_layers - k)]
    if cfg.family == "xlstm":
        # Runs of mLSTM blocks, one sLSTM block every ``slstm_every``.
        segs: List[Segment] = []
        run = 0
        for i in range(cfg.n_layers):
            if (i + 1) % cfg.xlstm.slstm_every == 0:
                if run:
                    segs.append(Segment("mlstm", run))
                    run = 0
                segs.append(Segment("slstm", 1))
            else:
                run += 1
        return segs + ([Segment("mlstm", run)] if run else [])
    if cfg.family in ("encoder", "audio"):
        return [Segment("encoder", cfg.n_layers)]
    raise ValueError(
        f"the port builds decoder and encoder stacks, xLSTM and Mamba2 hybrids (family "
        f"{cfg.family!r} is not ported yet)"
    )


def block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Pre-norm GQA or MLA attention, then a pre-norm (gated) MLP or MoE
    FFN; the parallel block has one norm for both; the encoder block is
    the dense one, its attention bidirectional. An xLSTM block is a
    pre-norm mixer."""
    d, dt = cfg.d_model, cfg.dtype
    if kind in RECURRENT_KINDS:
        mixer = xlstm.mlstm_specs(cfg) if kind == "mlstm" else xlstm.slstm_specs(cfg)
        return {"norm": norm_specs(d, cfg.norm, dt), "mixer": mixer}
    if kind not in ("dense", "parallel", "encoder", "moe", "mla_dense", "mla_moe"):
        raise ValueError(f"block kind {kind!r} is not ported yet")
    out = {"attn_norm": norm_specs(d, cfg.norm, dt),
           "attn": attn.mla_specs(cfg) if kind.startswith("mla") else attn.gqa_specs(cfg)}
    if kind != "parallel":
        out["mlp_norm"] = norm_specs(d, cfg.norm, dt)
    out["ffn"] = (moe.moe_specs(cfg) if kind in ("moe", "mla_moe")
                  else mlp_specs(d, cfg.d_ff, cfg.glu, dt))
    return out


def ffn_apply(params: Dict, h: torch.Tensor, cfg: ModelConfig,
              kind: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed ``h`` -> (out, router aux loss; None
    for a dense FFN, so that serving makes no zero on the card)."""
    if kind in ("moe", "mla_moe"):
        return moe.moe_apply(params["ffn"], h, cfg)
    return mlp_apply(params["ffn"], h, cfg.act, cfg.glu), None


def block_ffn(params: Dict, x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
              cfg: ModelConfig, kind: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rest of a block after its attention ``a`` of the normed ``h`` ->
    (x_out, aux_loss or None): the parallel block adds the FFN of the same
    ``h``; the others add ``a`` and then the FFN of the post-attention norm."""
    if kind == "parallel":
        f, aux = ffn_apply(params, h, cfg, kind)
        return x + a + f, aux
    x = x + a
    f, aux = ffn_apply(params, norm_apply(params["mlp_norm"], x, cfg.norm), cfg, kind)
    return x + f, aux


def recurrent_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    state: Optional[Dict] = None, mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """An xLSTM block: ``x`` plus its mixer of the pre-normed ``x`` ->
    (x_out, state). Without ``state`` the training forms (the mLSTM's
    parallel one); with one, a decode step that updates it in place,
    lanes where ``mask`` (B,) is False keeping theirs."""
    h = norm_apply(params["norm"], x, cfg.norm)
    if kind == "mlstm" and state is None:
        return x + xlstm.mlstm_apply(params["mixer"], h, cfg), None
    if kind == "mlstm":
        y, state = xlstm.mlstm_decode(params["mixer"], h, cfg, state, mask)
    else:
        y, state = xlstm.slstm_apply(params["mixer"], h, cfg, state=state, mask=mask)
    return x + y, state


def block_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward of one block -> (x_out, aux_loss): GQA attention
    through K1 (MLA through ``mea_attention``) and the FFN, each on a norm
    of the residual (K2 for RMSNorm); the parallel block adds both to
    ``x`` from one norm. An xLSTM block adds its mixer of the normed ``x``."""
    if kind in RECURRENT_KINDS:
        x, _ = recurrent_block(params, x, cfg, kind)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(params["attn_norm"], x, cfg.norm)
    if kind.startswith("mla"):
        a, _ = attn.mla_apply(params["attn"], h, cfg, positions=positions)
    else:
        a, _ = attn.gqa_apply(params["attn"], h, cfg, positions=positions)
    x, aux = block_ffn(params, x, h, a, cfg, kind)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def save_unbatched_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective remat's policy: save the outputs of matrix products
    without batch dimensions and recompute every other op.

    ``x @ W`` on a (B, S, D) activation lowers to ``aten.mm``; the
    projection einsums (``bsd,dhk->bshk``, ``bshk,hkd->bsd``) have no
    batch dimension either and lower to ``aten.bmm`` over a batch of 1.
    Products with batch dimensions (the MoE's per-expert ``bmm``, the
    attention's score and value products) are recomputed; on the card the
    attention products run inside K1, which no policy sees. A batched
    product whose batch is 1 (the CPU's plain K1 at one sequence and one
    kv head) is saved as well: that costs memory, never a value."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, cfg: ModelConfig) -> Callable:
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "selective":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    save_unbatched_products)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context)
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
