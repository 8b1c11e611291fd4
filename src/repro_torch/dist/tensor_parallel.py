"""Tensor-parallel compute over ``"model"``: the collectives GSPMD inserts
into the reference's train, prefill and decode steps when a product's
weight is cut along ``"model"`` (``DEFAULT_RULES``: heads, kv_heads, ffn
and vocab), or a decode cache's rows (``SP_DECODE_RULES``: act_kv_seq).

The dense decoders run on the rank's blocks of the TP-only layout
(``sharding.tp_rules``) under a ``sharding.tensor_parallel`` view:

  * a column-parallel product (``wq`` / ``wk`` / ``wv`` over heads,
    ``w_in`` / ``w_gate`` over ffn, the head over vocab) reads the
    replicated hidden through :func:`copy_to_tp` (identity forward; its
    backward sums the ranks' partial input gradients);
  * a row-parallel product (``wo`` over its heads input, ``w_out`` over
    ffn) gives a partial sum, made whole by :func:`reduce_from_tp`
    (``all_reduce`` forward, identity backward), before any term is added;
  * the embedding lookup and the cross-entropy run on the rank's vocab
    rows (:func:`vocab_parallel_embed`, :func:`vocab_parallel_ce`);
  * a decode step over a cache cut along its rows gathers the token's
    heads (:func:`gather_from_tp`), attends over the rank's rows (K3's
    partial form) and merges the ranks' partial softmaxes
    (:func:`merge_partials_over_tp`): distributed flash decode.

Every rank issues the same collectives in the same order: nothing here
branches on the rank. Outside a view, or on a mesh whose ``"model"`` has
size 1, every function is the identity (the single-device code).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import example_weights, masked_weighted_ce
from .sharding import current_tp, split_sum

__all__ = ["copy_to_tp", "reduce_from_tp", "gather_from_tp", "merge_partials_over_tp",
           "vocab_parallel_embed", "vocab_parallel_ce", "vocab_rows"]


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """``all_reduce`` (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """The replicated input of a column-parallel product: ``x`` itself,
    whose gradient is summed over ``"model"`` in the backward."""
    tp = current_tp()
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum made whole over ``"model"``."""
    tp = current_tp()
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def gather_from_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of ``x`` along ``dim``, where each rank of ``"model"`` holds
    an equal block of it in rank order (the token's q, k or v heads of a
    column-parallel projection): one ``all_gather``. Decode only: it
    carries no gradient."""
    tp = current_tp()
    if tp is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=dim)


def merge_partials_over_tp(out: torch.Tensor, lse: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """The softmax over every rank's rows from each rank's partial one:
    ``out`` f32 (..., D), the rank's normalised output over its rows, and
    ``lse`` f32 (...), their log-sum-exp (-inf where the rank holds no
    live row; K3's partial form). One ``all_reduce(MAX)`` of ``lse``,
    then one ``all_reduce(SUM)`` of ``[out * w, w]`` stacked, w = exp(lse
    - max), in f32, and the quotient rounded to ``dtype`` once. The
    largest lse is floored at the least finite f32, so a row live on no
    rank gives weights 0 and exact zeros, never NaN. B * H * (D + 1) values a layer:
    the work GSPMD inserts outside the reference's Pallas kernel, so it
    stays plain PyTorch. Outside a view (or at ``"model"`` = 1) ``out``
    rounded to ``dtype``."""
    tp = current_tp()
    if tp is None:
        return out.to(dtype)
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=tp.group)
    w = torch.exp(lse - top.clamp(min=torch.finfo(torch.float32).min))
    both = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    dist.all_reduce(both, group=tp.group)
    return (both[..., :-1] / both[..., -1:].clamp(min=1e-30)).to(dtype)


def vocab_rows(local: int) -> Tuple[int, int]:
    """(first, end) of the vocab rows the rank holds when it holds
    ``local`` of them (its block along ``"model"``)."""
    tp = current_tp()
    first = 0 if tp is None else tp.index * local
    return first, first + local


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table`` (V / m, D), the rank's vocab rows, looked up at ``ids``:
    ids outside them read row 0 and are zeroed, and the ranks' lookups are
    summed (each id's row comes from the one rank that holds it)."""
    first, end = vocab_rows(table.shape[0])
    ids = ids.long()
    mine = (ids >= first) & (ids < end)
    rows = table[torch.where(mine, ids - first, torch.zeros_like(ids))]
    return reduce_from_tp(rows * mine[..., None].to(rows.dtype))


def vocab_parallel_ce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    worker_mask: Optional[torch.Tensor] = None,
    *,
    vocab: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_weighted_ce`` over vocab-parallel ``logits`` (B, S, V / m),
    the rank's columns of the (B, S, ``vocab``) logits: the max over the
    vocab by ``all_reduce(MAX)`` and the sum of exp by ``all_reduce(SUM)``,
    both in f32; the gold logit from the rank that owns the label (summed
    with the exp sums in the same reduce). The same ``mask``,
    ``worker_mask`` weights and global ``denom``. Whole logits take
    ``masked_weighted_ce`` itself."""
    if current_tp() is None or logits.shape[-1] == vocab:
        return masked_weighted_ce(logits, labels, mask, worker_mask)
    w = torch.ones(labels.shape, dtype=torch.float32, device=logits.device) \
        if mask is None else mask.float()
    if worker_mask is not None:
        w = w * example_weights(worker_mask, labels.shape[0])[:, None]
    lf = logits.float()
    first, end = vocab_rows(lf.shape[-1])
    top = lf.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=current_tp().group)
    sumexp = torch.exp(lf - top[..., None]).sum(dim=-1)
    lab = labels.long()
    mine = (lab >= first) & (lab < end)
    gold = torch.gather(lf, -1, torch.where(mine, lab - first, torch.zeros_like(lab))[..., None])
    gold = gold[..., 0] * mine.to(lf.dtype)
    sumexp, gold = reduce_from_tp(torch.stack([sumexp, gold]))
    lse = top + torch.log(sumexp)
    nll = (lse - gold) * w
    denom = split_sum(w.sum())
    return nll.sum() / torch.clamp(denom, min=1.0), denom
