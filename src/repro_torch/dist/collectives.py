"""Masked fastest-k aggregation (port of ``repro.dist.collectives``).

The central node only waits for the fastest k of n workers; the batch is
laid out WORKER-MAJOR (worker w owns the contiguous example slice
``[w * b_w, (w + 1) * b_w)``). The responding-worker mask enters the
loss as DATA, never as shape: per-example weights zero out the
stragglers' examples and the normalizer counts only contributed tokens,
so the masked step is EXACTLY the dense step on the k contributing
workers' examples (the paper's aggregation, eq. (2)).

Under a data-parallel row split (``sharding.split_rows``) each rank holds
some rows and the normalizer is the GLOBAL count: a rank whose workers
all straggled has no contributed token of its own, and its term is 0,
not a mean over nothing. The ranks' terms then sum to the global loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sharding import split_sum

__all__ = [
    "contributors",
    "check_worker_major",
    "example_weights",
    "masked_weighted_ce",
]


def contributors(worker_mask: torch.Tensor) -> torch.Tensor:
    """Number of workers whose gradients entered the step (k_effective)."""
    return worker_mask.float().sum()


def check_worker_major(batch: int, n_workers: int) -> int:
    """The mask-vs-batch layout contract. Returns rows per worker.

    A fastest-k mask is a length-``n_workers`` vector over the workers
    that produced THIS batch: the batch is worker-major and ``batch``
    must divide evenly into ``n_workers`` shares (a stale larger-fleet
    mask would misassign rows after the fleet shrinks)."""
    if n_workers < 1:
        raise ValueError(f"need at least one worker, got {n_workers}")
    if batch % n_workers != 0:
        raise ValueError(
            f"batch {batch} not divisible by n_workers {n_workers}; the "
            "worker-major layout requires equal per-worker shares (is the "
            "mask sized for the current fleet that produced this batch?)"
        )
    return batch // n_workers


def example_weights(worker_mask: torch.Tensor, batch: int) -> torch.Tensor:
    """Expand a (n_workers,) 0/1 mask to per-example f32 weights (batch,)."""
    if worker_mask.dim() != 1:
        raise ValueError(
            f"worker_mask must be 1-D over workers, got shape {tuple(worker_mask.shape)}"
        )
    per_worker = check_worker_major(batch, worker_mask.shape[0])
    return worker_mask.float().repeat_interleave(per_worker)


def masked_weighted_ce(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    worker_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over f32 logits with an optional per-token mask
    (B, S) and fastest-k worker mask (n_workers,).

    Returns ``(loss, denom)``: the mean NLL over contributed tokens and
    that token count, the weight that recombines gradient-accumulation
    microbatches. Under a row split, ``denom`` is summed over the split's
    ranks and ``loss`` is this rank's NLL sum over it."""
    w = torch.ones(labels.shape, dtype=torch.float32, device=logits.device) \
        if mask is None else mask.float()
    if worker_mask is not None:
        w = w * example_weights(worker_mask, labels.shape[0])[:, None]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * w
    denom = split_sum(w.sum())
    return nll.sum() / torch.clamp(denom, min=1.0), denom
