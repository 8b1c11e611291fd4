"""Step functions (port of ``repro.runtime.steps``): the train step and
the serving slot steps (prefill, decode, and the speculative verify and
replay).

Plain functions, no tracing: PyTorch runs eagerly, so each step is the
model call itself. The fastest-k worker mask, occupancy and ragged
lengths enter as data, as in the reference. The train step is
single-device: the reference's sharding arguments wait for the
multi-device slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dist.collectives import contributors, masked_weighted_ce
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, chunked_global_norm, clip_scale

__all__ = ["train_loss_fn", "make_train_step", "make_slot_prefill_step",
           "make_slot_decode_step", "make_slot_verify_step", "make_slot_replay_step"]


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like, is_leaf=torch.is_tensor)


def train_loss_fn(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    """The train step's loss -> (loss, {"ce", "aux", "denom"}): the masked
    fastest-k cross-entropy, plus ``router_aux_weight`` times the router
    loss for an MoE, plus 0.3 times DeepSeek's multi-token-prediction loss
    with ``cfg.mtp``. As in the reference, the MTP term is masked by
    ``batch["mask"]`` alone, not by ``worker_mask``: the stragglers' rows
    enter it."""
    cfg = model.cfg
    inputs, labels = batch["inputs"], batch["labels"]
    positions = torch.arange(labels.shape[1], device=labels.device)
    h, aux = model.hidden(params, inputs, positions)
    ce, denom = masked_weighted_ce(model.logits(params, h), labels,
                                   batch.get("mask"), batch.get("worker_mask"))
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        loss = loss + 0.3 * model.mtp_loss(params, h, inputs, labels, mask, positions)
    return loss, {"ce": ce, "aux": aux, "denom": denom}


def make_train_step(model: Model, optimizer: Optimizer, *,
                    clip_norm: Optional[float] = 1.0, accum_steps: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    batch = {inputs, labels, [mask], worker_mask, lr}.

    The loss is ``train_loss_fn``'s, over f32 logits. With ``accum_steps``
    = A > 1 the worker-major batch is split so that every worker's rows
    spread evenly over A microbatches; their gradients are summed in
    f32, each weighted by its contributed-token count ``denom``, and
    divided by the total (the reference's ``_grads_accum``, with a Python
    loop for ``lax.scan``). Gradients are clipped to global norm
    ``clip_norm`` (the norm summed a chunk of a leaf at a time) and the
    optimizer's ``step`` updates the parameters and its state IN PLACE,
    a leaf at a time (see ``repro_torch.optim``): the returned params
    are the given tensors. The metrics are ``loss``, ``ce``, ``aux``,
    ``denom``, ``grad_norm`` and ``contributors`` as 0-dim tensors."""

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, list]:
        """loss, metrics and the gradient tree (in the params' dtypes)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params, is_leaf=torch.is_tensor)]
        loss, metrics = train_loss_fn(model, _unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _unflatten(params, list(grads)))

    def grads_accum(params, batch):
        A = accum_steps
        n = batch["worker_mask"].shape[0]
        bw = batch["inputs"].shape[0] // n
        if bw % A:
            raise ValueError(f"per-worker batch {bw} not divisible by accum {A}")

        def resh(x):
            x = x.reshape(n, A, bw // A, *x.shape[1:]).transpose(0, 1)
            return x.reshape(A, n * (bw // A), *x.shape[3:])

        mb = {k: resh(batch[k]) for k in ("inputs", "labels", "mask")
              if batch.get(k) is not None}
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params, is_leaf=torch.is_tensor)
        dev = batch["labels"].device
        lsum = dsum = auxsum = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(A):
            micro = {k: v[a] for k, v in mb.items()}
            micro["worker_mask"] = batch["worker_mask"]
            loss, metrics, grads = grads_of(params, micro)
            w = metrics["denom"]
            gsum = tree_map(lambda s, g: s + w * g.float(), gsum, grads,
                            is_leaf=torch.is_tensor)
            lsum = lsum + w * loss
            dsum = dsum + w
            auxsum = auxsum + metrics["aux"]
        dsum = torch.clamp(dsum, min=1.0)
        grads = tree_map(lambda g: g / dsum, gsum, is_leaf=torch.is_tensor)
        loss = lsum / dsum
        return loss, {"ce": loss, "aux": auxsum / A, "denom": dsum}, grads

    def train_step(params, opt_state, batch):
        if accum_steps > 1:
            loss, metrics, grads = grads_accum(params, batch)
        else:
            loss, metrics, grads = grads_of(params, batch)
        gnorm = chunked_global_norm(grads)
        scale = clip_scale(gnorm, clip_norm) if clip_norm is not None else None
        with torch.no_grad():
            opt_state = optimizer.step(grads, opt_state, params, float(batch["lr"]), scale)
        wm = batch.get("worker_mask")
        metrics = dict(metrics)
        metrics.update(
            loss=loss, grad_norm=gnorm,
            contributors=contributors(wm) if wm is not None else torch.zeros(()),
        )
        return params, opt_state, metrics

    return train_step


def make_slot_prefill_step(model: Model) -> Callable:
    """Cache-writing batched prefill for the serving engine.

    (params, inputs (B, P) right-padded, caches, length (B,), start_index,
    [block_tables]) -> (last-valid logits (B, 1, V), caches).
    ``block_tables`` (B, T) routes the chunk's cache rows through paged
    arenas (None = contiguous slot stripes)."""

    @torch.no_grad()
    def slot_prefill_step(params, inputs, caches, length, start_index,
                          block_tables=None):
        return model.prefill_with_cache(
            params, inputs, caches, length=length, start_index=start_index,
            block_tables=block_tables,
        )

    return slot_prefill_step


def make_slot_decode_step(model: Model) -> Callable:
    """One decode tick over the whole slot pool.

    ``cache_index`` is the per-slot position vector (n_slots,) and
    ``mask`` (n_slots,) bool marks the decoding lanes. Free and
    mid-prefill lanes ride along: each writes one K/V row at its own
    position, which nothing reads before it is rewritten (a mid-prefill
    lane's position is where its next prefill chunk starts; a free lane is
    reset at admission; a dead paged lane's NULL table sends its write to
    the sink). A recurrent state (the hybrid's) would keep such a lane's
    token, so the model keeps the old state wherever ``mask`` is False; a
    dense model ignores ``mask``, and the engine sends None for it."""

    @torch.no_grad()
    def slot_decode_step(params, tokens, caches, cache_index, block_tables=None, mask=None):
        return model.decode_step(
            params, tokens, caches, cache_index, block_tables=block_tables, mask=mask,
        )

    return slot_decode_step


def make_slot_verify_step(model: Model) -> Callable:
    """Speculative verify over the whole slot pool: one call scores every
    lane's draft window at its own position.

    (params, tokens (B, S), caches, n_input (B,), positions (B,),
    [block_tables]) -> (greedy tokens (B, S) int32, caches). Per-lane
    draft lengths ride along as data (``n_input``: 0 = a free or
    mid-prefill lane, 1 = plain decode, 1 + gamma = speculating). The
    caches come back committed as ``Model.verify_with_cache`` says: the
    caller applies the exact-argmax rule to the greedy tokens and rewinds
    its per-slot positions to the accepted prefix."""

    @torch.no_grad()
    def slot_verify_step(params, tokens, caches, n_input, positions, block_tables=None):
        logits, caches = model.verify_with_cache(
            params, tokens, caches, n_input, positions, block_tables=block_tables,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return slot_verify_step


def make_slot_replay_step(model: Model) -> Callable:
    """The draft's resync after a verify round: commit exactly
    ``n_input`` known tokens a lane into the caches (no acceptance chain:
    the tokens are the committed stream). Same arguments as
    ``make_slot_verify_step``; returns only the caches."""

    @torch.no_grad()
    def slot_replay_step(params, tokens, caches, n_input, positions, block_tables=None):
        _, caches = model.verify_with_cache(
            params, tokens, caches, n_input, positions, block_tables=block_tables,
            greedy_commit=False,
        )
        return caches

    return slot_replay_step
