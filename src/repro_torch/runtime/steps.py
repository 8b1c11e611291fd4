"""Serving step functions (port of ``repro.runtime.steps``' slot steps).

Plain functions, no tracing: PyTorch runs eagerly, so each step is the
model call itself. Occupancy and ragged lengths enter as data (per-slot
positions, per-row lengths), as in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model

__all__ = ["make_slot_prefill_step", "make_slot_decode_step"]


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

    ``cache_index`` is the per-slot position vector (n_slots,). Free and
    mid-prefill lanes ride along and need no mask: each writes one row at
    its own position, which nothing reads before it is rewritten. A
    mid-prefill lane's position is where its next prefill chunk starts; a
    free lane is reset at admission; a dead paged lane's NULL table sends
    its write to the sink. (The reference selects the old state back
    after the tick for recurrent caches, which this slice does not have.)"""

    @torch.no_grad()
    def slot_decode_step(params, tokens, caches, cache_index, block_tables=None):
        return model.decode_step(
            params, tokens, caches, cache_index, block_tables=block_tables,
        )

    return slot_decode_step
