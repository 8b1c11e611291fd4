"""Slot-based cache pool, contiguous or paged (port of
``repro.serve.kv_pool``: ``SlotPool`` in its contiguous and
commit-at-admission paged modes, and a copy of ``BlockManager``; prefix
sharing and migration snapshots are not ported yet). It holds the dense
decoders' KV caches and the Mamba2 hybrid's recurrent states beside its
shared block's KV; a speculative engine keeps a second, contiguous pool
for its draft (``serve.speculative.DraftRunner``), whose snapshot clones
the leaves ``is_state_spec`` picks.

The pool owns one device-resident cache tree shaped for ``n_slots``
sequences of up to ``max_len`` tokens, built from ``model.cache_specs``.
Slot occupancy is host-side bookkeeping; device mutation goes through
the spec-driven slot helpers in ``repro_torch.models.layers``, in place.

With ``block_size`` set, every leaf with a sequence axis becomes a
global BLOCK ARENA shared by all slots (recurrent states, which have no
sequence axis, stay per-slot stripes), and a ``BlockManager`` maps each slot's rows to
arena blocks through a block table, so decode memory tracks live tokens
instead of ``n_slots * max_len`` reserved stripes.

Invariants (tested in tests/test_torch_serve.py):
  * a slot is in exactly one of {free, active};
  * ``positions[s]`` is the next cache write index of slot ``s``;
  * freeing resets bookkeeping immediately and lazily reuses device rows;
    paged mode returns the slot's blocks to the free pool INSTANTLY;
  * a block is owned by at most one slot; arena row 0 is the NULL sink
    (never allocated, absorbs masked-lane writes);
  * ``defrag()`` compacts active slots to the lowest indices, gathering
    only contiguous leaves — paged leaves never move.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import NULL_BLOCK, round_kv_len
from repro_torch.models.layers import (
    DTYPES,
    is_paged_spec,
    slot_read,
    slot_reset,
    slot_take,
    slot_write,
    tree_leaves,
)

__all__ = ["BlockManager", "SlotPool", "is_state_spec"]


def is_state_spec(spec) -> bool:
    """A recurrent state leaf: per slot, with no sequence axis."""
    return not is_paged_spec(spec) and "act_kv_seq" not in spec.axes


class BlockManager:
    """Host-side block allocator: one global arena of ``num_blocks``
    usable blocks (arena row 0 is the NULL sink) and one block table row
    per slot. Purely bookkeeping — device scatter/gather reads ``tables``
    as data.

    Two-level discipline (memory-proportional and deadlock-free):

      * **commit** — admission charges a slot's whole token budget
        against the arena (``sum(committed) <= num_blocks`` always), so a
        slot can ALWAYS grow to its budget: decode never stalls on blocks;
      * **append** — blocks are physically allocated lazily, one block at
        a time, as rows are actually written, so the used high-water
        tracks LIVE tokens, not reserved budgets.
    """

    def __init__(self, n_slots: int, n_rows: int, block_size: int, num_blocks: int):
        if n_rows % block_size:
            raise ValueError(
                f"block_size={block_size} must divide the (aligned) cache "
                f"rows {n_rows} so paged views match contiguous shapes"
            )
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.table_width = n_rows // block_size
        #: (n_slots, T) int32 arena indices; NULL_BLOCK marks unallocated.
        self.tables = np.full((n_slots, self.table_width), NULL_BLOCK, np.int32)
        # LIFO free list over ids 1..num_blocks (0 is the sink).
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self._budget: List[int] = [0] * n_slots   # committed blocks per slot
        self.used_high_water = 0

    # -- accounting ----------------------------------------------------------
    @property
    def n_free_blocks(self) -> int:
        return len(self._free)

    @property
    def n_used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def n_committed_blocks(self) -> int:
        return sum(self._budget)

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(max(int(n_tokens), 0) / self.block_size)

    def can_commit(self, n_tokens: int) -> bool:
        """Admission test: the request's whole budget must fit beside
        every already-committed budget, and inside one slot's table."""
        need = self.blocks_for(n_tokens)
        if need > self.table_width:
            return False
        return self.n_committed_blocks + need <= self.num_blocks

    # -- commit / append / free ----------------------------------------------
    def commit(self, slot: int, n_tokens: int) -> None:
        """Charge ``slot``'s lifetime token budget against the arena (no
        blocks move yet). Raises when over-committed — callers gate
        admission on :meth:`can_commit`."""
        need = self.blocks_for(n_tokens)
        if need > self.table_width:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > table width "
                f"{self.table_width} (slot capacity)"
            )
        if self.n_committed_blocks - self._budget[slot] + need > self.num_blocks:
            raise ValueError(
                f"arena over-committed: budget {need} blocks on top of "
                f"{self.n_committed_blocks - self._budget[slot]} committed "
                f"(capacity {self.num_blocks})"
            )
        self._budget[slot] = max(self._budget[slot], need)

    def append(self, slot: int, n_rows: int) -> None:
        """Grow ``slot``'s table to physically cover ``n_rows`` rows
        (append-only; no-op when covered). Never exceeds the slot's
        committed budget, so the free list cannot run dry."""
        want = self.blocks_for(n_rows)
        owned = self._owned[slot]
        if want > self._budget[slot]:
            raise ValueError(
                f"slot {slot}: {n_rows} rows need {want} blocks > "
                f"committed budget {self._budget[slot]}"
            )
        while len(owned) < want:
            bid = self._free.pop()
            self.tables[slot, len(owned)] = bid
            owned.append(bid)
        self.used_high_water = max(self.used_high_water, self.n_used_blocks)

    def free(self, slot: int) -> None:
        """Return every block ``slot`` owns to the free list, release its
        budget, and point its table at the NULL sink. (Stale rows are never
        read again: reads mask by length, and reallocation overwrites.)"""
        owned = self._owned[slot]
        self._free.extend(reversed(owned))
        owned.clear()
        self._budget[slot] = 0
        self.tables[slot, :] = NULL_BLOCK

    def permute(self, order: np.ndarray) -> None:
        """Remap slot indices (pool defrag) — pure host bookkeeping."""
        self.tables = self.tables[order]
        self._owned = [self._owned[int(o)] for o in order]
        self._budget = [self._budget[int(o)] for o in order]

    def audit(self) -> List[str]:
        """Every allocator-invariant violation as a message list (empty
        = healthy)."""
        errs: List[str] = []
        owned_all: Dict[int, int] = {}
        for slot, owned in enumerate(self._owned):
            if len(owned) > self._budget[slot]:
                errs.append(f"slot {slot} holds {len(owned)} blocks over "
                            f"its budget {self._budget[slot]}")
            if list(self.tables[slot, : len(owned)]) != owned:
                errs.append(f"slot {slot} table/owned mismatch")
            if any(t != NULL_BLOCK for t in self.tables[slot, len(owned):]):
                errs.append(f"slot {slot} has table entries past its owned blocks")
            for b in owned:
                if not (NULL_BLOCK < b <= self.num_blocks):
                    errs.append(f"bad block id {b}")
                    continue
                owned_all[b] = owned_all.get(b, 0) + 1
        for b, n in owned_all.items():
            if n > 1:
                errs.append(f"block {b} owned twice")
        free = set(self._free)
        if len(free) != len(self._free):
            errs.append("duplicate ids in free list")
        if not free.isdisjoint(owned_all):
            errs.append("block both free and owned")
        if free | set(owned_all) != set(range(1, self.num_blocks + 1)):
            errs.append("leaked blocks: free + owned != capacity")
        if self.n_committed_blocks > self.num_blocks:
            errs.append("over-committed")
        if self.used_high_water < self.n_used_blocks:
            errs.append("high-water below current live blocks")
        return errs

    def check(self) -> None:
        """Raise on any allocator-invariant violation (test hook)."""
        errs = self.audit()
        if errs:
            raise AssertionError("; ".join(errs))


class SlotPool:
    def __init__(
        self,
        model,
        n_slots: int,
        max_len: int,
        *,
        block_size: Optional[int] = None,
        arena_blocks: Optional[int] = None,
        device="cuda",
    ):
        """``block_size`` switches the cache leaves to a paged arena of
        ``arena_blocks`` blocks (default: full capacity,
        ``n_slots * rows / block_size`` — undersize it to serve under an
        explicit memory budget with admit-by-budget queuing)."""
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.rows = round_kv_len(max_len)   # aligned per-slot row capacity
        self.block_size = block_size
        self.paged = block_size is not None
        if self.paged:
            if arena_blocks is None:
                arena_blocks = n_slots * math.ceil(self.rows / block_size)
            self.manager: Optional[BlockManager] = BlockManager(
                n_slots, self.rows, block_size, arena_blocks
            )
        else:
            arena_blocks = 0
            self.manager = None
        self.specs = model.cache_specs(
            n_slots, max_len, block_size=block_size, num_blocks=arena_blocks
        )
        self.caches = model.blank_caches(
            n_slots, max_len, block_size=block_size, num_blocks=arena_blocks,
            device=self.device,
        )
        self._spec_leaves = tree_leaves(self.specs)
        self._any_contiguous = any(not is_paged_spec(s) for s in self._spec_leaves)
        #: Whether the caches carry recurrent state (leaves with a slot
        #: axis and no sequence axis), which the decode tick must mask.
        self.recurrent = any(is_state_spec(s) for s in self._spec_leaves)
        # Host-side occupancy. Free slots are handed out lowest-index
        # first so the engine's active lanes stay dense without defrag.
        self.positions = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.owner: List[Optional[int]] = [None] * n_slots

    # -- occupancy -----------------------------------------------------------
    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return self.n_slots - self.n_active

    def can_admit(self, n_tokens: int) -> bool:
        """Admission test: a free slot AND (paged) room to commit the
        request's whole token budget."""
        if self.n_free == 0:
            return False
        return not self.paged or self.manager.can_commit(n_tokens)

    def allocate(self, owner: Optional[int] = None,
                 n_tokens: Optional[int] = None) -> Optional[int]:
        """Claim the lowest free slot (or None when full / over-committed).
        Paged pools commit ``n_tokens`` rows of budget at admission; blocks
        are appended lazily as rows are written (:meth:`ensure_rows`)."""
        free = np.nonzero(~self.active)[0]
        if free.size == 0:
            return None
        slot = int(free[0])
        if self.paged:
            budget = self.rows if n_tokens is None else int(n_tokens)
            if not self.manager.can_commit(budget):
                return None
            self.manager.commit(slot, budget)
        self.active[slot] = True
        self.owner[slot] = owner
        self.positions[slot] = 0
        return slot

    def ensure_rows(self, slot: int, n_rows: int) -> None:
        """Lazily append blocks so ``slot`` physically covers ``n_rows``
        cache rows (no-op for contiguous pools and covered slots)."""
        if self.paged:
            self.manager.append(slot, n_rows)

    def free(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.owner[slot] = None
        self.positions[slot] = 0
        if self.paged:
            self.manager.free(slot)

    # -- paged bookkeeping ---------------------------------------------------
    def tables_device(self, slot: Optional[int] = None) -> Optional[torch.Tensor]:
        """Block tables as int32 device data — all slots (n_slots, T) for
        the decode tick, or one (1, T) row for a slot's prefill."""
        if not self.paged:
            return None
        t = self.manager.tables if slot is None else self.manager.tables[slot:slot + 1]
        return torch.as_tensor(t, device=self.device)

    # -- memory accounting ---------------------------------------------------
    def kv_bytes_per_block(self) -> int:
        """Bytes one arena block occupies across every paged leaf."""
        total = 0
        for s in self._spec_leaves:
            if is_paged_spec(s):
                n_arena = s.shape[s.axes.index("kv_blocks")]
                total += s.size // n_arena * DTYPES[s.dtype].itemsize
        return total

    def kv_bytes_contiguous(self) -> int:
        """What the cache leaves would occupy as contiguous
        ``n_slots * rows`` stripes."""
        if self.paged:
            return self.kv_bytes_per_block() * (self.rows // self.block_size) * self.n_slots
        return sum(s.size * DTYPES[s.dtype].itemsize for s in self._spec_leaves
                   if "act_kv_seq" in s.axes)

    def state_bytes_per_slot(self) -> int:
        """Bytes of recurrent state one slot holds (0 for KV-only caches)."""
        return sum(s.size * DTYPES[s.dtype].itemsize for s in self._spec_leaves
                   if is_state_spec(s)) // self.n_slots

    def kv_bytes_high_water(self) -> int:
        """High-water mark of arena bytes actually reserved (+ the NULL
        sink block)."""
        if not self.paged:
            return self.kv_bytes_contiguous()
        return (self.manager.used_high_water + 1) * self.kv_bytes_per_block()

    # -- device-side slot ops ------------------------------------------------
    def read_slot(self, slot: int):
        """Batch-1 cache tree for one slot: views into the pool for
        contiguous leaves (writes through them land in the pool), the
        arenas themselves for paged leaves."""
        return slot_read(self.caches, self.specs, slot)

    def write_slot(self, slot: int, slot_caches, position: int) -> None:
        """Install a batch-1 cache (a prefill result) into ``slot`` (no copy
        when it is the pool's own view) and record its next write position."""
        slot_write(self.caches, self.specs, slot, slot_caches)
        self.positions[slot] = position

    def reset_slot(self, slot: int) -> None:
        """Restore one slot's contiguous rows to the spec init values, in
        place. Paged leaves are untouched — stale blocks are recycled."""
        slot_reset(self.caches, self.specs, slot)
        self.positions[slot] = 0

    def defrag(self) -> Dict[int, int]:
        """Compact active slots to the lowest indices (one gather over the
        CONTIGUOUS leaves; paged leaves only permute their host-side block
        tables). Returns the {old_slot: new_slot} moves applied to live
        slots. An engine holding per-slot state on top of this pool must
        remap it — use ``ServeEngine.defrag()`` on a live engine."""
        order = np.concatenate(
            [np.nonzero(self.active)[0], np.nonzero(~self.active)[0]]
        ).astype(np.int64)
        moves = {int(old): new for new, old in enumerate(order) if int(old) != new}
        if not moves:
            return {}
        if self._any_contiguous:
            self.caches = slot_take(self.caches, self.specs,
                                    torch.as_tensor(order, device=self.device))
        if self.paged:
            self.manager.permute(order)
        self.positions = self.positions[order]
        self.active = self.active[order]
        self.owner = [self.owner[int(old)] for old in order]
        return {old: new for old, new in moves.items() if self.active[new]}
