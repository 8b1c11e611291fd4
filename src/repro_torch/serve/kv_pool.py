"""Slot-based cache pool, contiguous or paged (port of
``repro.serve.kv_pool``: ``SlotPool`` in its contiguous, commit-at-admission
paged and copy-on-write prefix-sharing modes, with slot snapshots for
migration; ``BlockManager`` with refcounts, adopt and fork; and
``PrefixIndex``). It holds the dense decoders' KV caches and the Mamba2
hybrid's recurrent states beside its shared block's KV; a speculative
engine keeps a second, contiguous pool for its draft
(``serve.speculative.DraftRunner``), whose snapshot clones the leaves
``is_state_spec`` picks.

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

Copy-on-write prefix sharing (``prefix_sharing=True``): every block
carries a REFCOUNT, the number of slot tables naming it. A
:class:`PrefixIndex` trie maps full-block prompt prefixes to resident
blocks, so a new request ADOPTS a matching chain instead of recomputing
it, and a write into a block with refcount > 1 must FORK it first: a
fresh block, an in-place device copy (``slot_block_copy``) and a table
swap, so the writer scatters into a private clone while readers keep the
original. ``append`` and ``fork`` can then raise :class:`ArenaExhausted`,
and the engine answers by preempting a lane. Invariants (tested in
tests/test_torch_prefix.py against the reference, randomized):
  * refcount[b] == number of live table references to b, for every b;
  * a block written through a slot's table has refcount 1;
  * a block returns to the free list exactly once, when its LAST
    reference drops (free and referenced partition {1..num_blocks});
  * ``used_high_water`` tracks the max of UNIQUE live blocks.

A :class:`SlotSnapshot` holds COPIES of one slot's leaves (the pool's
caches change in place, so a view would be rewritten by the slot's next
tenant): its contiguous leaves cloned, its owned arena blocks gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import NULL_BLOCK, round_kv_len
from repro_torch.models.layers import (
    DTYPES,
    batch_axis_of,
    is_paged_spec,
    slot_block_copy,
    slot_read,
    slot_reset,
    slot_take,
    slot_write,
    tree_leaves,
    tree_map,
)

__all__ = [
    "ArenaExhausted", "BlockManager", "PrefixIndex", "SlotPool", "SlotSnapshot",
    "is_state_spec",
]


def is_state_spec(spec) -> bool:
    """A recurrent state leaf: per slot, with no sequence axis."""
    return not is_paged_spec(spec) and "act_kv_seq" not in spec.axes


class ArenaExhausted(RuntimeError):
    """A sharing-mode allocation (a lazy append or a copy-on-write fork)
    found the free list empty. Never raised in commit-at-admission mode,
    where the admission-time budget check makes exhaustion impossible;
    under prefix sharing the engine catches it and preempts a lane."""


@dataclasses.dataclass(frozen=True)
class SlotSnapshot:
    """One slot's cache state, detached from any pool: the unit of
    in-flight request migration between engines.

    ``data`` mirrors the pool's spec tree: contiguous leaves (recurrent
    states, or KV rows of an unpaged pool) are batch-1 copies; paged
    leaves are the slot's OWNED ARENA BLOCKS gathered block-major along
    the ``kv_blocks`` axis (``n_blocks`` on that axis). Restoring into a
    pool of the same geometry scatters those blocks into freshly
    allocated destination blocks: a block-table handoff, not a
    recompute. Every leaf is a copy, never a view of the pool."""

    data: Any                 # tree matching the pool's spec tree
    position: int             # next cache write index of the slot
    n_blocks: int             # owned arena blocks captured (0 = unpaged)
    block_size: Optional[int]
    rows: int                 # per-slot row capacity (geometry check)


class _TrieNode:
    __slots__ = ("key", "bid", "parent", "children")

    def __init__(self, key, bid, parent):
        self.key = key          # tuple of block_size tokens (root: None)
        self.bid = bid          # arena block holding these rows (root: None)
        self.parent = parent
        self.children: Dict[tuple, "_TrieNode"] = {}


class PrefixIndex:
    """Radix-style trie over FULL prompt blocks: each node is one
    ``block_size``-token chunk, its path from the root is the full token
    prefix, and its payload is the resident arena block holding exactly
    those rows. At admission the longest root chain matching a new prompt
    is adopted into the request's block table instead of being recomputed.

    Only full PROMPT blocks are registered (generated tokens are private
    to their stream), and a node dies the moment its block's last
    reference drops (``forget``, driven by the pool's ``free``). Adopters
    take whole root chains, so a live descendant implies live ancestors."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _TrieNode(None, None, None)
        self._by_bid: Dict[int, _TrieNode] = {}

    def __len__(self) -> int:
        return len(self._by_bid)

    def _chunks(self, tokens) -> List[tuple]:
        toks = [int(t) for t in tokens]
        bs = self.block_size
        return [tuple(toks[i:i + bs]) for i in range(0, len(toks) - len(toks) % bs, bs)]

    def match(self, tokens) -> List[int]:
        """Block ids of the longest resident full-block prefix of
        ``tokens`` (root-down chain; possibly empty)."""
        node, bids = self.root, []
        for key in self._chunks(tokens):
            node = node.children.get(key)
            if node is None:
                break
            bids.append(node.bid)
        return bids

    def register(self, tokens, bids: Sequence[int]) -> int:
        """Record that ``bids[k]`` holds the k-th full block of ``tokens``.
        Chunks already present keep their incumbent block (of two identical
        prompts racing through prefill the first registration wins and the
        other's blocks stay private). Returns how many nodes were created."""
        node, created = self.root, 0
        for key, bid in zip(self._chunks(tokens), bids):
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, int(bid), node)
                node.children[key] = child
                self._by_bid[int(bid)] = child
                created += 1
            node = child
        return created

    def forget(self, bid: int) -> None:
        """Evict the node holding ``bid`` (its block's last reference
        dropped and it returned to the free list)."""
        node = self._by_bid.pop(int(bid), None)
        if node is None:
            return
        if node.parent is not None and node.parent.children.get(node.key) is node:
            del node.parent.children[node.key]


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

    With ``sharing=True`` the arena-level half of the commit guarantee is
    traded for copy-on-write prefix sharing: ``adopt`` maps a slot's table
    onto resident blocks (refcount++), ``fork`` clones a shared block into
    the writer's table before a write, and ``append`` / ``fork`` raise
    :class:`ArenaExhausted`: the engine's preemption is the valve.
    ``refcount`` is kept in BOTH modes (blocks never exceed 1 without
    sharing), so ``sum(refcount) == live table references`` always.
    """

    def __init__(self, n_slots: int, n_rows: int, block_size: int, num_blocks: int, *,
                 sharing: bool = False):
        if n_rows % block_size:
            raise ValueError(
                f"block_size={block_size} must divide the (aligned) cache "
                f"rows {n_rows} so paged views match contiguous shapes"
            )
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.sharing = bool(sharing)
        self.table_width = n_rows // block_size
        #: (n_slots, T) int32 arena indices; NULL_BLOCK marks unallocated.
        self.tables = np.full((n_slots, self.table_width), NULL_BLOCK, np.int32)
        # LIFO free list over ids 1..num_blocks (0 is the sink).
        self._free: List[int] = list(range(num_blocks, 0, -1))
        #: per-slot referenced block ids in table order (under sharing a
        #: block adopted by several slots is in each one's list).
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self._budget: List[int] = [0] * n_slots   # committed blocks per slot
        #: refcount[bid] = number of live table references to bid.
        self.refcount = np.zeros(num_blocks + 1, np.int32)
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
        every already-committed budget, and inside one slot's table. Under
        sharing only the table-width half holds: the engine prices
        admission against live free blocks, with preemption as the valve."""
        need = self.blocks_for(n_tokens)
        if need > self.table_width:
            return False
        return self.sharing or self.n_committed_blocks + need <= self.num_blocks

    # -- commit / append / free ----------------------------------------------
    def commit(self, slot: int, n_tokens: int) -> None:
        """Charge ``slot``'s lifetime token budget against the arena (no
        blocks move yet). Raises when over-committed — callers gate
        admission on :meth:`can_commit`. Under sharing the budget caps
        the slot's table only."""
        need = self.blocks_for(n_tokens)
        if need > self.table_width:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > table width "
                f"{self.table_width} (slot capacity)"
            )
        if (not self.sharing
                and self.n_committed_blocks - self._budget[slot] + need > self.num_blocks):
            raise ValueError(
                f"arena over-committed: budget {need} blocks on top of "
                f"{self.n_committed_blocks - self._budget[slot]} committed "
                f"(capacity {self.num_blocks})"
            )
        self._budget[slot] = max(self._budget[slot], need)

    def append(self, slot: int, n_rows: int) -> None:
        """Grow ``slot``'s table to physically cover ``n_rows`` rows
        (append-only; no-op when covered). Never exceeds the slot's
        committed budget. Without sharing the free list cannot run dry;
        under sharing an empty one raises :class:`ArenaExhausted` after
        keeping the blocks taken so far."""
        want = self.blocks_for(n_rows)
        owned = self._owned[slot]
        if want > self._budget[slot]:
            raise ValueError(
                f"slot {slot}: {n_rows} rows need {want} blocks > "
                f"committed budget {self._budget[slot]}"
            )
        try:
            while len(owned) < want:
                if not self._free:
                    raise ArenaExhausted(
                        f"slot {slot} needs {want - len(owned)} more block(s) "
                        f"but the arena free list is empty"
                    )
                bid = self._free.pop()
                self.tables[slot, len(owned)] = bid
                owned.append(bid)
                self.refcount[bid] = 1
        finally:
            self.used_high_water = max(self.used_high_water, self.n_used_blocks)

    # -- sharing: adopt / fork -----------------------------------------------
    def adopt(self, slot: int, bids: Sequence[int]) -> None:
        """Map an empty slot's table prefix onto resident blocks (a trie
        match at admission): refcount++ per block, no device work."""
        if not self.sharing:
            raise ValueError("adopt requires a sharing-mode manager")
        owned = self._owned[slot]
        if owned:
            raise ValueError(f"slot {slot} must adopt before any append")
        if len(bids) > self._budget[slot]:
            raise ValueError(
                f"adopting {len(bids)} blocks exceeds slot {slot}'s "
                f"budget {self._budget[slot]}"
            )
        for bid in bids:
            bid = int(bid)
            if not (NULL_BLOCK < bid <= self.num_blocks) or self.refcount[bid] < 1:
                raise ValueError(f"cannot adopt non-resident block {bid}")
            self.tables[slot, len(owned)] = bid
            owned.append(bid)
            self.refcount[bid] += 1

    def is_shared(self, bid: int) -> bool:
        return self.refcount[int(bid)] > 1

    def fork(self, slot: int, block_index: int) -> Tuple[int, int]:
        """Copy-on-write: give ``slot`` a private clone of the shared block
        at ``block_index`` of its table. Pops a fresh block (raises
        :class:`ArenaExhausted` when none is free), swaps the table entry
        and moves one reference. Returns ``(src_bid, dst_bid)``: the pool
        must copy the rows on the device before any write."""
        if not self.sharing:
            raise ValueError("fork requires a sharing-mode manager")
        owned = self._owned[slot]
        if not 0 <= block_index < len(owned):
            raise ValueError(f"slot {slot} has no block at {block_index}")
        src = owned[block_index]
        if self.refcount[src] < 2:
            raise ValueError(f"block {src} is not shared — nothing to fork")
        if not self._free:
            raise ArenaExhausted(f"fork of shared block {src} needs a free block")
        dst = self._free.pop()
        self.refcount[src] -= 1
        self.refcount[dst] = 1
        self.tables[slot, block_index] = dst
        owned[block_index] = dst
        self.used_high_water = max(self.used_high_water, self.n_used_blocks)
        return src, dst

    def free(self, slot: int) -> List[int]:
        """Drop every reference ``slot`` holds, release its budget, and
        point its table at the NULL sink. A block returns to the free list
        exactly when its LAST reference drops; those ids are returned, so
        that the pool can evict them from the prefix index. (Stale rows
        are never read again: reads mask by length, reallocation
        overwrites.)"""
        owned = self._owned[slot]
        released: List[int] = []
        for bid in reversed(owned):
            self.refcount[bid] -= 1
            if self.refcount[bid] == 0:
                self._free.append(bid)
                released.append(bid)
        owned.clear()
        self._budget[slot] = 0
        self.tables[slot, :] = NULL_BLOCK
        return released

    def permute(self, order: np.ndarray) -> None:
        """Remap slot indices (pool defrag) — pure host bookkeeping."""
        self.tables = self.tables[order]
        self._owned = [self._owned[int(o)] for o in order]
        self._budget = [self._budget[int(o)] for o in order]

    def audit(self) -> List[str]:
        """Every allocator-invariant violation as a message list (empty
        = healthy)."""
        errs: List[str] = []
        refs: Dict[int, int] = {}
        for slot, owned in enumerate(self._owned):
            if len(owned) > self._budget[slot]:
                errs.append(f"slot {slot} holds {len(owned)} blocks over "
                            f"its budget {self._budget[slot]}")
            if list(self.tables[slot, :len(owned)]) != owned:
                errs.append(f"slot {slot} table/owned mismatch")
            if any(t != NULL_BLOCK for t in self.tables[slot, len(owned):]):
                errs.append(f"slot {slot} has table entries past its owned blocks")
            for b in owned:
                if not (NULL_BLOCK < b <= self.num_blocks):
                    errs.append(f"bad block id {b}")
                    continue
                refs[b] = refs.get(b, 0) + 1
        for b, n in refs.items():
            if int(self.refcount[b]) != n:
                errs.append(f"block {b}: refcount {int(self.refcount[b])} "
                            f"!= {n} live table references")
            if not self.sharing and n > 1:
                errs.append(f"block {b} owned twice")
        free = set(self._free)
        if len(free) != len(self._free):
            errs.append("duplicate ids in free list")
        if not free.isdisjoint(refs):
            errs.append("block both free and owned")
        if free | set(refs) != set(range(1, self.num_blocks + 1)):
            errs.append("leaked blocks: free + owned != capacity")
        for b in self._free:
            if int(self.refcount[b]) != 0:
                errs.append(f"free block {b} carries refcount {int(self.refcount[b])}")
        if not self.sharing and self.n_committed_blocks > self.num_blocks:
            errs.append("over-committed")
        if self.n_used_blocks != len(refs):
            errs.append(f"used {self.n_used_blocks} != {len(refs)} unique live blocks")
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
        prefix_sharing: bool = False,
        device="cuda",
    ):
        """``block_size`` switches the cache leaves to a paged arena of
        ``arena_blocks`` blocks (default: full capacity,
        ``n_slots * rows / block_size`` — undersize it to serve under an
        explicit memory budget with admit-by-budget queuing).

        ``prefix_sharing`` (paged only) turns on copy-on-write block
        sharing: new requests adopt trie-matched prompt blocks
        (:meth:`adopt_prefix`) and :meth:`ensure_writable` forks shared
        blocks before a write. Allocation can then raise
        :class:`ArenaExhausted`; the caller runs a preemption policy."""
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if prefix_sharing and block_size is None:
            raise ValueError("prefix_sharing requires a paged pool (block_size set)")
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.rows = round_kv_len(max_len)   # aligned per-slot row capacity
        self.block_size = block_size
        self.paged = block_size is not None
        self.prefix_sharing = bool(prefix_sharing)
        if self.paged:
            if arena_blocks is None:
                arena_blocks = n_slots * math.ceil(self.rows / block_size)
            self.manager: Optional[BlockManager] = BlockManager(
                n_slots, self.rows, block_size, arena_blocks, sharing=self.prefix_sharing,
            )
        else:
            arena_blocks = 0
            self.manager = None
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(block_size) if self.prefix_sharing else None
        )
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
            released = self.manager.free(slot)
            if self.prefix is not None:
                for bid in released:
                    self.prefix.forget(bid)

    # -- prefix sharing (copy-on-write) --------------------------------------
    def adopt_prefix(self, slot: int, prompt) -> int:
        """Map ``slot``'s table onto the longest resident full-block prefix
        of ``prompt`` (refcount++, no device work). Returns the number of
        cache ROWS adopted: the engine skips prefill for exactly those.

        Returns 0 for pools with ANY contiguous leaf: recurrent state is a
        running function of every token, so a block chain cannot stand in
        for the skipped compute; such families keep preemption only."""
        if self.prefix is None or self._any_contiguous:
            return 0
        bids = self.prefix.match(prompt)
        if not bids:
            return 0
        self.manager.adopt(slot, bids)
        rows = len(bids) * self.block_size
        self.positions[slot] = rows
        return rows

    def register_prefix(self, slot: int, prompt) -> int:
        """Publish ``slot``'s full PROMPT blocks into the trie once its
        prefill completed (generated tokens stay private). No-op without
        sharing and for recurrent hybrids. Returns new trie nodes."""
        if self.prefix is None or self._any_contiguous:
            return 0
        n_full = len(prompt) // self.block_size
        return self.prefix.register(prompt, self.manager._owned[slot][:n_full])

    def match_resident(self, prompt, exclude_slot: Optional[int] = None) -> int:
        """Rows of ``prompt`` that would stay trie-resident if
        ``exclude_slot`` dropped its references: what a preempted request
        could re-adopt on replay (the engine prices recompute with it).
        The chain is cut at the first block that would die with the
        excluded slot."""
        if self.prefix is None or self._any_contiguous:
            return 0
        excl = [] if exclude_slot is None else self.manager._owned[exclude_slot]
        rows = 0
        for bid in self.prefix.match(prompt):
            if int(self.manager.refcount[bid]) - excl.count(bid) < 1:
                break
            rows += self.block_size
        return rows

    def ensure_writable(self, slot: int, row_start: int, row_end: int) -> None:
        """Copy-on-write gate: fork every SHARED block backing rows
        ``[row_start, row_end)`` of ``slot`` (host table swap, then an
        in-place device block copy), so the upcoming write cannot be seen
        by other sharers. A host no-op when nothing in range is shared.
        May raise :class:`ArenaExhausted`. The copy is enqueued before any
        later write on the same stream; a caller reads the block table
        (``tables_device``) after this call."""
        if self.prefix is None or row_end <= row_start:
            return
        mgr = self.manager
        owned = mgr._owned[slot]
        lo = row_start // self.block_size
        hi = min((row_end - 1) // self.block_size, len(owned) - 1)
        for idx in range(lo, hi + 1):
            if mgr.refcount[owned[idx]] > 1:
                src, dst = mgr.fork(slot, idx)
                slot_block_copy(self.caches, self.specs, src, dst)

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

    # -- migration (KV block handoff) ----------------------------------------
    def snapshot_slot(self, slot: int) -> SlotSnapshot:
        """Capture one active slot as a :class:`SlotSnapshot` of COPIES:
        contiguous leaves cloned batch-1, paged leaves the slot's owned
        blocks gathered from the arena (``index_select`` copies). The slot
        itself is untouched (the caller frees it after the handoff)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        owned = list(self.manager._owned[slot]) if self.paged else []
        if self.paged:
            ids = torch.as_tensor(owned, dtype=torch.long, device=self.device)

        def snap(c, s):
            if is_paged_spec(s):
                return torch.index_select(c, s.axes.index("kv_blocks"), ids)
            return c.narrow(batch_axis_of(s), slot, 1).clone()

        return SlotSnapshot(
            data=tree_map(snap, self.caches, self.specs),
            position=int(self.positions[slot]),
            n_blocks=len(owned),
            block_size=self.block_size,
            rows=self.rows,
        )

    def restore_slot(self, snap: SlotSnapshot, owner: Optional[int] = None,
                     n_tokens: Optional[int] = None) -> Optional[int]:
        """Re-admit a migrated slot: allocate a slot (committing the
        request's remaining lifetime budget ``n_tokens``, paged pools),
        append destination blocks to cover the snapshot's rows and scatter
        the snapshot's blocks into them; contiguous leaves are copied into
        the slot. Returns the slot, or None when this pool cannot admit
        the request now (no free slot, arena over-committed, or under
        sharing no free blocks): the caller keeps the ticket and retries."""
        if snap.block_size != self.block_size or snap.rows != self.rows:
            raise ValueError(
                f"snapshot geometry (block_size={snap.block_size}, "
                f"rows={snap.rows}) does not match pool "
                f"(block_size={self.block_size}, rows={self.rows})"
            )
        budget = snap.position if n_tokens is None else int(n_tokens)
        if budget < snap.position:
            raise ValueError(f"budget {budget} tokens below snapshot position "
                             f"{snap.position}")
        if self.paged and self.manager.blocks_for(budget) < snap.n_blocks:
            raise ValueError(
                f"budget {budget} tokens ({self.manager.blocks_for(budget)} "
                f"blocks) cannot hold the snapshot's {snap.n_blocks} blocks"
            )
        slot = self.allocate(owner=owner, n_tokens=budget)
        if slot is None:
            return None
        if self.paged and snap.n_blocks:
            try:
                self.manager.append(slot, snap.n_blocks * self.block_size)
            except ArenaExhausted:
                # A sharing-mode arena too full to land the migration now:
                # "busy", like a full pool; the caller requeues.
                self.free(slot)
                return None
        if self.paged and snap.n_blocks:
            dest = torch.as_tensor(self.manager._owned[slot][:snap.n_blocks],
                                   dtype=torch.long, device=self.device)

        def rest(c, s, v):
            if is_paged_spec(s):
                if snap.n_blocks:
                    c.index_copy_(s.axes.index("kv_blocks"), dest, v.to(c.device, c.dtype))
            else:
                c.narrow(batch_axis_of(s), slot, 1).copy_(v)
            return c

        tree_map(rest, self.caches, self.specs, snap.data)
        self.positions[slot] = snap.position
        return slot

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
