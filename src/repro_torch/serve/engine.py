"""Continuous-batching inference engine over a fixed slot pool (port of
``repro.serve.engine`` with speculative decoding, copy-on-write prefix
sharing with preempt-and-requeue, request migration and the
observability hooks).

The pool's ``n_slots`` lanes decode together in one pool-wide tick; slot
occupancy enters as DATA (a per-slot position vector; a host-side lane
mask picks the lanes whose tokens are kept), so requests join and leave
mid-flight. Admission runs the batched
cache-writing prefill (``model.prefill_with_cache``) straight into the
slot's rows; prompts are padded to power-of-two buckets. Decode is greedy
(argmax): a request's token stream must equal a lone offline decode of
the same model (``generate_offline``).

Paged mode (``block_size=...``): the KV cache lives in a global block
arena addressed through per-slot block tables, admission requires enough
free blocks for the request's whole token budget (admit-by-budget), and
KV memory tracks live tokens. Decode then runs kernel K4 instead of K3.

The Mamba2 hybrid serves through the same engine: its recurrent states
are contiguous per slot in both modes, the tick hands the model the
decoding lanes' mask so that no other lane's state moves, and its
prefill scans the decode step token by token (``Model.prefill_with_cache``).

Speculative mode (``draft_model=...``): decode actions become
draft-then-verify rounds (``serve.speculative``): gamma masked draft
ticks, one target verify over the pool, exact-argmax acceptance and a
rollback, with gamma adapted to the acceptance rate. The streams stay
those of offline decode; speculation only moves throughput.

Prefix sharing (``prefix_sharing=True``, paged only): an admission adopts
the trie-matched full blocks of its prompt instead of recomputing them,
a shared block is forked before any write, and arena pressure preempts
the lane cheapest to recompute (priced by the cost model), whose request
requeues and later replays its prompt and emitted tokens from the
longest still-resident prefix. The hybrid's recurrent states cannot be
adopted, so it preempts but never shares. Migration
(``export_request`` / ``import_request``) moves a decoding request's slot
to another engine of the same geometry as a checksummed
:class:`MigrationTicket` holding copies of its cache leaves.
In every mode a resumed stream equals the uninterrupted one.

Observability (``obs=``, ``repro_torch.obs``): request lifecycle spans,
one complete event per prefill chunk, tick, round or idle jump,
instants for cancel, preemption and migration, occupancy counters and
the engine's metrics, all stamped on the virtual clock, the same events
the reference emits on the same traffic. Every hook reads host state
the engine already holds, so it adds no device work and no sync.

``run_static`` is the static-batching baseline: same pool and kernels,
but admissions barrier until the whole previous batch drains.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import NULL_BLOCK
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.runtime.steps import (
    make_slot_decode_step,
    make_slot_prefill_step,
    make_slot_verify_step,
)
from .kv_pool import ArenaExhausted, SlotPool, SlotSnapshot
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket
from .speculative import DraftRunner, SpecController

__all__ = [
    "ServeEngine", "EngineStats", "MigrationTicket", "TicketIntegrityError",
    "ticket_checksum", "generate_offline", "run_static",
]


class TicketIntegrityError(ValueError):
    """A :class:`MigrationTicket` failed its integrity check at import:
    the payload changed between ``export_request`` (which seals the
    checksum) and ``import_request`` (which verifies it). Resuming from it
    would silently part the stream, so the importer rejects it before
    allocating anything."""


@dataclasses.dataclass(frozen=True)
class MigrationTicket:
    """Everything needed to resume a mid-decode request on ANOTHER engine
    of the same model and pool geometry: the submission, the tokens
    emitted so far, the next token to feed (``pending``), and the slot's
    cache state as a :class:`SlotSnapshot` of copies. Restoring re-admits
    the request with its prefix in cache, with no re-prefill."""

    prompt: np.ndarray
    max_new_tokens: int
    arrival: float
    deadline: Optional[float]
    tokens: Tuple[int, ...]       # emitted so far (the stream's prefix)
    pending: int                  # next token to feed (the last emitted)
    snapshot: SlotSnapshot
    #: integrity seal over every resume-relevant field, computed at export
    #: (``ticket_checksum``) and verified at import; None = unsealed.
    checksum: Optional[str] = None


#: Same-width integer views for hashing a leaf's raw bytes through numpy,
#: which has no bf16.
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _numpy_dtype_str(dtype: torch.dtype) -> str:
    """numpy's ``dtype.str`` of the array the reference hashes for a leaf
    of ``dtype``: ``'<f4'``, ``'<i4'``, and ``'<V2'`` for bf16 (the
    ``ml_dtypes`` type numpy holds bf16 in)."""
    if dtype == torch.bfloat16:
        return "<V2"
    return torch.empty((), dtype=dtype).numpy().dtype.str


def _sorted_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple tree in the order
    ``jax.tree_util`` flattens it: a dict's values sorted by key, None
    left out."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _sorted_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _sorted_leaves(t)]
    return [tree]


def ticket_checksum(ticket: MigrationTicket) -> str:
    """SHA-256 over the ticket's resume-relevant content: the prompt, the
    budget, the emitted tokens, the pending token, the snapshot's position
    and block count, and every snapshot leaf (shape, numpy's dtype string
    and raw bytes) in ``jax.tree_util``'s order. A ticket whose fields
    and leaves equal a reference ticket's has the reference's digest.
    ``deadline`` is left out: the owner rewrites it in flight (deadlines
    are clock-local)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(ticket.prompt, np.int32)).tobytes())
    h.update(np.int64(ticket.max_new_tokens).tobytes())
    h.update(np.asarray(ticket.tokens, np.int64).tobytes())
    h.update(np.int64(ticket.pending).tobytes())
    snap = ticket.snapshot
    h.update(np.int64(snap.position).tobytes())
    h.update(np.int64(snap.n_blocks).tobytes())
    for leaf in _sorted_leaves(snap.data):
        # The reference's ``np.ascontiguousarray`` makes a 0-d leaf (1,).
        shape = tuple(leaf.shape) or (1,)
        h.update(str((shape, _numpy_dtype_str(leaf.dtype))).encode())
        raw = leaf.detach().contiguous().view(_INT_OF_WIDTH[leaf.element_size()])
        h.update(raw.cpu().numpy().tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class EngineStats:
    generated_tokens: int = 0
    decode_ticks: int = 0
    decode_tokens: int = 0        # tokens emitted by decode ticks and rounds
    prefill_calls: int = 0
    prefill_tokens: int = 0
    spec_rounds: int = 0          # speculation rounds (draft + verify)
    draft_ticks: int = 0          # sequential draft decode ticks
    spec_accepted: int = 0        # draft tokens the target accepted
    cancelled_requests: int = 0   # deadline expiries + explicit cancels
    preempted_requests: int = 0   # evict-and-requeue events (prefix sharing)
    prefix_hits: int = 0          # admissions that adopted a trie chain
    prefix_rows_shared: int = 0   # cache rows skipped through adoption
    migrated_out: int = 0         # requests exported as MigrationTickets
    migrated_in: int = 0          # tickets restored into this engine
    virtual_seconds: float = 0.0
    wall_seconds: float = 0.0
    decode_wall_seconds: float = 0.0   # host clock around decode ticks and rounds

    @property
    def tokens_per_vsec(self) -> float:
        return self.generated_tokens / max(self.virtual_seconds, 1e-12)

    @property
    def decode_tokens_per_wsec(self) -> float:
        return self.decode_tokens / max(self.decode_wall_seconds, 1e-12)


class ServeEngine:
    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int,
        max_len: int,
        scheduler: Optional[Scheduler] = None,
        prefill_bucket: int = 16,
        block_size: Optional[int] = None,
        arena_blocks: Optional[int] = None,
        prefix_sharing: bool = False,
        draft_model=None,
        draft_params=None,
        gamma_max: int = 4,
        spec_controller: Optional[SpecController] = None,
        obs: Optional[Observability] = None,
        obs_name: Optional[str] = None,
    ):
        """The engine runs on the device of ``params``. ``block_size``
        turns on paged KV; ``arena_blocks`` caps the arena below full
        capacity to serve under an explicit memory budget.

        ``prefix_sharing`` (paged only) switches the arena to copy-on-write
        sharing with preempt-and-requeue: admissions adopt trie-matched
        prompt blocks, shared blocks fork before any write, and arena
        pressure evicts the lane cheapest to recompute rather than
        queuing.

        ``draft_model`` / ``draft_params`` turn on speculative decoding:
        decode actions become draft-then-verify rounds whose draft length
        ``spec_controller`` (default ``SpecController(gamma_max)``)
        adapts. The draft pool lives on the device of ``draft_params``.

        ``obs``: the observability bundle, by default the disabled
        ``NULL_OBS``, which makes every hook a no-op costing one attribute
        check. ``obs_name`` labels this engine's trace lane (a replica
        passes ``"replica <id>"``)."""
        if model.cfg.is_encoder:
            raise ValueError("serving needs a causal decoder architecture")
        if prefix_sharing and draft_model is not None:
            raise ValueError(
                "prefix_sharing and speculative decoding are mutually "
                "exclusive: the draft twin pool does not track the target's "
                "copy-on-write forks, so lockstep would silently break"
            )
        if prefix_sharing and model.cfg.moe is not None and not model.cfg.moe.dropless:
            raise ValueError(
                "prefix_sharing requires dropless MoE routing "
                "(cfg.moe.dropless=True): adopting a prefix changes how "
                "many tokens share the suffix prefill call, and "
                "capacity-dropped routing makes logits depend on that "
                "count — byte-identity to offline decode would silently "
                "break"
            )
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.prefix_sharing = bool(prefix_sharing)
        self.pool = SlotPool(
            model, n_slots, max_len, block_size=block_size,
            arena_blocks=arena_blocks, prefix_sharing=prefix_sharing, device=self.device,
        )
        #: A seeded bug for the chaos search only (``tools/chaos_search_torch.py
        #: --leak-blocks``): when set, a cancelled slot's last block is dropped
        #: instead of freed, which the block-conservation oracle must catch
        #: and ddmin must shrink to the one cancel-bearing atom.
        self._chaos_leak_blocks = False
        self.sched = scheduler or Scheduler(n_slots)
        self.prefill_bucket = prefill_bucket
        self.stats = EngineStats()
        self.events: List[Tuple[str, float, int]] = []  # (action, vtime, rid)
        # -- observability ----------------------------------------------------
        self.obs = obs or NULL_OBS
        self._tr = self.obs.tracer
        self.pid = self._tr.register_process(obs_name or "engine")
        self._span_ids: Dict[int, int] = {}   # rid -> open lifecycle span
        if self.sched.obs is NULL_OBS:
            self.sched.bind_obs(self.obs)
        m = self.obs.metrics
        self._m_tokens = m.counter("engine.generated_tokens")
        self._m_prefill_tokens = m.counter("engine.prefill_tokens")
        self._m_decode_ticks = m.counter("engine.decode_ticks")
        self._g_slots = m.gauge("engine.slots_active")
        self._g_blocks = m.gauge("engine.arena_blocks_used")
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        # Per-slot decode state (host side).
        self._pending = np.zeros(n_slots, np.int32)   # next token to feed
        self._decoding = np.zeros(n_slots, bool)      # prefill done, generating
        self._prefill = make_slot_prefill_step(model)
        self._decode = make_slot_decode_step(model)
        self._verify = make_slot_verify_step(model)
        # -- speculation (optional) ------------------------------------------
        self.draft: Optional[DraftRunner] = None
        self.spec: Optional[SpecController] = None
        if draft_model is not None:
            if draft_params is None:
                raise ValueError("draft_model needs draft_params")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({draft_model.cfg.vocab_size} != {model.cfg.vocab_size})"
                )
            self.draft = DraftRunner(draft_model, draft_params, n_slots, max_len)
            self.spec = spec_controller or SpecController(gamma_max)
            self.spec.draft_fused = draft_model.fused_prefill
            if self.spec.obs is NULL_OBS:
                self.spec.obs = self.obs

    @property
    def speculative(self) -> bool:
        return self.draft is not None

    # -- submission ----------------------------------------------------------
    def submit(
        self, prompt, max_new_tokens: int, arrival: float = 0.0,
        deadline: Optional[float] = None,
    ) -> int:
        """``deadline``: absolute virtual-time deadline; None defers to the
        scheduler's ``deadline_ticks`` default (stamped at admission)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new_tokens({max_new_tokens}) "
                f"exceeds max_len({self.pool.max_len})"
            )
        if self.pool.paged:
            mgr = self.pool.manager
            need = mgr.blocks_for(prompt.size + max_new_tokens)
            if need > mgr.num_blocks:
                # A request bigger than the whole arena could never admit.
                raise ValueError(
                    f"request needs {need} blocks but the arena has only "
                    f"{mgr.num_blocks} — raise arena_blocks or block_size"
                )
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, int(max_new_tokens), float(arrival),
                      deadline=deadline)
        self._requests[rid] = req
        self.sched.submit(req)
        if self._tr.enabled:
            # The span opens at this engine's clock, not at the logical
            # arrival: a hedge copy can reach a replica whose clock is
            # behind the arrival stamp, and a span may not end before it
            # begins.
            self._span_ids[rid] = self._tr.begin_span(
                "request", self.pid, self.sched.clock.now,
                args={"rid": rid, "arrival": float(arrival),
                      "prompt_len": int(prompt.size),
                      "max_new_tokens": int(max_new_tokens)},
            )
        return rid

    def _end_request_span(self, req: Request, outcome: str, ts: float) -> None:
        """Close a request's lifecycle span exactly once, whichever path
        retired it (done, cancelled, deadline or migrated)."""
        sid = self._span_ids.pop(req.rid, None)
        if sid:
            self._tr.end_span(sid, ts, args={"outcome": outcome,
                                             "n_tokens": len(req.tokens)})

    # -- cancellation / deadlines --------------------------------------------
    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Tear down an unfinished request NOW, wherever it is in its
        lifecycle, freeing its slot (and, paged, its blocks). Returns False
        if the request is unknown, already finished, or already cancelled.
        The partial token stream is kept on the request."""
        req = self._requests.get(rid)
        if req is None or req.t_done is not None or req.cancelled:
            return False
        self.sched.drop(req)
        if rid in self.pool.owner:              # holds a slot (prefill/decode)
            slot = self._slot_of(rid)
            self._decoding[slot] = False
            if self._chaos_leak_blocks and self.pool.paged:
                # The seeded bug: the slot's last block leaves its table and
                # loses a reference without going back to the free list.
                mgr = self.pool.manager
                owned = mgr._owned[slot]
                if owned:
                    bid = owned.pop()
                    mgr.tables[slot, len(owned)] = NULL_BLOCK
                    mgr.refcount[bid] -= 1
            self._free_slot(slot)
        req.t_cancelled = self.sched.clock.now
        req.cancel_reason = reason
        self.stats.cancelled_requests += 1
        now = self.sched.clock.now
        self.events.append(("cancel", now, rid))
        self._end_request_span(req, reason, now)
        if self.obs.enabled:
            self.obs.metrics.counter(f"engine.cancel.{reason}").inc()
            self._tr.instant("cancel", self.pid, now, args={"rid": rid, "reason": reason})
        return True

    def _expire_deadlines(self) -> List[int]:
        """Cancel every unfinished request past its deadline (reason
        ``"deadline"``); returns their rids."""
        now = self.sched.clock.now
        expired = [
            rid for rid, req in self._requests.items()
            if req.t_done is None and not req.cancelled
            and req.deadline is not None and req.deadline <= now
        ]
        for rid in expired:
            self.cancel(rid, reason="deadline")
        return expired

    # -- migration -----------------------------------------------------------
    def export_request(self, rid: int) -> MigrationTicket:
        """Snapshot a decoding request into a sealed :class:`MigrationTicket`
        and release everything it holds here (reason ``"migrated"``).

        Only DECODING requests carry cache state worth handing off;
        waiting or mid-prefill requests migrate by resubmission. A
        speculative engine refuses: its draft pool is not in the snapshot.
        After ``m`` emitted tokens the slot has ``prompt_len + m - 1`` rows
        written and ``pending`` is token ``m``, so the importer's next tick
        emits token ``m + 1`` of the same stream."""
        if self.speculative:
            raise ValueError("cannot export from a speculative engine "
                             "(draft twin state is not snapshotted)")
        req = self._requests.get(rid)
        if req is None or req.t_done is not None or req.cancelled:
            raise ValueError(f"request {rid} is not live")
        slot = self._slot_of(rid)
        if not self._decoding[slot]:
            raise ValueError(f"request {rid} is not decoding "
                             "(migrate queued requests by resubmission)")
        expect = req.prompt_len + len(req.tokens) - 1
        if int(self.pool.positions[slot]) != expect:
            raise RuntimeError(f"slot {slot} position {self.pool.positions[slot]} != {expect}")
        ticket = MigrationTicket(
            prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            arrival=req.arrival,
            deadline=req.deadline,
            tokens=tuple(req.tokens),
            pending=int(self._pending[slot]),
            snapshot=self.pool.snapshot_slot(slot),
        )
        ticket = dataclasses.replace(ticket, checksum=ticket_checksum(ticket))
        self._decoding[slot] = False
        self._free_slot(slot)
        req.t_cancelled = self.sched.clock.now
        req.cancel_reason = "migrated"
        self.stats.migrated_out += 1
        now = self.sched.clock.now
        self.events.append(("migrate_out", now, rid))
        self._end_request_span(req, "migrated", now)
        if self.obs.enabled:
            self.obs.metrics.counter("engine.migrated_out").inc()
            self._tr.instant("migrate_out", self.pid, now,
                             args={"rid": rid, "n_tokens": len(req.tokens)})
        return ticket

    def import_request(self, ticket: MigrationTicket) -> Optional[int]:
        """Re-admit a migrated request with its cache prefix restored (no
        re-prefill). Returns the new local rid, or None when the pool
        cannot admit it now (no free slot or not enough blocks): the caller
        keeps the ticket and retries. A sealed ticket whose content changed
        raises :class:`TicketIntegrityError` before anything is allocated."""
        if self.speculative:
            raise ValueError("cannot import into a speculative engine "
                             "(draft twin state is not snapshotted)")
        if ticket.checksum is not None:
            expect = ticket_checksum(ticket)
            if expect != ticket.checksum:
                raise TicketIntegrityError(
                    f"migration ticket failed integrity check: sealed "
                    f"{ticket.checksum[:12]}…, recomputed {expect[:12]}…"
                )
        budget = int(ticket.prompt.size) + int(ticket.max_new_tokens)
        if budget > self.pool.max_len:
            raise ValueError("ticket exceeds this engine's max_len")
        rid = self._next_rid
        slot = self.pool.restore_slot(ticket.snapshot, owner=rid, n_tokens=budget)
        if slot is None:
            return None
        self._next_rid += 1
        req = Request(rid, ticket.prompt, int(ticket.max_new_tokens),
                      float(ticket.arrival), deadline=ticket.deadline)
        req.tokens = list(ticket.tokens)
        req.prefilled = req.prompt_len
        req.t_admit = self.sched.clock.now
        req.t_first_token = self.sched.clock.now
        self._requests[rid] = req
        self._pending[slot] = np.int32(ticket.pending)
        self._decoding[slot] = True
        self.stats.migrated_in += 1
        now = self.sched.clock.now
        self.events.append(("migrate_in", now, rid))
        if self._tr.enabled:
            self._span_ids[rid] = self._tr.begin_span(
                "request", self.pid, now,
                args={"rid": rid, "arrival": float(ticket.arrival),
                      "prompt_len": int(ticket.prompt.size),
                      "max_new_tokens": int(ticket.max_new_tokens),
                      "migrated_in": True, "tokens_so_far": len(ticket.tokens)},
            )
        if self.obs.enabled:
            self.obs.metrics.counter("engine.migrated_in").inc()
            self._tr.instant("migrate_in", self.pid, now,
                             args={"rid": rid, "n_tokens": len(ticket.tokens)})
        return rid

    # -- introspection -------------------------------------------------------
    def request(self, rid: int) -> Request:
        return self._requests[rid]

    def live_rids(self) -> List[int]:
        """Requests neither finished nor cancelled (queued, mid-prefill,
        or decoding)."""
        return [rid for rid, r in self._requests.items()
                if r.t_done is None and not r.cancelled]

    def decoding_rids(self) -> List[int]:
        """Requests mid-decode: the ones ``export_request`` can move."""
        return [self.pool.owner[int(s)] for s in np.nonzero(self._decoding)[0]]

    @property
    def has_work(self) -> bool:
        """True while ``step()`` would do something other than idle
        forever: active slots, queued arrivals or mid-prefill work."""
        return bool(self.pool.n_active > 0 or self.sched.waiting or self.sched.running)

    # -- actions -------------------------------------------------------------
    def _slot_of(self, rid: int) -> int:
        return self.pool.owner.index(rid)

    @staticmethod
    def _budget(req: Request) -> int:
        """Cache rows a request can touch over its whole lifetime —
        reserved in full at admission so decode never stalls on blocks."""
        return req.prompt_len + req.max_new_tokens

    def _can_admit(self, req: Request) -> bool:
        if not self.prefix_sharing:
            return self.pool.can_admit(self._budget(req))
        # Sharing: no whole-budget commitment. Admit when the prefill, less
        # what the trie already holds, fits the live free list with at
        # least one block to spare; decode-time growth is covered by
        # preemption, not by reservation.
        pool = self.pool
        mgr = pool.manager
        if pool.n_free == 0 or not mgr.can_commit(self._budget(req)):
            return False
        matched = 0 if pool._any_contiguous else len(pool.prefix.match(req.prefill_target()))
        need = mgr.blocks_for(req.prefill_len) - matched
        return mgr.n_free_blocks >= max(need, 1)

    def _do_prefill(self, req: Request) -> None:
        sched, pool = self.sched, self.pool
        v0 = sched.clock.now
        target = req.prefill_target()
        first = req.rid not in pool.owner
        if first:
            sched.on_admit(req)
            slot = pool.allocate(owner=req.rid, n_tokens=self._budget(req))
            if slot is None:
                raise RuntimeError("scheduler admitted without a slot or blocks")
            # A fresh slot starts from spec-initialized rows, as the
            # reference's blank batch-1 caches do.
            pool.reset_slot(slot)
            if self.prefix_sharing:
                matched = pool.adopt_prefix(slot, target)
                if matched:
                    if matched == len(target):
                        # A full-block full match: re-feed the last token,
                        # whose write forks the shared tail block, for the
                        # logits that pick the first new token.
                        matched -= 1
                        pool.positions[slot] = matched
                    req.prefilled = matched
                    self.stats.prefix_hits += 1
                    self.stats.prefix_rows_shared += matched
        else:
            slot = self._slot_of(req.rid)

        start, n_tok = sched.chunk_for(req)
        # Cap the pad bucket at the slot capacity past `start`: an oversized
        # chunk would write past the slot's rows. submit() guarantees
        # n_tok <= max_len - start.
        bucket = min(next_bucket(n_tok, self.prefill_bucket), pool.max_len - start)
        chunk = np.zeros((1, bucket), np.int32)
        chunk[0, :n_tok] = target[start:start + n_tok]
        # Grow the slot's block table to cover the chunk's real rows (pad
        # overhang past them falls into the NULL sink), and fork any shared
        # block the write would touch (only the full-match re-feed row can
        # be: adopted blocks lie below the write start). Under sharing
        # either may preempt another lane. The fork's block copy is
        # enqueued before the prefill, which reads the table afterwards.
        self._ensure_preempting(slot, lambda: pool.ensure_rows(slot, start + n_tok))
        if self.prefix_sharing:
            self._ensure_preempting(
                slot, lambda: pool.ensure_writable(slot, start, start + n_tok))
        chunk = torch.as_tensor(chunk, device=self.device)
        logits, slot_caches = self._prefill(
            self.params,
            chunk,
            pool.read_slot(slot),
            torch.tensor([n_tok], device=self.device),
            start,
            pool.tables_device(slot),
        )
        pool.write_slot(slot, slot_caches, position=start + n_tok)
        if self.speculative:
            # The draft cache must hold the same prefix (the same chunk).
            self.draft.prefill_chunk(slot, chunk, n_tok, start, owner=req.rid)
            sched.on_draft_prefill(n_tok)
        done = start + n_tok >= req.prefill_len
        sched.on_prefill_chunk(req, n_tok, done)
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens += n_tok
        if done:
            if self.prefix_sharing:
                pool.register_prefix(slot, req.prompt)
            if req.tokens:
                # The replay of a preempted request: its emitted tokens are
                # in the stream already, so decode resumes feeding the last
                # one, and nothing is emitted here.
                self._pending[slot] = np.int32(req.tokens[-1])
                self._decoding[slot] = True
            else:
                tok = int(torch.argmax(logits[0, -1]))
                self._emit(req, tok)
                if self._finished(req):     # max_new_tokens == 1
                    self._free_slot(slot)
                else:
                    self._pending[slot] = tok
                    self._decoding[slot] = True
        self.events.append(("prefill", self.sched.clock.now, req.rid))
        if self.obs.enabled:
            self._m_prefill_tokens.inc(n_tok)
            self._tr.complete("prefill", self.pid, v0, sched.clock.now,
                              args={"rid": req.rid, "start": start,
                                    "n_tokens": n_tok, "done": done})

    def _do_decode(self) -> None:
        pool = self.pool
        t0, v0 = time.perf_counter(), self.sched.clock.now
        # Each decoding lane writes one row at its position: grow its block
        # table (and, sharing, fork a shared block there) BEFORE taking the
        # lane mask. Without sharing this never fails (the whole budget was
        # committed); under sharing it may preempt other decoding lanes,
        # which then drop out of this tick.
        for slot in np.nonzero(self._decoding)[0]:
            slot = int(slot)
            if not self._decoding[slot]:
                continue                # preempted by an earlier lane's ensure
            pos = int(pool.positions[slot])
            self._ensure_preempting(slot, lambda s=slot, p=pos: pool.ensure_rows(s, p + 1))
            if self.prefix_sharing and self._decoding[slot]:
                self._ensure_preempting(
                    slot, lambda s=slot, p=pos: pool.ensure_writable(s, p, p + 1))
        mask = self._decoding.copy()
        tokens = torch.as_tensor(self._pending[:, None], device=self.device)
        positions = torch.as_tensor(
            np.clip(pool.positions, 0, pool.max_len - 1), device=self.device
        )
        # Only recurrent states need the lane mask (a dense tick sends none).
        lanes = torch.as_tensor(mask, device=self.device) if pool.recurrent else None
        logits, pool.caches = self._decode(
            self.params, tokens, pool.caches, positions, pool.tables_device(), lanes,
        )
        self.sched.on_decode_tick()
        self.stats.decode_ticks += 1
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy().astype(np.int32)
        self.stats.decode_wall_seconds += time.perf_counter() - t0
        self.stats.decode_tokens += int(mask.sum())
        for slot in np.nonzero(mask)[0]:
            slot = int(slot)
            pool.positions[slot] += 1
            req = self._requests[pool.owner[slot]]
            self._emit(req, int(next_tok[slot]))
            if self._finished(req):
                self._decoding[slot] = False
                self._free_slot(slot)
            else:
                self._pending[slot] = next_tok[slot]
        self.events.append(("decode", self.sched.clock.now, -1))
        if self.obs.enabled:
            self._m_decode_ticks.inc()
            self._tr.complete("decode", self.pid, v0, self.sched.clock.now,
                              args={"lanes": int(mask.sum())})

    def _free_slot(self, slot: int) -> None:
        self.pool.free(slot)
        if self.speculative:
            self.draft.pool.free(slot)

    # -- preemption (prefix sharing) -----------------------------------------
    def _recompute_cost(self, req: Request, slot: int) -> float:
        """Price of evicting ``slot`` now: prefill over the replay sequence
        less the prefix that stays trie-resident after the victim's own
        references drop (it re-adopts that part on requeue)."""
        replay = req.prompt_len + max(len(req.tokens) - 1, 0)
        resident = self.pool.match_resident(req.prefill_target(), exclude_slot=slot)
        return self.sched.clock.cost.recompute(replay - resident)

    def _preempt_slot(self, slot: int) -> None:
        """Evict ``slot``'s request and requeue it: blocks freed now,
        emitted tokens kept; its next admission replays from the longest
        still-resident prefix."""
        req = self._requests[self.pool.owner[slot]]
        self._decoding[slot] = False
        self._pending[slot] = 0
        self._free_slot(slot)
        self.sched.requeue(req)
        self.stats.preempted_requests += 1
        now = self.sched.clock.now
        self.events.append(("preempt", now, req.rid))
        if self.obs.enabled:
            self.obs.metrics.counter("engine.preempted").inc()
            self._tr.instant("preempt", self.pid, now,
                             args={"rid": req.rid, "n_tokens": len(req.tokens)})

    def _preempt_for(self, needy_slot: int) -> None:
        """FORCED eviction: ``needy_slot``'s write found the free list empty
        and must proceed. Evict the OTHER lane cheapest to recompute,
        decoding lanes first (a mid-prefill lane is the one the scheduler
        is committed to)."""
        best, best_rank = None, None
        for s in np.nonzero(self.pool.active)[0]:
            s = int(s)
            if s == needy_slot:
                continue
            rc = self._recompute_cost(self._requests[self.pool.owner[s]], s)
            rank = (0 if self._decoding[s] else 1, rc)
            if best_rank is None or rank < best_rank:
                best, best_rank = s, rank
        if best is None:
            raise RuntimeError(
                f"arena exhausted with no preemptable lane (slot {needy_slot} "
                f"alone holds the arena) — raise arena_blocks"
            )
        self._preempt_slot(best)

    def _ensure_preempting(self, slot: int, fn) -> None:
        """Run a block-allocating pool op, evicting lanes until it fits
        (only sharing raises ArenaExhausted)."""
        while True:
            try:
                return fn()
            except ArenaExhausted:
                self._preempt_for(slot)

    def _maybe_preempt_for_admission(self) -> None:
        """PRICED eviction at admission: when the queue head is blocked on
        blocks (not on slots), evict the lane cheapest to recompute, if
        recompute undercuts holding it to completion, and only among
        requests strictly YOUNGER than the head, so two queued requests
        never evict each other. At most one eviction a step."""
        sched = self.sched
        if sched.running:
            return                      # finish the in-flight prefill first
        req = sched._eligible()
        if req is None or self.pool.n_free == 0 or self._can_admit(req):
            return
        cost = sched.clock.cost
        head_key = (req.arrival, req.rid)
        best, best_rc = None, None
        for s in np.nonzero(self.pool.active)[0]:
            s = int(s)
            victim = self._requests[self.pool.owner[s]]
            if (victim.arrival, victim.rid) <= head_key:
                continue                # never evict an older request
            rc = self._recompute_cost(victim, s)
            hold = cost.hold(victim.max_new_tokens - len(victim.tokens))
            if rc < hold and (best_rc is None or rc < best_rc):
                best, best_rc = s, rc
        if best is not None:
            self._preempt_slot(best)

    def _do_spec_round(self) -> None:
        """One draft-then-verify round over the whole pool (in place of a
        decode tick when a draft model is attached).

        Per-lane draft budgets enter the fixed-shape verify as data
        (``n_input``: 0 = a free or mid-prefill lane, 1 = plain decode for
        a lane one token from its budget, 1 + gamma_b = speculating). The
        verify commits only what the acceptance rule allows
        (``Model.verify_with_cache``), the target rewinds its positions,
        and the draft resyncs (``DraftRunner.resync``). One host read of
        the verify's greedy tokens a round; the draft reads its
        proposals once a tick."""
        pool, sched, draft = self.pool, self.sched, self.draft
        t0, v0 = time.perf_counter(), sched.clock.now
        n_slots = pool.n_slots
        decoding = self._decoding.copy()
        slots = np.nonzero(decoding)[0]
        gamma = self.spec.choose_gamma(sched.clock.cost).gamma
        if gamma == 0 or slots.size == 0:
            # A plain tick; the draft consumes the same tokens in one masked
            # tick (proposal discarded) so that it stays on the committed
            # stream. Lanes that finished were freed in both pools.
            old_pending = self._pending.copy()
            self._do_decode()
            live = decoding & self._decoding
            if live.any():
                t1 = time.perf_counter()
                draft.decode_tick(old_pending, live)
                sched.on_draft_decode()
                self.stats.draft_ticks += 1
                self.stats.decode_wall_seconds += time.perf_counter() - t1
            return
        # Never draft past a request's remaining budget (its last token
        # needs no successor): every verify write stays inside the budget.
        remaining = np.zeros(n_slots, np.int64)
        for slot in slots:
            req = self._requests[pool.owner[slot]]
            remaining[slot] = req.max_new_tokens - len(req.tokens)
        gamma_b = np.minimum(gamma, np.maximum(remaining - 1, 0))
        S = gamma + 1
        inputs = np.zeros((n_slots, S), np.int32)
        inputs[:, 0] = self._pending
        n_input = np.zeros(n_slots, np.int32)
        n_input[slots] = 1 + gamma_b[slots]

        # -- draft: gamma masked sequential ticks ----------------------------
        draft.snapshot()
        tokens = self._pending.copy()
        draft_ticks = 0
        for j in range(gamma):
            mask_j = decoding & (gamma_b > j)
            if not mask_j.any():
                break
            proposed = draft.decode_tick(tokens, mask_j)
            tokens = np.where(mask_j, proposed, tokens)
            inputs[mask_j, j + 1] = proposed[mask_j]
            draft_ticks += 1

        # -- verify: one target call over the pool ---------------------------
        starts = pool.positions.copy()
        for slot in slots:
            pool.ensure_rows(int(slot), int(starts[slot]) + int(n_input[slot]))
        greedy, pool.caches = self._verify(
            self.params, torch.as_tensor(inputs, device=self.device), pool.caches,
            torch.as_tensor(n_input, device=self.device),
            torch.as_tensor(np.clip(starts, 0, pool.max_len - 1), device=self.device),
            pool.tables_device(),
        )
        greedy = greedy.cpu().numpy()

        # -- acceptance: the exact argmax chain, then emit and rewind --------
        n_commit = np.zeros(n_slots, np.int32)
        emitted_live: List[int] = []   # commits of lanes still decoding
        emitted_all: List[int] = []
        for slot in slots:
            slot = int(slot)
            ni = int(n_input[slot])
            a = 0
            while a < ni - 1 and greedy[slot, a] == inputs[slot, a + 1]:
                a += 1
            self.spec.observe(a, ni - 1)
            self.stats.spec_accepted += a
            req = self._requests[pool.owner[slot]]
            for i in range(a + 1):
                self._emit(req, int(greedy[slot, i]))
            pool.positions[slot] = int(starts[slot]) + a + 1
            n_commit[slot] = a + 1
            emitted_all.append(a + 1)
            if self._finished(req):
                self._decoding[slot] = False
                self._free_slot(slot)
                n_commit[slot] = 0      # a freed draft lane is left alone
            else:
                self._pending[slot] = greedy[slot, a]
                emitted_live.append(a + 1)

        # -- draft resync: roll back to the committed stream -----------------
        extra_ticks, replayed = draft.resync(inputs, n_commit)
        draft_ticks += extra_ticks
        # The interleave's credit is the weakest live lane's progress (an
        # all-finished round credits its largest commit).
        emitted = min(emitted_live) if emitted_live else max(emitted_all)
        sched.on_spec_round(draft_ticks, S, emitted, replay=replayed)
        self.stats.spec_rounds += 1
        self.stats.draft_ticks += draft_ticks
        self.stats.decode_tokens += sum(emitted_all)
        self.stats.decode_wall_seconds += time.perf_counter() - t0
        self.events.append(("spec", sched.clock.now, -1))
        if self.obs.enabled:
            self._tr.complete("spec_round", self.pid, v0, sched.clock.now,
                              args={"gamma": int(gamma), "lanes": int(slots.size),
                                    "committed": int(sum(emitted_all))})

    def _emit(self, req: Request, tok: int) -> None:
        if not req.tokens:
            req.t_first_token = self.sched.clock.now
        req.tokens.append(tok)
        self.stats.generated_tokens += 1
        self._m_tokens.inc()

    def _finished(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            if req.t_done is None:
                req.t_done = self.sched.clock.now
                self._end_request_span(req, "done", req.t_done)
            return True
        return False

    def defrag(self) -> Dict[int, int]:
        """Compact the pool's live slots and remap the engine's per-slot
        decode state to match — safe mid-flight (bare ``pool.defrag()``
        would silently desync ``_pending``/``_decoding``). A draft pool
        compacts with the same permutation (its occupancy mirrors the
        target's), keeping the two in slot-index lockstep."""
        moves = self.pool.defrag()
        if self.speculative:
            draft_moves = self.draft.pool.defrag()
            assert draft_moves == moves, (
                f"draft pool desync under defrag: {draft_moves} != {moves}"
            )
        if moves:
            inv = {new: old for old, new in moves.items()}
            pending, decoding = self._pending, self._decoding
            self._pending = np.zeros_like(pending)
            self._decoding = np.zeros_like(decoding)
            for s in np.nonzero(self.pool.active)[0]:
                src = inv.get(int(s), int(s))
                self._pending[s] = pending[src]
                self._decoding[s] = decoding[src]
        return moves

    # -- run loop ------------------------------------------------------------
    def step(self) -> str:
        """Run one scheduler action; returns its kind. Deadlines are
        policed first, so an expired request's slot (and blocks) are free
        by the time admission is priced."""
        self._expire_deadlines()
        if self.prefix_sharing:
            self._maybe_preempt_for_admission()
        kind, req = self.sched.next_action(
            self.pool.n_active, self.pool.n_free, self._can_admit
        )
        if kind == "prefill":
            self._do_prefill(req)
        elif kind == "decode":
            if self.speculative:
                self._do_spec_round()
            else:
                self._do_decode()
        elif kind == "idle":
            v0 = self.sched.clock.now
            self.sched.on_idle()
            self.events.append(("idle", self.sched.clock.now, -1))
            if self._tr.enabled:
                self._tr.complete("idle", self.pid, v0, self.sched.clock.now)
        if self.obs.enabled and kind != "done":
            self._g_slots.set(self.pool.n_active)
            values = {"slots": int(self.pool.n_active)}
            if self.pool.paged:
                used = self.pool.manager.n_used_blocks
                self._g_blocks.set(used)
                values["blocks"] = int(used)
            self._tr.counter("occupancy", self.pid, self.sched.clock.now, values)
        return kind

    def run(self) -> Dict[int, Request]:
        """Drive until every submitted request completes."""
        t0 = time.perf_counter()
        while self.step() != "done":
            pass
        self.stats.wall_seconds += time.perf_counter() - t0
        self.stats.virtual_seconds = self.sched.clock.now
        return dict(self._requests)


# ---------------------------------------------------------------------------
# References: per-request offline decode + static batching baseline
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate_offline(model, params, prompt, max_new_tokens: int, max_len: int,
                     *, forced=None):
    """Single-request greedy generation with batch-1 caches — the token
    stream the continuous-batching engine must reproduce.

    With ``forced`` (``max_new_tokens`` tokens, e.g. an engine's stream)
    it feeds those tokens instead of its own choices (teacher forcing) and
    returns (its own greedy choice at each position, the f32 gap between
    the top two logits of each choice), so a stream that parts from it at
    a near-tie is still checked at every later position."""
    dev = params["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt, np.int32).reshape(1, -1), device=dev)
    P = prompt.shape[1]
    caches = model.blank_caches(1, max_len, device=dev)
    logits, caches = model.prefill_with_cache(
        params, prompt, caches, length=torch.tensor([P], device=dev), start_index=0,
    )
    out, margins = [], []

    def take(lg: torch.Tensor, i: int) -> int:
        out.append(int(torch.argmax(lg[0, -1])))
        if forced is None:
            return out[-1]
        top = torch.topk(lg[0, -1].float(), 2).values
        margins.append(float(top[0] - top[1]))
        return int(forced[i])

    tok = take(logits, 0)
    for i in range(1, max_new_tokens):
        logits, caches = model.decode_step(
            params, torch.tensor([[tok]], device=dev), caches, P + i - 1
        )
        tok = take(logits, i)
    return out if forced is None else (out, margins)


class _StaticScheduler(Scheduler):
    """Static batching: admissions barrier until the pool fully drains."""

    def __init__(self, n_slots: int, *, clock: Optional[EventClock] = None):
        super().__init__(n_slots, clock=clock)
        self._barrier_open = True

    def next_action(self, n_active: int, n_free: int, can_admit=None):
        if n_active == 0:
            self._barrier_open = True
        if self.running:
            return "prefill", self.running[0]
        req = self._eligible()
        if (req is not None and n_free > 0 and self._barrier_open
                and (can_admit is None or can_admit(req))):
            return "prefill", req
        if n_active > 0:
            self._barrier_open = False
            return "decode", None
        if self._next_arrival() is not None:
            return "idle", None
        return "done", None


def run_static(
    model,
    params,
    requests: List[Tuple[np.ndarray, int, float]],   # (prompt, max_new, arrival)
    *,
    n_slots: int,
    max_len: int,
    cost: Optional[CostModel] = None,
    prefill_bucket: int = 16,
) -> Tuple[Dict[int, Request], EngineStats]:
    """Same kernels/pool, static-batch admission (the baseline)."""
    sched = _StaticScheduler(n_slots, clock=EventClock(cost))
    eng = ServeEngine(
        model, params, n_slots=n_slots, max_len=max_len,
        scheduler=sched, prefill_bucket=prefill_bucket,
    )
    for prompt, m, arr in requests:
        eng.submit(prompt, m, arrival=arr)
    return eng.run(), eng.stats
