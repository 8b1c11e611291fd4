"""Continuous-batching inference engine over a fixed slot pool (port of
``repro.serve.engine`` with speculative decoding, and without prefix
sharing, migration and observability hooks).

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

``run_static`` is the static-batching baseline: same pool and kernels,
but admissions barrier until the whole previous batch drains.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.steps import (
    make_slot_decode_step,
    make_slot_prefill_step,
    make_slot_verify_step,
)
from .kv_pool import SlotPool
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket
from .speculative import DraftRunner, SpecController

__all__ = ["ServeEngine", "EngineStats", "generate_offline", "run_static"]


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
    virtual_seconds: float = 0.0
    wall_seconds: float = 0.0
    decode_wall_seconds: float = 0.0   # host clock around decode ticks and rounds

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
        draft_model=None,
        draft_params=None,
        gamma_max: int = 4,
        spec_controller: Optional[SpecController] = None,
    ):
        """The engine runs on the device of ``params``. ``block_size``
        turns on paged KV; ``arena_blocks`` caps the arena below full
        capacity to serve under an explicit memory budget.

        ``draft_model`` / ``draft_params`` turn on speculative decoding:
        decode actions become draft-then-verify rounds whose draft length
        ``spec_controller`` (default ``SpecController(gamma_max)``)
        adapts. The draft pool lives on the device of ``draft_params``."""
        if model.cfg.is_encoder:
            raise ValueError("serving needs a causal decoder architecture")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.pool = SlotPool(
            model, n_slots, max_len, block_size=block_size,
            arena_blocks=arena_blocks, device=self.device,
        )
        self.sched = scheduler or Scheduler(n_slots)
        self.prefill_bucket = prefill_bucket
        self.stats = EngineStats()
        self.events: List[Tuple[str, float, int]] = []  # (action, vtime, rid)
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
        return rid

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
            self._free_slot(slot)
        req.t_cancelled = self.sched.clock.now
        req.cancel_reason = reason
        self.stats.cancelled_requests += 1
        self.events.append(("cancel", self.sched.clock.now, rid))
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

    # -- introspection -------------------------------------------------------
    def request(self, rid: int) -> Request:
        return self._requests[rid]

    # -- actions -------------------------------------------------------------
    def _slot_of(self, rid: int) -> int:
        return self.pool.owner.index(rid)

    @staticmethod
    def _budget(req: Request) -> int:
        """Cache rows a request can touch over its whole lifetime —
        reserved in full at admission so decode never stalls on blocks."""
        return req.prompt_len + req.max_new_tokens

    def _can_admit(self, req: Request) -> bool:
        return self.pool.can_admit(self._budget(req))

    def _do_prefill(self, req: Request) -> None:
        sched, pool = self.sched, self.pool
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
        # overhang past them falls into the NULL sink).
        pool.ensure_rows(slot, start + n_tok)
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
            tok = int(torch.argmax(logits[0, -1]))
            self._emit(req, tok)
            if self._finished(req):     # max_new_tokens == 1
                self._free_slot(slot)
            else:
                self._pending[slot] = tok
                self._decoding[slot] = True
        self.events.append(("prefill", self.sched.clock.now, req.rid))

    def _do_decode(self) -> None:
        pool = self.pool
        t0 = time.perf_counter()
        # Each decoding lane writes one row at its position: grow its block
        # table first (never fails: the whole budget was committed).
        for slot in np.nonzero(self._decoding)[0]:
            pool.ensure_rows(int(slot), int(pool.positions[slot]) + 1)
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

    def _free_slot(self, slot: int) -> None:
        self.pool.free(slot)
        if self.speculative:
            self.draft.pool.free(slot)

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
        t0 = time.perf_counter()
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

    def _emit(self, req: Request, tok: int) -> None:
        if not req.tokens:
            req.t_first_token = self.sched.clock.now
        req.tokens.append(tok)
        self.stats.generated_tokens += 1

    def _finished(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            if req.t_done is None:
                req.t_done = self.sched.clock.now
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
            self.sched.on_idle()
            self.events.append(("idle", self.sched.clock.now, -1))
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
