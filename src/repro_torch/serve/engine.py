"""Continuous-batching inference engine over a fixed slot pool (port of
``repro.serve.engine`` without speculation, prefix sharing, migration and
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

``run_static`` is the static-batching baseline: same pool and kernels,
but admissions barrier until the whole previous batch drains.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.steps import make_slot_decode_step, make_slot_prefill_step
from .kv_pool import SlotPool
from .scheduler import CostModel, EventClock, Request, Scheduler, next_bucket

__all__ = ["ServeEngine", "EngineStats", "generate_offline", "run_static"]


@dataclasses.dataclass
class EngineStats:
    generated_tokens: int = 0
    decode_ticks: int = 0
    decode_tokens: int = 0        # tokens emitted by decode ticks
    prefill_calls: int = 0
    prefill_tokens: int = 0
    cancelled_requests: int = 0   # deadline expiries + explicit cancels
    virtual_seconds: float = 0.0
    wall_seconds: float = 0.0
    decode_wall_seconds: float = 0.0   # host clock around decode ticks

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
    ):
        """The engine runs on the device of ``params``. ``block_size``
        turns on paged KV; ``arena_blocks`` caps the arena below full
        capacity to serve under an explicit memory budget."""
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
            self.pool.free(slot)
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
        logits, slot_caches = self._prefill(
            self.params,
            torch.as_tensor(chunk, device=self.device),
            pool.read_slot(slot),
            torch.tensor([n_tok], device=self.device),
            start,
            pool.tables_device(slot),
        )
        pool.write_slot(slot, slot_caches, position=start + n_tok)
        done = start + n_tok >= req.prefill_len
        sched.on_prefill_chunk(req, n_tok, done)
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens += n_tok
        if done:
            tok = int(torch.argmax(logits[0, -1]))
            self._emit(req, tok)
            if self._finished(req):     # max_new_tokens == 1
                pool.free(slot)
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
                pool.free(slot)
            else:
                self._pending[slot] = next_tok[slot]
        self.events.append(("decode", self.sched.clock.now, -1))

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
        would silently desync ``_pending``/``_decoding``)."""
        moves = self.pool.defrag()
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
