"""Admission + prefill/decode interleaving with a deterministic event clock.

A copy of the reference scheduler (``repro.serve.scheduler``) for the
port's engine, with its speculation pricing and callbacks (the draft
mirror of a prefill, the draft lockstep tick, the draft-then-verify
round), its preemption economics (``CostModel.recompute`` / ``hold``,
``Scheduler.requeue``) and its observability hooks (the
``sched.queue_wait`` histogram and the ``sched.waiting_depth`` gauge).

Every tick the scheduler picks ONE action — admit-and-prefill a waiting
request (possibly one chunk of it), run a decode tick over the whole
slot pool, or idle until the next arrival. Virtual time advances by a
linear cost model per action, so latencies are exact functions of the
workload, while the engine separately measures wall time. A long prompt
is chopped into ``prefill_chunk``-token pieces, and between consecutive
prefill actions at least ``decode_per_prefill`` decode ticks run whenever
sequences are active. Pure host logic: nothing here touches tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS, Observability

__all__ = ["Request", "CostModel", "EventClock", "Scheduler", "next_bucket"]


def next_bucket(n: int, base: int = 16) -> int:
    """Smallest power-of-two multiple of ``base`` >= n (prefill shape
    bucketing)."""
    b = base
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival: float = 0.0
    #: absolute virtual-time deadline (None = no deadline). Set by the
    #: caller at submit, or stamped by the scheduler at admission when it
    #: was built with ``deadline_ticks``. An unfinished request past its
    #: deadline is cancelled: slot and blocks freed, partial output kept.
    deadline: Optional[float] = None
    # -- filled by the engine ------------------------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_cancelled: Optional[float] = None
    cancel_reason: Optional[str] = None   # "deadline" | "cancelled" | "migrated"
    prefilled: int = 0            # prompt tokens already in cache (chunked)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_len(self) -> int:
        """Tokens the next prefill phase must put in cache: the prompt,
        plus, for a PREEMPTED request, every emitted token but the last
        (the first decode tick after the replay feeds that one, so the
        resumed stream equals the uninterrupted one)."""
        return self.prompt_len + max(len(self.tokens) - 1, 0)

    def prefill_target(self) -> np.ndarray:
        """The exact token sequence prefill feeds — see ``prefill_len``."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([
            self.prompt, np.asarray(self.tokens[:-1], self.prompt.dtype)
        ])

    @property
    def cancelled(self) -> bool:
        return self.t_cancelled is not None


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Virtual seconds per engine action: a per-launch constant plus a
    per-token term for prefill; decode ticks cost the same regardless of
    how many slots are live (the whole pool is one fixed-shape call).

    Speculation pricing: ``draft_ratio`` is the draft/target cost ratio
    (one draft action costs ``draft_ratio`` times the target's), and a
    verify call scoring a window of S tokens a lane costs one decode tick
    plus ``verify_per_token * S``."""

    prefill_base: float = 1e-3
    prefill_per_token: float = 1e-4
    decode_tick: float = 1e-3
    draft_ratio: float = 0.3
    verify_per_token: float = 1e-4

    def prefill(self, n_tokens: int) -> float:
        return self.prefill_base + self.prefill_per_token * n_tokens

    def decode(self) -> float:
        return self.decode_tick

    # -- speculation ---------------------------------------------------------
    def draft_decode(self) -> float:
        return self.draft_ratio * self.decode_tick

    def draft_prefill(self, n_tokens: int) -> float:
        return self.draft_ratio * self.prefill(n_tokens)

    def verify(self, n_tokens: int) -> float:
        """One batched verify call scoring ``n_tokens`` positions a lane."""
        return self.decode_tick + self.verify_per_token * n_tokens

    # -- preemption economics -------------------------------------------------
    def recompute(self, n_tokens: int) -> float:
        """Price of evicting a lane and replaying ``n_tokens`` of prefix
        later (prefill from the longest still-resident prefix)."""
        return self.prefill(n_tokens) if n_tokens > 0 else 0.0

    def hold(self, remaining_tokens: int) -> float:
        """Price of keeping a lane's blocks until it finishes on its own:
        the decode ticks it still needs."""
        return self.decode_tick * max(int(remaining_tokens), 0)

    def spec_round(self, draft_ticks: int, verify_tokens: int,
                   replay: bool = False) -> float:
        """One speculation round: sequential draft ticks (any resync tick
        included), one target verify, and, for drafts with recurrent
        state (which cannot rewind), a draft-scale replay scan over the
        same window (``replay``)."""
        c = draft_ticks * self.draft_decode() + self.verify(verify_tokens)
        if replay:
            c += self.draft_ratio * self.verify(verify_tokens)
        return c


class EventClock:
    def __init__(self, cost: Optional[CostModel] = None):
        self.cost = cost or CostModel()
        self.now = 0.0

    def advance_prefill(self, n_tokens: int) -> None:
        self.now += self.cost.prefill(n_tokens)

    def advance_decode(self) -> None:
        self.now += self.cost.decode()

    def advance_draft_prefill(self, n_tokens: int) -> None:
        self.now += self.cost.draft_prefill(n_tokens)

    def advance_spec_round(self, draft_ticks: int, verify_tokens: int,
                           replay: bool = False) -> None:
        self.now += self.cost.spec_round(draft_ticks, verify_tokens, replay)

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)


class Scheduler:
    """Chooses the next engine action. Pure host logic, fully deterministic."""

    def __init__(
        self,
        n_slots: int,
        *,
        prefill_chunk: Optional[int] = None,
        decode_per_prefill: int = 4,
        clock: Optional[EventClock] = None,
        deadline_ticks: Optional[int] = None,
        obs: Optional[Observability] = None,
    ):
        """``deadline_ticks``: default per-request deadline, in decode-tick
        units of the clock's cost model, stamped at ADMISSION (queueing
        time does not count against it). Requests submitted with an
        explicit absolute ``Request.deadline`` keep it."""
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.decode_per_prefill = max(int(decode_per_prefill), 0)
        self.clock = clock or EventClock()
        self.deadline_ticks = deadline_ticks
        self.waiting: List[Request] = []
        self.running: List[Request] = []   # admitted, mid-prefill (chunked)
        self._decode_debt = 0              # decode ticks owed before next prefill
        self.bind_obs(obs or NULL_OBS)

    def bind_obs(self, obs: Observability) -> None:
        """Attach (or swap) an observability bundle. The engine calls this
        for schedulers built without one, so that a default scheduler
        still reports queue metrics when the engine is instrumented."""
        self.obs = obs
        self._h_wait = obs.metrics.histogram("sched.queue_wait")
        self._g_depth = obs.metrics.gauge("sched.waiting_depth")

    # -- queue ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))  # FIFO by arrival
        self._g_depth.set(len(self.waiting))

    def _eligible(self) -> Optional[Request]:
        for r in self.waiting:
            if r.arrival <= self.clock.now:
                return r
        return None

    def _next_arrival(self) -> Optional[float]:
        return min((r.arrival for r in self.waiting), default=None)

    # -- policy --------------------------------------------------------------
    def next_action(
        self, n_active: int, n_free: int, can_admit=None
    ) -> Tuple[str, Optional[Request]]:
        """-> ("prefill", request) | ("decode", None) | ("idle", None) |
        ("done", None).

        Mid-prefill requests always finish their remaining chunks before
        new admissions (they hold a slot). A fresh admission needs a free
        slot, a paid-down decode debt, and — when the engine supplies a
        ``can_admit(request)`` predicate (paged pools: "enough free
        blocks for the whole token budget") — a passing budget check;
        otherwise decode if anything is active; otherwise jump the clock
        to the next arrival.
        """
        if self.running:
            req = self.running[0]
            if self._decode_debt > 0 and n_active > len(self.running):
                # sequences besides the mid-prefill ones are decoding:
                # interleave before the next chunk.
                self._decode_debt -= 1
                return "decode", None
            return "prefill", req
        req = self._eligible()
        if req is not None and n_free > 0 and (can_admit is None or can_admit(req)):
            if self._decode_debt > 0 and n_active > 0:
                self._decode_debt -= 1
                return "decode", None
            return "prefill", req
        if n_active > 0:
            return "decode", None
        nxt = self._next_arrival()
        if nxt is not None:
            return "idle", None
        return "done", None

    # -- engine callbacks ----------------------------------------------------
    def chunk_for(self, req: Request) -> Tuple[int, int]:
        """(start, n_tokens) of the next prefill chunk for ``req``,
        measured against ``prefill_len``, so a preempted request's replay
        chunks like a long prompt."""
        start = req.prefilled
        remaining = req.prefill_len - start
        if self.prefill_chunk is None:
            return start, remaining
        return start, min(self.prefill_chunk, remaining)

    def requeue(self, req: Request) -> None:
        """Put a PREEMPTED request back in the arrival queue: its slot and
        blocks were taken, its emitted tokens are kept, and its next
        admission replays from the longest still-resident prefix.
        ``arrival`` stays as it was: the request's latency includes the
        eviction, and FIFO order re-admits it first."""
        if req in self.running:
            self.running.remove(req)
        req.prefilled = 0
        req.t_admit = None
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))
        self._g_depth.set(len(self.waiting))

    def on_admit(self, req: Request) -> None:
        self.waiting.remove(req)
        self.running.append(req)
        req.t_admit = self.clock.now
        if req.deadline is None and self.deadline_ticks is not None:
            req.deadline = (
                self.clock.now + self.deadline_ticks * self.clock.cost.decode_tick
            )
        self._g_depth.set(len(self.waiting))
        # Queue wait, clamped at 0: a hedge copy can be admitted on a
        # replica whose clock is behind the logical arrival stamp.
        self._h_wait.observe(max(self.clock.now - req.arrival, 0.0))

    def drop(self, req: Request) -> None:
        """Forget a cancelled request wherever it sits in the queues
        (waiting or mid-prefill running; a decoding request is in
        neither — its slot is the engine's to free)."""
        if req in self.waiting:
            self.waiting.remove(req)
        if req in self.running:
            self.running.remove(req)
        self._g_depth.set(len(self.waiting))

    def on_prefill_chunk(self, req: Request, n_tokens: int, done: bool) -> None:
        req.prefilled += n_tokens
        self.clock.advance_prefill(n_tokens)
        if done:
            self.running.remove(req)
        self._decode_debt = self.decode_per_prefill

    def on_decode_tick(self) -> None:
        self.clock.advance_decode()

    def on_draft_prefill(self, n_tokens: int) -> None:
        """The draft mirrors every admission prefill (its cache must hold
        the same prefix); priced at the draft cost ratio."""
        self.clock.advance_draft_prefill(n_tokens)

    def on_draft_decode(self) -> None:
        """One draft lockstep tick of a non-speculating (gamma = 0) round:
        the draft consumes what the target consumed."""
        self.clock.now += self.clock.cost.draft_decode()

    def on_spec_round(self, draft_ticks: int, verify_tokens: int, emitted: int,
                      replay: bool = False) -> None:
        """One speculation round in place of a decode tick. The interleave
        owes in-flight requests decode PROGRESS between prefill chunks: a
        round is worth ``emitted`` ticks of it (the engine reports its
        weakest live lane's committed tokens). ``next_action`` paid 1 when
        it issued the round; the other ``emitted - 1`` are paid here."""
        self.clock.advance_spec_round(draft_ticks, verify_tokens, replay)
        self._decode_debt = max(0, self._decode_debt - max(emitted - 1, 0))

    def on_idle(self) -> None:
        nxt = self._next_arrival()
        if nxt is not None:
            self.clock.advance_to(nxt)
