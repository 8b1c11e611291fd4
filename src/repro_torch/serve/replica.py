"""One fleet member: a ServeEngine plus the fault surface chaos drives
(the port's copy of ``repro.serve.replica``).

A replica is an independent ``ServeEngine`` (own scheduler, own virtual
clock, own slot pool / paged arena) wearing the same fault model the
training runtime's straggler simulator applies to workers: it can FAIL
(drop out of the fleet, losing every in-flight request), run SLOW (every
engine action's virtual cost scales by a factor — a degraded node, not a
dead one), and REJOIN (come back empty and healthy at the fleet's
current time frontier). The frontend injects these from the shared
``repro_torch.runtime.faults.FaultEvent`` schedule and reacts only to what it
can observe — completions stop arriving, response times inflate — never
to the schedule itself (same oracle-free discipline as the training
loop's elastic failover).

Public API contract: a replica owns TIME and LIVENESS, nothing about
requests — submission, hedging, retry, and migration policy live in
``serve.frontend``. ``fail()`` tears down local state and returns the
cancelled requests so the frontend can harvest their partial streams
(greedy decode is deterministic, so every copy's partial output is a
prefix of the same stream and the longest one seeds the retry).

A replica runs where its ``params`` live, as its engine does: replicas
built over one params dict share those weights (nothing writes into
them) and each holds only its own pool. ``fail`` and ``rejoin`` free
and re-use the pool's slots and blocks; they never reallocate caches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.obs import Observability

from .engine import ServeEngine, TicketIntegrityError
from .scheduler import CostModel, EventClock, Request, Scheduler
from .transport import FE, Chunk, Expired, TicketReply, WireMessage, replica_endpoint

__all__ = ["FaultyClock", "Replica", "ReplicaPort"]


class FaultyClock(EventClock):
    """EventClock whose compute actions cost ``slow`` times the model's
    price (1.0 = nominal). Only COMPUTE advances scale — ``advance_to``
    (idle jump to an arrival / rejoin frontier) moves wall position, not
    work, so it stays unscaled."""

    def __init__(self, cost: Optional[CostModel] = None):
        super().__init__(cost)
        self.slow = 1.0

    def advance_prefill(self, n_tokens: int) -> None:
        self.now += self.cost.prefill(n_tokens) * self.slow

    def advance_decode(self) -> None:
        self.now += self.cost.decode() * self.slow

    def advance_draft_prefill(self, n_tokens: int) -> None:
        self.now += self.cost.draft_prefill(n_tokens) * self.slow

    def advance_spec_round(
        self, draft_ticks: int, verify_tokens: int, replay: bool = False
    ) -> None:
        self.now += self.cost.spec_round(draft_ticks, verify_tokens, replay) * self.slow


class Replica:
    """An engine + id + liveness. Builds its own ``FaultyClock`` and
    ``Scheduler`` so fleet members never share mutable state."""

    def __init__(
        self,
        replica_id: int,
        model,
        params,
        *,
        n_slots: int,
        max_len: int,
        cost: Optional[CostModel] = None,
        block_size: Optional[int] = None,
        arena_blocks: Optional[int] = None,
        prefix_sharing: bool = False,
        prefill_chunk: Optional[int] = None,
        decode_per_prefill: int = 4,
        prefill_bucket: int = 16,
        obs: Optional[Observability] = None,
    ):
        self.id = int(replica_id)
        self.clock = FaultyClock(cost)
        sched = Scheduler(
            n_slots,
            prefill_chunk=prefill_chunk,
            decode_per_prefill=decode_per_prefill,
            clock=self.clock,
        )
        self.engine = ServeEngine(
            model, params,
            n_slots=n_slots, max_len=max_len, scheduler=sched,
            prefill_bucket=prefill_bucket,
            block_size=block_size, arena_blocks=arena_blocks,
            prefix_sharing=prefix_sharing,
            obs=obs, obs_name=f"replica {self.id}",
        )
        self.alive = True

    def _fault_instant(self, kind: str, **args) -> None:
        """Mark a fault-surface transition on this replica's trace lane."""
        eng = self.engine
        if eng.obs.enabled:
            eng._tr.instant(
                "fault", eng.pid, self.clock.now,
                args={"kind": kind, "replica": self.id, **args},
            )
            eng.obs.metrics.counter(f"replica.fault.{kind}").inc()

    @property
    def now(self) -> float:
        return self.clock.now

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    def step(self) -> str:
        if not self.alive:
            raise RuntimeError(f"replica {self.id} is down")
        return self.engine.step()

    # -- fault surface -------------------------------------------------------
    def set_slow(self, factor: float) -> None:
        """Degrade (or restore, factor=1.0) this replica's speed."""
        if factor <= 0:
            raise ValueError("slow factor must be > 0")
        self.clock.slow = float(factor)
        self._fault_instant("slow", factor=float(factor))

    def fail(self) -> List[Request]:
        """Hard failure: every in-flight request dies with the node.
        Local slots and blocks are torn down (the engine survives to be
        rejoined later — a process restart with warm weights). Returns
        the cancelled requests, partial token streams intact, so the
        caller can requeue from the longest prefix."""
        self.alive = False
        self._fault_instant("fail")
        eng = self.engine
        out = []
        for rid in eng.live_rids():
            req = eng.request(rid)
            eng.cancel(rid, reason="cancelled")
            out.append(req)
        return out

    def rejoin(self, now: float) -> None:
        """Come back empty, healthy, and AT THE FLEET'S TIME FRONTIER —
        a rejoining node does not get to serve from the past."""
        self.alive = True
        self.clock.slow = 1.0
        self.clock.advance_to(now)
        self._fault_instant("rejoin")


class ReplicaPort:
    """The replica-side endpoint of the frontend↔replica message
    protocol (``serve.transport``): translates wire messages into engine
    calls and engine progress back into wire messages. The frontend
    NEVER sees replica-local rids — every copy is addressed by its
    ``(gid, attempt)`` key, which is also the receiver's idempotency
    key.

    Inbound: ``Submit`` admits a copy (stamping its absolute deadline on
    THIS replica's clock from the carried budget), ``Cancel`` tears one
    down (a tombstone in ``cancelled`` also blocks a late-retransmitted
    Submit from admitting a zombie after its cancel already landed), and
    ``Ticket`` imports a migration ticket — integrity verification
    happens inside ``import_request``; a :class:`TicketIntegrityError`
    becomes a ``corrupt`` reply (reject-and-requeue), pool backpressure
    a ``busy`` reply.

    Outbound (``flush`` after every engine step): new tokens ship as
    position-addressed ``Chunk`` messages — idempotent and order-free by
    construction, so duplicated/reordered delivery rewrites the same
    cells — with the terminal chunk carrying the stream length and the
    replica-local service time; a deadline expiry ships the full partial
    prefix as ``Expired``.

    ``admission_log`` is harness-facing monitoring, NOT control: it
    records every engine admission keyed by copy, append-only across
    ``reset()``, so the chaos harness can check the exactly-once-effects
    oracle (with transport dedup disabled, a duplicated Submit really
    does admit twice — that is the violation the oracle exists to
    catch)."""

    def __init__(self, replica: Replica, transport):
        self.rep = replica
        self.transport = transport
        self.ep = replica_endpoint(replica.id)
        self.rid_by_key: Dict[Tuple[int, int], int] = {}
        self.cursor: Dict[Tuple[int, int], int] = {}
        self.t_start: Dict[Tuple[int, int], float] = {}
        self.closed: Set[Tuple[int, int]] = set()
        self.cancelled: Set[Tuple[int, int]] = set()
        self.admission_log: List[Tuple[int, int]] = []

    # -- inbound -------------------------------------------------------------
    def on_message(self, msg: WireMessage, tick: int) -> None:
        if msg.kind == "submit":
            self._on_submit(msg.payload, tick)
        elif msg.kind == "cancel":
            self._on_cancel(msg.payload)
        elif msg.kind == "ticket":
            self._on_ticket(msg.payload, tick)
        else:
            raise ValueError(f"replica port got unexpected {msg.kind!r}")

    def _on_submit(self, p, tick: int) -> None:
        key = (p.gid, p.attempt)
        if key in self.cancelled:
            return      # cancel overtook a (re)transmitted submit
        if self.transport.dedup and key in self.rid_by_key:
            return      # idempotent receiver (transport dedup's backstop)
        self.admission_log.append(key)
        now = self.rep.clock.now
        t0 = max(now, float(p.arrival))
        dl = None if p.deadline_budget is None else t0 + p.deadline_budget
        rid = self.rep.engine.submit(
            p.prompt, p.max_new_tokens, arrival=p.arrival, deadline=dl
        )
        self.rid_by_key[key] = rid
        self.cursor[key] = 0
        self.t_start[key] = t0
        self.closed.discard(key)

    def _on_cancel(self, p) -> None:
        key = (p.gid, p.attempt)
        self.cancelled.add(key)
        rid = self.rid_by_key.get(key)
        if rid is not None:
            self.rep.engine.cancel(rid)     # no-op if already terminal
            self.closed.add(key)

    def _on_ticket(self, p, tick: int) -> None:
        key = (p.gid, p.attempt)
        if key in self.cancelled:
            self._reply(p, "busy", tick)
            return
        if self.transport.dedup and key in self.rid_by_key:
            self._reply(p, "ok", tick)      # duplicate ticket: re-ack
            return
        now = self.rep.clock.now
        adj = p.ticket
        if p.remaining_deadline is not None:
            # Absolute deadlines are clock-local: restamp from the
            # carried remaining budget (excluded from the integrity
            # seal for exactly this reason).
            adj = dataclasses.replace(adj, deadline=now + p.remaining_deadline)
        try:
            rid = self.rep.engine.import_request(adj)
        except TicketIntegrityError:
            self._reply(p, "corrupt", tick)
            return
        if rid is None:
            self._reply(p, "busy", tick)
            return
        self.admission_log.append(key)
        self.rid_by_key[key] = rid
        self.cursor[key] = len(p.ticket.tokens)
        self.t_start[key] = now - float(p.elapsed)
        self.closed.discard(key)
        self._reply(p, "ok", tick)

    def _reply(self, p, status: str, tick: int) -> None:
        self.transport.send(
            self.ep, FE, TicketReply(p.gid, p.attempt, status), tick
        )

    # -- outbound ------------------------------------------------------------
    def flush(self, tick: int) -> None:
        """Ship engine progress since the last flush: one Chunk per copy
        with new tokens (terminal chunk carries total + elapsed), one
        Expired per deadline-cancelled copy. Local teardown paths
        (explicit cancel, migration export) close silently — their
        initiator already knows."""
        eng = self.rep.engine
        for key, rid in list(self.rid_by_key.items()):
            if key in self.closed:
                continue
            req = eng.request(rid)
            if req.cancelled:
                if req.cancel_reason == "deadline":
                    self.transport.send(
                        self.ep, FE,
                        Expired(key[0], key[1], tuple(req.tokens)), tick,
                    )
                self.closed.add(key)
                continue
            cur, n = self.cursor[key], len(req.tokens)
            done = req.t_done is not None
            if n > cur:
                elapsed = (
                    self.rep.clock.now - self.t_start[key] if done else None
                )
                self.transport.send(
                    self.ep, FE,
                    Chunk(key[0], key[1], cur, tuple(req.tokens[cur:n]),
                          done=done, total=(n if done else None),
                          elapsed=elapsed),
                    tick,
                )
                self.cursor[key] = n
                if done:
                    self.closed.add(key)

    # -- introspection (co-located control plane: drain/fail paths) ----------
    def rid_of(self, gid: int, attempt: int) -> Optional[int]:
        return self.rid_by_key.get((gid, attempt))

    def elapsed_of(self, gid: int, attempt: int) -> float:
        return self.rep.clock.now - self.t_start[(gid, attempt)]

    def forget(self, gid: int, attempt: int) -> None:
        """Drop a copy's mapping after a co-located teardown (export)."""
        self.closed.add((gid, attempt))

    def reset(self) -> None:
        """Process death / rejoin: protocol state dies with the process.
        ``admission_log`` survives — it is the harness's god's-eye
        monitor, not process memory."""
        self.rid_by_key.clear()
        self.cursor.clear()
        self.t_start.clear()
        self.closed.clear()
        self.cancelled.clear()
