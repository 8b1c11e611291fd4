"""Async serving frontend: hedged dispatch over N replicas with chaos
failover, bounded retry, and in-flight KV migration — over an explicit,
faultable message transport (the port's copy of ``repro.serve.frontend``).

This is the serving analogue of the training loop's elastic failover:
the frontend owns a fleet of ``Replica`` engines and a ``HedgedRouter``,
and every request is dispatched per the router's order-statistic pricing
— ``n_h`` concurrent copies, keep the first to finish, cancel the rest.
Cancellation here is REAL: a hedged loser's engine slot and paged arena
blocks are freed when the cancel lands (``ServeEngine.cancel``), which
is what makes hedging affordable under memory pressure, and the loser is
fed to the tracker as CENSORED telemetry (all we learn is "slower than
the winner") — the same fastest-k censoring discipline the paper's
training side uses.

The frontend talks to replicas ONLY through
``serve.transport``: submits, cancels, stream chunks, migration tickets
and their replies are wire messages that a fault plan can drop,
duplicate, reorder, delay, or partition away, and the invariants below
survive because the protocol is idempotent at-least-once — copies are
addressed by ``(gid, attempt)`` (never replica-local rids), stream
chunks are position-addressed, the transport acks/dedups/retransmits
with backoff priced from the router's censored telemetry, and migration
tickets carry an end-to-end integrity checksum (reject-and-requeue on
corruption). The ONE deliberate exception to messages-only is the
co-located control plane: teardown of a node the chaos plane just
killed or drained (harvesting partials, exporting tickets) touches that
node's engine/port directly — that code runs ON the node in a real
deployment, and there is no network between a process and itself.

Failure semantics:

* **Deadlines** — each dispatch attempt carries a deadline BUDGET; the
  replica stamps the absolute deadline on its own clock at admission.
  The engine polices it every step; an expired copy frees its
  slot/blocks and surfaces (via an ``Expired`` message) as a censored
  observation at the deadline level. When every copy of a request
  expires, the request requeues (bounded by ``retry_budget``).
* **Retry-and-requeue** — a retry does NOT restart generation: greedy
  decode is deterministic, so every copy's partial output is a prefix of
  the same stream; the longest RECEIVED prefix is appended to the prompt
  and only the remaining tokens are regenerated. Final streams are
  byte-identical to a fault-free run.
* **Fleet degradation** — a dead replica is marked out of the fleet,
  its transport endpoint is forgotten (in-flight messages die with the
  process, dedup history wipes — a rejoin is a fresh process), and the
  router re-prices from the shrunken fleet.
* **Migration** — ``drain(r)`` exports every decoding request on ``r``
  into sealed ``MigrationTicket``s and ships each to the
  fastest-estimated peer as a ``Ticket`` message; the destination
  verifies integrity and replies ok / busy / corrupt. Busy walks the
  peer list; corrupt is reject-and-requeue from the last trusted prefix
  — a mutated ticket is NEVER resumed. A draining node stops taking new
  work but its outbound messages keep (re)transmitting until acked:
  graceful decommission flushes the pipe, hard failure cuts it.

Chaos enters on two axes: the node-level ``FaultEvent`` schedule shared
with the training runtime (fail / slow / rejoin / drain, keyed on
plane-wide ticks) and the message-level ``TransportFaults`` plan
(per-transmission drop/dup/delay/reorder/corrupt directives plus one-way
partitions). The frontend reacts only to observables — messages,
response times, liveness marks — never to either schedule.

Public API contract: MODEL-AGNOSTIC and deterministic — same workload +
same schedules -> same token streams, same virtual latencies, same wire
history. All policy (hedging, retry, migration targets) lives here;
replicas own time and liveness; engines own slots and caches; the
transport owns delivery.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS, Observability
from repro_torch.runtime.faults import FaultEvent, schedule_by_step

from .replica import Replica, ReplicaPort
from .router import HedgedRouter, HedgePlan
from .transport import (
    FE,
    Cancel,
    Submit,
    Ticket,
    Transport,
    TransportFaults,
    replica_endpoint,
)

__all__ = ["FrontendRequest", "Frontend"]


@dataclasses.dataclass
class _AttemptBuf:
    """Reassembly buffer for one copy's position-addressed chunk stream.
    Duplicated chunks rewrite the same cells with the same values;
    reordered chunks fill different cells; the stream is complete when
    positions ``0..total-1`` are all present."""

    toks: Dict[int, int] = dataclasses.field(default_factory=dict)
    total: Optional[int] = None
    elapsed: Optional[float] = None

    @property
    def complete(self) -> bool:
        return self.total is not None and all(
            i in self.toks for i in range(self.total)
        )

    def stream(self) -> List[int]:
        return [self.toks[i] for i in range(self.total)]

    def prefix(self) -> List[int]:
        """Longest contiguous received prefix — the safe salvage when
        the sender died mid-stream (later cells past a hole cannot be
        trusted as committed)."""
        out, i = [], 0
        while i in self.toks:
            out.append(self.toks[i])
            i += 1
        return out


@dataclasses.dataclass
class _PendingTicket:
    """A migration in flight: the frontend holds the sealed (intact)
    ticket while a wire copy rides to ``dest``; ``tried`` prevents
    re-offering to a peer that already refused."""

    attempt: int
    ticket: object                      # engine.MigrationTicket (sealed)
    remaining: Optional[float]          # deadline budget left (src clock)
    elapsed: float                      # service time already accrued
    dest: Optional[int] = None
    tried: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class FrontendRequest:
    """One logical request as the frontend sees it — possibly served by
    several copies (hedges, retries, migrations) over its lifetime, each
    addressed by a globally unique ``(gid, attempt)`` key. ``tokens`` is
    the committed stream prefix stitched across attempts; ``partial``
    buffers the best received prefix from the current attempt's dead
    copies until requeue."""

    gid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    partial: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    copies: Dict[int, int] = dataclasses.field(default_factory=dict)
    recv: Dict[int, _AttemptBuf] = dataclasses.field(default_factory=dict)
    n_attempts: int = 0
    pending_ticket: Optional[_PendingTicket] = None
    plan: Optional[HedgePlan] = None
    t_done: Optional[float] = None
    winner: Optional[int] = None
    dropped: bool = False

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def latency(self) -> float:
        return (self.t_done - self.arrival) if self.done else np.inf

    @property
    def live_copies(self) -> int:
        return len(self.copies) + (1 if self.pending_ticket else 0)


class Frontend:
    def __init__(
        self,
        replicas: Sequence[Replica],
        delay_model,
        *,
        quorum: int = 1,
        cost_per_replica: float = 0.0,
        beta: float = 1.0,
        deadline: Optional[float] = None,
        retry_budget: int = 3,
        events: Sequence[FaultEvent] = (),
        transport_faults: Optional[TransportFaults] = None,
        reliable: bool = True,
        dedup: bool = True,
        base_rto_ticks: int = 16,
        max_ticks: Optional[int] = None,
        n_max: Optional[int] = None,
        ewma_alpha: float = 0.1,
        warmup: int = 8,
        obs: Optional[Observability] = None,
    ):
        """``deadline``: per-ATTEMPT virtual-second budget, stamped
        absolute by the receiving replica at admission (None = no
        deadlines). ``events``: node-level chaos schedule keyed on
        plane-wide ticks. ``transport_faults``: message-level fault plan
        (``serve.transport``). ``reliable``/``dedup``: the at-least-once
        layer's knobs — ONLY disable them to demonstrate what they buy
        (the chaos harness does exactly that). ``max_ticks``: hard cap
        on plane ticks; exceeding it raises — the chaos harness's
        liveness oracle. ``obs``: the observability bundle — shared with
        the router and transport; replicas carry their own (pass the
        same one when building them to get the full fleet on one
        timeline)."""
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        n_slots = self.replicas[0].engine.pool.n_slots
        self.obs = obs or NULL_OBS
        self._tr = self.obs.tracer
        self.pid = self._tr.register_process("frontend")
        self.router = HedgedRouter(
            delay_model, n_replicas=len(self.replicas),
            quorum=quorum, cost_per_replica=cost_per_replica,
            slots_per_replica=n_slots, n_max=n_max,
            ewma_alpha=ewma_alpha, warmup=warmup, obs=self.obs,
        )
        self.transport = Transport(
            len(self.replicas), transport_faults,
            reliable=reliable, dedup=dedup, base_rto_ticks=base_rto_ticks,
            rto_scale=self._rto_scale, obs=self.obs,
        )
        self.ports = [ReplicaPort(rep, self.transport) for rep in self.replicas]
        self.beta = float(beta)
        self.deadline = deadline
        self.retry_budget = int(retry_budget)
        self.max_ticks = max_ticks
        self.schedule = schedule_by_step(events)
        self.ticks = 0                      # plane-wide engine steps
        self.queue: List[FrontendRequest] = []
        self.inflight: Dict[int, FrontendRequest] = {}
        self.results: Dict[int, FrontendRequest] = {}
        self.dropped: List[int] = []
        self.migrations = 0
        self.ticket_rejects = 0             # corrupt tickets refused
        self._next_gid = 0
        # -- observability state ---------------------------------------------
        self._gid_spans: Dict[int, int] = {}   # gid -> open lifecycle span
        self._ts = 0.0                         # monotone frontend timestamp
        m = self.obs.metrics
        self._m_wins = m.counter("hedge.wins")
        self._m_losers = m.counter("hedge.losers_cancelled")
        self._m_expiries = m.counter("hedge.deadline_expiries")
        self._m_retries = m.counter("frontend.retries")
        self._m_dropped = m.counter("frontend.dropped")
        self._m_migrations = m.counter("frontend.migrations")
        self._m_ticket_rejects = m.counter("frontend.ticket_rejects")
        self._h_latency = m.histogram("frontend.latency")

    def _rto_scale(self, ep: str) -> float:
        """Retransmission pricing: a destination the censored telemetry
        says is k-times slow gets a k-times retransmit budget before the
        sender burns a duplicate transmission."""
        if ep == FE:
            return 1.0
        return float(self.router.slowdowns()[int(ep[1:])])

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0) -> int:
        gid = self._next_gid
        self._next_gid += 1
        fr = FrontendRequest(
            gid, np.asarray(prompt, np.int32).reshape(-1),
            int(max_new_tokens), float(arrival),
        )
        self.queue.append(fr)
        if self._tr.enabled:
            # Logical lifecycle span: [arrival, t_done]. Every retirement
            # path stamps a ts >= arrival, so the span never inverts.
            self._gid_spans[gid] = self._tr.begin_span(
                "request", self.pid, fr.arrival,
                args={"gid": gid, "prompt_len": int(fr.prompt.size),
                      "max_new_tokens": int(max_new_tokens)},
            )
        return gid

    # -- time ----------------------------------------------------------------
    def _frontier(self) -> float:
        return max((rep.now for rep in self.replicas if rep.alive), default=0.0)

    def _stamp(self) -> float:
        """Monotone frontend-lane timestamp: the fleet frontier can go
        BACKWARD when the fastest replica fails, but a trace track may
        not — clamp to the furthest time this lane has already stamped."""
        self._ts = max(self._ts, self._frontier())
        return self._ts

    def _end_gid_span(self, fr: FrontendRequest, outcome: str, ts: float) -> None:
        sid = self._gid_spans.pop(fr.gid, None)
        if sid:
            self._tr.end_span(
                sid, max(ts, fr.arrival),
                args={"outcome": outcome, "n_tokens": len(fr.tokens),
                      "retries": fr.retries},
            )

    # -- fault surface -------------------------------------------------------
    def _apply(self, ev: FaultEvent) -> None:
        rep = self.replicas[ev.worker]
        if self._tr.enabled:
            self._tr.instant(
                "fault", self.pid, self._stamp(),
                args={"kind": ev.kind, "replica": ev.worker,
                      "tick": self.ticks},
            )
        if ev.kind == "fail":
            self._on_fail(ev.worker)
        elif ev.kind == "slow":
            if rep.alive:
                rep.set_slow(ev.factor)
        elif ev.kind == "rejoin":
            if rep.alive:
                rep.set_slow(1.0)
            else:
                rep.rejoin(self._frontier())
                self.ports[ev.worker].reset()
                self.transport.revive_endpoint(replica_endpoint(ev.worker))
                self.router.mark_joined(ev.worker)
        elif ev.kind == "drain":
            if rep.alive:
                self.drain(ev.worker)
                rep.alive = False
                self.router.mark_failed(ev.worker)
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")

    def _on_fail(self, r: int) -> None:
        """Hard failure: the process dies — its engine state, its
        protocol state, and every message queued to or from it. Partial
        streams are salvaged from what the frontend RECEIVED, not from
        the corpse's memory."""
        rep = self.replicas[r]
        if not rep.alive:
            return
        self.router.mark_failed(r)
        rep.fail()
        self.ports[r].reset()
        self.transport.forget_endpoint(replica_endpoint(r))
        for fr in list(self.inflight.values()):
            att = fr.copies.pop(r, None)
            if att is not None:
                self.router.release(r)
                prefix = fr.recv[att].prefix()
                if len(prefix) > len(fr.partial):
                    fr.partial = prefix
            pt = fr.pending_ticket
            if pt is not None and pt.dest == r:
                # The in-flight ticket's destination died before (or
                # after — we cannot know) importing: the frontend still
                # holds the intact ticket, so offer it to the next peer.
                pt.dest = None
                self._offer_ticket(fr, pt)
            if att is not None and fr.live_copies == 0:
                self._requeue(fr)

    # -- migration -----------------------------------------------------------
    def drain(self, r: int) -> int:
        """Gracefully decommission replica ``r``: export every decoding
        copy into a sealed ticket and ship it to a peer; abandon (and
        requeue) queued / mid-prefill copies. Export and teardown are
        co-located control plane (this code runs on the node); the
        ticket TRANSFER is a wire message the fault plan can attack.
        Returns the number of tickets put in flight — replies resolve
        asynchronously, so ``self.migrations`` counts landings, not
        departures."""
        rep, port = self.replicas[r], self.ports[r]
        decoding = set(rep.engine.decoding_rids())
        sent = 0
        for fr in list(self.inflight.values()):
            att = fr.copies.get(r)
            if att is None:
                continue
            rid = port.rid_of(fr.gid, att)
            if rid is not None and rid in decoding:
                self._export_and_offer(fr, r, att, rid)
                sent += 1
            else:
                self._abandon_copy(fr, r, att)
        return sent

    def _export_and_offer(
        self, fr: FrontendRequest, src: int, att: int, rid: int
    ) -> None:
        rep, port = self.replicas[src], self.ports[src]
        elapsed = port.elapsed_of(fr.gid, att)
        ticket = rep.engine.export_request(rid)
        port.forget(fr.gid, att)
        remaining = (
            None if ticket.deadline is None
            else max(ticket.deadline - rep.now, 0.0)
        )
        del fr.copies[src]
        self.router.release(src)
        # The sealed ticket is authoritative for the stream prefix it
        # carries. Chunks from ``src`` still in flight will be dropped
        # as stale once the copy is deregistered (the ``_active`` guard)
        # — without this merge, a chunk racing the export would leave a
        # permanent hole in the attempt buffer and strand the request.
        buf = fr.recv[att]
        for i, t in enumerate(ticket.tokens):
            buf.toks[i] = int(t)
        pt = _PendingTicket(
            attempt=att, ticket=ticket, remaining=remaining,
            elapsed=elapsed, tried={src},
        )
        fr.pending_ticket = pt
        self._offer_ticket(fr, pt)

    def _offer_ticket(self, fr: FrontendRequest, pt: _PendingTicket) -> None:
        """Ship the held ticket to the fastest-estimated peer not yet
        tried; when every peer has refused (or none is alive), the
        ticket dies and its tokens seed the requeue prefix. A peer
        already hosting a hedged copy of this request is excluded —
        ``fr.copies`` is keyed by replica, so landing there would
        silently orphan the existing copy's accounting (the chaos
        harness's no-leaks oracle caught exactly that)."""
        slow = self.router.slowdowns()
        dests = sorted(
            (d for d in self.replicas
             if d.alive and d.id not in pt.tried and d.id not in fr.copies),
            key=lambda d: (slow[d.id], d.id),
        )
        if not dests:
            fr.pending_ticket = None
            if len(pt.ticket.tokens) > len(fr.partial):
                fr.partial = list(pt.ticket.tokens)
            if fr.live_copies == 0:
                self._requeue(fr)
            return
        dest = dests[0]
        pt.dest = dest.id
        pt.tried.add(dest.id)
        self.transport.send(
            FE, replica_endpoint(dest.id),
            Ticket(fr.gid, pt.attempt, pt.ticket, pt.remaining, pt.elapsed),
            self.ticks,
        )

    def _abandon_copy(self, fr: FrontendRequest, r: int, att: int) -> None:
        """Tear down a copy on a node being decommissioned (co-located
        control plane). The engine's partial stream is trustworthy here
        — the node is alive and we are standing on it."""
        port = self.ports[r]
        rid = port.rid_of(fr.gid, att)
        if rid is not None:
            eng = self.replicas[r].engine
            local = eng.request(rid)
            eng.cancel(rid)
            if len(local.tokens) > len(fr.partial):
                fr.partial = list(local.tokens)
            port.forget(fr.gid, att)
        del fr.copies[r]
        self.router.release(r)
        if fr.live_copies == 0:
            self._requeue(fr)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self) -> None:
        self.queue.sort(key=lambda fr: (fr.arrival, fr.gid))
        while self.queue:
            plan = self.router.choose_hedge(self.beta)
            if plan is None:
                return
            fr = self.queue.pop(0)
            self.router.begin(plan)
            fr.plan = plan
            fr.copies, fr.recv = {}, {}
            prompt = fr.prompt
            if fr.tokens:
                prompt = np.concatenate(
                    [fr.prompt, np.asarray(fr.tokens, np.int32)]
                )
            remaining = fr.max_new_tokens - len(fr.tokens)
            for r in plan.replicas:
                att = fr.n_attempts
                fr.n_attempts += 1
                fr.copies[r] = att
                fr.recv[att] = _AttemptBuf()
                self.transport.send(
                    FE, replica_endpoint(r),
                    Submit(fr.gid, att, prompt, remaining,
                           fr.arrival, self.deadline),
                    self.ticks,
                )
            self.inflight[fr.gid] = fr
            if self._tr.enabled:
                self._tr.instant(
                    "dispatch", self.pid, self._stamp(),
                    args={"gid": fr.gid, "n_h": plan.n_h,
                          "replicas": list(plan.replicas),
                          "retry": fr.retries},
                )

    def _requeue(self, fr: FrontendRequest) -> None:
        fr.tokens = fr.tokens + fr.partial
        fr.partial = []
        fr.plan, fr.copies, fr.recv = None, {}, {}
        fr.pending_ticket = None
        self.inflight.pop(fr.gid, None)
        if len(fr.tokens) >= fr.max_new_tokens:
            # The dead copies had already finished the stream.
            fr.t_done = self._frontier()
            self.results[fr.gid] = fr
            self._end_gid_span(fr, "done", fr.t_done)
            self._h_latency.observe(fr.latency)
        elif fr.retries >= self.retry_budget:
            fr.dropped = True
            self.dropped.append(fr.gid)
            self.results[fr.gid] = fr
            self._m_dropped.inc()
            self._end_gid_span(fr, "dropped", self._stamp())
        else:
            fr.retries += 1
            self.queue.append(fr)
            self._m_retries.inc()
            if self._tr.enabled:
                self._tr.instant(
                    "requeue", self.pid, self._stamp(),
                    args={"gid": fr.gid, "retry": fr.retries,
                          "prefix_tokens": len(fr.tokens)},
                )

    # -- inbound protocol ----------------------------------------------------
    def _process_inbox(self) -> None:
        for msg in self.transport.receive(FE, self.ticks):
            r = int(msg.src[1:])
            if msg.kind == "chunk":
                self._on_chunk(r, msg.payload)
            elif msg.kind == "expired":
                self._on_expired(r, msg.payload)
            elif msg.kind == "ticketreply":
                self._on_ticket_reply(r, msg.payload)
            else:
                raise ValueError(f"frontend got unexpected {msg.kind!r}")

    def _active(self, r: int, gid: int, attempt: int) -> Optional[FrontendRequest]:
        """The request iff ``(gid, attempt)`` is the CURRENT copy on
        ``r`` — everything else (resolved gids, superseded attempts,
        reassigned replicas) is stale wire traffic to ignore."""
        fr = self.inflight.get(gid)
        if fr is None or fr.copies.get(r) != attempt:
            return None
        return fr

    def _on_chunk(self, r: int, p) -> None:
        fr = self._active(r, p.gid, p.attempt)
        if fr is None:
            return
        buf = fr.recv[p.attempt]
        for i, tok in enumerate(p.tokens):
            buf.toks[p.start + i] = int(tok)
        if p.done:
            buf.total = int(p.total)
            buf.elapsed = float(p.elapsed)
        if buf.complete:
            self._resolve_winner(fr, r, p.attempt)

    def _resolve_winner(self, fr: FrontendRequest, winner: int, att: int) -> None:
        buf = fr.recv[att]
        elapsed = buf.elapsed
        participants = list(fr.copies)
        for r, a in list(fr.copies.items()):
            if r != winner:
                # Loser cancellation is what frees slots AND blocks —
                # it rides the (reliable) wire, so it lands a beat
                # later than the old direct call; the run loop keeps
                # the plane alive until every cancel is acked.
                self.transport.send(
                    FE, replica_endpoint(r), Cancel(fr.gid, a), self.ticks
                )
            self.router.release(r)
        dense = np.zeros(self.router.n_replicas)
        dense[winner] = elapsed
        # Winner observed; losers censored at the winner's elapsed time.
        self.router.record(
            dense, participants, observed=[winner], censor_level=elapsed
        )
        fr.tokens = fr.tokens + buf.stream()
        fr.t_done = max(self.replicas[winner].now, fr.arrival)
        fr.winner = winner
        fr.copies, fr.recv = {}, {}
        self.inflight.pop(fr.gid, None)
        self.results[fr.gid] = fr
        self._m_wins.inc()
        self._m_losers.inc(len(participants) - 1)
        self._h_latency.observe(fr.latency)
        self._end_gid_span(fr, "done", fr.t_done)

    def _on_expired(self, r: int, p) -> None:
        fr = self._active(r, p.gid, p.attempt)
        if fr is None:
            return
        if len(p.tokens) > len(fr.partial):
            fr.partial = list(p.tokens)
        del fr.copies[r]
        self.router.release(r)
        # All the expiry teaches us: this replica was slower than the
        # deadline budget on this request.
        self.router.record(
            np.zeros(self.router.n_replicas), [r],
            observed=[], censor_level=self.deadline,
        )
        self._m_expiries.inc()
        if self._tr.enabled:
            self._tr.instant(
                "deadline_expiry", self.pid, self._stamp(),
                args={"gid": fr.gid, "replica": r},
            )
        if fr.live_copies == 0:
            self._requeue(fr)

    def _on_ticket_reply(self, r: int, p) -> None:
        fr = self.inflight.get(p.gid) or self.results.get(p.gid)
        pt = fr.pending_ticket if fr is not None else None
        if pt is None or pt.dest != r or pt.attempt != p.attempt:
            return
        if fr.done or fr.dropped:
            # The hedge resolved while the ticket was in flight: a
            # successful zombie import must be torn down, a refusal
            # needs nothing.
            fr.pending_ticket = None
            if p.status == "ok":
                self.transport.send(
                    FE, replica_endpoint(r), Cancel(p.gid, p.attempt),
                    self.ticks,
                )
            return
        if p.status == "ok":
            fr.pending_ticket = None
            fr.copies[r] = pt.attempt
            self.router.occupy(r)
            self.migrations += 1
            self._m_migrations.inc()
            if self._tr.enabled:
                self._tr.instant(
                    "migrate", self.pid, self._stamp(),
                    args={"gid": fr.gid, "dest": r},
                )
        elif p.status == "corrupt":
            # Reject-and-requeue: the wire copy was mutated in flight
            # and the destination's integrity check caught it. NEVER
            # resume from a corrupt ticket — fall back to the last
            # trusted prefix (the intact ticket the frontend held).
            fr.pending_ticket = None
            self.ticket_rejects += 1
            self._m_ticket_rejects.inc()
            if self._tr.enabled:
                self._tr.instant(
                    "ticket_reject", self.pid, self._stamp(),
                    args={"gid": fr.gid, "dest": r},
                )
            if len(pt.ticket.tokens) > len(fr.partial):
                fr.partial = list(pt.ticket.tokens)
            if fr.live_copies == 0:         # the ticket WAS the last copy
                self._requeue(fr)
        else:                               # busy: walk the peer list
            self._offer_ticket(fr, pt)

    # -- run loop ------------------------------------------------------------
    def _step_target(self) -> Optional[Replica]:
        cands = [rep for rep in self.replicas if rep.alive and rep.has_work]
        if not cands:
            return None
        return min(cands, key=lambda rep: (rep.now, rep.id))

    def _deliver_replica_inboxes(self) -> None:
        for rep, port in zip(self.replicas, self.ports):
            ep = replica_endpoint(rep.id)
            for msg in self.transport.receive(ep, self.ticks):
                if not rep.alive:
                    # A decommissioned (drained) node refuses new work
                    # but still answers tickets with busy — the sender
                    # must not wait forever on a corpse that acked.
                    if msg.kind == "ticket":
                        port._reply(msg.payload, "busy", self.ticks)
                    continue
                port.on_message(msg, self.ticks)

    def run(self) -> Dict[int, FrontendRequest]:
        """Drive the fleet until every request completes or drops AND
        the transport drains (un-acked cancels would otherwise leak
        slots). Deterministic: chaos events, inbox delivery, dispatch,
        then one engine action on the alive replica furthest behind in
        virtual time (ties to lowest id). When no replica has work the
        plane jumps to the next scheduled event — a chaos entry or a
        transport delivery/retransmission — instead of spinning."""
        while self.queue or self.inflight or self.transport.busy():
            if self.max_ticks is not None and self.ticks > self.max_ticks:
                raise RuntimeError(
                    f"frontend exceeded max_ticks={self.max_ticks} with "
                    f"{len(self.queue)} queued / {len(self.inflight)} "
                    "in-flight requests — the plane is stalled"
                )
            for ev in self.schedule.pop(self.ticks, []):
                self._apply(ev)
            self._process_inbox()
            self.transport.pump(self.ticks)
            self._dispatch()
            self._deliver_replica_inboxes()
            rep = self._step_target()
            if rep is None:
                future = [s for s in self.schedule if s > self.ticks]
                t_net = self.transport.next_event_tick()
                if t_net is not None:
                    future.append(max(t_net, self.ticks + 1))
                if future:
                    # Whole fleet idle: jump to the next chaos event or
                    # transport event instead of spinning.
                    self.ticks = min(future)
                    continue
                if self.queue or self.inflight:
                    raise RuntimeError(
                        "frontend stranded: requests pending but no live "
                        "replica has capacity and no future fault events"
                    )
                break
            rep.step()
            self.ports[rep.id].flush(self.ticks)
            self.ticks += 1
        return dict(self.results)

    # -- reporting -----------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        lats = [fr.latency for fr in self.results.values() if fr.done]
        eng = [rep.engine.stats for rep in self.replicas]
        out = {
            "completed": sum(fr.done for fr in self.results.values()),
            "dropped": len(self.dropped),
            "retries": sum(fr.retries for fr in self.results.values()),
            "migrations": self.migrations,
            "ticket_rejects": self.ticket_rejects,
            "cancelled_copies": sum(s.cancelled_requests for s in eng),
            "preemptions": sum(s.preempted_requests for s in eng),
            "prefix_hits": sum(s.prefix_hits for s in eng),
            "generated_tokens": sum(s.generated_tokens for s in eng),
            "p50_latency": float(np.percentile(lats, 50)) if lats else np.nan,
            "p99_latency": float(np.percentile(lats, 99)) if lats else np.nan,
        }
        out.update(
            {f"transport_{k}": v for k, v in self.transport.stats().items()}
        )
        return out
