"""Faultable message transport between the frontend and its replicas
(the port's copy of ``repro.serve.transport``; pure Python).

The frontend↔replica "network" is an explicit, *faultable* seam —
the serving plane's messages (submit / cancel / stream-chunk /
migration-ticket and their replies) travel over per-direction
:class:`Channel` objects on the plane's deterministic tick clock, and a
declarative :class:`TransportFaults` plan says exactly what the network
does to each transmission. On top of the raw channels sits an
idempotent at-least-once delivery layer:

* **acks + retransmission** — every data message is tracked until a
  transport-level ack returns; unacked messages retransmit after a
  deterministic timeout with exponential backoff, the base timeout
  priced per destination from the router's censored straggler telemetry
  (a replica the tracker thinks is 4x slow gets a 4x retransmit
  budget before the sender burns a duplicate);
* **receiver dedup** — per-link seen-sets drop re-delivered message ids
  (retransmissions whose ack was lost, fault-injected duplicates), and
  re-ack so the sender converges; the application layer above is ALSO
  idempotent (stream chunks are position-addressed, cancels are no-ops
  on finished requests) so even with dedup deliberately disabled most
  duplicates are harmless — the chaos-search harness exploits exactly
  that gap to demonstrate what the protections buy;
* **integrity** — fault-injected corruption models what link-layer CRCs
  *cannot* catch: a corrupted data frame (submit/chunk) is detected and
  dropped by the link (indistinguishable from loss; retransmission
  recovers it), but a :class:`~repro_torch.serve.engine.MigrationTicket`
  payload is mutated IN FLIGHT and delivered — only the ticket's
  end-to-end checksum (sealed at ``export_request``, verified at
  ``import_request``) catches it, and the frontend's policy is
  reject-and-requeue, never resume-from-garbage.

Fault plans are explicit per-transmission directives (``the 7th message
on link fe->r1 is dropped``) plus one-way partition windows, so a chaos
schedule is plain JSON: individually removable atoms that
a chaos search can delta-debug down to a minimal repro, and
a replay of the same plan is bit-for-bit the same run.

Public API contract: MODEL-AGNOSTIC and deterministic — the transport
never inspects tokens or caches, owns no RNG (fault plans are data,
sampled elsewhere), and given the same send sequence and plan produces
the same delivery sequence. Endpoint liveness enters only through
``forget_endpoint``/``revive_endpoint`` (the chaos control plane);
message POLICY (what to send, how to react) lives in
``serve.frontend`` and ``serve.replica``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS, Observability

__all__ = [
    "FE", "replica_endpoint",
    "FaultDirective", "Partition", "TransportFaults",
    "Submit", "Cancel", "Chunk", "Expired", "Ticket", "TicketReply", "Ack",
    "WireMessage", "Channel", "Transport", "TransportGaveUp",
]

#: the frontend's endpoint name; replicas are ``r0``, ``r1``, ...
FE = "fe"


def replica_endpoint(replica_id: int) -> str:
    return f"r{int(replica_id)}"


# ---------------------------------------------------------------------------
# Fault plans: explicit, JSON-serializable, individually removable
# ---------------------------------------------------------------------------

_OPS = ("drop", "dup", "delay", "reorder", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultDirective:
    """One fault on one link: the ``nth`` TRANSMISSION (0-based, counting
    retransmissions) on ``(src, dst)`` suffers ``op``.

    * ``drop``    — the transmission is lost;
    * ``dup``     — it is delivered twice;
    * ``delay``   — delivery is postponed by ``ticks`` plane ticks;
    * ``reorder`` — it stays on schedule but sorts AFTER the next
      ``ticks`` (default 2) messages that share its delivery tick;
    * ``corrupt`` — the payload is mutated in flight if it carries an
      in-band mutator (migration tickets); data frames without one are
      dropped instead — the link CRC caught the damage, which is
      exactly a loss.
    """

    src: str
    dst: str
    op: str
    nth: int
    ticks: int = 0

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown transport fault op {self.op!r}")
        if self.nth < 0:
            raise ValueError(f"directive nth must be >= 0, got {self.nth}")
        if self.ticks < 0:
            raise ValueError(f"directive ticks must be >= 0, got {self.ticks}")

    def as_dict(self) -> dict:
        return {"src": self.src, "dst": self.dst, "op": self.op,
                "nth": self.nth, "ticks": self.ticks}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultDirective":
        return cls(src=str(d["src"]), dst=str(d["dst"]), op=str(d["op"]),
                   nth=int(d["nth"]), ticks=int(d.get("ticks", 0)))


@dataclasses.dataclass(frozen=True)
class Partition:
    """A one-way partition: every transmission sent on ``(src, dst)``
    while ``t0 <= tick < t1`` is dropped. The reverse direction is
    UNAFFECTED — one-way partitions are the nasty case (acks die while
    data flows, or data dies while acks flow)."""

    src: str
    dst: str
    t0: int
    t1: int

    def __post_init__(self):
        if self.t1 <= self.t0 or self.t0 < 0:
            raise ValueError(
                f"partition window must satisfy 0 <= t0 < t1, "
                f"got [{self.t0}, {self.t1})"
            )

    def as_dict(self) -> dict:
        return {"src": self.src, "dst": self.dst, "t0": self.t0, "t1": self.t1}

    @classmethod
    def from_dict(cls, d: dict) -> "Partition":
        return cls(src=str(d["src"]), dst=str(d["dst"]),
                   t0=int(d["t0"]), t1=int(d["t1"]))


class TransportFaults:
    """A complete network-fault plan: per-link per-transmission
    directives plus one-way partition windows. Pure data — construction
    validates, ``as_dict``/``from_dict`` round-trip through JSON, and
    the chaos-search shrinker removes atoms one at a time."""

    def __init__(
        self,
        directives: Iterable[FaultDirective] = (),
        partitions: Iterable[Partition] = (),
    ):
        self.directives: List[FaultDirective] = list(directives)
        self.partitions: List[Partition] = list(partitions)
        self._by_link: Dict[Tuple[str, str, int], List[FaultDirective]] = {}
        for fd in self.directives:
            self._by_link.setdefault((fd.src, fd.dst, fd.nth), []).append(fd)

    def __len__(self) -> int:
        return len(self.directives) + len(self.partitions)

    def ops_for(self, src: str, dst: str, nth: int) -> List[FaultDirective]:
        return self._by_link.get((src, dst, nth), [])

    def partitioned(self, src: str, dst: str, tick: int) -> bool:
        return any(
            p.src == src and p.dst == dst and p.t0 <= tick < p.t1
            for p in self.partitions
        )

    def as_dict(self) -> dict:
        return {
            "directives": [fd.as_dict() for fd in self.directives],
            "partitions": [p.as_dict() for p in self.partitions],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TransportFaults":
        return cls(
            directives=[FaultDirective.from_dict(x)
                        for x in d.get("directives", ())],
            partitions=[Partition.from_dict(x)
                        for x in d.get("partitions", ())],
        )


# ---------------------------------------------------------------------------
# Message payloads (the serving plane's wire vocabulary)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Submit:
    """Dispatch one copy of a request onto a replica. ``attempt`` makes
    the copy key ``(gid, attempt)`` globally unique across hedges,
    retries, and migrations — the receiver's idempotency key."""

    gid: int
    attempt: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float
    deadline_budget: Optional[float]   # per-attempt vtime budget (None = none)


@dataclasses.dataclass(frozen=True)
class Cancel:
    """Tear down a copy (hedged loser, zombie migration)."""

    gid: int
    attempt: int


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A position-addressed slice of one copy's token stream:
    ``tokens[i]`` is stream position ``start + i``. Position addressing
    makes chunk application idempotent and order-free — duplicates
    rewrite the same cells, reordered chunks fill different cells, and
    the stream is complete when positions ``0..total-1`` are present and
    a ``done`` chunk supplied ``total``."""

    gid: int
    attempt: int
    start: int
    tokens: Tuple[int, ...]
    done: bool = False
    total: Optional[int] = None        # stream length (done chunks only)
    elapsed: Optional[float] = None    # replica-local service time (done only)


@dataclasses.dataclass(frozen=True)
class Expired:
    """A copy's per-attempt deadline fired replica-side; ``tokens`` is
    the full partial prefix so the frontend can requeue from it."""

    gid: int
    attempt: int
    tokens: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Ticket:
    """A migration ticket in flight to its destination replica.
    ``remaining_deadline`` carries the deadline budget left on the
    SOURCE clock (absolute deadlines are clock-local); ``elapsed`` is
    the service time already accrued, so the destination's completion
    telemetry prices the whole request, not just its own share."""

    gid: int
    attempt: int
    ticket: Any                        # engine.MigrationTicket (sealed)
    remaining_deadline: Optional[float]
    elapsed: float


@dataclasses.dataclass(frozen=True)
class TicketReply:
    """Destination's verdict on a Ticket: ``ok`` (imported, decoding
    resumes), ``busy`` (no slot/blocks — try another peer), or
    ``corrupt`` (integrity checksum failed — reject-and-requeue)."""

    gid: int
    attempt: int
    status: str                        # "ok" | "busy" | "corrupt"


@dataclasses.dataclass(frozen=True)
class Ack:
    msg_id: int


@dataclasses.dataclass
class WireMessage:
    msg_id: int
    src: str
    dst: str
    kind: str                          # payload class name, lowercased
    payload: Any
    needs_ack: bool = True
    corrupted: bool = False            # in-flight mutation happened


def _corrupt_in_flight(msg: WireMessage) -> Optional[WireMessage]:
    """Mutate a payload the way a link CRC cannot catch. Only migration
    tickets are end-to-end payloads here (they transit DMA/storage paths
    between meshes); everything else returns None = "the link CRC saw
    it" and the caller drops the frame instead."""
    if msg.kind != "ticket":
        return None
    p: Ticket = msg.payload
    t = p.ticket
    # Flip the resume token: the single most dangerous corruption — a
    # byte-plausible ticket whose greedy continuation silently diverges.
    bad = dataclasses.replace(
        t,
        pending=int(t.pending) ^ 1,
        tokens=tuple(t.tokens[:-1]) + ((t.tokens[-1] ^ 1),) if t.tokens
        else t.tokens,
    )
    out = dataclasses.replace(msg, payload=dataclasses.replace(p, ticket=bad))
    out.corrupted = True
    return out


# ---------------------------------------------------------------------------
# Channels + the reliability fabric
# ---------------------------------------------------------------------------

class Channel:
    """One direction of one link. Applies the fault plan per
    transmission and delivers in deterministic ``(deliver_tick,
    order_key)`` order. No RNG — faults are the plan's explicit
    directives, nothing else."""

    def __init__(self, src: str, dst: str, faults: TransportFaults):
        self.src, self.dst = src, dst
        self.faults = faults
        self.n_sent = 0                # transmissions attempted (incl. retx)
        self.n_dropped = 0
        self.n_duplicated = 0
        self.n_delayed = 0
        self.n_corrupted = 0
        self._order = 0
        self._heap: List[Tuple[int, int, int, WireMessage]] = []
        self._tiebreak = 0

    def transmit(self, msg: WireMessage, tick: int) -> None:
        nth = self.n_sent
        self.n_sent += 1
        if self.faults.partitioned(self.src, self.dst, tick):
            self.n_dropped += 1
            return
        copies, delay, order_bump, dropped = 1, 0, 0, False
        out = msg
        for fd in self.faults.ops_for(self.src, self.dst, nth):
            if fd.op == "drop":
                dropped = True
            elif fd.op == "dup":
                copies += 1
                self.n_duplicated += 1
            elif fd.op == "delay":
                delay += max(fd.ticks, 1)
                self.n_delayed += 1
            elif fd.op == "reorder":
                order_bump += max(fd.ticks, 2)
            elif fd.op == "corrupt":
                mutated = _corrupt_in_flight(out)
                if mutated is None:
                    dropped = True        # link CRC caught it = loss
                else:
                    out = mutated
                    self.n_corrupted += 1
        if dropped:                       # drop dominates dup/delay/reorder
            self.n_dropped += 1
            return
        for _ in range(copies):
            self._order += 1
            self._tiebreak += 1
            heapq.heappush(
                self._heap,
                (tick + delay, self._order + order_bump, self._tiebreak, out),
            )

    def deliverable(self, tick: int) -> bool:
        return bool(self._heap) and self._heap[0][0] <= tick

    def next_deliver_tick(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None

    def receive(self, tick: int) -> List[WireMessage]:
        out = []
        while self._heap and self._heap[0][0] <= tick:
            out.append(heapq.heappop(self._heap)[3])
        return out

    def clear(self) -> int:
        n = len(self._heap)
        self._heap.clear()
        return n


@dataclasses.dataclass
class _Pending:
    msg: WireMessage
    attempt: int
    due_tick: int


class TransportGaveUp(RuntimeError):
    """A reliable message exhausted its retransmission budget — the
    destination is unreachable beyond anything the fault plan heals.
    Surfaced as a liveness violation by the chaos harness."""


class Transport:
    """The fabric: channels both ways between ``fe`` and every replica,
    plus the at-least-once layer (acks, dedup, deterministic
    retransmission with telemetry-priced timeouts).

    ``rto_scale(dst)`` supplies the per-destination slowdown estimate —
    the frontend wires it to the router's censored telemetry, so
    retransmit budgets track the same order-statistic view of the fleet
    every other scheduling decision prices against. ``reliable=False``
    turns the whole layer fire-and-forget and ``dedup=False`` redelivers
    duplicates — chaos-search knobs that exist so the harness can show
    the invariants FAILING without them."""

    def __init__(
        self,
        n_replicas: int,
        faults: Optional[TransportFaults] = None,
        *,
        reliable: bool = True,
        dedup: bool = True,
        base_rto_ticks: int = 16,
        backoff: float = 2.0,
        max_rto_ticks: int = 512,
        max_attempts: int = 24,
        rto_scale: Optional[Callable[[str], float]] = None,
        obs: Optional[Observability] = None,
    ):
        self.faults = faults or TransportFaults()
        self.reliable = bool(reliable)
        self.dedup = bool(dedup)
        self.base_rto_ticks = int(base_rto_ticks)
        self.backoff = float(backoff)
        self.max_rto_ticks = int(max_rto_ticks)
        self.max_attempts = int(max_attempts)
        self.rto_scale = rto_scale or (lambda dst: 1.0)
        self.endpoints = [FE] + [replica_endpoint(i) for i in range(n_replicas)]
        self.channels: Dict[Tuple[str, str], Channel] = {}
        for i in range(n_replicas):
            r = replica_endpoint(i)
            self.channels[(FE, r)] = Channel(FE, r, self.faults)
            self.channels[(r, FE)] = Channel(r, FE, self.faults)
        self._next_msg_id = 0
        self._unacked: Dict[int, _Pending] = {}
        self._seen: Dict[Tuple[str, str], set] = {
            link: set() for link in self.channels
        }
        self._dead: set = set()
        self.gave_up = 0
        self.obs = obs or NULL_OBS
        m = self.obs.metrics
        self._m_sent = m.counter("transport.sent")
        self._m_delivered = m.counter("transport.delivered")
        self._m_retx = m.counter("transport.retransmits")
        self._m_dedup = m.counter("transport.deduped")
        self._m_acked = m.counter("transport.acked")

    # -- sending -------------------------------------------------------------
    def send(
        self, src: str, dst: str, payload: Any, tick: int,
        *, needs_ack: bool = True,
    ) -> int:
        """Send ``payload`` from ``src`` to ``dst``; returns the message
        id. Reliable messages are tracked until acked; sends to a dead
        endpoint are dropped silently (the chaos plane already told us
        nobody is listening)."""
        kind = type(payload).__name__.lower()
        msg = WireMessage(self._next_msg_id, src, dst, kind, payload,
                          needs_ack=needs_ack and self.reliable)
        self._next_msg_id += 1
        self._m_sent.inc()
        if dst in self._dead:
            return msg.msg_id
        self.channels[(src, dst)].transmit(msg, tick)
        if msg.needs_ack:
            self._unacked[msg.msg_id] = _Pending(
                msg, 0, tick + self._rto(dst, 0)
            )
        return msg.msg_id

    def _rto(self, dst: str, attempt: int) -> int:
        base = self.base_rto_ticks * max(1.0, float(self.rto_scale(dst)))
        return min(int(base * self.backoff ** attempt) + 1, self.max_rto_ticks)

    def pump(self, tick: int) -> None:
        """Retransmit every overdue unacked message (deterministic order:
        by message id)."""
        if not self.reliable:
            return
        for mid in sorted(self._unacked):
            p = self._unacked[mid]
            if p.due_tick > tick:
                continue
            if p.msg.dst in self._dead:
                del self._unacked[mid]
                continue
            p.attempt += 1
            if p.attempt > self.max_attempts:
                del self._unacked[mid]
                self.gave_up += 1
                raise TransportGaveUp(
                    f"message {mid} ({p.msg.kind} {p.msg.src}->{p.msg.dst}) "
                    f"unacked after {self.max_attempts} attempts"
                )
            self._m_retx.inc()
            self.channels[(p.msg.src, p.msg.dst)].transmit(p.msg, tick)
            p.due_tick = tick + self._rto(p.msg.dst, p.attempt)

    # -- receiving -----------------------------------------------------------
    def receive(self, dst: str, tick: int) -> List[WireMessage]:
        """Drain every deliverable message addressed to ``dst``: strips
        acks, dedups (re-acking, so a lost ack converges), acks fresh
        data messages, and returns the application payloads in
        deterministic delivery order."""
        out: List[WireMessage] = []
        for (src, d), ch in self.channels.items():
            if d != dst or not ch.deliverable(tick):
                continue
            seen = self._seen[(src, d)]
            for msg in ch.receive(tick):
                if msg.kind == "ack":
                    self._unacked.pop(msg.payload.msg_id, None)
                    self._m_acked.inc()
                    continue
                if self.dedup and msg.msg_id in seen:
                    self._m_dedup.inc()
                    if msg.needs_ack:
                        self._send_ack(dst, src, msg.msg_id, tick)
                    continue
                seen.add(msg.msg_id)
                if msg.needs_ack:
                    self._send_ack(dst, src, msg.msg_id, tick)
                self._m_delivered.inc()
                out.append(msg)
        return out

    def _send_ack(self, src: str, dst: str, msg_id: int, tick: int) -> None:
        if dst in self._dead:
            return
        msg = WireMessage(self._next_msg_id, src, dst, "ack", Ack(msg_id),
                          needs_ack=False)
        self._next_msg_id += 1
        self.channels[(src, dst)].transmit(msg, tick)

    # -- liveness / progress -------------------------------------------------
    def deliverable(self, dst: str, tick: int) -> bool:
        return any(
            ch.deliverable(tick)
            for (s, d), ch in self.channels.items() if d == dst
        )

    def busy(self) -> bool:
        """Anything still in flight or awaiting ack? The frontend's run
        loop drains the fabric before declaring the plane quiescent —
        un-delivered cancels would otherwise leak slots."""
        return bool(self._unacked) or any(
            ch.next_deliver_tick() is not None for ch in self.channels.values()
        )

    def next_event_tick(self) -> Optional[int]:
        """Earliest tick at which the fabric will do something on its
        own (a delayed delivery lands, a retransmit fires) — the run
        loop jumps here when every replica is idle."""
        ticks = [t for ch in self.channels.values()
                 if (t := ch.next_deliver_tick()) is not None]
        if self.reliable:
            ticks.extend(p.due_tick for p in self._unacked.values()
                         if p.msg.dst not in self._dead)
        return min(ticks, default=None)

    # -- chaos control plane -------------------------------------------------
    def forget_endpoint(self, ep: str) -> None:
        """An endpoint died: every queued message to/from it vanishes
        with the process, every pending retransmit to it is abandoned,
        and its dedup history is wiped (a rejoin is a fresh process)."""
        self._dead.add(ep)
        for (src, dst), ch in self.channels.items():
            if src == ep or dst == ep:
                ch.clear()
                self._seen[(src, dst)].clear()
        for mid in [m for m, p in self._unacked.items()
                    if p.msg.dst == ep or p.msg.src == ep]:
            del self._unacked[mid]

    def revive_endpoint(self, ep: str) -> None:
        self._dead.discard(ep)

    # -- reporting -----------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        agg = {"sent": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
               "corrupted": 0}
        for ch in self.channels.values():
            agg["sent"] += ch.n_sent
            agg["dropped"] += ch.n_dropped
            agg["duplicated"] += ch.n_duplicated
            agg["delayed"] += ch.n_delayed
            agg["corrupted"] += ch.n_corrupted
        agg["unacked"] = len(self._unacked)
        agg["gave_up"] = self.gave_up
        return agg
