"""The port's faultable transport (``repro_torch.serve.transport``) and
migration-ticket integrity, on the CPU.

1. Twins of ``tests/test_transport.py`` on the port: the fault plan
   (drop / dup / delay / reorder / corrupt / partition, JSON
   round-trippable), the at-least-once layer (ack and retransmit, receiver
   dedup, give-up), and the end-to-end ticket seal (sealed at export,
   verified at import, the deadline left out by design).
2. Parity: a plan with a drop, a duplicate, a delay, a reorder, a
   partition and a corruption, run through the reference's and the
   port's ``Transport`` on the same send schedule, delivers the same
   messages in the same order at every tick, and ``stats()`` agree.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import numpy as np
import pytest
import torch

import repro.serve.transport as ref_transport
import repro_torch.serve.transport as port_transport
from repro_torch.serve import (
    FaultDirective,
    Partition,
    ServeEngine,
    TicketIntegrityError,
    Transport,
    TransportFaults,
    TransportGaveUp,
    generate_offline,
    ticket_checksum,
)
from repro_torch.serve.transport import FE, Cancel, Submit

from _fleet import MAX_LEN, model_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# 1. Twins of tests/test_transport.py
# ---------------------------------------------------------------------------

def test_fault_directive_validation():
    with pytest.raises(ValueError):
        FaultDirective(src="fe", dst="r0", op="explode", nth=0)
    with pytest.raises(ValueError):
        FaultDirective(src="fe", dst="r0", op="drop", nth=-1)
    with pytest.raises(ValueError):
        FaultDirective(src="fe", dst="r0", op="delay", nth=0, ticks=-2)


def test_partition_validation():
    with pytest.raises(ValueError):
        Partition(src="fe", dst="r0", t0=5, t1=5)
    with pytest.raises(ValueError):
        Partition(src="fe", dst="r0", t0=-1, t1=5)


def test_fault_plan_json_roundtrip():
    plan = TransportFaults(
        [FaultDirective("fe", "r0", "drop", 0),
         FaultDirective("r1", "fe", "delay", 3, ticks=4)],
        [Partition("fe", "r2", 10, 20)],
    )
    back = TransportFaults.from_dict(plan.as_dict())
    assert back.as_dict() == plan.as_dict()
    assert len(back) == 3
    assert back.ops_for("fe", "r0", 0) == plan.ops_for("fe", "r0", 0)
    assert back.partitioned("fe", "r2", 15) and not back.partitioned("fe", "r2", 20)
    # The reference reads the port's plan and the other way round.
    assert ref_transport.TransportFaults.from_dict(plan.as_dict()).as_dict() == plan.as_dict()


def _drain(t, until: int = 60):
    """Pump and receive on both ends each tick, collecting what r0 sees."""
    got = []
    for tick in range(until):
        t.pump(tick)
        got += [m.payload for m in t.receive("r0", tick)]
        t.receive(FE, tick)
    return got


def test_drop_without_reliability_loses_the_message():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "drop", 0)]), reliable=False)
    t.send(FE, "r0", Cancel(7, 0), 0)
    assert _drain(t) == []
    assert t.stats()["dropped"] == 1 and not t.busy()


def test_reliable_retransmit_survives_drop_exactly_once():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "drop", 0)]), base_rto_ticks=1)
    t.send(FE, "r0", Cancel(7, 0), 0)
    got = _drain(t)
    assert [p.gid for p in got] == [7]
    s = t.stats()
    assert s["dropped"] == 1 and s["sent"] >= 3 and not t.busy()


def test_duplicate_suppressed_by_receiver_dedup():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "dup", 0)]))
    t.send(FE, "r0", Cancel(3, 1), 0)
    got = _drain(t)
    assert [(p.gid, p.attempt) for p in got] == [(3, 1)]
    assert t.stats()["duplicated"] == 1 and not t.busy()


def test_duplicate_delivered_twice_without_dedup():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "dup", 0)]), dedup=False)
    t.send(FE, "r0", Cancel(3, 1), 0)
    assert [(p.gid, p.attempt) for p in _drain(t)] == [(3, 1), (3, 1)]


def test_delay_holds_delivery_until_the_tick():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "delay", 0, ticks=5)]))
    t.send(FE, "r0", Cancel(0, 0), 0)
    assert t.receive("r0", 4) == []
    assert [m.payload.gid for m in t.receive("r0", 5)] == [0]


def test_reorder_swaps_adjacent_messages():
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "reorder", 0, ticks=2)]),
                  reliable=False)
    t.send(FE, "r0", Cancel(0, 0), 0)
    t.send(FE, "r0", Cancel(1, 0), 0)
    assert [p.gid for p in _drain(t)] == [1, 0]


def test_partition_heals_and_retransmit_gets_through():
    t = Transport(1, TransportFaults([], [Partition("fe", "r0", 0, 6)]), base_rto_ticks=1)
    t.send(FE, "r0", Cancel(9, 0), 0)
    assert [p.gid for p in _drain(t)] == [9] and not t.busy()


def test_unhealed_partition_raises_gave_up():
    t = Transport(1, TransportFaults([], [Partition("fe", "r0", 0, 10**6)]),
                  base_rto_ticks=1, max_attempts=3)
    t.send(FE, "r0", Cancel(0, 0), 0)
    with pytest.raises(TransportGaveUp):
        for tick in range(10_000):
            t.pump(tick)


def test_forget_endpoint_clears_traffic_both_ways():
    t = Transport(1, None, base_rto_ticks=1)
    t.send(FE, "r0", Cancel(0, 0), 0)
    t.send("r0", FE, Cancel(1, 0), 0)
    t.forget_endpoint("r0")
    assert not t.busy()
    assert t.receive("r0", 1) == [] and t.receive(FE, 1) == []
    t.send(FE, "r0", Cancel(2, 0), 2)
    assert not t.busy()
    t.revive_endpoint("r0")
    t.send(FE, "r0", Cancel(3, 0), 3)
    assert [p.gid for p in _drain(t)] == [3]


def test_corrupt_nonticket_degrades_to_drop():
    """Corruption of anything but a migration ticket is a link CRC
    failure: the frame is discarded, counted as a loss, not as a
    delivered mutation."""
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "corrupt", 0)]),
                  reliable=False)
    t.send(FE, "r0", Submit(0, 0, np.arange(4, dtype=np.int32), 8, 0.0, None), 0)
    assert _drain(t) == []
    s = t.stats()
    assert s["dropped"] == 1 and s["corrupted"] == 0


def _exported_ticket(model, params):
    src = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8)
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, 12).astype(np.int32)
    rid = src.submit(prompt, 10)
    while len(src.request(rid).tokens) < 3:
        src.step()
    return src.export_request(rid), prompt


def test_export_seals_and_import_verifies():
    model, params = model_params("port")
    ticket, prompt = _exported_ticket(model, params)
    assert ticket.checksum is not None and ticket.checksum == ticket_checksum(ticket)
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8)
    rid = dst.import_request(ticket)
    assert rid is not None
    assert dst.run()[rid].tokens == generate_offline(model, params, prompt, 10, MAX_LEN)


def test_tampered_ticket_rejected_before_allocation():
    model, params = model_params("port")
    ticket, _ = _exported_ticket(model, params)
    toks = list(ticket.tokens)
    toks[-1] ^= 1
    evil = dataclasses.replace(ticket, tokens=tuple(toks))
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8)
    with pytest.raises(TicketIntegrityError) as e:
        dst.import_request(evil)
    assert ticket.checksum[:12] in str(e.value)
    assert dst.pool.n_active == 0 and not dst.has_work


def test_deadline_restamp_does_not_break_the_seal():
    model, params = model_params("port")
    ticket, _ = _exported_ticket(model, params)
    restamped = dataclasses.replace(ticket, deadline=123.456)
    assert ticket_checksum(restamped) == ticket.checksum
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8)
    assert dst.import_request(restamped) is not None


def test_corrupted_ticket_in_flight_is_refused_on_import():
    """A ticket the fault plan corrupts in flight arrives mutated (its
    pending and last tokens flipped) and marked; the destination's import
    refuses it, and the intact ticket the sender kept still lands."""
    model, params = model_params("port")
    ticket, prompt = _exported_ticket(model, params)
    t = Transport(1, TransportFaults([FaultDirective("fe", "r0", "corrupt", 0)]))
    t.send(FE, "r0", port_transport.Ticket(0, 0, ticket, None, 0.0), 0)
    (msg,) = t.receive("r0", 0)
    assert msg.corrupted and t.stats()["corrupted"] == 1
    bad = msg.payload.ticket
    assert bad.pending == ticket.pending ^ 1 and bad.tokens[-1] == ticket.tokens[-1] ^ 1
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8)
    with pytest.raises(TicketIntegrityError):
        dst.import_request(bad)
    rid = dst.import_request(ticket)
    assert dst.run()[rid].tokens == generate_offline(model, params, prompt, 10, MAX_LEN)


# ---------------------------------------------------------------------------
# 2. Parity with the reference's transport
# ---------------------------------------------------------------------------

def _plan(mod):
    """One of each fault: a drop, a duplicate, a delay and a reorder on
    fe->r0, a corruption of the first frame on fe->r1 (a ticket) and of
    r1->fe's second (a chunk: the link drops it), and a one-way partition
    of r0->fe."""
    D = mod.FaultDirective
    return mod.TransportFaults(
        [D("fe", "r0", "drop", 1), D("fe", "r0", "dup", 2), D("fe", "r0", "delay", 3, ticks=3),
         D("fe", "r0", "reorder", 4, ticks=2), D("fe", "r1", "corrupt", 0),
         D("r1", "fe", "corrupt", 1)],
        [mod.Partition("r0", "fe", 2, 5)])


def _norm(msg):
    """A comparable view of a delivered message, tickets by their fields."""
    p = msg.payload
    if msg.kind == "ticket":
        t = p.ticket
        body = (p.gid, p.attempt, tuple(t.tokens), t.pending, p.remaining_deadline, p.elapsed)
    elif msg.kind == "submit":
        body = (p.gid, p.attempt, tuple(p.prompt), p.max_new_tokens, p.arrival)
    else:
        body = dataclasses.astuple(p)
    return (msg.msg_id, msg.src, msg.dst, msg.kind, msg.corrupted, msg.needs_ack, body)


def _schedule(mod, ticket_cls, tick):
    """The sends of one tick: a submit or cancel to r0 each tick, a ticket
    to r1 at tick 0, and chunks back from both replicas."""
    sends = [(mod.FE, "r0", mod.Cancel(tick, 0) if tick % 2 else
              mod.Submit(tick, 0, np.arange(3, dtype=np.int32) + tick, 4, 0.01 * tick, None))]
    if tick == 0:
        t = ticket_cls(prompt=np.arange(4, dtype=np.int32), max_new_tokens=6, arrival=0.0,
                       deadline=None, tokens=(5, 6, 7), pending=7, snapshot=None)
        sends.append((mod.FE, "r1", mod.Ticket(9, 1, t, 0.25, 0.125)))
    if tick < 6:
        sends.append(("r0", mod.FE, mod.Chunk(tick, 0, 0, (tick,), done=False)))
        sends.append(("r1", mod.FE, mod.Chunk(tick, 1, 0, (tick, tick + 1), done=True,
                                              total=2, elapsed=0.5)))
    return sends


@pytest.mark.parametrize("reliable,dedup", [(True, True), (True, False), (False, True)])
def test_transport_matches_reference(reliable, dedup):
    """Both transports under ``_plan`` and the same sends, pumped and
    drained at every tick: equal deliveries per tick (ids, links, kinds,
    payloads, the corrupted mark), equal ``busy`` and ``stats()``."""
    from repro.serve.engine import MigrationTicket as RefTicket
    from repro_torch.serve.engine import MigrationTicket as PortTicket

    runs = []
    for mod, ticket_cls in ((ref_transport, RefTicket), (port_transport, PortTicket)):
        t = mod.Transport(2, _plan(mod), reliable=reliable, dedup=dedup, base_rto_ticks=2,
                          rto_scale=lambda dst: 1.5 if dst == "r1" else 1.0)
        log = []
        for tick in range(40):
            for src, dst, payload in (_schedule(mod, ticket_cls, tick) if tick < 10 else ()):
                t.send(src, dst, payload, tick)
            t.pump(tick)
            for ep in ("r0", "r1", mod.FE):
                log.append((tick, ep, [_norm(m) for m in t.receive(ep, tick)]))
            log.append((tick, t.busy(), t.next_event_tick()))
        runs.append((log, t.stats()))
    assert runs[0] == runs[1]
    stats = runs[1][1]
    assert stats["dropped"] >= 2 and stats["duplicated"] == 1 and stats["delayed"] == 1
    assert stats["corrupted"] == 1
