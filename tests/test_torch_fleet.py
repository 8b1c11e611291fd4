"""The port's multi-replica fleet (``HedgedRouter``, ``Replica``,
``Frontend``) and the engine verbs it drives, on the CPU, at reduced
smollm-135m (and zamba2 for migration), f32.

1. Twins of ``tests/test_replicas.py`` on the port: the shared
   ``FaultEvent`` schema; the router's degraded-fleet quorum, rejoin
   cold start, all-censored pricing and slot accounting; deadlines
   stamped at admission and expired with everything freed; cancel
   releasing paged blocks under arena pressure; migration byte identity
   (smollm-135m and zamba2, contiguous and paged) and backpressure; the
   frontend fault-free, under a kill and rejoin, through a drain that
   migrates, with deadline retries, with a retry budget that drops; and a
   deadline expiry racing a drain, resolved exactly once.
2. Parity: the reference's ``Frontend`` and the port's, on the same
   fleet, events and fault plan, give equal streams, drops, retries,
   ``summary()`` (the transport's counts too), router decisions, router
   in-flight counts, and (obs on) an equal trace and metrics snapshot.
"""

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro_torch.core.delay_models import SimplifiedDelayModel
from repro_torch.obs import Observability, validate_trace
from repro_torch.runtime.faults import FaultEvent, schedule_by_step
from repro_torch.serve import Frontend, HedgedRouter, Scheduler, ServeEngine, generate_offline

from _fleet import MAX_LEN, PKGS, fleet, model_params, pair, prompts

DELAY = SimplifiedDelayModel(lambda_y=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(arch="smollm-135m"):
    return model_params("port", arch)


def _refs(reqs):
    model, params = _port()
    return [generate_offline(model, params, p, m, MAX_LEN) for p, m, _ in reqs]


# ---------------------------------------------------------------------------
# 1. Twins of tests/test_replicas.py
# ---------------------------------------------------------------------------

def test_fault_event_shared_schema():
    from repro_torch.runtime import train_loop

    assert train_loop.FaultEvent is FaultEvent
    ev = [FaultEvent(step=3, kind="fail", worker=1),
          FaultEvent(step=3, kind="slow", worker=0, factor=2.0)]
    assert schedule_by_step(ev) == {3: ev} and train_loop.schedule_by_step(ev) == {3: ev}
    with pytest.raises(ValueError):
        FaultEvent(step=0, kind="explode", worker=0)


def test_fault_event_validates_at_construction():
    for kw in (dict(step=-1, kind="fail", worker=0), dict(step=0, kind="fail", worker=-2),
               dict(step=0, kind="slow", worker=0, factor=0.0),
               dict(step=0, kind="slow", worker=0, factor=-3.0)):
        with pytest.raises(ValueError):
            FaultEvent(**kw)
    ev = FaultEvent(step=7, kind="slow", worker=2, factor=2.5)
    assert FaultEvent.from_dict(ev.as_dict()) == ev


def test_router_degraded_fleet_reprices_quorum():
    router = HedgedRouter(DELAY, 4, quorum=3, cost_per_replica=0.05)
    plan = router.choose_hedge()
    assert plan is not None and plan.k == 3
    router.mark_failed(2)
    router.mark_failed(3)
    plan = router.choose_hedge()
    assert plan is not None and plan.k == 2
    assert set(plan.replicas) <= {0, 1}
    router.inflight[0] = router.slots_per_replica
    assert router.choose_hedge() is None


def test_router_rejoin_cold_start_seeding():
    router = HedgedRouter(DELAY, 3, warmup=1)
    for _ in range(12):
        router.record(np.array([1.0, 1.0, 8.0]), participants=[0, 1, 2])
    assert router._slowdowns()[2] > 4.0
    router.mark_failed(2)
    assert router.available() == [0, 1]
    router.mark_joined(2)
    assert router.available() == [0, 1, 2]
    assert router._slowdowns()[2] == pytest.approx(1.0)
    router.record(np.array([0.0, 0.0, 2.5]), participants=[2])
    assert router.tracker.mean_estimate()[2] == pytest.approx(2.5)


def test_router_unbounded_censored_estimate_prices_last():
    router = HedgedRouter(DELAY, 3, warmup=1)
    for _ in range(4):
        router.record(np.array([1.0, 1.0, 0.0]), participants=[0, 1])
        router.record(np.zeros(3), [2], observed=[], censor_level=3.0)
    slow = router._slowdowns()
    assert np.isfinite(slow).all()
    assert slow[2] == router.slow_cap > slow[0]
    plan = router.choose_hedge()
    assert plan is not None and 2 not in plan.replicas[:2]


def test_router_release_occupy_roundtrip():
    router = HedgedRouter(DELAY, 2, slots_per_replica=2)
    router.begin(router.choose_hedge())
    before = router.inflight.copy()
    router.occupy(1)
    router.release(1)
    assert (router.inflight == before).all()
    with pytest.raises(ValueError):
        for _ in range(10):
            router.release(0)


def test_deadline_stamped_at_admission_and_expires():
    model, params = _port()
    sched = Scheduler(2, deadline_ticks=3)
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, scheduler=sched, block_size=8)
    rng = np.random.default_rng(0)
    rid = eng.submit(rng.integers(0, model.cfg.vocab_size, 8).astype(np.int32), 30)
    req = eng.run()[rid]
    assert req.cancelled and req.cancel_reason == "deadline"
    assert req.deadline == pytest.approx(req.t_admit + 3 * sched.clock.cost.decode_tick)
    assert 0 < len(req.tokens) < 30
    assert eng.pool.n_active == 0
    assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks
    assert eng.stats.cancelled_requests == 1 and not eng.has_work


def test_cancel_releases_paged_blocks_under_pressure():
    model, params = _port()
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8, arena_blocks=8)
    rng = np.random.default_rng(0)
    p = lambda n: rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)  # noqa: E731
    r1 = eng.submit(p(20), 30)
    r2 = eng.submit(p(20), 30)
    for _ in range(6):
        eng.step()
    assert eng.request(r2).t_admit is None
    free_before = eng.pool.manager.n_free_blocks
    assert eng.cancel(r1)
    assert eng.pool.manager.n_free_blocks > free_before
    out = eng.run()
    assert out[r2].t_done is not None
    assert out[r1].cancelled and out[r1].cancel_reason == "cancelled"
    assert not eng.cancel(r1)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_migration_byte_identity(arch, paged):
    """Export mid-decode, import into a second engine, finish there: the
    stitched stream equals offline decode (the reference's deepseek-v3 and
    xlstm cases wait for those families' port)."""
    model, params = _port(arch)
    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab_size, 12).astype(np.int32)
    ref = generate_offline(model, params, prompt, 10, MAX_LEN)
    kw = dict(block_size=8) if paged else {}
    src = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, **kw)
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, **kw)
    rid = src.submit(prompt, 10)
    while len(src.request(rid).tokens) < 4:
        src.step()
    ticket = src.export_request(rid)
    assert src.request(rid).cancel_reason == "migrated"
    assert src.pool.n_active == 0 and not src.has_work
    if paged:
        assert src.pool.manager.n_free_blocks == src.pool.manager.num_blocks
    new_rid = dst.import_request(ticket)
    assert new_rid is not None and dst.has_work
    assert dst.run()[new_rid].tokens == ref
    assert dst.stats.migrated_in == 1 and src.stats.migrated_out == 1


def test_migration_backpressure_returns_none():
    model, params = _port()
    rng = np.random.default_rng(0)
    p = lambda n: rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)  # noqa: E731
    src = ServeEngine(model, params, n_slots=1, max_len=MAX_LEN, block_size=8)
    dst = ServeEngine(model, params, n_slots=1, max_len=MAX_LEN, block_size=8)
    blocker = dst.submit(p(8), 20)
    while not dst.request(blocker).tokens:
        dst.step()
    rid = src.submit(p(8), 10)
    while len(src.request(rid).tokens) < 3:
        src.step()
    ticket = src.export_request(rid)
    assert dst.import_request(ticket) is None
    dst.cancel(blocker)
    assert dst.import_request(ticket) is not None


def _drained(fe):
    """Every pool empty, every arena fully free, no router count left."""
    for rep in fe.replicas:
        assert rep.engine.live_rids() == [] and rep.engine.pool.n_active == 0
        mgr = rep.engine.pool.manager
        assert mgr.n_free_blocks == mgr.num_blocks
    assert (fe.router.inflight == 0).all()
    assert not fe.transport.busy()


def test_frontend_fault_free_matches_offline():
    reqs = prompts(_port()[0].cfg.vocab_size)
    fe = Frontend(fleet("port"), DELAY, cost_per_replica=0.001)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert all(out[g].done and not out[g].dropped for g in gids)
    assert [out[g].tokens for g in gids] == _refs(reqs)
    _drained(fe)


def test_frontend_chaos_kill_rejoin_zero_drop():
    reqs = prompts(_port()[0].cfg.vocab_size)
    events = [FaultEvent(step=12, kind="fail", worker=1),
              FaultEvent(step=60, kind="rejoin", worker=1)]
    fe = Frontend(fleet("port"), DELAY, cost_per_replica=0.001, events=events)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert all(out[g].done and not out[g].dropped for g in gids)
    assert [out[g].tokens for g in gids] == _refs(reqs)
    assert fe.replicas[1].alive and fe.replicas[1].engine.pool.n_active == 0
    _drained(fe)


def test_frontend_drain_migrates_in_flight():
    reqs = prompts(_port()[0].cfg.vocab_size)
    events = [FaultEvent(step=20, kind="drain", worker=0),
              FaultEvent(step=90, kind="rejoin", worker=0)]
    fe = Frontend(fleet("port"), DELAY, cost_per_replica=10.0, events=events)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert all(out[g].done and not out[g].dropped for g in gids)
    assert [out[g].tokens for g in gids] == _refs(reqs)
    assert fe.migrations > 0
    _drained(fe)


def test_frontend_deadline_retry_requeues_elsewhere():
    reqs = prompts(_port()[0].cfg.vocab_size)
    events = [FaultEvent(step=0, kind="slow", worker=0, factor=40.0)]
    fe = Frontend(fleet("port"), DELAY, cost_per_replica=10.0, events=events,
                  deadline=0.06, retry_budget=4)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert all(out[g].done and not out[g].dropped for g in gids)
    assert [out[g].tokens for g in gids] == _refs(reqs)
    assert fe.summary()["retries"] > 0
    assert fe.router.tracker.rounds[0] > fe.router.tracker.wins[0]


def test_frontend_retry_budget_drops_and_reports():
    model, _ = _port()
    events = [FaultEvent(step=0, kind="slow", worker=i, factor=500.0) for i in range(2)]
    fe = Frontend(fleet("port", n=2), DELAY, cost_per_replica=10.0, events=events,
                  deadline=0.02, retry_budget=1)
    rng = np.random.default_rng(0)
    gid = fe.submit(rng.integers(0, model.cfg.vocab_size, 8).astype(np.int32), 12)
    out = fe.run()
    assert out[gid].dropped and not out[gid].done
    assert fe.summary()["dropped"] == 1


@pytest.mark.parametrize("drain_step", [6, 9, 12, 15])
def test_deadline_expiry_racing_drain_resolves_exactly_once(drain_step):
    reqs = prompts(_port()[0].cfg.vocab_size, n=6)
    refs = _refs(reqs)
    events = [FaultEvent(step=0, kind="slow", worker=0, factor=40.0),
              FaultEvent(step=drain_step, kind="drain", worker=0),
              FaultEvent(step=drain_step + 40, kind="rejoin", worker=0)]
    fe = Frontend(fleet("port"), DELAY, cost_per_replica=10.0, events=events,
                  deadline=0.06, retry_budget=6, max_ticks=20_000)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert set(out) == set(gids)
    for g in gids:
        assert out[g].done != out[g].dropped
        if out[g].done:
            assert out[g].tokens == refs[g]
    _drained(fe)
    s = fe.summary()
    assert s["completed"] + s["dropped"] == len(gids)


# ---------------------------------------------------------------------------
# 2. Parity with the reference's frontend
# ---------------------------------------------------------------------------

def _ticket_plan(pkg, fe_kw, events, base):
    """``base`` (drop / dup directives) plus a corruption of the first
    ticket the drain sends: found by running the fleet once with ``base``
    alone and counting transmissions per link (a directive changes
    nothing before the transmission it names)."""
    ns = PKGS[pkg]
    mod = ns.serve.transport
    sent = []
    transmit = mod.Channel.transmit

    def spy(ch, msg, tick):
        if msg.kind == "ticket":
            sent.append((ch.src, ch.dst, ch.n_sent))
        return transmit(ch, msg, tick)

    mod.Channel.transmit = spy
    try:
        _frontend(pkg, None, events, mod.TransportFaults(base), **fe_kw)
    finally:
        mod.Channel.transmit = transmit
    src, dst, nth = sent[0]
    return mod.TransportFaults(base + [mod.FaultDirective(src, dst, "corrupt", nth)])


def _frontend(pkg, obs, events, faults, **kw):
    ns = PKGS[pkg]
    reqs = prompts(pair()[2].cfg.vocab_size, n=8, seed=5)
    fe = ns.serve.Frontend(
        fleet(pkg, obs=obs), ns.Delay(lambda_y=2.0),
        events=[ns.FaultEvent(*e) for e in events], transport_faults=faults, obs=obs, **kw)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    return fe, [out[g].tokens for g in gids], gids


#: Fleets run through both frontends: (frontend options, node events,
#: transport directives).
FLEETS = {
    "kill-rejoin": (dict(cost_per_replica=0.001, deadline=0.5, retry_budget=3),
                    [(12, "fail", 1), (60, "rejoin", 1)], None),
    "drain-faulty-transport": (
        dict(cost_per_replica=10.0, retry_budget=3),
        [(8, "fail", 1), (14, "drain", 0), (60, "rejoin", 1), (90, "rejoin", 0)],
        [("fe", "r2", "drop", 2), ("r2", "fe", "dup", 3)]),
    "deadline-retry": (dict(cost_per_replica=10.0, deadline=0.06, retry_budget=4),
                       [(0, "slow", 0, 40.0)], None),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_frontend_matches_reference(name):
    """Both frontends over their three replicas (obs on): equal streams,
    drops, retries and ``summary()``, equal router decisions and in-flight
    counts at the end, and an equal default trace and metrics snapshot."""
    kw, events, directives = FLEETS[name]
    runs = []
    for pkg in ("ref", "port"):
        mod = PKGS[pkg].serve.transport
        faults = None
        if directives is not None:
            faults = _ticket_plan(pkg, kw, events, [mod.FaultDirective(*d) for d in directives])
        obs = (ref_obs.Observability if pkg == "ref" else Observability)()
        fe, streams, gids = _frontend(pkg, obs, events, faults, **kw)
        runs.append(dict(
            streams=streams, dropped=list(fe.dropped),
            retries=[fe.results[g].retries for g in gids], summary=fe.summary(),
            decisions=obs.decisions.to_jsonable(), inflight=fe.router.inflight.tolist(),
            plan=None if faults is None else faults.as_dict(),
            trace=obs.tracer.to_json(), metrics=obs.metrics.snapshot()))
        if pkg == "port":
            assert obs.tracer.open_spans == [] and validate_trace(obs.tracer.events) == []
            _drained(fe)
    ref, port = runs
    assert port["summary"] == ref["summary"]
    assert port == ref
    s = port["summary"]
    assert s["completed"] == 8 and s["dropped"] == 0
    assert port["decisions"]["entries"], "the router logged no hedge decision"
    if name == "drain-faulty-transport":
        assert s["migrations"] >= 1 and s["ticket_rejects"] >= 1
        assert s["transport_corrupted"] == 1 and s["transport_duplicated"] >= 1
    if name == "deadline-retry":
        assert s["retries"] > 0
    assert port["streams"] == _refs(prompts(pair()[2].cfg.vocab_size, n=8, seed=5))

