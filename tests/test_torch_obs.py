"""The port's observability plane (``repro_torch.obs``) against the
reference's, on the CPU.

1. Twins of ``tests/test_obs.py``'s contracts, on the port: ``NULL_OBS``
   is inert, the default trace export is byte-identical across identical
   seeds and tracing does not move a stream, every span closes under
   chaos (cancel, deadline, failover, migration) and the trace validates,
   ``validate_trace`` catches what it claims to, the metrics are
   deterministic, the decision log is bounded and records on change only,
   and the structured log's stdout is a view of its records.
2. Parity: the same calls on both packages' ``MetricsRegistry``,
   ``Tracer``, ``DecisionLog`` and ``StructuredLog`` give equal exports;
   the reference engine and the port's, both with ``Observability()``, on
   the same traffic give an equal default ``tracer.to_json()`` (bytes), an
   equal ``metrics.snapshot()`` and an equal decision log, over the
   contiguous pool, the paged pool, a sharing arena that preempts, and a
   speculative engine with a noisy draft (and the port's streams do not
   depend on obs); the two ``train()`` loops under a fail and a rejoin
   give equal traces, metrics and decisions, the per-step loss (two
   frameworks' f32 arithmetic) within 1e-5 relative.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.obs as R
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
import repro_torch.obs as P
from repro_torch.obs import (
    NULL_OBS,
    DecisionLog,
    MetricsRegistry,
    Observability,
    StructuredLog,
    Tracer,
    validate_trace,
)
from repro_torch.models import params_from_numpy
from repro_torch.serve import Scheduler, ServeEngine, SpecController, generate_offline
from repro_torch.serve.scheduler import CostModel

from _fleet import MAX_LEN, chaos_run, model_params, pair, prompts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced-model steps are many tiny ops: intra-op threads only wait
    on each other beside other busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# 1. Twins of tests/test_obs.py
# ---------------------------------------------------------------------------

def test_null_obs_is_inert():
    obs = NULL_OBS
    assert not obs.enabled
    assert obs.tracer.register_process("x") == 0
    sid = obs.tracer.begin_span("request", 0, 1.0)
    assert sid == 0
    obs.tracer.end_span(sid, 2.0)
    obs.tracer.complete("decode", 0, 1.0, 2.0)
    obs.tracer.instant("cancel", 0, 1.0)
    obs.tracer.counter("occupancy", 0, 1.0, {"slots": 1})
    assert obs.tracer.events == [] and obs.tracer.open_spans == []
    c = obs.metrics.counter("a")
    c.inc(5)
    assert obs.metrics.snapshot() == {}
    assert obs.metrics.counter("a") is obs.metrics.counter("b")
    assert obs.metrics.histogram("h") is obs.metrics.histogram("h2")
    obs.decisions.record("serve.gamma", {"gamma": 2}, {"p": 0.5})
    assert obs.decisions.to_jsonable()["entries"] == []
    rec = obs.log.emit("x", a=1)
    assert rec.kind == "x" and obs.log.records == []


def test_port_singleton_is_its_own():
    """The port's NULL_OBS and classes are its own, not the reference's."""
    assert P.NULL_OBS is not R.NULL_OBS
    assert P.Observability is not R.Observability and P.Tracer is not R.Tracer
    assert P.NULL_OBS.tracer.events is not R.NULL_OBS.tracer.events


def test_disabled_obs_engine_records_nothing():
    model, params = model_params("port")
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN)
    eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.run()
    assert eng.obs is NULL_OBS
    assert eng.obs.tracer.events == []
    assert eng.obs.metrics.snapshot() == {}


def test_trace_byte_identical_across_identical_seeds():
    obs1, obs2 = Observability(), Observability()
    s1 = chaos_run("port", obs1)[1]
    s2 = chaos_run("port", obs2)[1]
    assert s1 == s2
    j1, j2 = obs1.tracer.to_json(), obs2.tracer.to_json()
    assert j1 == j2, "identical seeds must export byte-identical traces"
    assert obs1.tracer.to_json(include_wall=True) != j1


def test_tracing_does_not_perturb_streams():
    model, params = model_params("port")
    reqs = prompts(model.cfg.vocab_size, n=8, seed=5)
    refs = [generate_offline(model, params, p, m, MAX_LEN) for p, m, _ in reqs]
    traced = chaos_run("port", Observability())[1]
    plain = chaos_run("port", NULL_OBS)[1]
    assert traced == plain == refs


def test_chaos_closes_every_span_and_trace_validates():
    obs = Observability()
    chaos_run("port", obs)
    assert obs.tracer.open_spans == [], "spans leaked across kill-1-of-3"
    assert validate_trace(obs.tracer.events) == []
    snap = obs.metrics.snapshot()
    assert snap["replica.fault.fail"] >= 1
    assert snap["replica.fault.rejoin"] >= 1
    names = {ev["name"] for ev in obs.tracer.events}
    assert {"request", "prefill", "decode", "fault", "dispatch"} <= names


def test_cancel_closes_span_and_counts():
    model, params = model_params("port")
    obs = Observability()
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, obs=obs)
    rid = eng.submit(np.arange(6, dtype=np.int32), 8)
    eng.step()
    assert obs.tracer.open_spans == ["request"]
    eng.cancel(rid, reason="cancelled")
    assert obs.tracer.open_spans == []
    assert obs.metrics.snapshot()["engine.cancel.cancelled"] == 1
    ends = [ev for ev in obs.tracer.events if ev["ph"] == "e"]
    assert ends and ends[-1]["args"]["outcome"] == "cancelled"


def test_migration_closes_source_span_opens_dest_span():
    model, params = model_params("port")
    obs = Observability()
    src = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, obs=obs, obs_name="src")
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, obs=obs, obs_name="dst")
    prompt = np.arange(6, dtype=np.int32)
    ref = generate_offline(model, params, prompt, 8, MAX_LEN)
    rid = src.submit(prompt, 8)
    for _ in range(3):
        src.step()
    ticket = src.export_request(rid)
    assert src.obs.tracer.open_spans == []
    rid2 = dst.import_request(ticket)
    assert obs.tracer.open_spans == ["request"]
    out = dst.run()
    assert obs.tracer.open_spans == []
    assert out[rid2].tokens == ref
    snap = obs.metrics.snapshot()
    assert snap["engine.migrated_out"] == 1
    assert snap["engine.migrated_in"] == 1
    kinds = [ev["name"] for ev in obs.tracer.events if ev["ph"] == "i"]
    assert "migrate_out" in kinds and "migrate_in" in kinds


def test_validate_trace_catches_violations():
    ok = [
        {"ph": "b", "cat": "c", "name": "s", "pid": 1, "tid": 0, "id": 1, "ts": 1.0},
        {"ph": "e", "cat": "c", "name": "s", "pid": 1, "tid": 0, "id": 1, "ts": 2.0},
        {"ph": "X", "name": "x", "pid": 1, "tid": 0, "ts": 2.0, "dur": 1.0},
        {"ph": "i", "name": "i", "pid": 1, "tid": 0, "ts": 3.0, "s": "p"},
    ]
    assert validate_trace(ok) == []
    orphan = [{"ph": "e", "cat": "c", "name": "s", "pid": 1, "id": 9, "ts": 1.0}]
    assert any("orphan" in e for e in validate_trace(orphan))
    unclosed = [{"ph": "b", "cat": "c", "name": "s", "pid": 1, "id": 1, "ts": 1.0}]
    assert any("unclosed" in e for e in validate_trace(unclosed))
    inverted = [
        {"ph": "b", "cat": "c", "name": "s", "pid": 1, "id": 1, "ts": 5.0},
        {"ph": "e", "cat": "c", "name": "s", "pid": 1, "id": 1, "ts": 1.0},
    ]
    assert any("before it begins" in e for e in validate_trace(inverted))
    negdur = [{"ph": "X", "name": "x", "pid": 1, "ts": 1.0, "dur": -0.5}]
    assert any("negative duration" in e for e in validate_trace(negdur))
    backwards = [
        {"ph": "X", "name": "x", "pid": 1, "tid": 0, "ts": 5.0, "dur": 1.0},
        {"ph": "i", "name": "i", "pid": 1, "tid": 0, "ts": 2.0, "s": "p"},
    ]
    assert any("non-monotone" in e for e in validate_trace(backwards))


def test_tracer_end_span_twice_raises():
    tr = Tracer()
    pid = tr.register_process("p")
    sid = tr.begin_span("s", pid, 1.0)
    tr.end_span(sid, 2.0)
    with pytest.raises(ValueError):
        tr.end_span(sid, 3.0)


def test_metrics_registry_basics():
    m = MetricsRegistry()
    c = m.counter("c")
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    assert m.counter("c") is c
    with pytest.raises(TypeError):
        m.gauge("c")
    g = m.gauge("g")
    g.set(2.0)
    g.set(7.0)
    g.set(3.0)
    assert g.value == 3.0 and g.high_water == 7.0
    h = m.histogram("h")
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 5 and s["max"] == 100.0 and s["min"] == 1.0
    assert h.percentile(50) == 3.0
    snap = m.snapshot()
    assert list(snap) == sorted(snap)
    assert snap["c"] == 4
    assert snap["g"] == {"value": 3.0, "high_water": 7.0}


def test_histogram_deterministic_under_decimation():
    def fill(seed):
        h = MetricsRegistry().histogram("h")
        for v in np.random.default_rng(seed).exponential(1.0, size=20_000):
            h.observe(float(v))
        return h

    h1, h2 = fill(3), fill(3)
    assert h1.snapshot() == h2.snapshot()
    assert h1.snapshot()["count"] == 20_000
    exact = float(np.percentile(np.random.default_rng(3).exponential(1.0, size=20_000), 99))
    assert abs(h1.percentile(99) - exact) / exact < 0.1


def test_empty_histogram_snapshot_is_json_safe():
    assert json.dumps(MetricsRegistry().histogram("h").snapshot())


def test_decision_log_bounded_with_counted_drops():
    d = DecisionLog(cap=10)
    for i in range(25):
        d.record("serve.gamma", {"gamma": i}, {"p": 0.5}, step=i)
    out = d.to_jsonable()
    assert len(out["entries"]) == 10
    assert out["dropped"] == 15
    assert [x["decision"]["gamma"] for x in out["entries"]] == list(range(10))


def test_spec_controller_records_gamma_changes_only():
    obs = Observability()
    ctl = SpecController(gamma_max=4)
    ctl.obs = obs
    cost = CostModel()
    for _ in range(40):
        ctl.observe(3, 4)
        ctl.choose_gamma(cost)
    recs = obs.decisions.by_domain("serve.gamma")
    assert recs, "at least the first plan must be recorded"
    gammas = [r.decision["gamma"] for r in recs]
    assert all(a != b for a, b in zip(gammas, gammas[1:]))
    assert {"p", "observations", "cost_per_token"} <= set(recs[0].inputs)


def test_structured_log_echo_is_a_view_of_records(capsys):
    log = StructuredLog(echo=True)
    log.emit("step", t=1.5, loss=0.25, k=3)
    log.emit("done", ok=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == log.records[0].format()
    assert out[1] == log.records[1].format()
    assert log.last("step").fields["k"] == 3
    assert [r["kind"] for r in log.to_jsonable()] == ["step", "done"]


def test_structured_log_silent_still_records(capsys):
    log = StructuredLog(echo=False)
    log.emit("step", loss=1.0)
    assert capsys.readouterr().out == ""
    assert len(log.by_kind("step")) == 1


def test_observability_snapshot_roundtrip(tmp_path):
    obs = Observability()
    chaos_run("port", obs)
    path = tmp_path / "snap.json"
    obs.export_snapshot(str(path))
    snap = json.loads(path.read_text())
    assert snap["open_spans"] == []
    assert snap["trace_events"] == len(obs.tracer.events)
    assert "engine.generated_tokens" in snap["metrics"]


# ---------------------------------------------------------------------------
# 2. Parity with the reference
# ---------------------------------------------------------------------------

def _drive_metrics(pkg):
    m = pkg.MetricsRegistry()
    c = m.counter("a.count")
    for v in (1, 3, 0, 2.5):
        c.inc(v)
    g = m.gauge("b.level")
    for v in (2, 9, 4, 0):
        g.set(v)
    h = m.histogram("c.small", cap=64)       # decimates past 64 samples
    for v in np.random.default_rng(7).exponential(2.0, size=1000):
        h.observe(float(v))
    m.histogram("d.empty")
    for v in (0.5, 0.25, 1e-10):
        m.histogram("e.exact").observe(v)
    return m.snapshot()


def _drive_tracer(pkg):
    tr = pkg.Tracer()
    a, b = tr.register_process("engine"), tr.register_process("frontend")
    s1 = tr.begin_span("request", a, 0.001, args={"rid": 0})
    s2 = tr.begin_span("request", b, 0.0015)
    tr.complete("prefill", a, 0.001, 0.0123456789, args={"rid": 0, "done": True})
    tr.instant("cancel", a, 0.0125, args={"rid": 0, "reason": "deadline"})
    tr.counter("occupancy", a, 0.0125, {"slots": 1, "blocks": 3})
    tr.end_span(s1, 0.013, args={"outcome": "done"})
    tr.complete("idle", b, 0.0015, 1.0 / 3.0)
    assert tr.open_spans == ["request"]
    tr.end_span(s2, 0.5)
    return tr.to_json(), tr.open_spans, validate_trace(tr.events)


def _drive_decisions(pkg):
    d = pkg.DecisionLog(cap=5)
    for i in range(8):
        d.record("serve.hedge", {"n_h": i % 3}, {"slowdowns": [1.0, 2.5]}, step=i,
                 vtime=0.1 * i)
    return d.to_jsonable(), [x.step for x in d.by_domain("serve.hedge")]


def _drive_log(pkg):
    log = pkg.StructuredLog(echo=False)
    log.emit("train_step", t=0.25, step=3, loss=2.5, k=2, beta=0.5, workers=[0, 1])
    log.emit("done", ok=True)
    return log.to_jsonable(), [r.format() for r in log.records], log.last("done").fields


@pytest.mark.parametrize("drive", [_drive_metrics, _drive_tracer, _drive_decisions, _drive_log],
                         ids=["metrics", "tracer", "decisions", "log"])
def test_components_match_reference(drive):
    """The same calls on each component of both packages give equal
    exports (the histogram past its cap included)."""
    assert drive(P) == drive(R)


def _noisy_draft(noise=3e-4):
    ref, jp, model, _ = pair()
    rng = np.random.default_rng(17)
    noisy = jax.tree.map(lambda a: (np.asarray(a) + noise * rng.standard_normal(a.shape))
                         .astype(np.float32), jp)
    return jax.tree.map(jax.numpy.asarray, noisy), params_from_numpy(model.cfg, noisy,
                                                                     device="cpu")


#: Engine configurations: pool options, traffic, slots.
ENGINES = {
    "contiguous": (dict(), dict(n=6, seed=1), 2),
    "paged": (dict(block_size=8), dict(n=6, seed=1), 2),
    "sharing-preempting": (dict(block_size=8, arena_blocks=7, prefix_sharing=True),
                           "preempt", 2),
    "speculative": (dict(gamma_max=3), dict(n=4, seed=2), 3),
}


def _engine_run(pkg, name, obs):
    ref, jp, model, params = pair()
    kw, traffic, n_slots = ENGINES[name]
    kw = dict(kw)
    if pkg == "ref":
        Engine, Sched, mp = RefEngine, RefScheduler, (ref, jp)
    else:
        Engine, Sched, mp = ServeEngine, Scheduler, (model, params)
    if name == "speculative":
        jd, td = _noisy_draft()
        kw.update(draft_model=mp[0], draft_params=jd if pkg == "ref" else td)
    if traffic == "preempt":
        rng = np.random.default_rng(5)
        reqs = [(rng.integers(0, model.cfg.vocab_size, size=int(rng.integers(18, 30)))
                 .astype(np.int32), 10, i * 0.001) for i in range(4)]
    else:
        reqs = prompts(model.cfg.vocab_size, **traffic)
    eng = Engine(*mp, n_slots=n_slots, max_len=MAX_LEN, obs=obs,
                 scheduler=Sched(n_slots, prefill_chunk=8, decode_per_prefill=2), **kw)
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    out = eng.run()
    return eng, [out[r].tokens for r in rids]


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_obs_matches_reference(name):
    """The port's engine and the reference's, both with Observability(),
    on the same traffic: the default trace export is equal byte for byte,
    and so are the metrics snapshot and the decision log."""
    ref_obs, port_obs = R.Observability(), Observability()
    ref_eng, ref_streams = _engine_run("ref", name, ref_obs)
    eng, streams = _engine_run("port", name, port_obs)
    assert streams == ref_streams
    assert port_obs.tracer.to_json() == ref_obs.tracer.to_json()
    assert port_obs.metrics.snapshot() == ref_obs.metrics.snapshot()
    assert port_obs.decisions.to_jsonable() == ref_obs.decisions.to_jsonable()
    assert port_obs.tracer.open_spans == [] and validate_trace(port_obs.tracer.events) == []
    if name == "sharing-preempting":
        assert eng.stats.preempted_requests > 0, "workload failed to preempt"
        assert port_obs.metrics.snapshot()["engine.preempted"] == eng.stats.preempted_requests
    if name == "speculative":
        assert eng.stats.spec_rounds > 0 and port_obs.decisions.by_domain("serve.gamma")
        assert port_obs.metrics.snapshot()["spec.offered"] > 0


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_streams_do_not_depend_on_obs(name):
    """Streams, events and stats (but the host clock's) with obs on equal
    those with obs off."""
    on, off = _engine_run("port", name, Observability()), _engine_run("port", name, None)
    assert on[1] == off[1]
    assert on[0].events == off[0].events
    counts = [{k: v for k, v in dataclasses.asdict(e.stats).items() if "wall" not in k}
              for e in (on[0], off[0])]
    assert counts[0] == counts[1]
    assert off[0].obs is NULL_OBS and NULL_OBS.tracer.events == []


def test_train_loop_obs_matches_reference():
    """``tests/test_torch_train_loop.py``'s fail-and-rejoin run (20 steps
    of adaptive_kbeta, worker 1 fails at step 5 and rejoins at 12) with
    obs on in both loops: the metrics snapshot and the decision log are
    equal, and so is the trace event for event, except each
    ``train_step``'s loss, which agrees within 1e-5 relative (two
    frameworks' f32 arithmetic)."""
    import repro.core as jcore
    import repro.data as jdata
    from repro.configs import get_config
    from repro.models import build_model
    from repro.optim.optimizers import get_optimizer as j_get_optimizer
    from repro.runtime.train_loop import FaultEvent as JFault
    from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
    from repro.runtime.train_loop import train as j_train
    import repro_torch.core as tcore
    import repro_torch.data as tdata
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import FaultEvent, TrainLoopConfig, train
    from test_torch_train_loop import TINY, _setup

    events = [(5, "fail", 1), (12, "rejoin", 1)]
    ref_obs, port_obs = R.Observability(), Observability()
    ref = build_model(get_config("llama3.2-1b").reduced(**TINY))
    j_train(ref, j_get_optimizer("adamw"), *_setup(jcore, jdata),
            JLoopConfig(total_steps=20, log_every=0, lr=3e-3,
                        events=[JFault(*e) for e in events]), obs=ref_obs)
    cfg = port_config("llama3.2-1b").reduced(**TINY)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0))),
                               device="cpu")
    train(Model(cfg), get_optimizer("adamw"), *_setup(tcore, tdata),
          TrainLoopConfig(total_steps=20, log_every=0, lr=3e-3,
                          events=[FaultEvent(*e) for e in events]),
          params=params, device="cpu", obs=port_obs)
    assert port_obs.metrics.snapshot() == ref_obs.metrics.snapshot()
    assert port_obs.decisions.to_jsonable() == ref_obs.decisions.to_jsonable()
    assert len(port_obs.decisions.entries) >= 1
    a, b = ref_obs.tracer.events, port_obs.tracer.events
    assert len(a) == len(b) and validate_trace(b) == []
    names = {ev["name"] for ev in b}
    assert {"train_step", "fault", "stage_switch"} <= names
    for x, y in zip(a, b):
        if x["name"] == "train_step":
            assert y["args"]["loss"] == pytest.approx(x["args"]["loss"], rel=1e-5)
            x = dict(x, args={k: v for k, v in x["args"].items() if k != "loss"})
            y = dict(y, args={k: v for k, v in y["args"].items() if k != "loss"})
        assert json.dumps(x, sort_keys=True) == json.dumps(y, sort_keys=True)
