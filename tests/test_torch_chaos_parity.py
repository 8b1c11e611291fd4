"""The chaos search of the reference (``tools/chaos_search.py``) and its
port twin (``tools/chaos_search_torch.py``) on the same schedules, on the
CPU: reduced smollm-135m in f32, the port holding the reference's
parameters (crossed by ``params_from_numpy``).

Each schedule (three sampled ones, the seeded cancel-path leak, a single
drop with retransmission off, a duplicated submit with dedup off) gives
equal signatures, violation lists (oracle and detail), plane ticks and
``summary()`` in both; the schedule sampler makes the same draws; the
leak schedule shrinks to the same single ``fail`` atom; and a repro file
written by the reference replays through the port with the same
signature.
"""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import tools.chaos_search as ref                           # noqa: E402
import tools.chaos_search_torch as port                    # noqa: E402
from repro.runtime.faults import FaultEvent                # noqa: E402
from repro.serve import FaultDirective                     # noqa: E402
from repro_torch.models import Model, params_from_numpy    # noqa: E402

KNOBS = {"max_ticks": 6_000}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wls():
    """(reference workload, port workload on the same parameters)."""
    rwl = ref.Workload(n_requests=4)
    cfg = port.get_config("smollm-135m").reduced()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rwl.params), device="cpu")
    pwl = port.Workload(n_requests=4, model=Model(cfg), params=params, device="cpu")
    assert [list(r) for r in pwl.refs] == [list(r) for r in rwl.refs]
    assert pwl.as_dict() == rwl.as_dict()
    return rwl, pwl


def _to_ref(sched: "port.Schedule") -> "ref.Schedule":
    return ref.Schedule.from_dict(sched.as_dict())


def _leak_schedule():
    """``tests/test_chaos_search.py``'s leak schedule, in the port's types."""
    return port.Schedule(
        events=[port.FaultEvent(step=8, kind="fail", worker=1),
                port.FaultEvent(step=70, kind="rejoin", worker=1),
                port.FaultEvent(step=40, kind="slow", worker=2, factor=2.0)],
        directives=[port.FaultDirective("r1", "fe", "delay", 50, ticks=3)],
        partitions=[], cost_per_replica=10.0)


CASES = {
    **{f"sampled_{i}": (lambda i=i: port.sample_schedule(np.random.default_rng([0, i])), {})
       for i in range(3)},
    "leak_blocks": (_leak_schedule, {"leak_blocks": True}),
    "no_reliable_drop": (lambda: port.Schedule(
        events=[], directives=[port.FaultDirective("fe", "r0", "drop", 0)], partitions=[],
        cost_per_replica=10.0), {"reliable": False}),
    "no_dedup_dup": (lambda: port.Schedule(
        events=[], directives=[port.FaultDirective("fe", "r0", "dup", 0)], partitions=[],
        cost_per_replica=0.001), {"dedup": False}),
}


def _same_summary(a: dict, b: dict) -> bool:
    """Equal keys and values, NaN equal to NaN (the latency percentiles of
    a run that completes nothing)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and math.isnan(a[k]) and math.isnan(b[k]))
        for k in a)


@pytest.mark.parametrize("case", list(CASES))
def test_run_schedule_equal_to_reference(wls, case):
    rwl, pwl = wls
    make, knobs = CASES[case]
    sched = make()
    r = ref.run_schedule(rwl, _to_ref(sched), **knobs, **KNOBS)
    p = port.run_schedule(pwl, sched, **knobs, **KNOBS)
    assert p.signature() == r.signature()
    assert p.violations == r.violations
    assert p.ticks == r.ticks
    assert _same_summary(p.summary, r.summary), (p.summary, r.summary)
    want = {"leak_blocks": ("block_conservation", "no_leaks"),
            "no_reliable_drop": ("liveness",), "no_dedup_dup": ("exactly_once",)}
    assert p.signature() == want.get(case, ())


def test_sample_schedule_makes_the_reference_draws():
    for seed in (0, 3, 7):
        for i in range(40):
            a = port.sample_schedule(np.random.default_rng([seed, i])).as_dict()
            assert a == ref.sample_schedule(np.random.default_rng([seed, i])).as_dict()


def test_leak_schedule_shrinks_to_the_same_atom(wls):
    rwl, pwl = wls
    sched = _leak_schedule()
    sig = port.run_schedule(pwl, sched, leak_blocks=True, **KNOBS).signature()
    small = port.shrink(pwl, sched, sig, leak_blocks=True, **KNOBS)
    ref_small = ref.shrink(rwl, _to_ref(sched), sig, leak_blocks=True, **KNOBS)
    assert small.as_dict() == ref_small.as_dict()
    assert small.size() == 1 and small.events[0].kind == "fail"


def test_reference_repro_replays_on_the_port(wls, tmp_path):
    """A leak repro written by the reference's ``write_repro`` replays
    through the port's ``replay_repro`` (the port's own seeded weights)
    with the reference's signature; so does a drop with retransmission
    off."""
    rwl, _ = wls
    cases = [
        (ref.Schedule(events=[FaultEvent(step=8, kind="fail", worker=1)], directives=[],
                      partitions=[], cost_per_replica=10.0), {"leak_blocks": True}),
        (ref.Schedule(events=[], directives=[FaultDirective("fe", "r0", "drop", 0)],
                      partitions=[], cost_per_replica=10.0), {"reliable": False}),
    ]
    for i, (sched, extra) in enumerate(cases):
        knobs = {"reliable": True, "dedup": True, "retry_budget": 8, "max_ticks": 6_000,
                 "leak_blocks": False, **extra}
        report = ref.run_schedule(rwl, sched, **knobs)
        path = str(tmp_path / f"repro_{i}.json")
        ref.write_repro(path, seed=0, index=i, wl=rwl, sched=sched, report=report,
                        knobs=knobs)
        replayed = port.replay_repro(path, device="cpu")
        assert replayed.signature() == report.signature() != ()
        assert replayed.violations == report.violations
