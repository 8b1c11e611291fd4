"""The port's chaos search (``tools/chaos_search_torch.py``) on its own,
on the CPU: twins of ``tests/test_chaos_search.py`` at reduced
smollm-135m in f32 with the port's seeded weights.

1. With the reliability layer on, sampled chaos schedules pass every
   oracle.
2. With retransmission or dedup disabled, or the engine's seeded
   cancel-path leak armed, the search finds the violation, shrinks it to
   a single fault atom, and the minimal schedule replays identically.
3. The reference's regression schedules stay clean on the port.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.chaos_search_torch import (          # noqa: E402
    Schedule,
    Workload,
    replay_repro,
    run_schedule,
    sample_schedule,
    shrink,
    write_repro,
)

from repro_torch.runtime.faults import FaultEvent               # noqa: E402
from repro_torch.serve import FaultDirective, Partition         # noqa: E402

KNOBS = {"max_ticks": 6_000}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wl():
    return Workload(n_requests=4, device="cpu")


# ---------------------------------------------------------------------------
# 1. The reliable plane passes sampled campaigns
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sampled_schedules_pass_all_oracles(wl):
    for i in range(6):
        sched = sample_schedule(np.random.default_rng([0, i]))
        report = run_schedule(wl, sched, **KNOBS)
        assert report.ok, (i, sched.as_dict(), report.violations)


def test_schedule_json_roundtrip():
    sched = sample_schedule(np.random.default_rng([7, 7]))
    back = Schedule.from_dict(json.loads(json.dumps(sched.as_dict())))
    assert back.as_dict() == sched.as_dict()
    assert back.size() == sched.size()


# ---------------------------------------------------------------------------
# 2. Disabling the at-least-once layer is FOUND, shrunk, and replayable
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_unreliable_drop_found_and_shrunk_to_one_atom(wl):
    """A single dropped Submit strands the singleton-dispatch plane when
    retransmission is off — and ddmin strips the noise atoms down to
    exactly that drop. The same schedule is absorbed with the layer on."""
    sched = Schedule(
        events=[FaultEvent(step=40, kind="slow", worker=2, factor=2.0)],
        directives=[
            FaultDirective("fe", "r0", "drop", 0),
            FaultDirective("r1", "fe", "delay", 50, ticks=3),
        ],
        partitions=[Partition("r2", "fe", 200, 210)],
        cost_per_replica=10.0,
    )
    report = run_schedule(wl, sched, reliable=False, **KNOBS)
    assert report.signature() == ("liveness",)

    small = shrink(wl, sched, report.signature(), reliable=False, **KNOBS)
    assert small.size() == 1
    assert small.directives and small.directives[0].op == "drop"

    # minimal repro replays deterministically
    a = run_schedule(wl, small, reliable=False, **KNOBS)
    b = run_schedule(wl, small, reliable=False, **KNOBS)
    assert a.signature() == b.signature() == ("liveness",)

    # the reliability layer absorbs the full schedule
    assert run_schedule(wl, sched, **KNOBS).ok


def test_no_dedup_duplicate_admission_found(wl):
    """A duplicated Submit double-admits on the receiving engine when
    receiver dedup is off — caught by the exactly-once oracle via the
    port's god's-eye admission log."""
    sched = Schedule(
        events=[],
        directives=[FaultDirective("fe", "r0", "dup", 0)],
        partitions=[],
        cost_per_replica=0.001,
    )
    report = run_schedule(wl, sched, dedup=False, **KNOBS)
    assert report.signature() == ("exactly_once",)
    assert run_schedule(wl, sched, **KNOBS).ok


def test_corrupt_ticket_rejected_and_requeued(wl):
    """In-flight ticket corruption survives the link CRC but not the
    end-to-end checksum: the dest rejects, the frontend requeues from
    the intact prefix, and every oracle still holds."""
    sched = Schedule(
        events=[FaultEvent(step=9, kind="drain", worker=1)],
        directives=[FaultDirective("fe", "r0", "corrupt", 8)],
        partitions=[],
        cost_per_replica=10.0,
    )
    report = run_schedule(wl, sched, **KNOBS)
    assert report.ok, report.violations
    assert report.summary["ticket_rejects"] == 1
    assert report.summary["migrations"] == 0


@pytest.mark.slow
def test_leak_blocks_found_and_shrunk_to_one_atom(wl):
    """The seeded cancel-path refcount bug (--leak-blocks) drops one
    arena block per cancel without freeing it. Under singleton dispatch
    the ONLY cancels come from node failure, so the block-conservation
    oracle trips exactly on cancel-bearing schedules and ddmin strips
    every noise atom down to the one fail event."""
    sched = Schedule(
        events=[
            FaultEvent(step=8, kind="fail", worker=1),
            FaultEvent(step=70, kind="rejoin", worker=1),
            FaultEvent(step=40, kind="slow", worker=2, factor=2.0),
        ],
        directives=[FaultDirective("r1", "fe", "delay", 50, ticks=3)],
        partitions=[],
        cost_per_replica=10.0,
    )
    report = run_schedule(wl, sched, leak_blocks=True, **KNOBS)
    assert "block_conservation" in report.signature()

    small = shrink(wl, sched, report.signature(), leak_blocks=True, **KNOBS)
    assert small.size() == 1
    assert small.events and small.events[0].kind == "fail"

    # minimal repro replays deterministically
    a = run_schedule(wl, small, leak_blocks=True, **KNOBS)
    b = run_schedule(wl, small, leak_blocks=True, **KNOBS)
    assert a.signature() == b.signature() == report.signature()

    # with the bug unseeded the same schedule passes every oracle,
    # including block_conservation
    assert run_schedule(wl, sched, **KNOBS).ok


def test_leak_blocks_knob_roundtrips_repro(tmp_path, wl):
    """A --leak-blocks repro JSON must carry the knob: replaying it
    without re-arming the seeded bug would vacuously pass."""
    sched = Schedule(
        events=[FaultEvent(step=8, kind="fail", worker=1)],
        directives=[], partitions=[], cost_per_replica=10.0,
    )
    knobs = {"reliable": True, "dedup": True, "retry_budget": 8,
             "max_ticks": 6_000, "leak_blocks": True}
    report = run_schedule(wl, sched, **knobs)
    assert "block_conservation" in report.signature()
    path = str(tmp_path / "repro_leak.json")
    write_repro(path, seed=0, index=0, wl=wl, sched=sched, report=report,
                knobs=knobs)
    assert json.load(open(path))["knobs"]["leak_blocks"] is True
    assert replay_repro(path, device="cpu").signature() == report.signature()


@pytest.mark.slow
def test_sharing_fleet_passes_sampled_schedules():
    """The COW ledger holds under chaos: sampled schedules on a
    prefix-sharing fleet (shared-prefix workload, hedged and singleton
    dispatch both drawn) pass every oracle including conservation."""
    swl = Workload(n_requests=4, prefix_sharing=True, device="cpu")
    for i in range(4):
        sched = sample_schedule(np.random.default_rng([3, i]))
        report = run_schedule(swl, sched, **KNOBS)
        assert report.ok, (i, sched.as_dict(), report.violations)


def test_repro_file_roundtrip(tmp_path, wl):
    sched = Schedule(
        events=[], partitions=[], cost_per_replica=10.0,
        directives=[FaultDirective("fe", "r0", "drop", 0)],
    )
    knobs = {"reliable": False, "dedup": True, "retry_budget": 8,
             "max_ticks": 6_000}
    report = run_schedule(wl, sched, **knobs)
    assert report.signature() == ("liveness",)
    path = str(tmp_path / "repro.json")
    write_repro(path, seed=0, index=0, wl=wl, sched=sched, report=report,
                knobs=knobs)
    replayed = replay_repro(path, device="cpu")
    assert replayed.signature() == report.signature()


# ---------------------------------------------------------------------------
# 3. Regression repros for real bugs the harness caught
# ---------------------------------------------------------------------------

def test_regression_drain_chunk_race_stays_clean(wl):
    """A chunk racing its copy's migration export used to be dropped as
    stale, leaving a permanent hole in the stream buffer (the ticket's
    prefix now backfills the attempt buffer at export)."""
    sched = Schedule(
        events=[FaultEvent(step=9, kind="drain", worker=1, factor=3.904)],
        directives=[], partitions=[], cost_per_replica=10.0,
    )
    assert run_schedule(wl, sched, **KNOBS).ok


def test_regression_ticket_not_offered_to_hosting_replica(wl):
    """Offering a migration ticket to a replica already hosting a hedged
    copy of the same request used to orphan that copy's router slot
    (``fr.copies`` is keyed by replica)."""
    sched = Schedule(
        events=[FaultEvent(step=4, kind="drain", worker=2, factor=2.583)],
        directives=[], partitions=[], cost_per_replica=0.001,
    )
    assert run_schedule(wl, sched, **KNOBS).ok


# ---------------------------------------------------------------------------
# 4. The engine's seeded leak itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("armed", [False, True])
def test_seeded_leak_drops_one_block_on_cancel(wl, armed):
    """``_chaos_leak_blocks`` is off by default: a cancel returns every
    block. Armed, a cancelled paged slot's last block leaves its table
    and loses its reference without reaching the free list, which
    ``audit()`` reports; a contiguous pool is untouched either way."""
    from repro_torch.serve import ServeEngine

    prompt, m, _ = wl.requests[0]
    for block_size in (8, None):
        eng = ServeEngine(wl.model, wl.params, n_slots=2, max_len=64, block_size=block_size)
        assert eng._chaos_leak_blocks is False
        eng._chaos_leak_blocks = armed
        rid = eng.submit(prompt, m)
        while not eng.decoding_rids():
            eng.step()
        assert eng.cancel(rid)
        assert eng.pool.n_active == 0
        mgr = eng.pool.manager
        if mgr is None:
            continue
        if armed:
            assert mgr.n_used_blocks == 1 and (mgr.tables == 0).all()
            assert "leaked blocks: free + referenced != capacity" in mgr.audit()
        else:
            assert mgr.n_used_blocks == 0 and mgr.audit() == []
