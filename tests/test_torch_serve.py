"""The port's serving engine: continuous batching must be invisible, and
the port must serve the reference's exact token streams.

A request served by ``repro_torch.serve.ServeEngine`` — joining
mid-flight, sharing decode ticks with strangers, surviving chunked
prefill, masked dead lanes and paging under arena pressure — must emit
the same greedy stream as the port's ``generate_offline`` AND as the
reference JAX engine on the same parameters (bridged from the
reference's ``Model.init``). Plus the slot pool and the copied
``BlockManager``'s invariants, ported from tests/test_serve.py.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import is_paged_spec, tree_leaves, tree_map
from repro_torch.serve import (
    BlockManager,
    Scheduler,
    ServeEngine,
    SlotPool,
    generate_offline,
    run_static,
)

MAX_LEN = 64


@pytest.fixture(scope="module")
def smollm():
    """(reference model, reference params, port model, port params)."""
    ref = build_model(get_config("smollm-135m").reduced())
    jp = ref.init(jax.random.PRNGKey(0))
    cfg = port_config("smollm-135m").reduced()
    return ref, jp, Model(cfg), params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _workload(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = int(rng.integers(3, 20))
        m = int(rng.integers(1, 12))
        prompt = rng.integers(0, vocab, size=p).astype(np.int32)
        reqs.append((prompt, m, i * 0.004))
    return reqs


# ---------------------------------------------------------------------------
# Token equivalence: port engine == port offline == reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_offline_and_reference_engine(smollm, paged):
    """Staggered arrivals, mixed lengths, prefill_chunk=8, 3 slots for 6
    requests (paged: 10 blocks < the 18 a full pool would reserve, so
    admissions queue on block budget). Streams equal the port's offline
    decode and the reference engine's; so do the scheduling event logs."""
    ref, jp, model, params = smollm
    reqs = _workload(model.cfg.vocab_size)
    max_len = 48 if paged else MAX_LEN
    kw = dict(block_size=8, arena_blocks=10) if paged else {}
    reqs = [(p, min(m, 24), a) for p, m, a in reqs]
    eng = ServeEngine(model, params, n_slots=3, max_len=max_len,
                      scheduler=Scheduler(3, prefill_chunk=8, decode_per_prefill=2),
                      **kw)
    ref_eng = RefEngine(ref, jp, n_slots=3, max_len=max_len,
                        scheduler=RefScheduler(3, prefill_chunk=8, decode_per_prefill=2),
                        **kw)
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    results, ref_results = eng.run(), ref_eng.run()
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        tokens = results[rid].tokens
        assert tokens == generate_offline(model, params, p, m, max_len), rid
        assert tokens == ref_results[ref_rid].tokens, f"rid={rid} differs from reference"
        assert results[rid].t_done is not None
    assert eng.events == ref_eng.events
    if paged:
        eng.pool.manager.check()
        assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks


def test_static_baseline_matches_offline(smollm):
    _, _, model, params = smollm
    reqs = _workload(model.cfg.vocab_size, n=5, seed=3)
    results, stats = run_static(model, params, reqs, n_slots=2, max_len=MAX_LEN)
    for rid, (p, m, _) in zip(sorted(results), reqs):
        assert results[rid].tokens == generate_offline(model, params, p, m, MAX_LEN)
    assert stats.generated_tokens == sum(m for _, m, _ in reqs)


def test_prefill_bucket_capped_at_max_len(smollm):
    """The pad bucket never exceeds the slot capacity past the chunk
    start, so a bucket can never write over valid rows."""
    _, _, model, params = smollm
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, model.cfg.vocab_size, size=24).astype(np.int32)
    eng = ServeEngine(model, params, n_slots=1, max_len=29)
    rid = eng.submit(prompt, 4)
    assert eng.run()[rid].tokens == generate_offline(model, params, prompt, 4, 29)
    prompt = rng.integers(0, model.cfg.vocab_size, size=34).astype(np.int32)
    eng = ServeEngine(model, params, n_slots=1, max_len=40,
                      scheduler=Scheduler(1, prefill_chunk=5))
    rid = eng.submit(prompt, 5)
    assert eng.run()[rid].tokens == generate_offline(model, params, prompt, 5, 40)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_defrag_mid_flight_keeps_equivalence(smollm, paged):
    """Defragging while requests generate remaps the engine's per-slot
    decode state with the pool rows (paged: host block tables only)."""
    _, _, model, params = smollm
    reqs = _workload(model.cfg.vocab_size, n=5, seed=9)
    eng = ServeEngine(model, params, n_slots=3, max_len=MAX_LEN,
                      block_size=16 if paged else None)
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    defragged = 0
    while eng.step() != "done":
        act = eng.pool.active
        if act.any() and not act[: eng.pool.n_active].all():
            if eng.defrag():
                defragged += 1
            if paged:
                eng.pool.manager.check()
    assert defragged > 0, "workload never fragmented the pool; weak test"
    for rid, (p, m, _) in zip(rids, reqs):
        assert eng.request(rid).tokens == generate_offline(model, params, p, m, MAX_LEN)


def test_cancel_and_deadline_free_slot_and_blocks(smollm):
    _, _, model, params = smollm
    reqs = _workload(model.cfg.vocab_size, n=4, seed=2)
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=16,
                      scheduler=Scheduler(2, deadline_ticks=3))
    rids = [eng.submit(p, 11, arrival=a) for p, _, a in reqs]
    eng.step()                          # admit + prefill the first request
    assert eng.cancel(rids[0]) and not eng.cancel(rids[0])
    assert eng.request(rids[0]).cancel_reason == "cancelled"
    results = eng.run()
    assert any(results[r].cancel_reason == "deadline" for r in rids[1:])
    assert eng.pool.n_active == 0
    assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks
    assert eng.pool.manager.n_committed_blocks == 0
    eng.pool.manager.check()


# ---------------------------------------------------------------------------
# Slot pool invariants
# ---------------------------------------------------------------------------

def test_slot_pool_allocate_free_reuse(smollm):
    model = smollm[2]
    pool = SlotPool(model, n_slots=3, max_len=8, device="cpu")
    slots = [pool.allocate(owner=i) for i in range(3)]
    assert slots == [0, 1, 2] and pool.n_free == 0
    assert pool.allocate() is None          # full
    pool.free(1)
    assert pool.allocate(owner=9) == 1      # lowest free slot reused
    with pytest.raises(ValueError):
        pool.free(1)
        pool.free(1)                        # double free rejected


def test_slot_pool_defrag_compacts_and_preserves(smollm):
    model = smollm[2]
    pool = SlotPool(model, n_slots=4, max_len=8, device="cpu")
    for i in range(4):
        pool.allocate(owner=i)
    for s in range(4):
        one = tree_map(lambda spec: torch.full(
            [1 if a == "act_batch" else d for a, d in zip(spec.axes, spec.shape)],
            float(s + 1)), pool.specs)
        pool.write_slot(s, one, position=s + 1)
    pool.free(0)
    pool.free(2)
    assert pool.defrag() == {1: 0, 3: 1}
    assert pool.active.tolist() == [True, True, False, False]
    assert pool.owner[:2] == [1, 3]
    assert pool.positions[:2].tolist() == [2, 4]
    leaf = tree_leaves(pool.caches)[0]
    assert leaf.reshape(4, -1)[:, 0][:2].tolist() == [2.0, 4.0]
    pool.reset_slot(0)
    assert (tree_leaves(pool.caches)[0][0] == 0).all()
    assert (tree_leaves(pool.caches)[0][1] == 4).all()


def test_paged_pool_defrag_is_device_noop(smollm):
    model = smollm[2]
    pool = SlotPool(model, n_slots=4, max_len=32, block_size=16, device="cpu")
    assert all(is_paged_spec(s) for s in tree_leaves(pool.specs))
    for i in range(4):
        assert pool.allocate(owner=i, n_tokens=20) is not None
        pool.ensure_rows(i, 20)
    tables_before = pool.manager.tables.copy()
    leaves_before = tree_leaves(pool.caches)
    pool.free(0)
    pool.free(2)
    assert pool.defrag() == {1: 0, 3: 1}
    for a, b in zip(tree_leaves(pool.caches), leaves_before):
        assert a is b
    assert (pool.manager.tables[0] == tables_before[1]).all()
    assert (pool.manager.tables[1] == tables_before[3]).all()
    pool.manager.check()


def test_paged_pool_commit_append_free_lifecycle(smollm):
    model = smollm[2]
    pool = SlotPool(model, n_slots=2, max_len=32, block_size=8, arena_blocks=6,
                    device="cpu")
    mgr = pool.manager
    s0 = pool.allocate(owner=0, n_tokens=17)     # commits 3 blocks, owns 0
    assert mgr.n_committed_blocks == 3 and mgr.n_used_blocks == 0
    pool.ensure_rows(s0, 9)
    assert mgr.n_used_blocks == 2
    pool.ensure_rows(s0, 9)                      # idempotent
    assert mgr.n_used_blocks == 2
    assert pool.can_admit(24) and not pool.can_admit(25)
    assert pool.allocate(owner=1, n_tokens=25) is None
    with pytest.raises(ValueError, match="budget"):
        pool.ensure_rows(s0, 25)
    pool.free(s0)
    assert mgr.n_free_blocks == 6 and mgr.n_committed_blocks == 0
    assert pool.can_admit(32)
    assert mgr.used_high_water == 2
    mgr.check()


def test_paged_engine_rejects_oversized_request(smollm):
    _, _, model, params = smollm
    eng = ServeEngine(model, params, n_slots=2, max_len=48, block_size=8,
                      arena_blocks=4)
    with pytest.raises(ValueError, match="arena"):
        eng.submit(np.arange(30, dtype=np.int32), 10)   # 5 blocks > 4
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(40, dtype=np.int32), 10)


def test_block_size_must_divide_rows(smollm):
    with pytest.raises(ValueError, match="divide"):
        SlotPool(smollm[2], n_slots=2, max_len=32, block_size=24, device="cpu")


# ---------------------------------------------------------------------------
# BlockManager invariants (the copy in repro_torch.serve.kv_pool)
# ---------------------------------------------------------------------------

def test_block_manager_invariants():
    mgr = BlockManager(n_slots=3, n_rows=64, block_size=16, num_blocks=8)
    assert mgr.table_width == 4
    mgr.commit(0, 33)                  # budget 3 blocks
    mgr.commit(1, 64)                  # budget 4 blocks
    mgr.check()
    assert mgr.n_committed_blocks == 7 and mgr.n_used_blocks == 0
    mgr.append(0, 17)                  # 2 physical blocks
    mgr.append(1, 64)                  # 4 physical blocks
    assert mgr.n_used_blocks == 6 and mgr.used_high_water == 6
    mgr.append(0, 30)                  # still 2 blocks: no growth
    assert mgr.n_used_blocks == 6
    mgr.append(0, 33)                  # grows to 3 (its full budget)
    assert mgr.n_used_blocks == 7
    mgr.check()
    assert not mgr.can_commit(17)      # 2 more blocks > 8 - 7 committed
    assert mgr.can_commit(16)
    with pytest.raises(ValueError, match="over-committed"):
        mgr.commit(2, 33)
    with pytest.raises(ValueError, match="table width"):
        mgr.commit(2, 65)
    with pytest.raises(ValueError, match="budget"):
        mgr.append(0, 49)
    mgr.free(1)
    assert mgr.n_free_blocks == 5 and mgr.n_committed_blocks == 3
    assert (mgr.tables[1] == 0).all()
    mgr.check()
    mgr.free(0)
    assert mgr.n_free_blocks == 8
    assert mgr.used_high_water == 7    # high-water survives frees
    mgr.check()


def test_block_manager_never_hands_out_a_block_twice():
    mgr = BlockManager(n_slots=4, n_rows=32, block_size=8, num_blocks=12)
    rng = np.random.default_rng(0)
    budget = [0] * 4
    for _ in range(300):
        slot = int(rng.integers(4))
        p = rng.random()
        if budget[slot] and p < 0.3:
            mgr.free(slot)
            budget[slot] = 0
        elif budget[slot]:
            mgr.append(slot, int(rng.integers(1, budget[slot] + 1)))
        else:
            want = int(rng.integers(1, 33))
            if mgr.can_commit(want):
                mgr.commit(slot, want)
                budget[slot] = want
        mgr.check()


def test_block_manager_audit_reports_corruption():
    mgr = BlockManager(n_slots=2, n_rows=32, block_size=8, num_blocks=4)
    mgr.commit(0, 16)
    mgr.append(0, 16)
    mgr._free.append(mgr._owned[0][0])          # a block both free and owned
    assert any("both free and referenced" in e for e in mgr.audit())
    with pytest.raises(AssertionError):
        mgr.check()
