"""Copy-on-write prefix sharing and preempt-and-requeue in the port,
against the reference, on the CPU.

1. Random operation sequences (commit, append, adopt, fork, free, permute,
   and the trie's register / match / forget) drive the port's and the
   reference's ``BlockManager`` and ``PrefixIndex`` side by side: tables,
   refcounts, free lists, budgets, high-water marks, released ids, trie
   matches, raised errors and ``audit()`` must agree exactly after every
   operation.
2. ``ServeEngine(prefix_sharing=True)`` against the reference engine on
   the same parameters (reduced smollm-135m and zamba2, f32): streams,
   event logs and the ``prefix_hits`` / ``prefix_rows_shared`` /
   ``preempted_requests`` counters, for a shared prefix, preemption under
   a 7-block arena, the full-match re-feed, ``restore_slot`` busy under
   arena pressure and a defrag mid-run. Every prefill and tick launch is
   checked: no position it writes lies in a block whose refcount is
   above 1.
3. The refusals: sharing with a draft model, without paging, and with
   capacity-dropped MoE.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.serve import BlockManager as RefBlockManager
from repro.serve import CostModel as RefCostModel
from repro.serve import Request as RefRequest
from repro.serve import PrefixIndex as RefPrefixIndex
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.attention import NULL_BLOCK
from repro_torch.serve import (
    ArenaExhausted,
    BlockManager,
    CostModel,
    PrefixIndex,
    Request,
    Scheduler,
    ServeEngine,
    generate_offline,
)

MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced-model steps are many tiny ops: intra-op threads only wait
    on each other beside other busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# 1. The block manager and the trie, mirrored
# ---------------------------------------------------------------------------

def _same_state(port: BlockManager, ref) -> None:
    assert np.array_equal(port.tables, ref.tables)
    assert np.array_equal(port.refcount, ref.refcount)
    assert port._free == ref._free
    assert port._owned == ref._owned
    assert port._budget == ref._budget
    assert port.used_high_water == ref.used_high_water
    assert port.audit() == ref.audit() == []


def _both(op, port, ref, *args):
    """Apply ``op`` to both managers: equal results, or errors of the same
    kind with the same message."""
    out = []
    for mgr in (port, ref):
        try:
            out.append(("ok", getattr(mgr, op)(*args)))
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1], (op, args, out)
    return out[0]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sharing,n_slots,num_blocks,block_size,n_ops", [
    (True, 4, 12, 4, 150),
    (True, 3, 5, 2, 120),          # constant exhaustion pressure
    (False, 4, 12, 4, 120),        # commit-at-admission: refcounts stay 1
], ids=["sharing", "tiny-arena", "committed"])
def test_block_manager_and_trie_match_the_reference(seed, sharing, n_slots, num_blocks,
                                                    block_size, n_ops):
    rng = np.random.default_rng(seed)
    rows = num_blocks * block_size
    port = BlockManager(n_slots, rows, block_size, num_blocks, sharing=sharing)
    ref = RefBlockManager(n_slots, rows, block_size, num_blocks, sharing=sharing)
    tries = (PrefixIndex(block_size), RefPrefixIndex(block_size))
    registered = []                # token lists handed to register
    active, exhausted = set(), 0
    ops = ["admit", "append", "append", "append", "free", "permute", "register", "match"]
    ops += ["adopt", "fork", "fork"] if sharing else []
    for _ in range(n_ops):
        op = rng.choice(ops)
        free_slots = [s for s in range(n_slots) if s not in active]
        if op == "admit" and free_slots:
            slot = int(rng.choice(free_slots))
            # Sharing commits the table width (the arena is the valve);
            # commit-at-admission a random budget, which may not fit.
            n_tok = rows if sharing else int(rng.integers(1, rows + 1))
            if _both("can_commit", port, ref, n_tok)[1]:
                _both("commit", port, ref, slot, n_tok)
                active.add(slot)
        elif op == "append" and active:
            slot = int(rng.choice(sorted(active)))
            want = len(port._owned[slot]) * block_size + int(rng.integers(1, 2 * block_size))
            kind, _ = _both("append", port, ref, slot, want)
            exhausted += kind == "ArenaExhausted"
        elif op == "adopt" and free_slots:
            donors = [s for s in active if port._owned[s]]
            if not donors:
                continue
            slot, donor = int(rng.choice(free_slots)), int(rng.choice(donors))
            chain = list(port._owned[donor][:int(rng.integers(1, len(port._owned[donor]) + 1))])
            _both("commit", port, ref, slot, rows)
            _both("adopt", port, ref, slot, chain)
            active.add(slot)
        elif op == "fork":
            cands = [(s, i) for s in sorted(active) for i, b in enumerate(port._owned[s])
                     if port.refcount[b] > 1]
            if not cands:
                continue
            slot, idx = cands[int(rng.integers(len(cands)))]
            kind, res = _both("fork", port, ref, slot, idx)
            exhausted += kind == "ArenaExhausted"
            if kind == "ok":
                assert not port.is_shared(res[1])
        elif op == "free" and active:
            slot = int(rng.choice(sorted(active)))
            _, released = _both("free", port, ref, slot)
            active.discard(slot)
            for trie in tries:
                for bid in released:
                    trie.forget(bid)
        elif op == "permute":
            order = rng.permutation(n_slots)
            port.permute(order)
            ref.permute(order)
            active = {new for new, old in enumerate(order) if int(old) in active}
        elif op == "register" and active:
            slot = int(rng.choice(sorted(active)))
            n_full = len(port._owned[slot])
            toks = list(rng.integers(0, 3, size=n_full * block_size + int(rng.integers(0, 3))))
            assert tries[0].register(toks, port._owned[slot]) == \
                tries[1].register(toks, ref._owned[slot])
            registered.append(toks)
        elif op == "match" and registered:
            probe = list(registered[int(rng.integers(len(registered)))])
            probe = probe[:int(rng.integers(0, len(probe) + 1))]
            assert tries[0].match(probe) == tries[1].match(probe)
        _same_state(port, ref)
        assert len(tries[0]) == len(tries[1])
    for slot in sorted(active):
        assert _both("free", port, ref, slot)[0] == "ok"
    _same_state(port, ref)
    assert port.n_free_blocks == num_blocks
    if sharing and num_blocks == 5:
        assert exhausted > 0, "the tiny arena never ran dry: weak test"


def test_adopt_and_fork_refuse_as_the_reference():
    """Fork needs a shared block and a free one; adopt needs an empty
    table and resident blocks; neither runs without sharing."""
    port, ref = BlockManager(2, 16, 4, 4, sharing=True), RefBlockManager(2, 16, 4, 4, sharing=True)
    for args in [("commit", 0, 16), ("append", 0, 8), ("fork", 0, 0), ("commit", 1, 16),
                 ("adopt", 1, [3]), ("adopt", 1, [1, 3]), ("adopt", 1, [2]),
                 ("append", 0, 16), ("fork", 1, 0)]:
        _both(args[0], port, ref, *args[1:])
    _same_state(port, ref)
    with pytest.raises(ArenaExhausted):
        port.fork(1, 0)
    legacy = BlockManager(1, 16, 4, 4)
    legacy.commit(0, 8)
    with pytest.raises(ValueError, match="sharing-mode"):
        legacy.adopt(0, [1])


@pytest.mark.parametrize("n", [-3, 0, 1, 16, 557])
def test_preemption_prices_match_the_reference(n):
    """Recompute (a prefill of the replay, nothing for none) and hold (the
    ticks still to run) price eviction as the reference does."""
    assert CostModel().recompute(n) == RefCostModel().recompute(n)
    assert CostModel().hold(n) == RefCostModel().hold(n)


def test_requeue_matches_the_reference():
    """A preempted request goes back to the queue in arrival order, its
    prefill progress and admission time reset, its tokens and arrival
    kept."""
    queues = []
    for Sched, Req in ((Scheduler, Request), (RefScheduler, RefRequest)):
        sched = Sched(2, prefill_chunk=8)
        reqs = [Req(i, np.arange(5 + i, dtype=np.int32), 4, 0.01 * i) for i in range(3)]
        for r in reqs:
            sched.submit(r)
        sched.on_admit(reqs[0])
        sched.on_prefill_chunk(reqs[0], 5, True)
        sched.on_admit(reqs[1])
        reqs[1].prefilled, reqs[1].tokens = 3, [7, 8]
        sched.requeue(reqs[1])
        sched.requeue(reqs[0])
        queues.append([(r.rid, r.prefilled, r.t_admit, r.tokens, r.arrival, r.prefill_len)
                       for r in sched.waiting] + [len(sched.running)])
    assert queues[0] == queues[1]
    assert [q[0] for q in queues[0][:3]] == [0, 1, 2]


# ---------------------------------------------------------------------------
# 2. The engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """arch -> (reference model, its params, port model, bridged params)."""
    out = {}
    for arch in ("smollm-135m", "zamba2"):
        ref = build_model(get_config(arch).reduced())
        jp = ref.init(jax.random.PRNGKey(0))
        cfg = port_config(arch).reduced()
        out[arch] = (ref, jp, Model(cfg),
                     params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


class WriteCheck:
    """Wraps an engine's prefill and tick: before each launch, every
    position it writes through a block table must lie in the NULL sink or
    in a block of refcount 1 (a shared block is read-only until forked).
    Counts the launches checked and those made while some table named a
    shared block."""

    def __init__(self, eng):
        self.mgr, self.bs = eng.pool.manager, eng.pool.block_size
        self.launches = self.with_shared = 0
        prefill, decode = eng._prefill, eng._decode

        def checked_prefill(params, chunk, caches, length, start, tables):
            self.check(tables, torch.arange(start, start + chunk.shape[1])[None, :])
            return prefill(params, chunk, caches, length, start, tables)

        def checked_decode(params, tokens, caches, positions, tables, lanes):
            self.check(tables, positions.reshape(-1, 1))
            return decode(params, tokens, caches, positions, tables, lanes)

        eng._prefill, eng._decode = checked_prefill, checked_decode

    def check(self, tables, pos):
        t = tables.cpu().numpy()
        idx = np.minimum(pos.cpu().numpy() // self.bs, t.shape[1] - 1)
        written = np.take_along_axis(t, idx, axis=1)
        live = written[written != NULL_BLOCK]
        assert (self.mgr.refcount[live] == 1).all(), \
            f"a write lands in a shared block: {live[self.mgr.refcount[live] != 1]}"
        self.launches += 1
        self.with_shared += bool((self.mgr.refcount > 1).any())


def _engines(pair, n_slots, chunk=8, **kw):
    ref, jp, model, params = pair
    eng = ServeEngine(model, params, n_slots=n_slots, max_len=MAX_LEN,
                      scheduler=Scheduler(n_slots, prefill_chunk=chunk, decode_per_prefill=2),
                      **kw)
    ref_eng = RefEngine(ref, jp, n_slots=n_slots, max_len=MAX_LEN,
                        scheduler=RefScheduler(n_slots, prefill_chunk=chunk,
                                               decode_per_prefill=2), **kw)
    return eng, ref_eng, WriteCheck(eng)


def _same_run(eng, ref_eng, rids, ref_rids, reqs, check_offline=True):
    """Streams equal the reference engine's (and the port's offline
    decode), and so do the event logs and the sharing counters; the arena
    drains clean."""
    model, params = eng.model, eng.params
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        tokens = eng.request(rid).tokens
        assert tokens == ref_eng.request(ref_rid).tokens, f"rid={rid} differs from reference"
        if check_offline:
            assert tokens == generate_offline(model, params, p, m, MAX_LEN), rid
    assert eng.events == ref_eng.events
    for name in ("prefix_hits", "prefix_rows_shared", "preempted_requests",
                 "prefill_tokens", "decode_ticks"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    eng.pool.manager.check()
    assert eng.pool.manager.n_used_blocks == 0


def _shared_prefix_reqs(vocab, shared_len=24, n=6, seed=11):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, vocab, size=int(rng.integers(2, 6)))
                             .astype(np.int32)]), 8, i * 0.002) for i in range(n)]


def _run_both(eng, ref_eng, reqs):
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    eng.run()
    ref_eng.run()
    return rids, ref_rids


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
def test_shared_prefix_matches_reference(pairs, arch):
    """Six prompts sharing 24 of 26-29 tokens, 3 slots, block 8: the dense
    model adopts (and its writes never touch a shared block); the hybrid,
    whose recurrent states cannot be adopted, shares nothing."""
    eng, ref_eng, writes = _engines(pairs[arch], 3, block_size=8, prefix_sharing=True)
    reqs = _shared_prefix_reqs(eng.model.cfg.vocab_size)
    _same_run(eng, ref_eng, *_run_both(eng, ref_eng, reqs), reqs)
    if arch == "zamba2":
        assert eng.pool._any_contiguous and eng.stats.prefix_hits == 0
    else:
        assert not eng.pool._any_contiguous
        assert eng.stats.prefix_hits > 0 and eng.stats.prefix_rows_shared >= 16
        assert writes.with_shared > 0, "no launch ran beside a shared block: weak test"
    assert writes.launches > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
def test_preempted_requeued_matches_reference(pairs, arch):
    """2 slots over a 7-block arena while each request wants ~5: evictions
    happen, and every replayed stream equals the uninterrupted one."""
    eng, ref_eng, writes = _engines(pairs[arch], 2, block_size=8, arena_blocks=7,
                                    prefix_sharing=True)
    rng = np.random.default_rng(5)
    V = eng.model.cfg.vocab_size
    reqs = [(rng.integers(0, V, size=int(rng.integers(18, 30))).astype(np.int32), 10, i * 0.001)
            for i in range(4)]
    _same_run(eng, ref_eng, *_run_both(eng, ref_eng, reqs), reqs)
    assert eng.stats.preempted_requests > 0, "workload failed to preempt"
    assert sum(kind == "preempt" for kind, _, _ in eng.events) == eng.stats.preempted_requests


def test_identical_prompts_full_match_refeed(pairs):
    """Block-aligned identical prompts: an adopter matches its WHOLE
    prompt and re-feeds the last token through a forked tail block — the
    one case where a prefill write meets a shared block."""
    eng, ref_eng, writes = _engines(pairs["smollm-135m"], 3, block_size=8, prefix_sharing=True)
    p0 = np.random.default_rng(9).integers(0, eng.model.cfg.vocab_size, size=16).astype(np.int32)
    reqs = [(p0, 6, 0.0), (p0, 6, 0.001), (p0, 6, 0.002)]
    forks = []
    fork = eng.pool.manager.fork
    eng.pool.manager.fork = lambda *a: forks.append(fork(*a)) or forks[-1]
    _same_run(eng, ref_eng, *_run_both(eng, ref_eng, reqs), reqs)
    assert eng.stats.prefix_hits >= 2 and forks, "no full match forked its tail block"


def test_restore_slot_busy_under_arena_pressure(pairs):
    """A migration landing on a sharing-mode pool without free blocks is
    refused (None) rather than crashing; once space frees it lands and the
    stream finishes as the reference's does."""
    ref, jp, model, params = pairs["smollm-135m"]
    rng = np.random.default_rng(2)
    V = model.cfg.vocab_size
    p = rng.integers(0, V, size=20).astype(np.int32)
    filler = rng.integers(0, V, size=40).astype(np.int32)
    results = []
    for Engine, mp in ((ServeEngine, (model, params)), (RefEngine, (ref, jp))):
        src = Engine(*mp, n_slots=2, max_len=MAX_LEN, block_size=8, prefix_sharing=True)
        rid = src.submit(p, 8, arrival=0.0)
        while len(src.request(rid).tokens) < 3:
            src.step()
        ticket = src.export_request(rid)
        dst = Engine(*mp, n_slots=2, max_len=MAX_LEN, block_size=8, arena_blocks=7,
                     prefix_sharing=True)
        f = dst.submit(filler, 8)
        while dst.request(f).prefilled < 40:
            dst.step()
        used = dst.pool.manager.n_used_blocks
        assert dst.import_request(ticket) is None          # busy, not a crash
        assert dst.pool.manager.n_used_blocks == used and dst.pool.n_active == 1
        dst.cancel(f)
        new = dst.import_request(ticket)
        assert new is not None
        dst.pool.manager.check()
        out = dst.run()
        results.append((out[new].tokens, dst.events, dst.stats.migrated_in))
    assert results[0] == results[1]
    assert results[0][0] == generate_offline(model, params, p, 8, MAX_LEN)


def test_defrag_mid_sharing_run_matches_reference(pairs):
    """Both engines defrag at the same steps while lanes share blocks:
    block tables permute on the host, refcounts are untouched, and streams
    and events stay the reference's."""
    eng, ref_eng, writes = _engines(pairs["smollm-135m"], 3, block_size=8, prefix_sharing=True)
    reqs = _shared_prefix_reqs(eng.model.cfg.vocab_size, seed=4)
    reqs = [(p, m + 4 * (i % 2), a) for i, (p, m, a) in enumerate(reqs)]
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    moved = 0
    while eng.step() != "done":
        assert ref_eng.step() != "done"
        act = eng.pool.active
        if act.any() and not act[:eng.pool.n_active].all():
            refcount = eng.pool.manager.refcount.copy()
            moves = eng.defrag()
            assert moves == ref_eng.defrag()
            moved += bool(moves)
            assert np.array_equal(eng.pool.manager.refcount, refcount)
            eng.pool.manager.check()
    assert ref_eng.step() == "done"
    assert moved > 0, "workload never fragmented the pool; weak test"
    _same_run(eng, ref_eng, rids, ref_rids, reqs)
    assert eng.stats.prefix_hits > 0 and writes.with_shared > 0


# ---------------------------------------------------------------------------
# 3. Refusals
# ---------------------------------------------------------------------------

def test_prefix_sharing_refusals(pairs):
    """Sharing with a draft (its twin pool does not follow the forks),
    without paging, and with capacity-dropped MoE (logits would depend on
    how many tokens share the suffix prefill) is refused, as in the
    reference; dropless MoE passes that check."""
    _, _, model, params = pairs["smollm-135m"]
    with pytest.raises(ValueError, match="prefix_sharing and speculative"):
        ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, block_size=8,
                    prefix_sharing=True, draft_model=model, draft_params=params)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, prefix_sharing=True)
    moe_cfg = port_config("smollm-135m").reduced()
    ref_moe = get_config("deepseek-v3").reduced().moe
    assert ref_moe is not None and not ref_moe.dropless
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(**{f.name: getattr(ref_moe, f.name) for f in dataclasses.fields(MoEConfig)})
    dropped = Model(dataclasses.replace(moe_cfg, moe=moe))
    with pytest.raises(ValueError, match="dropless"):
        ServeEngine(dropped, params, n_slots=2, max_len=MAX_LEN, block_size=8,
                    prefix_sharing=True)
    dropless = Model(dataclasses.replace(moe_cfg, moe=dataclasses.replace(moe, dropless=True)))
    eng = ServeEngine(dropless, params, n_slots=2, max_len=MAX_LEN, block_size=8,
                      prefix_sharing=True)
    assert eng.prefix_sharing
