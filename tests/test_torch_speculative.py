"""Speculative decoding in the port against the reference, on the CPU:
the pricing (``expected_round_tokens``, ``hedged_round_cost``,
``SpecController``), the scheduler's speculation clock, the model's
``verify_with_cache`` and the replay step over both pools, the hybrid's
commit of exactly the accepted prefix, ``DraftRunner``'s snapshot and
resync, a lane whose budget ends at ``max_len``, and ``ServeEngine``
with drafts of three qualities over both pools through a defrag.

Models: reduced smollm-135m (dense) and reduced zamba2-1.2b (2 Mamba2
layers and one shared call), from the reference's own
``Model.init`` through ``params_from_numpy`` (zamba2's LoRA
up-projections and conv / dt biases drawn at random, as in
tests/test_torch_zamba_serve.py). A draft is the target's parameters
plus seeded numpy noise, the same values in both frameworks. All f32.

Tolerances: pricing 1e-12 (the same float operations in the same
order); model outputs 1e-5 relative to the compared leaf's largest
magnitude (``close``: the frameworks sum the same f32 products in other
orders); the port against its own sequential decode, bit for bit.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import delay_models as ref_delay
from repro.models import build_model
from repro.serve import CostModel as RefCostModel
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro.serve import SpecController as RefSpecController
from repro.serve import hedged_round_cost as ref_hedged_round_cost
from repro.serve.scheduler import Request as RefRequest
from repro.serve.speculative import expected_round_tokens as ref_round_tokens
from repro_torch.configs import get_config as port_config
from repro_torch.core import delay_models as port_delay
from repro_torch.kernels.parity import RMS_VERIFY_SHAPES
from repro_torch.kernels.rmsnorm import _units, launch_plan
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.attention import paged_kv_view
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime.steps import make_slot_replay_step, make_slot_verify_step
from repro_torch.serve import (
    CostModel,
    DraftRunner,
    Scheduler,
    ServeEngine,
    SpecController,
    generate_offline,
    hedged_round_cost,
)
from repro_torch.serve.kv_pool import is_state_spec
from repro_torch.serve.scheduler import Request
from repro_torch.serve.speculative import expected_round_tokens

RTOL = 1e-5
MAX_LEN = 64
BLOCK = 8
FAMILIES = ["dense", "hybrid"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A decode step is hundreds of tiny ops: intra-op threads only wait
    on each other, and beside other busy processes they stall."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, what=""):
    """|got - want| <= RTOL * max(1, max |want|), element by element."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=what)


@functools.lru_cache(maxsize=None)
def _pair(family):
    """(reference model, its params as numpy, port model, bridged params)."""
    if family == "dense":
        jcfg, cfg = get_config("smollm-135m").reduced(), port_config("smollm-135m").reduced()
        jp = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
    else:
        jcfg, cfg = (get_config("zamba2").reduced(n_layers=2),
                     port_config("zamba2").reduced(n_layers=2))
        jp = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(4)
        stack = dict(jp["stack"])
        shared = dict(stack["shared"])
        for name in ("lora_qkv_b", "lora_mlp_b"):
            shared[name] = (0.05 * rng.standard_normal(shared[name].shape)).astype(np.float32)
        mixer = dict(stack["mamba"]["mixer"])
        for name in ("conv_b", "dt_bias"):
            mixer[name] = (0.1 * rng.standard_normal(mixer[name].shape)).astype(np.float32)
        stack["shared"] = shared
        stack["mamba"] = dict(stack["mamba"], mixer=mixer)
        jp = dict(jp, stack=stack)
    return build_model(jcfg), jp, Model(cfg), params_from_numpy(cfg, jp, device="cpu")


@functools.lru_cache(maxsize=None)
def _draft(family, noise):
    """(reference draft params, port draft params): the target's plus
    ``noise`` times seeded standard normals, leaf by leaf."""
    _, jp, model, _ = _pair(family)
    rng = np.random.default_rng(17)
    noisy = jax.tree.map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype), jp)
    return (jax.tree.map(jnp.asarray, noisy),
            params_from_numpy(model.cfg, noisy, device="cpu"))


@functools.lru_cache(maxsize=None)
def _ref_params(family):
    return jax.tree.map(jnp.asarray, _pair(family)[1])


@functools.lru_cache(maxsize=None)
def _ref_verify(family, greedy_commit=True):
    ref = _pair(family)[0]
    return jax.jit(functools.partial(ref.verify_with_cache, greedy_commit=greedy_commit))


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------

def _delay_pair(kind):
    if kind == "simplified":
        kw = dict(lambda_y=2.0, x=0.3, y=0.1)
        return ref_delay.SimplifiedDelayModel(**kw), port_delay.SimplifiedDelayModel(**kw)
    kw = dict(lambda_x=3.0, lambda_y=0.7, x=0.2, y=0.05)
    return ref_delay.GeneralizedDelayModel(**kw), port_delay.GeneralizedDelayModel(**kw)


@pytest.mark.parametrize("kind", ["simplified", "generalized"])
def test_round_tokens_and_hedged_cost_match_reference(kind):
    """Over gamma 0-6 and a grid of p, fan-outs, quorums, window loads
    (below and past beta = 1), per-replica costs and slowdowns."""
    for gamma in range(7):
        for p in (0.0, 0.3, 0.8, 0.95, 1.0):
            assert abs(expected_round_tokens(gamma, p) - ref_round_tokens(gamma, p)) <= 1e-12
    jd, td = _delay_pair(kind)
    for n_h in (1, 2, 4):
        for gamma in (0, 1, 3, 5):
            for quorum in (1, 2):
                for beta_unit in (0.05, 0.2, 0.4):
                    kw = dict(draft_time=0.01, beta_unit=beta_unit, quorum=quorum,
                              cost_per_replica=0.002, slowdown=1.3)
                    want = ref_hedged_round_cost(jd, n_h, gamma, **kw)
                    got = hedged_round_cost(td, n_h, gamma, **kw)
                    assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (n_h, gamma, kw)


def _plans_equal(got, want):
    assert (got.gamma, got.n_h) == (want.gamma, want.n_h)
    for name in ("expected_tokens", "expected_cost", "cost_per_token"):
        a, b = getattr(got, name), getattr(want, name)
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), name


@pytest.mark.parametrize("fused", [True, False])
def test_spec_controller_matches_reference(fused):
    """A seeded script of observations (with a warm-up, censored chains
    and all-accepted rounds), each followed by ``choose_gamma`` under
    three cost models and ``choose_hedged`` under both delay models: the
    EWMA, its counters, the histogram, ``p_effective`` and every plan."""
    rng = np.random.default_rng(3)
    got, want = SpecController(5, warmup=3, probe_every=4), RefSpecController(5, warmup=3,
                                                                              probe_every=4)
    got.draft_fused = want.draft_fused = fused
    costs = [(CostModel(), RefCostModel()),
             (CostModel(draft_ratio=0.9, verify_per_token=5e-4),
              RefCostModel(draft_ratio=0.9, verify_per_token=5e-4)),
             (CostModel(draft_ratio=0.05, decode_tick=2e-3),
              RefCostModel(draft_ratio=0.05, decode_tick=2e-3))]
    delays = [_delay_pair("simplified"), _delay_pair("generalized")]
    for _ in range(40):
        offered = int(rng.integers(0, 6))
        accepted = int(rng.integers(0, offered + 1)) if rng.random() < 0.7 else offered
        got.observe(accepted, offered)
        want.observe(accepted, offered)
        assert abs(got.p - want.p) <= 1e-12
        assert got.observations == want.observations
        assert np.array_equal(got.hist, want.hist)
        assert got.p_effective == want.p_effective
        for tc, jc in costs:
            _plans_equal(got.choose_gamma(tc), want.choose_gamma(jc))
            assert got.rounds == want.rounds
        for jd, td in delays:
            kw = dict(draft_time=0.004, beta_unit=0.15, n_max=3, quorum=2,
                      cost_per_replica=0.001, slowdown=1.1)
            _plans_equal(got.choose_hedged(td, **kw), want.choose_hedged(jd, **kw))
    with pytest.raises(ValueError):
        got.observe(3, 2)


def test_scheduler_speculation_clock_matches_reference():
    """A script of admissions, prefill chunks, draft mirrors, lockstep
    ticks and rounds (with replay, and with emitted counts that pay the
    decode debt down): the same actions and the same virtual times."""
    cost_kw = dict(draft_ratio=0.4, verify_per_token=3e-4, prefill_per_token=2e-4)
    got = Scheduler(2, prefill_chunk=8, decode_per_prefill=3)
    want = RefScheduler(2, prefill_chunk=8, decode_per_prefill=3)
    got.clock.cost = CostModel(**cost_kw)
    want.clock.cost = RefCostModel(**cost_kw)
    prompts = [np.arange(n, dtype=np.int32) for n in (20, 5, 11)]
    reqs = [(Request(i, p, 6, 0.001 * i), RefRequest(i, p, 6, 0.001 * i))
            for i, p in enumerate(prompts)]
    for a, b in reqs:
        got.submit(a)
        want.submit(b)
    n_active = 0
    script = [(3, 4, 2, False), (2, 3, 1, True), (0, 5, 4, False), (1, 2, 3, True)]
    for step in range(30):
        kind, req = got.next_action(n_active, 2 - n_active)
        ref_kind, ref_req = want.next_action(n_active, 2 - n_active)
        assert (kind, None if req is None else req.rid) == \
            (ref_kind, None if ref_req is None else ref_req.rid)
        if kind == "prefill":
            if req.prefilled == 0:
                got.on_admit(req)
                want.on_admit(ref_req)
                n_active += 1
            start, n_tok = got.chunk_for(req)
            assert (start, n_tok) == want.chunk_for(ref_req)
            got.on_draft_prefill(n_tok)
            want.on_draft_prefill(n_tok)
            done = start + n_tok >= req.prefill_len
            got.on_prefill_chunk(req, n_tok, done)
            want.on_prefill_chunk(ref_req, n_tok, done)
        elif kind == "decode":
            ticks, window, emitted, replay = script[step % len(script)]
            if step % 5 == 0:
                got.on_decode_tick()
                want.on_decode_tick()
                got.on_draft_decode()
                want.on_draft_decode()
            else:
                got.on_spec_round(ticks, window, emitted, replay=replay)
                want.on_spec_round(ticks, window, emitted, replay=replay)
        elif kind == "idle":
            got.on_idle()
            want.on_idle()
        else:
            break
        assert got.clock.now == want.clock.now, step
        assert got._decode_debt == want._decode_debt, step


# ---------------------------------------------------------------------------
# The model's verify and replay
# ---------------------------------------------------------------------------

def _prefilled(family, paged, lens, seed):
    """Port caches of B = len(lens) lanes prefilled with seeded prompts of
    ``lens`` tokens (paged: shuffled tables), as numpy leaves, and the
    tables (or None)."""
    _, _, model, tp = _pair(family)
    B = len(lens)
    rng = np.random.default_rng(seed)
    kw = dict(block_size=BLOCK, num_blocks=B * MAX_LEN // BLOCK) if paged else {}
    caches = model.blank_caches(B, MAX_LEN, device="cpu", **kw)
    tables = None
    if paged:
        ids = rng.permutation(B * MAX_LEN // BLOCK) + 1
        tables = torch.from_numpy(ids.reshape(B, -1).astype(np.int32))
    P = max(lens)
    prompt = rng.integers(0, model.cfg.vocab_size, (B, P)).astype(np.int32)
    _, caches = model.prefill_with_cache(tp, torch.from_numpy(prompt), caches,
                                         length=torch.tensor(lens), start_index=0,
                                         block_tables=tables)
    return tree_map(lambda t: t.numpy().copy(), caches, is_leaf=torch.is_tensor), tables


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree,
                    is_leaf=lambda x: isinstance(x, np.ndarray))


def _ref_tree(family, tree):
    """The port's numpy cache tree in the reference's layout (dense: one
    stacked leaf a segment; the hybrid's is already stacked)."""
    if family == "hybrid":
        return jax.tree.map(jnp.asarray, tree)
    return [{k: jnp.asarray(np.stack([layer[k] for layer in seg])) for k in ("k", "v")}
            for seg in tree]


def _np(tree):
    """A port cache tree as numpy leaves."""
    return tree_map(lambda t: t.numpy(), tree, is_leaf=torch.is_tensor)


def _from_ref(family, tree):
    """A reference cache tree as numpy leaves in the port's layout (dense:
    one dict a layer)."""
    tree = jax.tree.map(np.asarray, tree)
    if family == "hybrid":
        return tree
    return [[{k: seg[k][i] for k in ("k", "v")} for i in range(seg["k"].shape[0])]
            for seg in tree]


def _kv_rows(family, caches, tables, b, upto):
    """Lane b's K and V rows [0, upto) of every layer / shared call, as
    numpy (the port's tree; paged: gathered through the tables)."""
    out = []
    if family == "hybrid":
        pairs = [(caches["attn"]["k"][c], caches["attn"]["v"][c])
                 for c in range(caches["attn"]["k"].shape[0])]
    else:
        pairs = [(layer["k"], layer["v"]) for seg in caches for layer in seg]
    for k, v in pairs:
        k, v = torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))
        if tables is not None:
            k, v = paged_kv_view(k, tables), paged_kv_view(v, tables)
        out += [k[b, :upto].numpy(), v[b, :upto].numpy()]
    return out


def _states(caches):
    return [np.asarray(caches["mamba"][n]) for n in ("conv", "ssm")]


def _accepted(greedy, inputs, n_input):
    """The engine's rule: a[b] = the draft tokens lane b accepts."""
    out = []
    for b in range(inputs.shape[0]):
        a = 0
        while a < n_input[b] - 1 and greedy[b, a] == inputs[b, a + 1]:
            a += 1
        out.append(a)
    return np.array(out)


def _windows(family, paged, seed):
    """Prefilled caches and a verify window of S = 5 over 4 lanes at
    their own starts: n_input 0 (a free lane), 1 (plain decode), 5 with
    two tokens that the target accepts then a rejected tail, and 4
    with a rejected first draft."""
    _, _, model, tp = _pair(family)
    lens = [6, 9, 13, 4]
    caches, tables = _prefilled(family, paged, lens, seed)
    rng = np.random.default_rng(seed + 1)
    S = 5
    inputs = rng.integers(0, model.cfg.vocab_size, (4, S)).astype(np.int32)
    n_input = np.array([0, 1, 5, 4], np.int32)
    starts = np.array(lens, np.int32)
    verify = make_slot_verify_step(model)
    for t in range(2):          # lane 2 accepts its first two draft tokens
        greedy, _ = verify(tp, torch.from_numpy(inputs), _torch_tree(caches),
                           torch.from_numpy(n_input), torch.from_numpy(starts), tables)
        inputs[2, t + 1] = int(greedy[2, t])
    return caches, tables, inputs, n_input, starts


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_verify_and_replay_match_reference(family, paged):
    """The verify's logits at every position the caller reads (dense: all
    of ``n_input``; the hybrid: up to one past the accepted prefix, as
    later steps attend to rows the two frameworks keep differently), the
    committed recurrent states and every K/V row below each lane's
    committed position; then the replay of the committed tokens."""
    ref, _, model, tp = _pair(family)
    jp = _ref_params(family)
    caches, tables, inputs, n_input, starts = _windows(family, paged, 31)
    B = inputs.shape[0]
    logits, got = model.verify_with_cache(tp, torch.from_numpy(inputs), _torch_tree(caches),
                                          torch.from_numpy(n_input),
                                          torch.from_numpy(starts), tables)
    jt = None if tables is None else jnp.asarray(tables.numpy())
    ref_logits, want = _ref_verify(family)(jp, jnp.asarray(inputs),
                                           _ref_tree(family, caches),
                                           jnp.asarray(n_input), jnp.asarray(starts), jt)
    greedy = torch.argmax(logits, -1).numpy()
    a = _accepted(greedy, inputs, n_input)
    assert list(a) == [0, 0, 2, 0]
    assert np.array_equal(greedy[n_input > 0, 0],
                          np.asarray(jnp.argmax(ref_logits, -1))[n_input > 0, 0])
    for b in np.nonzero(n_input)[0]:
        upto = n_input[b] if family == "dense" else min(n_input[b], a[b] + 2)
        close(logits[b, :upto], np.asarray(ref_logits)[b, :upto], f"logits lane {b}")
    commit = np.where(n_input > 0, n_input if family == "dense" else a + 1, 0)
    got_np, want_np = _np(got), _from_ref(family, want)
    if family == "hybrid":
        for g, w in zip(_states(got_np), _states(want_np)):
            close(g, w, "recurrent state")
    for b in range(B):
        upto = starts[b] + commit[b]
        for g, w in zip(_kv_rows(family, got_np, tables, b, upto),
                        _kv_rows(family, want_np, tables, b, upto)):
            close(g, w, f"K/V lane {b}")

    # The replay commits exactly n tokens a lane from the same start.
    replay = make_slot_replay_step(model)
    got = replay(tp, torch.from_numpy(inputs), _torch_tree(caches), torch.from_numpy(commit),
                 torch.from_numpy(starts), tables)
    want = _ref_verify(family, False)(jp, jnp.asarray(inputs),
                                      _ref_tree(family, caches),
                                      jnp.asarray(commit), jnp.asarray(starts), jt)[1]
    got_np, want_np = _np(got), _from_ref(family, want)
    if family == "hybrid":
        for g, w in zip(_states(got_np), _states(want_np)):
            close(g, w, "replayed recurrent state")
    for b in range(B):
        for g, w in zip(_kv_rows(family, got_np, tables, b, starts[b] + commit[b]),
                        _kv_rows(family, want_np, tables, b, starts[b] + commit[b])):
            close(g, w, f"replayed K/V lane {b}")


def _sequential(model, tp, caches, inputs, n_commit, starts, tables):
    """The port's own decode_step over each lane's committed tokens, one
    token a step, lanes past their count masked off."""
    caches = _torch_tree(caches)
    for t in range(int(n_commit.max())):
        _, caches = model.decode_step(tp, torch.from_numpy(inputs[:, t:t + 1].copy()), caches,
                                      torch.from_numpy(starts + t), block_tables=tables,
                                      mask=torch.from_numpy(t < n_commit))
    return _np(caches)


@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_verify_commits_exactly_the_accepted_prefix(paged):
    """The hybrid's verify leaves each lane's recurrent state where the
    port's own sequential decode of its committed tokens (the pending
    token and the accepted drafts) leaves it, bit for bit, and every K/V
    row below the committed position with it; a free lane's state does
    not move."""
    _, _, model, tp = _pair("hybrid")
    caches, tables, inputs, n_input, starts = _windows("hybrid", paged, 41)
    logits, got = model.verify_with_cache(tp, torch.from_numpy(inputs), _torch_tree(caches),
                                          torch.from_numpy(n_input),
                                          torch.from_numpy(starts), tables)
    a = _accepted(torch.argmax(logits, -1).numpy(), inputs, n_input)
    commit = np.where(n_input > 0, a + 1, 0)
    want = _sequential(model, tp, caches, inputs, commit, starts, tables)
    got = _np(got)
    for g, w, old in zip(_states(got), _states(want), _states(caches)):
        assert np.array_equal(g, w)
        assert np.array_equal(g[:, 0], old[:, 0])          # the free lane
        assert not np.array_equal(g[:, 2], old[:, 2])
    for b in range(4):
        for g, w in zip(_kv_rows("hybrid", got, tables, b, starts[b] + commit[b]),
                        _kv_rows("hybrid", want, tables, b, starts[b] + commit[b])):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# The draft runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_draft_runner_snapshot_and_resync(family):
    """Three lanes prefilled, a free fourth; three masked draft ticks (lane
    1 drafts once, lanes 0 and 2 three times); resync commits 2, 2 (all
    accepted: its last token was proposed, never consumed) and 4 tokens.
    The draft's caches then equal a runner that consumed only the
    committed tokens: recurrent states bit for bit (the snapshot clones
    them before the ticks move them in place), every K/V row below the
    new positions, and the positions themselves."""
    _, _, model, tp = _pair(family)
    rng = np.random.default_rng(5)
    V = model.cfg.vocab_size
    lens = [7, 12, 5]

    def runner():
        dr = DraftRunner(model, tp, 4, MAX_LEN)
        for slot, n in enumerate(lens):
            chunk = torch.from_numpy(rng_prompts[slot][None])
            dr.prefill_chunk(slot, chunk, n, 0, owner=slot)
        return dr

    rng_prompts = [np.pad(rng.integers(0, V, n).astype(np.int32), (0, 16 - n)) for n in lens]
    dr = runner()
    dr.snapshot()
    assert [s is None for s in dr._snap] == [not is_state_spec(s)
                                             for s in tree_leaves(dr.pool.specs)]
    pending = rng.integers(0, V, 4).astype(np.int32)
    inputs = np.zeros((4, 4), np.int32)
    inputs[:, 0] = pending
    tokens = pending.copy()
    budget = np.array([3, 1, 3, 0])
    for j in range(3):
        mask = budget > j
        proposed = dr.decode_tick(tokens, mask)
        tokens = np.where(mask, proposed, tokens)
        inputs[mask, j + 1] = proposed[mask]
    n_commit = np.array([2, 2, 4, 0], np.int32)
    extra, replayed = dr.resync(inputs, n_commit)
    assert (extra, replayed) == ((1, False) if family == "dense" else (0, True))
    assert list(dr.pool.positions) == [9, 14, 9, 0]

    ref = runner()
    for t in range(4):
        ref.decode_tick(inputs[:, t].copy(), t < n_commit)
    assert list(ref.pool.positions) == list(dr.pool.positions)
    got, want = _np(dr.pool.caches), _np(ref.pool.caches)
    if family == "hybrid":
        for g, w in zip(_states(got), _states(want)):
            assert np.array_equal(g[:, :3], w[:, :3])
    for b in range(3):
        for g, w in zip(_kv_rows(family, got, None, b, dr.pool.positions[b]),
                        _kv_rows(family, want, None, b, dr.pool.positions[b])):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_lane_ending_at_max_len(family, paged):
    """Every request's budget ends exactly at ``max_len`` (48 rows, 6 blocks
    of 8), a poor draft (noise 2e-2) is rejected round after round, and a
    controller that never adapts keeps gamma at 4: late rounds draft less
    than gamma, so the hybrid's verify scan has pad steps past the last
    row while the lane goes on. Their positions clamp onto row 47, which
    no lane reads (unclamped, a paged write would wrap onto a row of the
    lane's own block 5): no row below a lane's committed position ever
    changes, and every stream equals offline decode."""
    _, _, model, tp = _pair(family)
    max_len = 48
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, model.cfg.vocab_size, n).astype(np.int32), max_len - n)
            for n in (41, 44)]
    _, draft = _draft(family, 2e-2)
    eng = ServeEngine(model, tp, n_slots=3, max_len=max_len,
                      block_size=BLOCK if paged else None,
                      scheduler=Scheduler(3, prefill_chunk=16), draft_model=model,
                      draft_params=draft, spec_controller=SpecController(4, alpha=0.0, p0=0.99))
    rids = [eng.submit(p, m) for p, m in reqs]
    committed = {}
    while True:
        kind = eng.step()
        tables = torch.from_numpy(eng.pool.manager.tables) if paged else None
        caches = _np(eng.pool.caches)
        for slot in np.nonzero(eng._decoding)[0]:
            rid = eng.pool.owner[slot]
            rows = _kv_rows(family, caches, tables, slot, int(eng.pool.positions[slot]))
            for g, w in zip(rows, committed.get(rid, [])):
                assert np.array_equal(g[:len(w)], w), f"request {rid}'s committed rows moved"
            committed[rid] = [r.copy() for r in rows]
        if kind == "done":
            break
    assert eng.stats.spec_rounds > 0 and eng.stats.spec_accepted < eng.stats.draft_ticks
    for rid, (p, m) in zip(rids, reqs):
        assert eng.request(rid).tokens == generate_offline(model, tp, p, m, max_len)


def _workload(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 14)), i * 0.004) for i in range(n)]


def _drive(eng, defrag_at):
    """Run to the end, defragging once at the first step (from
    ``defrag_at``) where the active slots have a hole."""
    n, moved = 0, None
    while eng.step() != "done":
        n += 1
        act = eng.pool.active
        if moved is None and n >= defrag_at and act.any() and not act[:act.sum()].all():
            moved = eng.defrag()
    return moved


@pytest.mark.parametrize("noise", [0.0, 3e-4, 2e-2])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_reference_engine_and_offline(family, paged, noise):
    """Drafts of noise 0 (the target itself), 3e-4 (a good draft) and 2e-2
    (a poor one, which drives gamma to 0), 3 slots for 4 staggered
    requests, chunked prefill, a defrag mid-run (paged: 12 blocks of 8,
    fewer than a full pool's 18): the streams, the speculation counters,
    the event log and every request's event-clock times equal the
    reference engine's, and the streams equal the port's offline
    decode."""
    ref, _, model, tp = _pair(family)
    jdraft, tdraft = _draft(family, noise)
    max_len = 48
    kw = dict(block_size=BLOCK, arena_blocks=12) if paged else {}
    reqs = _workload(model.cfg.vocab_size)
    eng = ServeEngine(model, tp, n_slots=3, max_len=max_len,
                      scheduler=Scheduler(3, prefill_chunk=8, decode_per_prefill=2),
                      draft_model=model, draft_params=tdraft, gamma_max=3, **kw)
    ref_eng = RefEngine(ref, _ref_params(family), n_slots=3, max_len=max_len,
                        scheduler=RefScheduler(3, prefill_chunk=8, decode_per_prefill=2),
                        draft_model=ref, draft_params=jdraft, gamma_max=3, **kw)
    assert eng.speculative and eng.spec.draft_fused == (family == "dense")
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    moved = _drive(eng, 6)
    assert moved, "no defrag happened mid-run"
    assert _drive(ref_eng, 6) == moved
    for name in ("spec_rounds", "draft_ticks", "spec_accepted", "decode_ticks",
                 "prefill_calls", "generated_tokens"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.stats.spec_rounds > 0
    if noise == 0.0:
        assert eng.stats.spec_accepted > 0
    if noise == 2e-2:
        assert eng.stats.decode_ticks > 0      # gamma = 0 rounds ran
    assert eng.events == ref_eng.events
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        got, want = eng.request(rid), ref_eng.request(ref_rid)
        assert got.tokens == want.tokens, rid
        assert (got.t_admit, got.t_first_token, got.t_done) == \
            (want.t_admit, want.t_first_token, want.t_done), rid
        assert got.tokens == generate_offline(model, tp, p, m, max_len), rid
    if paged:
        eng.pool.manager.check()
        assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks
    assert not eng.draft.pool.active.any()


def test_engine_refuses_a_draft_without_params_or_vocabulary():
    _, _, model, tp = _pair("dense")
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(model, tp, n_slots=2, max_len=32, draft_model=model)
    other = Model(port_config("smollm-135m").reduced(vocab_size=model.cfg.vocab_size + 8))
    with pytest.raises(ValueError, match="vocabulary"):
        ServeEngine(model, tp, n_slots=2, max_len=32, draft_model=other,
                    draft_params=other.init(0, device="cpu"))


# ---------------------------------------------------------------------------
# K2 at the verify's rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", RMS_VERIFY_SHAPES)
def test_rmsnorm_plan_covers_the_verify_rows(shape):
    """A llama verify norms (4, 1 + gamma, 2048) rows: the launch plan
    finds an instance for each, on the H100's 132 SMs, in f32 and bf16."""
    rows, dim = shape[0] * shape[1], shape[-1]
    for es in (4, 2):
        plan = launch_plan(False, rows, dim, es, True, 132)
        assert plan.tpr * plan.j >= _units(dim, es, True) and plan.blocks >= 1
