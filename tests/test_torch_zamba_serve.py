"""Serving zamba2 (Mamba2 + shared attention) in the port against the
reference, on the CPU: the Mamba2 decode step and its causal convolution
with a carried state, the cache specs, ``decode_step`` and the chunked
``prefill_with_cache`` over both pools, the per-lane select of the decode
tick, and ``ServeEngine`` (both pools, defrag mid-flight) against the
port's ``generate_offline`` and the reference engine.

The reduced zamba2 (4 Mamba2 layers, a shared call after every 2, d_model
128) and a 5-layer variant (a trailing Mamba2 layer after the last
shared call) take the reference's own ``Model.init`` through
``params_from_numpy``, with the LoRA up-projections and the conv and dt
biases (zeros at init) drawn at random so that every call's adapters and
every bias count. Inputs and carried states are seeded numpy handed to
both frameworks. Everything is f32.

Tolerance: 1e-5 relative, against the largest magnitude of the compared
leaf (``close``) — the two frameworks sum the same f32 products in other
orders.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.models import mamba2 as jmamba2
from repro.models.layers import ParamSpec, slot_mask_select
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import mamba2 as tmamba2
from repro_torch.kernels.decode_attention import scale_query
from repro_torch.models.attention import paged_kv_view
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import Scheduler, ServeEngine, generate_offline, run_static

RTOL = 1e-5
MAX_LEN = 32          # cache rows of the model-level tests
BLOCK = 8


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
def _pair(n_layers=4):
    """(reference model, its params, port model, bridged params)."""
    jcfg = get_config("zamba2").reduced(n_layers=n_layers)
    ref = build_model(jcfg)
    jp = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(n_layers)
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
    cfg = port_config("zamba2").reduced(n_layers=n_layers)
    return ref, jax.tree.map(jnp.asarray, jp), Model(cfg), params_from_numpy(cfg, jp,
                                                                            device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_jit(n_layers, name):
    """The reference model's method ``name`` under ``jax.jit``: one compile
    a shape, where eager JAX compiles every primitive on its own."""
    return jax.jit(getattr(_pair(n_layers)[0], name))


def _is_spec(x):
    return isinstance(x, ParamSpec)


def _paired(ref_tree, port_tree, is_leaf=None):
    """[(path, reference leaf, port leaf)] matched by dict keys (jax orders
    dict leaves by sorted key, the port by insertion)."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree, is_leaf=is_leaf):
        node = port_tree
        for key in path:
            node = node[key.key]
        out.append((jax.tree_util.keystr(path), leaf, node))
    return out


def _random_caches(ref, B, seed, paged=False):
    """Seeded random numpy leaves for the reference's cache specs (B
    sequences of MAX_LEN rows; paged: B * MAX_LEN / BLOCK blocks)."""
    rng = np.random.default_rng(seed)
    kw = dict(block_size=BLOCK, num_blocks=B * MAX_LEN // BLOCK) if paged else {}
    specs = ref.cache_specs(B, MAX_LEN, **kw)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), specs,
                        is_leaf=_is_spec)


def _both(tree):
    """(jnp tree, torch tree) of one numpy tree."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _tables(B, seed):
    """(B, MAX_LEN / BLOCK) int32 block tables over a shuffled arena."""
    T = MAX_LEN // BLOCK
    ids = np.random.default_rng(seed).permutation(B * T) + 1
    return ids.reshape(B, T).astype(np.int32)


# ---------------------------------------------------------------------------
# The Mamba2 decode step
# ---------------------------------------------------------------------------

def test_causal_conv_with_state_matches_reference():
    """The decode form over 1 and 5 tokens from a random carried state:
    output and the new last W - 1 inputs; the training form unchanged."""
    rng = np.random.default_rng(0)
    W, D, B = 4, 48, 3
    w = rng.standard_normal((W, D)).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    state = rng.standard_normal((B, W - 1, D)).astype(np.float32)
    for S in (1, 5):
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        jy, js = jmamba2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      state=jnp.asarray(state))
        ty, ts = tmamba2._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                      state=torch.from_numpy(state))
        close(ty, jy, f"y S={S}")
        close(ts, js, f"state S={S}")
        jy0, _ = jmamba2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        close(tmamba2._causal_conv(*map(torch.from_numpy, (x, w, b))), jy0, "training form")


@pytest.mark.parametrize("layer", [0, 3])
def test_mamba2_decode_matches_reference(layer):
    """One token through one Mamba2 block from a random carried conv and
    SSM state: the output and both new states."""
    ref, jp, model, tp = _pair()
    cfg = model.cfg
    rng = np.random.default_rng(1 + layer)
    B = 3
    spec = tmamba2.mamba2_state_spec(cfg, B)
    state = {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in spec.items()}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda t: t[layer], jp["stack"]["mamba"]["mixer"])
    step = jax.jit(lambda p, x, s: jmamba2.mamba2_decode(p, x, ref.cfg, s))
    jout, jstate = step(jparams, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tout, tnew = tmamba2.mamba2_decode(tp["stack"]["mamba"][layer]["mixer"],
                                       torch.from_numpy(x), cfg, tstate)
    assert tnew["conv"] is tstate["conv"] and tnew["ssm"] is tstate["ssm"]   # in place
    close(tout, jout, "out")
    close(tnew["conv"], jstate["conv"], "conv state")
    close(tnew["ssm"], jstate["ssm"], "ssm state")
    assert tnew["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Model-level serving entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [4, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_specs_match_reference(n_layers, paged):
    """Shapes, axes, dtypes and inits, leaf for leaf, in the reference's
    stacked layout (the max_len rounded up as the reference rounds it)."""
    ref, _, model, _ = _pair(n_layers)
    kw = dict(block_size=BLOCK, num_blocks=11) if paged else {}
    want = ref.cache_specs(3, 30, **kw)
    got = model.cache_specs(3, 30, **kw)
    pairs = _paired(want, got, _is_spec)
    assert len(pairs) == len(tree_leaves(got)) == 4
    for path, w, g in pairs:
        assert (g.shape, g.axes, g.dtype, g.init) == (w.shape, w.axes, w.dtype, w.init), path
    blank = model.blank_caches(3, 30, device="cpu", **kw)
    for path, w, g in _paired(want, blank, _is_spec):
        assert tuple(g.shape) == w.shape and g.dtype == getattr(torch, w.dtype), path
        assert bool((g == 0).all()), path


@pytest.mark.parametrize("n_layers", [4, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_matches_reference(n_layers, paged):
    """One token per row at per-row positions, from random caches: logits
    and every cache leaf (states, K/V stripes or arenas) leaf for leaf."""
    ref, jp, model, tp = _pair(n_layers)
    B = 3
    jc, tc = _both(_random_caches(ref, B, 10 + n_layers, paged))
    tok = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([5, 17, 30], np.int32)
    tables = _tables(B, 3) if paged else None
    jl, jnew = _ref_jit(n_layers, "decode_step")(
        jp, jnp.asarray(tok), jc, jnp.asarray(pos),
        block_tables=None if tables is None else jnp.asarray(tables))
    tl, tnew = model.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos),
                                 block_tables=None if tables is None else
                                 torch.from_numpy(tables))
    close(tl, jl, "logits")
    pairs = _paired(jnew, tnew)
    assert len(pairs) == 4
    for path, want, got in pairs:
        close(got, want, path)


def _kv_rows(kv, tables, rows, upto):
    """K or V rows [0, upto[b]) of row b, contiguous or through tables."""
    view = kv if tables is None else paged_kv_view(torch.as_tensor(np.array(kv)),
                                                   torch.as_tensor(tables))
    return [np.asarray(view)[b, :upto[b]] for b in range(rows)]


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_matches_reference(paged):
    """Two chunks into blank caches: a full first chunk of 8 tokens, then a
    right-padded bucket of 8 at start_index 8 with lengths 6, 2 and 4.
    After each: last-valid logits, every recurrent state, and each shared
    call's K/V rows below each row's length."""
    ref, jp, model, tp = _pair(5)
    B, P = 3, 8
    kw = dict(block_size=BLOCK, num_blocks=B * MAX_LEN // BLOCK) if paged else {}
    jc = ref.blank_caches(B, MAX_LEN, **kw)
    tc = model.blank_caches(B, MAX_LEN, device="cpu", **kw)
    tables = _tables(B, 4) if paged else None
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else torch.from_numpy(tables)
    rng = np.random.default_rng(5)
    for start, lens in ((0, [8, 8, 8]), (8, [6, 2, 4])):
        toks = rng.integers(0, model.cfg.vocab_size, (B, P)).astype(np.int32)
        for b, n in enumerate(lens):
            toks[b, n:] = 0                          # the bucket's padding
        length = np.array(lens, np.int32)
        jl, jc = _ref_jit(5, "prefill_with_cache")(
            jp, jnp.asarray(toks), jc, length=jnp.asarray(length), start_index=start,
            block_tables=jt)
        tl, tc = model.prefill_with_cache(tp, torch.from_numpy(toks), tc,
                                          length=torch.from_numpy(length),
                                          start_index=start, block_tables=tt)
        close(tl, jl, f"logits at start {start}")
        for name in ("conv", "ssm"):
            close(tc["mamba"][name], jc["mamba"][name], f"{name} at start {start}")
        upto = [start + n for n in lens]
        for name in ("k", "v"):
            for call in range(tc["attn"][name].shape[0]):
                got = _kv_rows(tc["attn"][name][call], tables, B, upto)
                want = _kv_rows(jc["attn"][name][call], tables, B, upto)
                for b in range(B):
                    close(got[b], want[b], f"{name} call {call} row {b} at start {start}")


def test_masked_lane_keeps_its_recurrent_state():
    """A tick with lane 1 masked off: its conv and SSM states stay bit for
    bit; the other lanes' states are the unmasked step's, and all three
    equal the reference's step followed by its ``slot_mask_select``."""
    ref, jp, model, tp = _pair()
    B = 3
    caches = _random_caches(ref, B, 20)
    tok = np.random.default_rng(6).integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = torch.tensor([3, 9, 14])
    mask = np.array([True, False, True])
    _, tc = _both(caches)
    _, masked = model.decode_step(tp, torch.from_numpy(tok), tc, pos,
                                  mask=torch.from_numpy(mask))
    _, free = model.decode_step(tp, torch.from_numpy(tok), _both(caches)[1], pos)
    for name in ("conv", "ssm"):
        got, old, full = masked["mamba"][name], caches["mamba"][name], free["mamba"][name]
        assert torch.equal(got[:, 1], torch.from_numpy(old[:, 1])), f"{name}: lane 1 moved"
        assert not torch.equal(full[:, 1], torch.from_numpy(old[:, 1]))
        assert torch.equal(got[:, [0, 2]], full[:, [0, 2]])
    jc = jax.tree.map(jnp.asarray, caches)
    _, jnew = _ref_jit(4, "decode_step")(jp, jnp.asarray(tok), jc, jnp.asarray(pos.numpy()))
    specs = ref.cache_specs(B, MAX_LEN)
    jsel = slot_mask_select(jnp.asarray(mask), jnew, jc, specs)
    for name in ("conv", "ssm"):
        close(masked["mamba"][name], jsel["mamba"][name], name)


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

def _workload(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(1, 12)), i * 0.004) for i in range(n)]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_offline_and_reference_engine(paged):
    """Staggered arrivals, chunked prefill (chunk 8, so longer prompts
    continue a prefilled state), 3 slots for 6 requests; paged: block 8
    and 10 blocks, fewer than the 18 a full pool would reserve, so
    admissions queue on block budget. Streams equal the port's offline
    decode and the reference engine's, and so do the event logs."""
    ref, jp, model, tp = _pair()
    max_len = 48
    kw = dict(block_size=8, arena_blocks=10) if paged else {}
    reqs = _workload(model.cfg.vocab_size)
    eng = ServeEngine(model, tp, n_slots=3, max_len=max_len,
                      scheduler=Scheduler(3, prefill_chunk=8, decode_per_prefill=2), **kw)
    ref_eng = RefEngine(ref, jp, n_slots=3, max_len=max_len,
                        scheduler=RefScheduler(3, prefill_chunk=8, decode_per_prefill=2), **kw)
    assert eng.pool.recurrent and eng.pool.state_bytes_per_slot() > 0
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    results, ref_results = eng.run(), ref_eng.run()
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        tokens = results[rid].tokens
        assert len(tokens) == m
        assert tokens == generate_offline(model, tp, p, m, max_len), rid
        assert tokens == ref_results[ref_rid].tokens, f"rid={rid} differs from reference"
    assert eng.events == ref_eng.events
    if paged:
        eng.pool.manager.check()
        assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks


def test_static_baseline_matches_offline():
    _, _, model, tp = _pair()
    reqs = _workload(model.cfg.vocab_size, n=4, seed=3)
    results, stats = run_static(model, tp, reqs, n_slots=2, max_len=MAX_LEN)
    for rid, (p, m, _) in zip(sorted(results), reqs):
        assert results[rid].tokens == generate_offline(model, tp, p, m, MAX_LEN)
    assert stats.generated_tokens == sum(m for _, m, _ in reqs)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_defrag_mid_flight_moves_recurrent_states(paged):
    """Defragging while requests generate moves each live slot's recurrent
    states (and, contiguous, its K/V stripes) with the slot: every stream
    still equals its offline decode."""
    _, _, model, tp = _pair()
    reqs = _workload(model.cfg.vocab_size, n=5, seed=9)
    eng = ServeEngine(model, tp, n_slots=3, max_len=MAX_LEN,
                      block_size=16 if paged else None)
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    defragged = 0
    while eng.step() != "done":
        act = eng.pool.active
        if act.any() and not act[: eng.pool.n_active].all():
            before = eng.pool.caches["mamba"]["ssm"].clone()
            moves = eng.defrag()
            if moves:
                defragged += 1
                for old, new in moves.items():
                    assert torch.equal(eng.pool.caches["mamba"]["ssm"][:, new],
                                       before[:, old])
            if paged:
                eng.pool.manager.check()
    assert defragged > 0, "workload never fragmented the pool; weak test"
    for rid, (p, m, _) in zip(rids, reqs):
        assert eng.request(rid).tokens == generate_offline(model, tp, p, m, MAX_LEN)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_decode_query_scale_rounds_as_the_reference(head_dim):
    """The bf16 query scale of the decode path (``scale_query``, which the
    K3/K4 kernels mirror: scale rounded to bf16, then the product) equals
    the reference's jnp ``q * scale`` bit for bit; at head_dim 128 (the
    shared block's) PyTorch's own ``q * scale`` does not."""
    q = np.random.default_rng(head_dim).standard_normal((64, 4, head_dim)).astype(np.float32)
    scale = 1.0 / math.sqrt(head_dim)     # a Python float, as the reference's
    want = np.asarray((jnp.asarray(q).astype(jnp.bfloat16) * scale).astype(jnp.float32))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    assert np.array_equal(scale_query(tq).float().numpy(), want)
    naive = (tq * scale).float().numpy()
    assert np.array_equal(naive, want) == (head_dim == 64)
