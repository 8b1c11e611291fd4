"""xLSTM (mLSTM and sLSTM blocks) and its model in the port, against the
reference on the CPU: ``mlstm_parallel`` and ``mlstm_recurrent`` (each
against the reference's, and against each other), ``mlstm_decode`` and
``slstm_apply`` from carried states with a lane mask, the state specs
and the sLSTM normaliser's ones init (which the slot pool's reset must
restore), the parameter tree, the whole model's logits (training
forward, scanned prefill, decode) over both pools, and ``ServeEngine``
twins of the reference's serving tests: continuous batching and the paged
pool under arena pressure (``tests/test_serve.py``), preemption
(``tests/test_prefix.py``; recurrent states share nothing) and
speculation with an xLSTM target over both pools
(``tests/test_speculative.py``, noise 3e-4).

Model: xlstm-125m reduced to 3 layers with an sLSTM block every 2 (so the
stack is mLSTM, sLSTM, mLSTM; the registry's ``slstm_every`` 6 would
leave a reduced stack without one), d 128, 4 heads (mLSTM inner width
256, heads of 64), f32, from the reference's ``Model.init`` with its
norm scales, gate biases and conv biases made noisy
(``tests/_families.py``).

Tolerance: 2e-5 relative to the compared leaf's largest magnitude
(``close``). The exponential gates are stabilised by a running max in
both packages, so the f32 summation-order differences stay small: the
blocks held at 2e-6 on the CPU, the 3-layer model's logits at 5e-6 but
not at 2e-6. The parallel and the recurrent form differ by more: they
stabilise from different starts (``test_mlstm_parallel_and_recurrent_agree``,
1e-4). Streams: token for token.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (close, engines, family_pair, jitted_model, port_spec_items, ref_spec_items,
                       run_twins, workload)
from repro.configs import get_config
from repro.models import build_model
from repro.models import xlstm as jx
from repro.serve import SlotPool as RefSlotPool
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import xlstm as tx
from repro_torch.serve import SlotPool

RTOL = 2e-5
ARCH = "xlstm-125m"
CUT = dict(n_layers=3, slstm_every=2)
B, BLOCK = 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A decode step is hundreds of tiny ops: intra-op threads only wait
    on each other, and beside other busy processes they stall."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return family_pair(ARCH, **CUT)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_specs_match_reference(reduced):
    """Segments (full width: 5 mLSTM, sLSTM, 5 mLSTM, sLSTM), keys,
    shapes, dtypes and inits equal the reference's, layer by layer."""
    port, ref = port_config(ARCH), get_config(ARCH)
    if reduced:
        port = dataclasses.replace(port.reduced(n_layers=3), xlstm=dataclasses.replace(
            port.xlstm, slstm_every=2))
        ref = dataclasses.replace(ref.reduced(n_layers=3), xlstm=dataclasses.replace(
            ref.xlstm, slstm_every=2))
    model, jmodel = Model(port), build_model(ref)
    assert [(s.kind, s.count) for s in model.segments] == \
        [(s.kind, s.count) for s in jmodel.segments]
    assert {s.kind for s in model.segments} == {"mlstm", "slstm"}
    assert port_spec_items(model) == ref_spec_items(jmodel)
    assert model.recurrent and not model.fused_prefill and not model.is_hybrid


# ---------------------------------------------------------------------------
# mLSTM core and blocks
# ---------------------------------------------------------------------------

def _qkvif(seed, S=9, H=4, D=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    i_pre = rng.standard_normal((B, S, H)).astype(np.float32)
    f_pre = (2.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _mlstm_state(seed, H=4, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D, D)).astype(np.float32),
            rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def test_mlstm_parallel_matches_reference():
    ins = _qkvif(0)
    close(tx.mlstm_parallel(*map(_t, ins)), jx.mlstm_parallel(*map(jnp.asarray, ins)), RTOL)


def test_mlstm_recurrent_matches_reference():
    """9 steps from a random carried (C, n, m): the outputs and the final
    state."""
    ins, state = _qkvif(1), _mlstm_state(2)
    got, (C, n, m) = tx.mlstm_recurrent(*map(_t, ins), tuple(map(_t, state)))
    want, wstate = jx.mlstm_recurrent(*map(jnp.asarray, ins), tuple(map(jnp.asarray, state)))
    close(got, want, RTOL, "h")
    for name, a, b in zip("Cnm", (C, n, m), wstate):
        close(a, b, RTOL, name)


def test_mlstm_parallel_and_recurrent_agree():
    """The two forms compute one recurrence, stabilised from different
    starts: the parallel form's max runs over the sequence seen, the
    recurrent one's from the zero state, which enters the normaliser's
    floor exp(-m). Where |q n| sits far above that floor both give the
    same h; here (forget preactivations ~2) the port's two forms agree
    within 1e-4 of the largest value, as the reference's do."""
    ins = _qkvif(3)
    S, H, D = ins[0].shape[1:]
    zero = (torch.zeros(B, H, D, D), torch.zeros(B, H, D), torch.zeros(B, H))
    par = tx.mlstm_parallel(*map(_t, ins))
    rec, _ = tx.mlstm_recurrent(*map(_t, ins), zero)
    close(par, rec.numpy(), 1e-4)
    jpar = jx.mlstm_parallel(*map(jnp.asarray, ins))
    jrec, _ = jx.mlstm_recurrent(*map(jnp.asarray, ins), tuple(map(jnp.asarray, zero)))
    close(np.asarray(jpar), jrec, 1e-4)


def _block(pair, layer):
    ref, jp, model, tp, _ = pair
    return ref.cfg, jp["stack"][layer]["mixer"], model.cfg, tp["stack"][layer][0]["mixer"]


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _random_state(specs, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in specs.items()}


MASK = np.array([True, False, True])


def _masked(new, old):
    """The reference's new state where MASK, else the old (its engine's
    ``slot_mask_select``)."""
    keep = MASK.reshape(-1, *([1] * (np.ndim(new) - 1)))
    return np.where(keep, np.asarray(new), old)


def test_mlstm_block_forward_matches_reference(pair):
    jcfg, jw, cfg, tw = _block(pair, 0)
    x = _x(cfg, 7, 4)
    close(tx.mlstm_apply(tw, _t(x), cfg), jx.mlstm_apply(jw, jnp.asarray(x), jcfg), RTOL)


@pytest.mark.parametrize("mask", [False, True], ids=["all", "masked"])
def test_mlstm_decode_matches_reference(pair, mask):
    """One token against a random carried state: the output, and every
    state leaf updated in place (``mask``: lane 1 keeps its state)."""
    jcfg, jw, cfg, tw = _block(pair, 2)
    state = _random_state(tx.mlstm_state_spec(cfg, B), 5)
    x = _x(cfg, 1, 6)
    want, wstate = jx.mlstm_decode(jw, jnp.asarray(x), jcfg, {k: jnp.asarray(v)
                                                              for k, v in state.items()})
    tstate = {k: _t(v) for k, v in state.items()}
    got, gstate = tx.mlstm_decode(tw, _t(x), cfg, tstate,
                                  torch.from_numpy(MASK) if mask else None)
    assert gstate is tstate
    close(got, want, RTOL, "out")
    for k in state:
        close(gstate[k], _masked(wstate[k], state[k]) if mask else wstate[k], RTOL, k)


@pytest.mark.parametrize("carried", [None, 1, 5], ids=["fresh", "decode", "carried-5"])
def test_slstm_apply_matches_reference(pair, carried):
    """The sLSTM scan: the training form from a fresh state over 7 steps,
    one decode step from a random carried state with lane 1 masked, and
    5 steps from a carried state; the output and the final state."""
    jcfg, jw, cfg, tw = _block(pair, 1)
    x = _x(cfg, carried or 7, 7)
    if carried is None:
        want, wstate = jx.slstm_apply(jw, jnp.asarray(x), jcfg)
        got, gstate = tx.slstm_apply(tw, _t(x), cfg)
        expect = {k: np.asarray(v) for k, v in wstate.items()}
    else:
        state = _random_state(tx.slstm_state_spec(cfg, B), 8)
        state["n"] = np.abs(state["n"]) + 0.5          # a normaliser is positive
        want, wstate = jx.slstm_apply(jw, jnp.asarray(x), jcfg,
                                      state={k: jnp.asarray(v) for k, v in state.items()})
        mask = carried == 1
        tstate = {k: _t(v) for k, v in state.items()}
        got, gstate = tx.slstm_apply(tw, _t(x), cfg, state=tstate,
                                     mask=torch.from_numpy(MASK) if mask else None)
        assert gstate is tstate
        expect = {k: _masked(v, state[k]) if mask else np.asarray(v) for k, v in wstate.items()}
    close(got, want, RTOL, "out")
    for k, v in expect.items():
        close(gstate[k], v, RTOL, k)


# ---------------------------------------------------------------------------
# States, specs and the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_cache_specs_match_reference(pair, paged):
    """Every layer's state spec equals the reference's (no sequence axis:
    the paged pool keeps them contiguous per slot); blank caches hold the
    sLSTM normaliser at ones."""
    ref, _, model, _, _ = pair
    kw = dict(block_size=BLOCK, num_blocks=12) if paged else {}
    got, want = model.cache_specs(B, 32, **kw), ref.cache_specs(B, 32, **kw)
    assert len(got) == len(want)
    for g_seg, w_seg in zip(got, want):
        assert len(g_seg) == 1
        assert {k: (s.shape, s.axes, s.init, s.dtype) for k, s in g_seg[0].items()} == \
            {k: (s.shape, s.axes, s.init, s.dtype) for k, s in w_seg.items()}
    caches = model.blank_caches(B, 32, device="cpu", **kw)
    assert torch.equal(caches[1][0]["n"], torch.ones(B, 4, 32))
    assert not caches[1][0]["c"].any() and not caches[0][0]["C"].any()


def test_slot_pool_reset_restores_spec_init(pair):
    """``tests/test_serve.py``'s reset check: scribble 7 over both slots,
    reset slot 0: each leaf's slot 0 is back at its spec's fill (ones for
    the sLSTM normaliser), slot 1 untouched; the reference pool alike."""
    ref, _, model, _, _ = pair
    pool, ref_pool = SlotPool(model, n_slots=2, max_len=8, device="cpu"), \
        RefSlotPool(ref, n_slots=2, max_len=8)
    leaves = [(c, s) for seg_c, seg_s in zip(pool.caches, pool.specs)
              for c_layer, s_layer in zip(seg_c, seg_s) for k in c_layer
              for c, s in [(c_layer[k], s_layer[k])]]
    assert any(s.init == "ones" for _, s in leaves)
    for c, _ in leaves:
        c.fill_(7.0)
    pool.reset_slot(0)
    for c, s in leaves:
        assert (c[0] == (1.0 if s.init == "ones" else 0.0)).all(), s
        assert (c[1] == 7.0).all()
    ref_pool.caches = jax.tree.map(lambda a: jnp.full_like(a, 7.0), ref_pool.caches)
    ref_pool.reset_slot(0)
    want = [np.asarray(a) for a in jax.tree.leaves(ref_pool.caches)]
    got = [np.asarray(c) for seg in pool.caches for layer in seg
           for c in jax.tree.leaves({k: v.numpy() for k, v in layer.items()})]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def _port_caches(ref_caches):
    return [[{k: _t(v) for k, v in seg.items()}] for seg in ref_caches]


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_model_logits_match_reference(pair, paged):
    """The training forward's logits (parallel mLSTM) over 12 positions;
    then a scanned prefill of right-padded rows (12, 7 and 9 tokens) and 3
    decode steps: every call's logits and, after them, every state leaf."""
    ref, jp, model, tp, _ = pair
    cfg = model.cfg
    j_forward, j_prefill, j_decode = jitted_model(ref)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, size=(B, 12)).astype(np.int32)
    if not paged:
        ht, _ = model.hidden(tp, _t(ids), torch.arange(12))
        close(model.logits(tp, ht), j_forward(jp, jnp.asarray(ids)), RTOL, "forward")
    kw = dict(block_size=BLOCK, num_blocks=12) if paged else {}
    tables = np.arange(1, 13).reshape(B, 4).astype(np.int32) if paged else None
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else _t(tables)
    jc = ref.blank_caches(B, 32, **kw)
    tc = model.blank_caches(B, 32, device="cpu", **kw)
    lens = np.array([12, 7, 9], np.int32)
    want, jc = j_prefill(jp, jnp.asarray(ids), jc, jnp.asarray(lens), jt)
    got, tc = model.prefill_with_cache(tp, _t(ids), tc, length=_t(lens).long(), start_index=0,
                                       block_tables=tt)
    close(got, want, RTOL, "prefill")
    pos = lens.copy()
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        want, jc = j_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jt)
        got, tc = model.decode_step(tp, _t(tok), tc, _t(pos).long(), block_tables=tt)
        close(got, want, RTOL, f"decode {t}")
        pos = pos + 1
    for g_seg, w_seg in zip(tc, jc):
        for k, w in w_seg.items():
            close(g_seg[0][k], w, RTOL, k)


# ---------------------------------------------------------------------------
# ServeEngine twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_engine_matches_reference_engine(pair, paged):
    """Contiguous: ``tests/test_serve.py``'s continuous batching (3 slots,
    6 staggered requests, 64 rows, chunks of 8). Paged: its arena-pressure
    run (48 rows, block 8 on 10 blocks, so admissions queue, 5 requests).
    Every stream equals the reference engine's and offline decode, and
    the events are equal."""
    if paged:
        eng, ref_eng = engines(pair, 3, 48, block_size=BLOCK, arena_blocks=10)
        reqs = [(p, min(m, 24), a) for p, m, a in workload(eng.model.cfg.vocab_size, n=5)]
    else:
        eng, ref_eng = engines(pair, 3, 64)
        reqs = workload(eng.model.cfg.vocab_size)
    run_twins(eng, ref_eng, reqs, 48 if paged else 64)
    assert eng.pool.recurrent
    if paged:
        eng.pool.manager.check()
        assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks


def test_preempted_requeued_matches_reference(pair):
    """``tests/test_prefix.py``'s preemption run: 2 slots over a 7-block
    sharing arena while each request wants ~5 blocks. Recurrent states
    cannot be adopted, so nothing is shared; requests are preempted and
    replayed, and every stream equals the reference's and offline
    decode."""
    eng, ref_eng = engines(pair, 2, 64, block_size=BLOCK, arena_blocks=7, prefix_sharing=True)
    rng = np.random.default_rng(5)
    V = eng.model.cfg.vocab_size
    reqs = [(rng.integers(0, V, size=int(rng.integers(18, 30))).astype(np.int32), 10, i * 0.001)
            for i in range(4)]
    run_twins(eng, ref_eng, reqs, 64)
    for name in ("prefix_hits", "preempted_requests", "prefill_tokens", "decode_ticks"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.stats.preempted_requests > 0 and eng.stats.prefix_hits == 0
    eng.pool.manager.check()
    assert eng.pool.manager.n_used_blocks == 0


@functools.lru_cache(maxsize=None)
def _draft(noise):
    """(reference draft params, port draft params): the target's plus
    ``noise`` times seeded standard normals, leaf by leaf."""
    _, _, model, _, tree = family_pair(ARCH, **CUT)
    rng = np.random.default_rng(17)
    noisy = jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                         tree)
    return jax.tree.map(jnp.asarray, noisy), params_from_numpy(model.cfg, noisy, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_speculative_matches_reference_engine(pair, paged):
    """``tests/test_speculative.py``'s xLSTM target with a draft of noise
    3e-4, gamma <= 4, 4 staggered requests (paged: 48 rows on 10 blocks of
    8): the streams, the
    speculation counters and the events equal the reference engine's, and
    the streams equal offline decode."""
    kw = dict(block_size=BLOCK, arena_blocks=10) if paged else {}
    max_len = 48 if paged else 64
    eng, ref_eng = engines(pair, 3, max_len, draft=_draft(3e-4), **kw)
    assert eng.speculative and not eng.spec.draft_fused
    reqs = workload(eng.model.cfg.vocab_size, n=4)
    run_twins(eng, ref_eng, reqs, max_len)
    for name in ("spec_rounds", "draft_ticks", "spec_accepted", "decode_ticks",
                 "prefill_calls", "generated_tokens"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.stats.spec_rounds > 0 and eng.stats.spec_accepted > 0
    assert not eng.draft.pool.active.any()
