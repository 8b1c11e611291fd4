"""DeepSeek-V3's multi-head latent attention (MLA) and its model in the
port, against the reference on the CPU: the MLA specs and latent cache
specs, ``mla_apply``'s training forward and its two decode paths
(absorbed in latent space, and expanded per head) over contiguous and
paged caches, ``mla_prefill`` (a chunk, and a verify's per-row starts),
the whole model's logits (training forward, cache-writing prefill and
decode; the 3-dense + 58-MoE plan with a shared expert), the parameter
tree with its MTP head, and ``ServeEngine`` twins of the reference's
serving tests: paged under arena pressure (``tests/test_serve.py``), a
shared prefix, preemption and the full-match re-feed with prefix
sharing, and the refusal of a capacity-dropped MoE
(``tests/test_prefix.py``).

Model: deepseek-v3 reduced (2 layers: one ``mla_dense``, one
``mla_moe``; d 128, 4 heads, q_lora 64, kv_lora 32, nope 32 + rope 16,
v 32; 8 experts top 2 plus one shared expert), f32, from the reference's
``Model.init`` with its norm scales made noisy (``tests/_families.py``).

Tolerance: 5e-6 relative to the compared leaf's largest magnitude
(``close``): the frameworks sum the same f32 products in other orders;
every comparison here held at 1e-6 on the CPU. Streams: token for token.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (close, engines, family_pair, jitted_model, port_spec_items, ref_spec_items,
                       run_twins, workload)
from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import ServeEngine

RTOL = 5e-6
ARCH = "deepseek-v3"
B, ROWS, BLOCK = 3, 32, 8


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
    return family_pair(ARCH)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_specs_match_reference(reduced):
    """The parameter tree, the MTP head included, has the reference's keys,
    shapes, dtypes and inits, layer by layer (full width: 61 layers, spec
    counting only)."""
    port, ref = port_config(ARCH), get_config(ARCH)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    model, jmodel = Model(port), build_model(ref)
    assert [(s.kind, s.count) for s in model.segments] == \
        [(s.kind, s.count) for s in jmodel.segments]
    got, want = port_spec_items(model), ref_spec_items(jmodel)
    assert got == want
    assert any(k[0] == "mtp" for k in got) and port.mtp
    assert any("shared" in k for k in got)


def test_bridge_crosses_the_reference_init(pair):
    """``params_from_numpy`` carries every leaf of the reference's
    ``Model.init`` (MTP head included) bit for bit."""
    ref, _, model, tp, tree = pair
    flat = {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert len(tree_leaves(tp, is_leaf=torch.is_tensor)) == len(flat)
    assert torch.equal(tp["mtp"]["proj"], torch.tensor(tree["mtp"]["proj"]))
    w = tp["stack"][1][0]["ffn"]["w_in"]
    assert torch.equal(w, torch.tensor(tree["stack"][1]["ffn"]["w_in"]))


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_cache_spec_matches_reference(paged):
    cfg, jcfg = port_config(ARCH).reduced(), get_config(ARCH).reduced()
    page = (12, BLOCK) if paged else None
    got = tattn.mla_cache_spec(cfg, B, ROWS, page)
    want = jattn.mla_cache_spec(jcfg, B, ROWS, page)
    assert {k: (s.shape, s.axes, s.init, s.dtype) for k, s in got.items()} == \
        {k: (s.shape, s.axes, s.init, s.dtype) for k, s in want.items()}


# ---------------------------------------------------------------------------
# mla_apply and mla_prefill
# ---------------------------------------------------------------------------

#: The reference's attention functions, compiled once (as ``jitted_model``).
_j_apply = jax.jit(jattn.mla_apply, static_argnums=2, static_argnames=("absorb",))
_j_prefill = jax.jit(jattn.mla_prefill, static_argnums=2)


def _attn(pair, layer=0):
    ref, jp, model, tp, _ = pair
    return ref.cfg, jp["stack"][layer]["attn"], model.cfg, tp["stack"][layer][0]["attn"]


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _caches(cfg, paged, seed):
    """Random latent caches (numpy) and block tables (None: contiguous)."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    if paged:
        T = ROWS // BLOCK
        tables = (rng.permutation(B * T) + 1).reshape(B, T).astype(np.int32)
        front = (B * T + 1, BLOCK)
    else:
        tables, front = None, (B, ROWS)
    return ({"ckv": rng.standard_normal((*front, m.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((*front, m.qk_rope_head_dim)).astype(np.float32)},
            tables)


def _both(cache, tables):
    j = {k: jnp.asarray(v) for k, v in cache.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    return j, t, (None if tables is None else jnp.asarray(tables)), (
        None if tables is None else torch.from_numpy(tables))


def test_mla_forward_matches_reference(pair):
    """No cache: the training forward (per-head expansion, causal
    ``mea_attention``) over 11 positions."""
    jcfg, jw, cfg, tw = _attn(pair)
    x = _x(cfg, 11, 0)
    pos = np.arange(11)
    want, _ = _j_apply(jw, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    got, none = tattn.mla_apply(tw, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    assert none is None
    close(got, want, RTOL)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "expanded"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_mla_decode_matches_reference(pair, absorb, paged):
    """One token a row at per-row positions (3, 17, 31: the last row)
    against random latent caches: the output and every cache row (the new
    one written, the others kept)."""
    jcfg, jw, cfg, tw = _attn(pair, layer=1)
    cache, tables = _caches(cfg, paged, 1)
    jc, tc, jt, tt = _both(cache, tables)
    idx = np.array([3, 17, 31], np.int32)
    x = _x(cfg, 1, 2)
    want, wc = _j_apply(jw, jnp.asarray(x), jcfg, positions=jnp.asarray(idx[:, None]),
                        cache=jc, cache_index=jnp.asarray(idx), absorb=absorb, block_table=jt)
    got, gc = tattn.mla_apply(tw, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(idx[:, None]).long(), cache=tc,
                              cache_index=torch.from_numpy(idx).long(), absorb=absorb,
                              block_table=tt)
    close(got, want, RTOL, "out")
    for k in ("ckv", "k_rope"):
        close(gc[k], wc[k], RTOL, k)


def test_absorbed_decode_equals_expanded(pair):
    """The two decode paths compute one function (W_UK and W_UV moved
    across the products): the port's agree within the tolerance."""
    _, _, cfg, tw = _attn(pair, layer=1)
    cache, _ = _caches(cfg, False, 3)
    idx = torch.tensor([0, 9, 30])
    x = torch.from_numpy(_x(cfg, 1, 4))
    outs = [tattn.mla_apply(tw, x, cfg, positions=idx[:, None], cache={
        k: torch.from_numpy(v.copy()) for k, v in cache.items()}, cache_index=idx,
        absorb=absorb)[0] for absorb in (True, False)]
    close(outs[0], outs[1].detach().numpy(), RTOL)


@pytest.mark.parametrize("verify", [False, True], ids=["chunk", "verify"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_mla_prefill_matches_reference(pair, paged, verify):
    """A 6-token chunk at start 8 after an earlier chunk's rows (random),
    or a verify: per-row starts (2, 14, 25) with 6, 3 and 1 valid inputs
    (rows past them dropped, or sunk into the NULL block)."""
    jcfg, jw, cfg, tw = _attn(pair)
    cache, tables = _caches(cfg, paged, 5)
    jc, tc, jt, tt = _both(cache, tables)
    x = _x(cfg, 6, 6)
    if verify:
        start = np.array([2, 14, 25], np.int32)
        n_valid = np.array([6, 3, 1], np.int32)
        pos = start[:, None] + np.arange(6)
        jkw = dict(start_index=jnp.asarray(start), n_valid=jnp.asarray(n_valid))
        tkw = dict(start_index=torch.from_numpy(start).long(),
                   n_valid=torch.from_numpy(n_valid).long())
    else:
        pos = 8 + np.arange(6)
        jkw, tkw = dict(start_index=jnp.int32(8)), dict(start_index=8)
    want, wc = _j_prefill(jw, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                          cache=jc, block_table=jt, **jkw)
    got, gc = tattn.mla_prefill(tw, torch.from_numpy(x), cfg,
                                positions=torch.from_numpy(pos).long(), cache=tc,
                                block_table=tt, **tkw)
    if verify:
        # Rows past a row's valid inputs are pad: their outputs are garbage.
        for b, n in enumerate(n_valid):
            close(got[b, :n], np.asarray(want)[b, :n], RTOL, f"row {b}")
    else:
        close(got, want, RTOL, "out")
    for k in ("ckv", "k_rope"):
        w = np.asarray(wc[k])
        g = gc[k].numpy()
        if paged:
            w, g = w[1:], g[1:]     # the NULL block's contents are garbage
        close(g, w, RTOL, k)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "expanded"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_model_logits_match_reference(pair, absorb, paged):
    """The training forward's logits over 12 positions; then a right-padded
    prefill chunk (rows of 12, 7 and 9 tokens) and 3 decode steps at
    per-row positions, through both pools: every call's logits."""
    ref, jp, model, tp, _ = pair
    assert ref.cfg.mla_absorb and model.cfg.mla_absorb     # the registry's choice
    if not absorb:
        ref = build_model(dataclasses.replace(ref.cfg, mla_absorb=False))
        model = Model(dataclasses.replace(model.cfg, mla_absorb=False))
    cfg = model.cfg
    j_forward, j_prefill, j_decode = jitted_model(ref)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab_size, size=(B, 12)).astype(np.int32)
    if not paged:
        ht, _ = model.hidden(tp, torch.from_numpy(ids), torch.arange(12))
        close(model.logits(tp, ht), j_forward(jp, jnp.asarray(ids)), RTOL, "forward")
    kw = dict(block_size=BLOCK, num_blocks=B * ROWS // BLOCK) if paged else {}
    jc = ref.blank_caches(B, ROWS, **kw)
    tc = model.blank_caches(B, ROWS, device="cpu", **kw)
    tables = (np.random.default_rng(8).permutation(B * ROWS // BLOCK) + 1).reshape(
        B, -1).astype(np.int32) if paged else None
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else torch.from_numpy(tables)
    lens = np.array([12, 7, 9], np.int32)
    want, jc = j_prefill(jp, jnp.asarray(ids), jc, jnp.asarray(lens), jt)
    got, tc = model.prefill_with_cache(tp, torch.from_numpy(ids), tc,
                                       length=torch.from_numpy(lens).long(), start_index=0,
                                       block_tables=tt)
    close(got, want, RTOL, "prefill")
    pos = lens.copy()
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        want, jc = j_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jt)
        got, tc = model.decode_step(tp, torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos).long(), block_tables=tt)
        close(got, want, RTOL, f"decode {t}")
        pos = pos + 1


# ---------------------------------------------------------------------------
# ServeEngine twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_engine_matches_reference_engine(pair, paged):
    """``tests/test_serve.py``'s paged engine under arena pressure (3 slots,
    48 rows, block 8 on 10 blocks, so admissions queue) and the same over
    the contiguous pool: 5 staggered requests, chunks of 8, the registry's
    capacity-dropped routing, every stream equal to the reference
    engine's and to offline decode."""
    kw = dict(block_size=BLOCK, arena_blocks=10) if paged else {}
    eng, ref_eng = engines(pair, 3, 48, **kw)
    reqs = [(p, min(m, 24), a) for p, m, a in workload(eng.model.cfg.vocab_size, n=5)]
    run_twins(eng, ref_eng, reqs, 48)
    if paged:
        eng.pool.manager.check()
        assert eng.pool.manager.n_free_blocks == eng.pool.manager.num_blocks


@pytest.fixture(scope="module")
def dropless():
    return family_pair(ARCH, dropless=True)


def _sharing_checks(eng, ref_eng):
    for name in ("prefix_hits", "prefix_rows_shared", "preempted_requests",
                 "prefill_tokens", "decode_ticks"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    eng.pool.manager.check()
    assert eng.pool.manager.n_used_blocks == 0


def test_shared_prefix_matches_reference(dropless):
    """Six prompts sharing 24 of 26-29 tokens, 3 slots, block 8, sharing
    on: the latent arena's blocks are adopted (rows shared > 0), and the
    streams, events and sharing counters equal the reference engine's."""
    eng, ref_eng = engines(dropless, 3, 64, block_size=BLOCK, prefix_sharing=True)
    rng = np.random.default_rng(11)
    V = eng.model.cfg.vocab_size
    shared = rng.integers(0, V, size=24).astype(np.int32)
    reqs = [(np.concatenate([shared, rng.integers(0, V, size=int(rng.integers(2, 6)))
                             .astype(np.int32)]), 8, i * 0.002) for i in range(6)]
    run_twins(eng, ref_eng, reqs, 64)
    _sharing_checks(eng, ref_eng)
    assert not eng.pool._any_contiguous
    assert eng.stats.prefix_hits > 0 and eng.stats.prefix_rows_shared >= 16


def test_preempted_requeued_matches_reference(dropless):
    """2 slots over a 7-block sharing arena while each request wants ~5:
    requests are preempted and replayed, and every stream equals the
    reference's and the uninterrupted offline decode."""
    eng, ref_eng = engines(dropless, 2, 64, block_size=BLOCK, arena_blocks=7,
                           prefix_sharing=True)
    rng = np.random.default_rng(5)
    V = eng.model.cfg.vocab_size
    reqs = [(rng.integers(0, V, size=int(rng.integers(18, 30))).astype(np.int32), 10, i * 0.001)
            for i in range(4)]
    run_twins(eng, ref_eng, reqs, 64)
    _sharing_checks(eng, ref_eng)
    assert eng.stats.preempted_requests > 0, "workload failed to preempt"


def test_identical_prompts_full_match_refeed(dropless):
    """``tests/test_prefix.py``'s full-match re-feed over the latent arena:
    three identical block-aligned prompts; the adopters match the whole
    prompt and re-feed its last token through a forked tail block."""
    eng, ref_eng = engines(dropless, 3, 64, block_size=BLOCK, prefix_sharing=True)
    p0 = np.random.default_rng(9).integers(0, eng.model.cfg.vocab_size, size=16).astype(np.int32)
    forks = []
    fork = eng.pool.manager.fork
    eng.pool.manager.fork = lambda *a: forks.append(fork(*a)) or forks[-1]
    run_twins(eng, ref_eng, [(p0, 6, 0.0), (p0, 6, 0.001), (p0, 6, 0.002)], 64)
    _sharing_checks(eng, ref_eng)
    assert eng.stats.prefix_hits >= 2 and forks, "no full match forked its tail block"


def test_prefix_sharing_refuses_capacity_dropped_moe(pair, dropless):
    """The registry's capacity-dropped routing makes logits depend on how
    many tokens share a call, so sharing refuses it, as the reference
    does; the same config routed dropless is accepted."""
    _, _, model, tp, _ = pair
    assert model.cfg.moe is not None and not model.cfg.moe.dropless
    with pytest.raises(ValueError, match="dropless"):
        ServeEngine(model, tp, n_slots=2, max_len=64, block_size=BLOCK, prefix_sharing=True)
    ref, jp = pair[:2]
    from repro.serve import ServeEngine as RefEngine
    with pytest.raises(ValueError, match="dropless"):
        RefEngine(ref, jp, n_slots=2, max_len=64, block_size=BLOCK, prefix_sharing=True)
    eng = ServeEngine(dropless[2], dropless[3], n_slots=2, max_len=64, block_size=BLOCK,
                      prefix_sharing=True)
    assert eng.prefix_sharing
