"""The port's dense GQA model against the reference model, on the CPU.

Parameters come from the reference's own ``Model.init`` and cross
through ``repro_torch.models.params_from_numpy`` (for qwen2.5-3b,
command-r-35b, chameleon-34b and qwen3-moe-30b-a3b with seeded noise on
the bias and norm leaves, ``tests/_noisy.py``); prompts, positions and
block tables come from seeded numpy and go to both frameworks. Logits
agree at atol 1e-4 in f32 (different summation orders, 2 layers).
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.models import attention as jattn
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, count_params_analytic, params_from_numpy
from repro_torch.models import attention as tattn
from _noisy import NOISY_ARCHS, noisy_pair

MAX_LEN = 64
CONFIGS = {
    "llama3.2-1b": {},                            # G = 2 once reduced
    "smollm-135m": {},
    "llama3.2-1b-g3": {"n_heads": 6, "n_kv_heads": 2},
    "qwen2.5-3b": {},                             # qkv bias
    "command-r-35b": {},                          # LayerNorm, parallel block, logit scale
    "chameleon-34b": {},                          # qk-norm, untied head
    "qwen3-moe-30b-a3b": {},                      # top-2 of 8 experts, capacity-dropped
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference model, its params, port model, bridged params, jitted
    reference prefill, jitted reference decode) — built once per config."""
    arch = name.removesuffix("-g3")
    over = CONFIGS[name]
    if arch in NOISY_ARCHS:
        ref, jp, cfg, tp = noisy_pair(arch)
    else:
        ref = build_model(get_config(arch).reduced(**over))
        jp = ref.init(jax.random.PRNGKey(0))
        cfg = port_config(arch).reduced(**over)
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    port = Model(cfg)
    return ref, jp, port, tp, jax.jit(ref.prefill_with_cache), jax.jit(ref.decode_step)


def _close(a, b, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), atol=atol)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_then_decode_matches_reference(name, paged):
    """Ragged right-padded prefill, then 8 decode steps with per-row
    positions, on a contiguous or a paged cache (the same shuffled block
    tables on both sides): logits agree at every step."""
    ref, jp, port, tp, prefill, decode = _pair(name)
    rng = np.random.default_rng(1)
    B, P, bs = 3, 16, 8
    lengths = np.array([16, 9, 3], np.int32)
    prompt = rng.integers(0, ref.cfg.vocab_size, size=(B, P)).astype(np.int32)
    if paged:
        T = MAX_LEN // bs
        tables = (rng.permutation(B * T) + 1).astype(np.int32).reshape(B, T)
        kw_j = dict(block_size=bs, num_blocks=B * T)
        jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    else:
        kw_j, jt, tt = {}, None, None
    jc = ref.blank_caches(B, MAX_LEN, **kw_j)
    tc = port.blank_caches(B, MAX_LEN, device="cpu", **kw_j)
    jl, jc = prefill(
        jp, jnp.asarray(prompt), jc, length=jnp.asarray(lengths),
        start_index=jnp.int32(0), block_tables=jt)
    with torch.no_grad():
        tl, tc = port.prefill_with_cache(tp, torch.from_numpy(prompt), tc,
                                         length=torch.from_numpy(lengths),
                                         start_index=0, block_tables=tt)
    _close(jl, tl)
    pos = lengths.copy()
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for _ in range(8):
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), block_tables=jt)
        with torch.no_grad():
            tl, tc = port.decode_step(tp, torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos), block_tables=tt)
        _close(jl, tl)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
        pos += 1
    # The caches the two sides wrote agree too (the reference stacks layers).
    for layer in range(ref.cfg.n_layers):
        for leaf in ("k", "v"):
            got = tc[0][layer][leaf]
            want = np.asarray(jc[0][leaf])[layer]
            if paged:   # the NULL sink row is garbage by contract
                got, want = got[1:], want[1:]
            _close(want, got, atol=1e-5)


def test_param_tree_and_count_match_reference():
    ref, jp, port, tp = _pair("llama3.2-1b")[:4]
    assert count_params_analytic(port.cfg) == ref.cfg.param_count()
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(t.numel() for t in _leaves(tp)) == n
    specs = port.param_specs()
    assert len(tp["stack"][0]) == ref.cfg.n_layers == len(specs["stack"][0])
    assert tuple(tp["stack"][0][1]["attn"]["wq"].shape) == \
        specs["stack"][0][1]["attn"]["wq"].shape


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_seeded_init_is_deterministic_and_spec_shaped():
    port = Model(port_config("smollm-135m").reduced())
    a, b = port.init(3, device="cpu"), port.init(3, device="cpu")
    c = port.init(4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm"]["scale"], torch.ones(port.cfg.d_model))
    assert abs(a["embed"].std().item() - 0.02) < 2e-3


def test_mea_attention_per_row_offset_matches_reference():
    rng = np.random.default_rng(2)
    B, Sq, Skv, H, Hkv, D = 2, 5, 40, 4, 2, 16
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    off = np.array([0, 31], np.int32)
    for q_offset in (off, 7):
        want = jattn.mea_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, chunk=16,
                                   q_offset=jnp.asarray(q_offset))
        got = tattn.mea_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True, chunk=16,
                                  q_offset=torch.as_tensor(q_offset))
        _close(want, got, atol=2e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_cache_rows_update_drops_or_sinks_rows_past_n_valid(paged):
    """Per-row starts with ``n_valid``: contiguous rows past the count or
    past the cache end are DROPPED (never clamped onto valid rows); paged
    rows past the count go to the NULL sink."""
    rng = np.random.default_rng(3)
    B, P, S, bs = 3, 6, 16, 4
    new = rng.normal(size=(B, P, 2, 4)).astype(np.float32)
    start = np.array([0, 9, 13], np.int32)
    n_valid = np.array([6, 2, 6], np.int32)          # row 2 overruns the end
    if paged:
        tables = (rng.permutation(B * S // bs) + 1).astype(np.int32).reshape(B, -1)
        cache = rng.normal(size=(B * S // bs + 1, bs, 2, 4)).astype(np.float32)
        start[2] = 8                                 # stay inside the table
        jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    else:
        cache = rng.normal(size=(B, S, 2, 4)).astype(np.float32)
        jt = tt = None
    want = jattn.cache_rows_update(jnp.asarray(cache), jnp.asarray(new),
                                   jnp.asarray(start), block_table=jt,
                                   n_valid=jnp.asarray(n_valid))
    got = tattn.cache_rows_update(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                                  torch.from_numpy(start), block_table=tt,
                                  n_valid=torch.from_numpy(n_valid))
    if paged:   # sink contents depend on which duplicate write wins
        want, got = want[1:], got[1:]
    _close(want, got, atol=0)


def test_cache_row_update_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(4)
    cache = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    idx = np.array([0, 7, 12], np.int32)               # 12 clamps to 7
    want = jattn.cache_row_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(idx))
    got = tattn.cache_row_update(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                                 torch.from_numpy(idx))
    _close(want, got, atol=0)
