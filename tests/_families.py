"""Shared set-up of the MLA (deepseek-v3) and xLSTM parity tests
(``tests/test_torch_mla.py``, ``tests/test_torch_xlstm.py``,
``tests/test_torch_train_families.py``).

``family_pair`` builds a reduced config in both packages, initialises the
reference's parameters with its own ``Model.init``, makes the leaves that
init sets to zeros or ones noisy (seeded numpy noise, the same values on
both sides; ``_noisy.with_noise`` plus the xLSTM's conv and gate biases)
and bridges them to the port on the CPU. Everything is f32.

``close`` holds a port value to the reference's within ``rtol`` of the
compared leaf's largest magnitude (at least 1).

``TRAIN_CUTS`` are the training tests' cuts, and ``train_pair`` gives the
reference's own initial parameters (no noise: the reference's ``train``
draws them itself) bridged to the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _noisy import with_noise
from repro.configs import get_config
from repro.models import build_model
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serve import Scheduler, ServeEngine, generate_offline

#: Leaves the reference initializes to zeros beyond ``_noisy``'s: the
#: mLSTM's conv bias and input / forget gate biases.
ZERO_LEAVES = ("conv_b", "b_if")


def close(got, want, rtol: float, what: str = "") -> None:
    """|got - want| <= rtol * max(1, max |want|), element by element."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())), err_msg=what)


def _noisy_zeros(tree, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        a = np.asarray(t)
        if key in ZERO_LEAVES:
            a = (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(tree, None)


def cut(cfg, **replace):
    """``cfg.reduced(n_layers=...)`` with ``replace``: top-level fields,
    and ``dropless`` / ``slstm_every`` in the MoE / xLSTM sub-config."""
    dropless = replace.pop("dropless", None)
    slstm_every = replace.pop("slstm_every", None)
    n_layers = replace.pop("n_layers", None)
    cfg = cfg.reduced(**({} if n_layers is None else {"n_layers": n_layers}))
    if dropless is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=dropless))
    if slstm_every is not None:
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm,
                                                                 slstm_every=slstm_every))
    return dataclasses.replace(cfg, **replace)


@functools.lru_cache(maxsize=None)
def family_pair(arch: str, **replace):
    """(reference model, its params as jnp, port model, bridged params,
    the numpy tree) for ``arch`` cut by ``cut(**replace)``."""
    ref = build_model(cut(get_config(arch), **dict(replace)))
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
    tree = _noisy_zeros(with_noise(tree, 1), 2)
    cfg = cut(port_config(arch), **dict(replace))
    return (ref, jax.tree.map(jnp.asarray, tree), Model(cfg),
            params_from_numpy(cfg, tree, device="cpu"), tree)


#: The training tests' cuts: deepseek-v3 at 3 layers (1 MLA dense, 2 MLA
#: MoE: the reference stacks the MoE segment), xLSTM at 4 with an sLSTM
#: every third (mLSTM x 2, sLSTM, mLSTM).
TRAIN_CUTS = {"deepseek-v3": {"n_layers": 3},
              "xlstm-125m": {"n_layers": 4, "slstm_every": 3}}


@functools.lru_cache(maxsize=None)
def train_pair(arch: str, **replace):
    """(reference model, port config, the reference's ``init`` at
    ``PRNGKey(0)`` bridged to the port on the CPU), the parameters the
    reference's ``train`` starts from at seed 0."""
    ref = build_model(cut(get_config(arch), **dict(replace)))
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
    cfg = cut(port_config(arch), **dict(replace))
    return ref, cfg, params_from_numpy(cfg, tree, device="cpu")


@functools.lru_cache(maxsize=None)
def jitted_model(ref):
    """The reference model's training-forward logits, cache-writing
    prefill (from position 0) and decode step, each jitted once (eager JAX
    compiles every op of a first call on its own, which takes longer)."""
    return (jax.jit(lambda p, ids: ref.logits(p, ref.hidden(p, ids, jnp.arange(ids.shape[1]))[0])),
            jax.jit(lambda p, ids, c, lens, t: ref.prefill_with_cache(
                p, ids, c, length=lens, start_index=0, block_tables=t)),
            jax.jit(lambda p, tok, c, pos, t: ref.decode_step(p, tok, c, pos, block_tables=t)))


def _spec_items(tree):
    """{path: (shape, dtype, init)} of a spec tree, keyed alike in both
    packages (the reference's single-layer segments are unstacked)."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init")):
        keys = tuple(k.key if hasattr(k, "key") else k.idx for k in path)
        out[keys] = (tuple(s.shape), s.dtype, s.init)
    return out


def port_spec_items(model):
    """{path: (shape, dtype, init)} of the port's parameter specs, one
    path element a layer."""
    specs = model.param_specs()
    stack = specs.pop("stack")
    out = _spec_items(specs)
    for i, seg in enumerate(stack):
        for j, layer in enumerate(seg):
            for keys, v in _spec_items(layer).items():
                out[("stack", i, j) + keys] = v
    return out


def ref_spec_items(ref):
    """The reference's parameter specs keyed as ``port_spec_items``: a
    stacked segment's leaves cut along their layer axis."""
    specs = ref.param_specs()
    stack = specs.pop("stack")
    out = _spec_items(specs)
    for i, (seg, tree) in enumerate(zip(ref.segments, stack)):
        for keys, (shape, dt, init) in _spec_items(tree).items():
            if seg.count == 1:
                out[("stack", i, 0) + keys] = (shape, dt, init)
            else:
                for j in range(seg.count):
                    out[("stack", i, j) + keys] = (shape[1:], dt, init)
    return out


def workload(vocab: int, n: int = 6, seed: int = 0, new=(1, 12)):
    """``n`` staggered requests: prompts of 3-19 tokens, ``new`` tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(*new)), i * 0.004) for i in range(n)]


def engines(pair, n_slots: int, max_len: int, chunk: int = 8, draft=None, **kw):
    """(port engine, reference engine) over the same model, scheduler and
    pool options; ``draft`` = (reference draft params, port draft params)
    adds a speculative draft of the same config."""
    ref, jp, model, tp = pair[:4]
    spec, ref_spec = {}, {}
    if draft is not None:
        ref_spec = dict(draft_model=ref, draft_params=draft[0], gamma_max=4)
        spec = dict(draft_model=model, draft_params=draft[1], gamma_max=4)
    eng = ServeEngine(model, tp, n_slots=n_slots, max_len=max_len,
                      scheduler=Scheduler(n_slots, prefill_chunk=chunk, decode_per_prefill=2),
                      **kw, **spec)
    ref_eng = RefEngine(ref, jp, n_slots=n_slots, max_len=max_len,
                        scheduler=RefScheduler(n_slots, prefill_chunk=chunk,
                                               decode_per_prefill=2), **kw, **ref_spec)
    return eng, ref_eng


def run_twins(eng, ref_eng, reqs, max_len: int, offline: bool = True):
    """Submit ``reqs`` to both engines and run them: every stream equals
    the reference engine's and (``offline``) the port's offline decode,
    and the event logs are equal. Returns the port's request ids."""
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    eng.run()
    ref_eng.run()
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        tokens = eng.request(rid).tokens
        assert len(tokens) == m, rid
        assert tokens == ref_eng.request(ref_rid).tokens, f"rid={rid} differs from the reference"
        if offline:
            assert tokens == generate_offline(eng.model, eng.params, p, m, max_len), rid
    assert eng.events == ref_eng.events
    return rids
