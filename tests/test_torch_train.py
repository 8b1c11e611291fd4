"""The port's training pieces against the reference, on the CPU: the
model's training forward and gradients, the masked fastest-k loss, the
optimizer, the train step (direct and accumulated), and the copies of the
control plane the loop runs on.

Parameters come from the reference's own ``Model.init`` and cross
through ``params_from_numpy`` (gradients cross the same way; qwen2.5-3b,
command-r-35b, chameleon-34b and qwen3-moe-30b-a3b carry seeded noise on
their bias and norm leaves, ``tests/_noisy.py``); batches
come from seeded numpy and go to both frameworks. Everything is f32.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.runtime.telemetry as jtele
from repro.configs import get_config
from repro.dist import collectives as jcoll
from repro.models import build_model
from repro.optim import optimizers as jopt
from repro.runtime.steps import make_train_step as j_make_train_step
import repro_torch.core as tcore
import repro_torch.data as tdata
from repro_torch.configs import get_config as port_config
from repro_torch.dist import collectives as tcoll
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import StragglerTracker
from repro_torch.runtime.steps import make_train_step
from _noisy import NOISY_ARCHS, noisy_pair

CONFIGS = {
    "llama3.2-1b": {},                            # G = 2 once reduced
    "smollm-135m": {},
    "llama3.2-1b-g3": {"n_heads": 6, "n_kv_heads": 2},
    "qwen2.5-3b": {},                             # qkv bias
    "command-r-35b": {},                          # LayerNorm, parallel block, logit scale
    "chameleon-34b": {},                          # qk-norm, untied head
    "qwen3-moe-30b-a3b": {},                      # router loss in the loss
}
RNG = np.random.default_rng(5)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference model, its params, port config, bridged params)."""
    arch = name.removesuffix("-g3")
    if arch in NOISY_ARCHS:
        return noisy_pair(arch)
    ref = build_model(get_config(arch).reduced(**CONFIGS[name]))
    jp = ref.init(jax.random.PRNGKey(0))
    cfg = port_config(arch).reduced(**CONFIGS[name])
    return ref, jp, cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab, B=4, S=24, mask=True, worker_mask=None):
    ids = RNG.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    out = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
    if mask:
        out["mask"] = (RNG.random((B, S)) > 0.2).astype(np.float32)
    if worker_mask is not None:
        out["worker_mask"] = np.asarray(worker_mask, np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _copy(tree):
    """A copy of a parameter tree: the train step updates its parameters
    in place, and the cached ones serve other tests."""
    return tree_map(torch.clone, tree, is_leaf=torch.is_tensor)


def _grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params, is_leaf=torch.is_tensor)
    loss, metrics = model.train_loss(p, batch)
    loss.backward()
    return loss, metrics, [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hidden_loss_and_grads_match_reference(name):
    """``Model.hidden`` and ``train_loss`` at atol 1e-5, and the gradient
    of every parameter against ``jax.grad`` at 1e-5 of the largest
    gradient (2 layers in f32, sums in other orders). The port runs with
    ``remat`` "none" and "full"; the two give the same gradients bit for
    bit (the recompute repeats the same f32 operations)."""
    ref, jp, cfg, tp = _pair(name)
    batch = _batch(cfg.vocab_size)
    jb = _j(batch)
    positions = jnp.arange(batch["labels"].shape[1])
    jh, _ = ref.hidden(jp, jb["inputs"], positions)
    (jloss, _), jgrads = jax.value_and_grad(ref.train_loss, has_aux=True)(jp, jb)
    jg = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads), device="cpu"))

    got = {}
    for remat in ("none", "full"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        with torch.no_grad():
            th, _ = model.hidden(tp, _t(batch)["inputs"],
                                 torch.arange(batch["labels"].shape[1]))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
        loss, metrics, grads = _grads(model, tp, _t(batch))
        assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
        assert set(metrics) == {"ce", "aux", "loss"}
        scale = max(float(np.abs(np.asarray(g)).max()) for g in jg)
        assert len(grads) == len(jg)
        for a, b in zip(grads, jg):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale)
        got[remat] = grads
    for a, b in zip(got["none"], got["full"]):
        assert torch.equal(a, b)


def test_every_norm_scale_gets_a_gradient():
    """The fault the slice repairs: RMSNorm's output once came back
    without a gradient function, so no norm scale learned and the
    pre-norm branches fell out of the residual stream's gradient."""
    _, _, cfg, tp = _pair("llama3.2-1b")
    model = Model(cfg)
    _, _, grads = _grads(model, tp, _t(_batch(cfg.vocab_size)))
    named = dict(zip([id(p) for p in _leaves(tp)], grads))
    scales = [layer[n]["scale"] for layer in tp["stack"][0] for n in ("attn_norm", "mlp_norm")]
    for s in scales + [tp["final_norm"]["scale"]]:
        g = named[id(s)]
        assert g is not None and bool((g != 0).any())


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("worker_mask", [None, [1.0, 0.0, 1.0, 1.0]])
def test_masked_weighted_ce_matches_reference(mask, worker_mask):
    logits = RNG.normal(size=(8, 12, 50)).astype(np.float32) * 3
    labels = RNG.integers(0, 50, size=(8, 12)).astype(np.int32)
    m = (RNG.random((8, 12)) > 0.3).astype(np.float32) if mask else None
    wm = None if worker_mask is None else np.asarray(worker_mask, np.float32)
    jl, jd = jcoll.masked_weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                      None if m is None else jnp.asarray(m),
                                      None if wm is None else jnp.asarray(wm))
    tl, td = tcoll.masked_weighted_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if m is None else torch.from_numpy(m),
                                      None if wm is None else torch.from_numpy(wm))
    assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    assert float(td) == float(jd)
    if wm is not None:
        assert float(tcoll.contributors(torch.from_numpy(wm))) == float(jcoll.contributors(wm))
    with pytest.raises(ValueError, match="not divisible"):
        tcoll.example_weights(torch.ones(3), 8)


def test_masked_step_is_the_dense_step_on_the_contributing_workers():
    """The paper's eq. (2): with the mask zeroing worker 1, the step's
    loss and update equal a dense step on workers 0, 2, 3's rows alone."""
    _, _, cfg, tp = _pair("smollm-135m")
    model = Model(cfg)
    batch = _batch(cfg.vocab_size, B=8, mask=False, worker_mask=[1.0, 0.0, 1.0, 1.0])
    keep = np.r_[0:2, 4:8]
    dense = {"inputs": batch["inputs"][keep], "labels": batch["labels"][keep],
             "worker_mask": np.ones(3, np.float32)}
    step = make_train_step(model, topt.sgd(), clip_norm=None)
    pm, _, mm = step(_copy(tp), (), {**_t(batch), "lr": 0.1})
    pd, _, md = step(_copy(tp), (), {**_t(dense), "lr": 0.1})
    assert float(mm["loss"]) == pytest.approx(float(md["loss"]), abs=1e-6)
    assert float(mm["denom"]) == float(md["denom"]) == 6 * 24
    assert float(mm["contributors"]) == 3.0
    for a, b in zip(_leaves(pm), _leaves(pd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_adamw_clip_update_matches_reference():
    """One AdamW update after global-norm clipping (the norm is above the
    limit) of a mixed-dtype tree, twice, against the reference's; f32
    at 1e-6, the bf16 leaf within one bf16 step."""
    p = {"a": RNG.normal(size=(5, 7)).astype(np.float32),
         "b": [RNG.normal(size=(3,)).astype(np.float32), RNG.normal(size=(2, 4)).astype(np.float32)]}
    jp = {"a": jnp.asarray(p["a"]), "b": [jnp.asarray(p["b"][0]),
                                          jnp.asarray(p["b"][1], jnp.bfloat16)]}
    tp = {"a": torch.from_numpy(p["a"]), "b": [torch.from_numpy(p["b"][0]),
                                               torch.from_numpy(p["b"][1]).bfloat16()]}
    jo, to = jopt.adamw(weight_decay=0.1), topt.adamw(weight_decay=0.1)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        g = jax.tree.map(lambda x: RNG.normal(size=x.shape).astype(np.float32) * 3, p)
        jg = jax.tree.map(lambda gg, x: jnp.asarray(gg, x.dtype), g, jp)
        tg = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0]),
                                                   torch.from_numpy(g["b"][1]).bfloat16()]}
        jg, jn = jopt.clip_by_global_norm(jg, 1.0)
        tg, tn = topt.clip_by_global_norm(tg, 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6) and float(tn) > 1.0
        ju, js = jo.update(jg, js, jp, jnp.float32(1e-2))
        tu, ts = to.update(tg, ts, tp, 1e-2)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert int(ts["step"]) == int(js.step) == 2
    for a, b in zip(jax.tree.leaves(jp), _leaves(tp)):
        assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        atol = 2 ** -7 if b.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), atol=atol)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("adafactor2")


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_reference(optimizer):
    """One clipped step with a worker mask: loss and grad norm at 1e-5,
    every updated parameter at 1e-5 (SGD) or 1e-4 (AdamW's first step
    moves a weight by about lr, so it repeats the grads' f32 noise only
    where a gradient is near eps)."""
    ref, jp, cfg, tp = _pair("llama3.2-1b-g3")
    batch = _batch(cfg.vocab_size, B=8, worker_mask=[1.0, 1.0, 0.0, 1.0])
    jo, to = jopt.get_optimizer(optimizer), topt.get_optimizer(optimizer)
    jnew, _, jm = jax.jit(j_make_train_step(ref, jo))(jp, jo.init(jp),
                                                      {**_j(batch), "lr": jnp.float32(1e-3)})
    tp = _copy(tp)
    tnew, _, tm = make_train_step(Model(cfg), to)(tp, to.init(tp), {**_t(batch), "lr": 1e-3})
    for key in ("loss", "ce", "grad_norm", "denom", "contributors"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5, abs=1e-6), key
    atol = 1e-5 if optimizer == "sgd" else 1e-4
    jn = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jnew), device="cpu"))
    for a, b in zip(_leaves(tnew), jn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)


def test_accumulated_step_equals_direct_step():
    """accum_steps=2 splits each worker's rows over two microbatches and
    recombines them weighted by their token counts: the same loss and
    update as the direct step (f32, sums in another order)."""
    _, _, cfg, tp = _pair("llama3.2-1b")
    model = Model(cfg)
    batch = {**_t(_batch(cfg.vocab_size, B=8, worker_mask=[1.0, 0.0, 1.0, 1.0])), "lr": 0.1}
    p1, _, m1 = make_train_step(model, topt.sgd(), clip_norm=None)(_copy(tp), (), batch)
    p2, _, m2 = make_train_step(model, topt.sgd(), clip_norm=None, accum_steps=2)(
        _copy(tp), (), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["denom"]) == float(m2["denom"])
    for a, b in zip(_leaves(p1), _leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="not divisible by accum"):
        make_train_step(model, topt.sgd(), accum_steps=3)(_copy(tp), (), batch)


def _strategies(core):
    """The four strategies of benchmarks/perf_train_adaptive.py."""
    diag = core.DiagnosticConfig(kind="loss", rel_tol=0.02, min_iters=6, consecutive=2)
    grid = (0.25, 0.5, 0.75, 1.0)
    return [
        core.StrategyConfig("naive", n=8, s=4),
        core.StrategyConfig("fastest_k", n=8, s=4, k0=2),
        core.StrategyConfig("adaptive_k", n=8, s=4, k0=1, k_max=4, diagnostic=diag),
        core.StrategyConfig("adaptive_kbeta", n=8, s=4, k0=1, k_max=4, beta_grid=grid,
                            diagnostic=diag),
    ]


@pytest.mark.parametrize("delay", [(1.0, 0.05), (2.0, 0.3)])
def test_stage_tables_match_reference(delay):
    jm = jcore.SimplifiedDelayModel(lambda_y=delay[0], x=delay[1])
    tm = tcore.SimplifiedDelayModel(lambda_y=delay[0], x=delay[1])
    for js, ts in zip(_strategies(jcore), _strategies(tcore)):
        jt, tt = jcore.stage_table(js, jm), tcore.stage_table(ts, tm)
        assert [(s.k, s.beta) for s in tt] == [(s.k, s.beta) for s in jt]
        for s in jt:
            nj, nt = jcore.next_stage(js, s, jm), tcore.next_stage(ts, tcore.Stage(s.k, s.beta), tm)
            assert (nj is None and nt is None) or (nj.k, nj.beta) == (nt.k, nt.beta)
    gm = (jcore.GeneralizedDelayModel(lambda_x=3.0, lambda_y=1.0, x=0.1),
          tcore.GeneralizedDelayModel(lambda_x=3.0, lambda_y=1.0, x=0.1))
    js, ts = _strategies(jcore)[-1], _strategies(tcore)[-1]
    assert [(s.k, s.beta) for s in tcore.stage_table(ts, gm[1])] == \
        [(s.k, s.beta) for s in jcore.stage_table(js, gm[0])]


def test_staged_batcher_and_tracker_match_reference():
    jb = jdata.StagedBatcher(jdata.TokenStream(300, seed=3), n_workers=4, global_batch=16,
                             seq_len=20)
    tb = tdata.StagedBatcher(tdata.TokenStream(300, seed=3), n_workers=4, global_batch=16,
                             seq_len=20)
    for beta, n in ((0.25, 4), (0.5, 3), (1.0, 4), (0.75, 2)):
        a, b = jb.batch_for_stage(beta, n_workers=n), tb.batch_for_stage(beta, n_workers=n)
        for key in ("inputs", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        assert jb.batch_shape(beta, n) == tb.batch_shape(beta, n)
    jt, tt = jtele.StragglerTracker(5), StragglerTracker(5)
    rng = np.random.default_rng(9)
    alive = np.array([1, 1, 0, 1, 1], bool)
    for i in range(30):
        z = rng.exponential(size=5) * np.array([1, 1, 1, 1, 4.0])
        observed = z <= np.sort(z[alive])[1]
        kw = dict(observed=observed, censor_level=float(np.sort(z[alive])[1]))
        jt.observe(z, alive, **kw)
        tt.observe(z, alive, **kw)
        if i == 12:
            jt.reset_worker(1)
            tt.reset_worker(1)
    assert jt.state_dict() == tt.state_dict()
    assert jt.persistent_stragglers(2.0) == tt.persistent_stragglers(2.0)
    np.testing.assert_array_equal(jt.slowdown(), tt.slowdown())
