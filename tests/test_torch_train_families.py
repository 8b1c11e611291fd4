"""Training deepseek-v3 (MLA, capacity-dropped MoE with a shared expert,
first-k-dense, the MTP loss) and xLSTM (mLSTM's parallel form, sLSTM's
scan) in the port against the reference, on the CPU, reduced and f32:
the loss terms and every gradient against ``jax.grad``, one train step
with AdamW, Adafactor and momentum against the reference's
``make_train_step``, an 8-step adaptive-(k, beta) loop under a fail and a
rejoin against the reference's ``train``, and exact resume of the
Adafactor and momentum states.

deepseek-v3 is cut to 3 layers (1 ``mla_dense``, 2 ``mla_moe``, so that
the reference stacks the MoE segment and Adafactor pools over it), 8
experts of top 2 and a shared one; xLSTM to 4 layers with an sLSTM every
third (mLSTM x 2, sLSTM, mLSTM). Set-up: ``tests/_families.py``.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
from repro.dist import collectives as jcoll
from repro.optim import optimizers as jopt
from repro.runtime.steps import make_train_step as j_make_train_step
from repro.runtime.train_loop import FaultEvent as JFault
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro.runtime.train_loop import train as j_train
import repro_torch.core as tcore
import repro_torch.data as tdata
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import get_optimizer
from repro_torch.runtime import FaultEvent, TrainLoopConfig, make_train_step, train
from repro_torch.runtime.steps import train_loss_fn
from _families import TRAIN_CUTS, close, family_pair, train_pair

FAMILIES = list(TRAIN_CUTS)
#: The optimizer each family's loop runs, as phase 21 of chip_smoke.py.
LOOP_OPT = {"deepseek-v3": ("adafactor", {}), "xlstm-125m": ("momentum", {"mu": 0.9})}
RNG = np.random.default_rng(11)


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _copy(tree):
    return tree_map(torch.clone, tree, is_leaf=torch.is_tensor)


def _batch(vocab, B=8, S=24, worker_mask=(1.0, 0.0, 1.0, 1.0)):
    ids = RNG.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"inputs": ids[:, :-1], "labels": ids[:, 1:],
            "mask": (RNG.random((B, S)) > 0.2).astype(np.float32),
            "worker_mask": np.asarray(worker_mask, np.float32)}


def _ref_loss_fn(ref, params, batch):
    """The reference's ``make_train_step`` loss, restated from
    ``repro/runtime/steps.py`` with its own functions (the step holds it
    in a closure); the tests check it against the step's own metrics."""
    cfg = ref.cfg
    inputs, labels = batch["inputs"], batch["labels"]
    positions = jnp.arange(labels.shape[1])
    h, aux = ref.hidden(params, inputs, positions)
    ce, denom = jcoll.masked_weighted_ce(ref.logits(params, h), labels, batch.get("mask"),
                                         batch.get("worker_mask"))
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        mask = batch.get("mask")
        if mask is None:
            mask = jnp.ones(labels.shape, jnp.float32)
        loss = loss + 0.3 * ref._mtp_loss(params, h, inputs, labels, mask, positions)
    return loss, {"ce": ce, "aux": aux, "denom": denom}


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    """The reference's loss, metrics and gradient of a fixed batch."""
    ref, jp, model, tp, _ = family_pair(arch, **TRAIN_CUTS[arch])
    batch = _batch(model.cfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(lambda p, b: _ref_loss_fn(ref, p, b), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), {k: float(v) for k, v in metrics.items()}, \
        jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_terms_and_grads_match_reference(arch):
    """The step's loss, ce, aux and denom, ``train_loss``'s ce, aux and mtp,
    and every gradient leaf against ``jax.grad`` of the reference's loss,
    with worker 1 dropped by the fastest-k mask: f32, 1e-5 of the largest
    gradient. The port runs with remat "none" and "full", whose gradients
    are equal bit for bit (the recompute repeats the same f32 work). The
    MTP term keeps worker 1's rows, as the reference's does."""
    ref, jp, model, tp, _ = family_pair(arch, **TRAIN_CUTS[arch])
    batch, jloss, jm, jgrads = _ref_grads(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jg = _leaves(params_from_numpy(model.cfg, jgrads, device="cpu"))
    scale = max(float(g.abs().max()) for g in jg)
    got = {}
    for remat in ("none", "full"):
        rmodel = Model(dataclasses.replace(model.cfg, remat=remat))
        leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(tp)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), tp, is_leaf=torch.is_tensor)
        loss, metrics = train_loss_fn(rmodel, p, tb)
        loss.backward()
        assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
        for key in ("ce", "aux", "denom"):
            assert float(metrics[key].detach()) == pytest.approx(jm[key], rel=1e-5,
                                                                 abs=1e-7), key
        for a, b in zip([x.grad for x in leaves], jg):
            close(a, b, 1e-5 * scale / max(1.0, float(b.abs().max())))
        got[remat] = [x.grad for x in leaves]
    for a, b in zip(got["none"], got["full"]):
        assert torch.equal(a, b)
    # train_loss's terms (no worker mask) against the reference's.
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "worker_mask"}
    _, jtm = jax.jit(ref.train_loss)(jp, jb)
    with torch.no_grad():
        _, ttm = model.train_loss(tp, {k: v for k, v in tb.items() if k != "worker_mask"})
    assert set(ttm) == set(jtm)
    for key in jtm:
        assert float(ttm[key]) == pytest.approx(float(jtm[key]), rel=1e-5, abs=1e-7), key
    if model.cfg.mtp:
        # The quirk: the step's MTP term is train_loss's, every row counted,
        # while its cross-entropy drops worker 1's rows.
        with torch.no_grad():
            loss, metrics = train_loss_fn(model, tp, tb)
        mtp = float(loss - metrics["ce"] - model.cfg.moe.router_aux_weight * metrics["aux"]) / 0.3
        assert mtp == pytest.approx(float(ttm["mtp"]), rel=1e-4)
        assert float(metrics["ce"]) != pytest.approx(float(ttm["ce"]), rel=1e-3)


#: Parameters after two steps (lr 1e-3, clip 1) are held within this much
#: of the reference's. Momentum moves by the clipped gradient, so its
#: parameters repeat the gradients' f32 noise. AdamW's and Adafactor's
#: first step moves a weight by about lr * sign(g): where g sits at the
#: f32 noise of two frameworks the sign may differ, which moves that
#: weight by up to 2 lr a step, and the second step's gradients inherit
#: it. So at most one weight in 10^4 (at least one) may lie beyond this,
#: and none more than 2 lr a step away.
STEP_ATOL = {"adamw": 2e-4, "adafactor": 2e-4, "momentum": 1e-6}
#: The same for the second step's loss and gradient norm (relative): the
#: first step's metrics are held to 1e-5.
STEP2_RTOL = {"adamw": 1e-4, "adafactor": 1e-4, "momentum": 1e-5}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "momentum"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, optimizer):
    """Two clipped steps on one batch with a worker mask: loss, ce and grad
    norm at 1e-5 relative (the second step's at ``STEP2_RTOL``), the
    parameters within ``STEP_ATOL`` (see there for the few sign flips),
    and the first step's loss equals the restated reference loss of the
    first test."""
    ref, jp, model, tp, _ = family_pair(arch, **TRAIN_CUTS[arch])
    batch, jloss, _, _ = _ref_grads(arch)
    jo, to = jopt.get_optimizer(optimizer), get_optimizer(optimizer)
    jstep = jax.jit(j_make_train_step(ref, jo))
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "lr": jnp.float32(1e-3)}
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()}, "lr": 1e-3}
    tstep = make_train_step(model, to)
    js, tp = jo.init(jp), _copy(tp)
    ts = to.init(tp)
    for i in range(2):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        if i == 0:
            assert float(jm["loss"]) == pytest.approx(jloss, rel=1e-6)
        rtol = 1e-5 if i == 0 else STEP2_RTOL[optimizer]
        for key in ("loss", "ce", "grad_norm", "denom", "contributors"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=rtol, abs=1e-6), key
    jn = _leaves(params_from_numpy(model.cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    flips = 0
    for a, b in zip(_leaves(tp), jn):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * 2 * 1e-3, "a weight moved more than 2 lr a step apart"
        flips += int((diff > STEP_ATOL[optimizer]).sum())
    n = sum(a.numel() for a in jn)
    assert flips <= max(1, 1e-4 * n), f"{flips} of {n} weights beyond {STEP_ATOL[optimizer]}"


def test_accumulated_step_with_mtp_matches_reference():
    """deepseek-v3 with accum_steps 2: each microbatch's loss holds its MTP
    term, weighted by its token count like the rest, as in the
    reference's ``_grads_accum``; one clipped SGD step's loss and every
    parameter at 1e-5."""
    arch = "deepseek-v3"
    ref, jp, model, tp, _ = family_pair(arch, **TRAIN_CUTS[arch])
    batch, _, _, _ = _ref_grads(arch)
    jo, to = jopt.get_optimizer("sgd"), get_optimizer("sgd")
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "lr": jnp.float32(0.1)}
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()}, "lr": 0.1}
    jnew, _, jm = jax.jit(j_make_train_step(ref, jo, accum_steps=2))(jp, jo.init(jp), jb)
    tnew, _, tm = make_train_step(model, to, accum_steps=2)(_copy(tp), to.init(tp), tb)
    for key in ("loss", "grad_norm", "denom"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    jn = _leaves(params_from_numpy(model.cfg, jax.tree.map(np.asarray, jnew), device="cpu"))
    for a, b in zip(_leaves(tnew), jn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _setup(core, data, vocab, n=4, global_batch=8, seq_len=32):
    st = core.StrategyConfig(
        "adaptive_kbeta", n=n, s=global_batch // n, k_max=n // 2, beta_grid=(0.5, 1.0),
        diagnostic=core.DiagnosticConfig(kind="loss", rel_tol=0.5, min_iters=2,
                                         consecutive=1))
    batcher = data.StagedBatcher(data.TokenStream(vocab, seed=0), n_workers=n,
                                 global_batch=global_batch, seq_len=seq_len)
    return st, core.SimplifiedDelayModel(lambda_y=1.0, x=0.05), batcher


@pytest.mark.parametrize("arch", FAMILIES)
def test_loop_matches_reference_under_fail_and_rejoin(arch):
    """8 steps of adaptive_kbeta (deepseek with Adafactor, xLSTM with
    momentum) with a fail at step 2 and a rejoin at step 5: k, beta,
    n_workers, sim_time, contributors, the stage switches and the batch
    shapes are equal; loss and grad_norm within 1e-4 relative (f32 in two
    frameworks, 8 steps apart)."""
    ref, cfg, tp = train_pair(arch, **TRAIN_CUTS[arch])
    name, kw = LOOP_OPT[arch]
    events = [(2, "fail", 1), (5, "rejoin", 1)]
    st, delay, batcher = _setup(jcore, jdata, cfg.vocab_size)
    jout = j_train(ref, jopt.get_optimizer(name, **kw), st, delay, batcher,
                   JLoopConfig(total_steps=8, log_every=0, lr=3e-3,
                               events=[JFault(*e) for e in events]))
    st, delay, batcher = _setup(tcore, tdata, cfg.vocab_size)
    tout = train(Model(cfg), get_optimizer(name, **kw), st, delay, batcher,
                 TrainLoopConfig(total_steps=8, log_every=0, lr=3e-3,
                                 events=[FaultEvent(*e) for e in events]),
                 params=_copy(tp), device="cpu")
    jh, th = jout["history"], tout["history"]
    assert len(jh) == len(th) == 8
    for a, b in zip(jh, th):
        for key in ("step", "k", "beta", "n_workers", "sim_time", "contributors"):
            assert a[key] == b[key], (a["step"], key, a[key], b[key])
        assert a.get("switched_to") == b.get("switched_to"), a["step"]
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    walk = [h["n_workers"] for h in th]
    assert walk[1:6] == [4, 3, 3, 3, 4]
    assert len({(h["k"], h["beta"]) for h in th}) >= 2
    assert [tuple(s) for s in tout["compiled_shapes"]] == \
        [tuple(s) for s in jout["compiled_shapes"]]


@pytest.mark.parametrize("arch", FAMILIES)
def test_resume_with_adafactor_and_momentum_states_replays_exactly(arch):
    """A run checkpointed at step 5 and resumed by a fresh loop replays the
    uninterrupted run's steps 5-7 field for field and ends with the same
    parameters and optimizer state (Adafactor's step and row / column /
    full moments; momentum's f32 tree) bit for bit. One CPU thread: MKL's
    multi-threaded products are not reproducible run to run."""
    _, cfg, tp = train_pair(arch, **TRAIN_CUTS[arch])
    name, kw = LOOP_OPT[arch]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    events = [FaultEvent(2, "fail", 1), FaultEvent(5, "rejoin", 1)]
    with tempfile.TemporaryDirectory() as d:
        def run():
            st, delay, batcher = _setup(tcore, tdata, cfg.vocab_size)
            return train(Model(cfg), get_optimizer(name, **kw), st, delay, batcher,
                         TrainLoopConfig(total_steps=8, log_every=0, lr=3e-3,
                                         checkpoint_dir=d, checkpoint_every=5,
                                         events=events), params=_copy(tp), device="cpu")
        try:
            out1 = run()
            out2 = run()                   # fresh everything, state from disk
        finally:
            torch.set_num_threads(threads)
    tail = [h for h in out1["history"] if h["step"] >= 5]
    assert out2["history"][0]["step"] == 5 and out2["history"] == tail
    assert out2["controller"].state_dict() == out1["controller"].state_dict()
    for a, b in zip(_leaves(out1["params"]), _leaves(out2["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    s1, s2 = _leaves(out1["opt_state"]), _leaves(out2["opt_state"])
    assert len(s1) == len(s2) > 0
    for a, b in zip(s1, s2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name == "adafactor":
        assert int(out2["opt_state"]["step"]) == 8
        kinds = {tuple(sorted(s)) for s in tree_leaves(
            out2["opt_state"]["states"], is_leaf=lambda x: isinstance(x, dict) and (
                set(x) in ({"v"}, {"row", "col"})))}
        assert kinds == {("col", "row"), ("v",)}
