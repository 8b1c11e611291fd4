"""zamba2 (Mamba2 + shared attention) in the port against the reference,
on the CPU: the bridge, one Mamba2 block, the model's hidden states,
logits, loss and gradients, remat, one train step, a short run of the
adaptive-(k, beta) loop under a fail and a rejoin, and exact resume of
a tree that mixes f32 and bf16 leaves.

The reduced zamba2 (4 Mamba2 layers, a shared call after every 2, d_model
128, chunk 32) takes the reference's own ``Model.init`` through
``params_from_numpy``; batches are seeded numpy handed to both
frameworks. Everything is f32 but the bridge's bf16 case.
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
from repro.configs import get_config
from repro.models import build_model
from repro.models import mamba2 as jmamba2
from repro.optim import optimizers as jopt
from repro.runtime.steps import make_train_step as j_make_train_step
from repro.runtime.train_loop import FaultEvent as JFault
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro.runtime.train_loop import train as j_train
import repro_torch.core as tcore
import repro_torch.data as tdata
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, count_params_analytic, params_from_numpy
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import get_optimizer
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import FaultEvent, TrainLoopConfig, make_train_step, train

RNG = np.random.default_rng(13)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(reference model, its params, port config, bridged params)."""
    ref = build_model(get_config("zamba2").reduced(dtype=dtype))
    jp = ref.init(jax.random.PRNGKey(0))
    cfg = port_config("zamba2").reduced(dtype=dtype)
    return ref, jp, cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _batch(vocab, B=4, S=64, worker_mask=None):
    ids = RNG.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    out = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
    if worker_mask is not None:
        out["worker_mask"] = np.asarray(worker_mask, np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_bridge_keeps_the_f32_leaves_of_a_bf16_model():
    """In a bf16 zamba2 the reference declares each Mamba2 layer's a_log,
    dt_bias and d_skip f32: they arrive f32 with the reference's exact
    values, every other leaf bf16 and equal to the reference's bits."""
    _, jp, cfg, tp = _pair("bfloat16")
    f32 = ("a_log", "dt_bias", "d_skip")
    for i, layer in enumerate(tp["stack"]["mamba"]):
        for name in f32:
            got = layer["mixer"][name]
            want = np.asarray(jp["stack"]["mamba"]["mixer"][name][i])
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(), want)
    others = [leaf for leaf in _leaves(tp)
              if not any(leaf is layer["mixer"][n] for layer in tp["stack"]["mamba"]
                         for n in f32)]
    assert len(others) == len(_leaves(tp)) - 3 * cfg.n_layers
    assert all(leaf.dtype == torch.bfloat16 for leaf in others)
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))


def test_param_count_and_specs_match_reference():
    """zamba2-1.2b's 1,225,003,904 parameters, and the reduced spec tree
    leaf for leaf (the port's per-layer dicts against the reference's
    stacked layers)."""
    assert count_params_analytic(port_config("zamba2")) == \
        get_config("zamba2").param_count() == 1_225_003_904
    ref, jp, cfg, tp = _pair()
    assert len(tp["stack"]["mamba"]) == cfg.n_layers
    assert sum(t.numel() for t in _leaves(tp)) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_mamba2_apply_matches_reference():
    """One Mamba2 block (projection, causal conv, SSD scan, D skip, gated
    RMSNorm, output projection) at atol 1e-4."""
    _, jp, cfg, tp = _pair()
    x = RNG.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[1], jp["stack"]["mamba"]["mixer"])
    want = jmamba2.mamba2_apply(jl, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = tmamba2.mamba2_apply(tp["stack"]["mamba"][1]["mixer"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    it = iter(leaves)
    loss, _ = model.train_loss(tree_map(lambda _: next(it), params, is_leaf=torch.is_tensor),
                               batch)
    loss.backward()
    return loss.detach(), [leaf.grad for leaf in leaves]


def test_hidden_logits_loss_and_grads_match_reference():
    """``hidden``, logits and ``train_loss`` at 1e-4, every parameter's
    gradient against ``jax.grad`` at 1e-5 of the largest gradient, with
    remat "none" and "full". The two remat modes give the same gradients
    bit for bit (the recompute repeats the same f32 operations), but for
    the embedding's: it sums the tied head's, the residual stream's and
    every shared call's x0 share, which autograd adds in another order
    under checkpointing, so it is held to 1e-6 of its largest."""
    ref, jp, cfg, tp = _pair()
    batch = _batch(cfg.vocab_size)
    jb, tb = _j(batch), _t(batch)
    positions = jnp.arange(batch["labels"].shape[1])
    jh, _ = ref.hidden(jp, jb["inputs"], positions)
    jlogits = ref.logits(jp, jh)
    (jloss, _), jgrads = jax.value_and_grad(ref.train_loss, has_aux=True)(jp, jb)
    jg = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads), device="cpu"))
    scale = max(float(g.abs().max()) for g in jg)
    got = {}
    for remat in ("none", "full"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        with torch.no_grad():
            th, aux = model.hidden(tp, tb["inputs"], torch.arange(batch["labels"].shape[1]))
            tlogits = model.logits(tp, th)
        assert float(aux) == 0.0
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4)
        loss, grads = _grads(model, tp, tb)
        assert float(loss) == pytest.approx(float(jloss), abs=1e-4)
        assert len(grads) == len(jg)
        for a, b in zip(grads, jg):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale)
        got[remat] = grads
    assert _leaves(tp)[0] is tp["embed"]              # the first leaf in tree order
    for i, (a, b) in enumerate(zip(got["none"], got["full"])):
        if i == 0:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * float(a.abs().max()))
        else:
            assert torch.equal(a, b), i


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_reference(optimizer):
    """One clipped step with a worker mask: loss and grad norm at 1e-5
    relative, every updated parameter at 1e-5 (SGD) or 1e-4 (AdamW's
    first step moves a weight by about lr, so it repeats the gradients'
    f32 noise where a gradient is near eps)."""
    ref, jp, cfg, tp = _pair()
    batch = _batch(cfg.vocab_size, worker_mask=[1.0, 1.0, 0.0, 1.0])
    jo, to = jopt.get_optimizer(optimizer), topt.get_optimizer(optimizer)
    jnew, _, jm = jax.jit(j_make_train_step(ref, jo))(jp, jo.init(jp),
                                                      {**_j(batch), "lr": jnp.float32(1e-3)})
    # The step updates its parameters in place: it gets a copy of the
    # cached ones.
    tp = tree_map(torch.clone, tp, is_leaf=torch.is_tensor)
    tnew, _, tm = make_train_step(Model(cfg), to)(tp, to.init(tp), {**_t(batch), "lr": 1e-3})
    for key in ("loss", "ce", "grad_norm", "denom", "contributors"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5, abs=1e-6), key
    atol = 1e-5 if optimizer == "sgd" else 1e-4
    jn = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jnew), device="cpu"))
    for a, b in zip(_leaves(tnew), jn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)


def _setup(core, data, vocab, n=4, global_batch=8, seq_len=32):
    st = core.StrategyConfig(
        "adaptive_kbeta", n=n, s=global_batch // n, k_max=n // 2, beta_grid=(0.5, 1.0),
        diagnostic=core.DiagnosticConfig(kind="loss", rel_tol=0.5, min_iters=2,
                                         consecutive=1))
    batcher = data.StagedBatcher(data.TokenStream(vocab, seed=0), n_workers=n,
                                 global_batch=global_batch, seq_len=seq_len)
    return st, core.SimplifiedDelayModel(lambda_y=1.0, x=0.05), batcher


def test_loop_matches_reference_under_fail_and_rejoin():
    """8 steps of adaptive_kbeta on the reduced zamba2 with a fail at step
    2 and a rejoin at step 5: per step, k, beta, n_workers, sim_time and
    contributors are equal, and so are the stage switches and batch
    shapes; loss and grad_norm agree within 1e-4 relative (f32 in two
    frameworks, 8 AdamW steps apart)."""
    ref, jp, cfg, tp = _pair()
    events = [(2, "fail", 1), (5, "rejoin", 1)]
    st, delay, batcher = _setup(jcore, jdata, cfg.vocab_size)
    jout = j_train(ref, jopt.get_optimizer("adamw"), st, delay, batcher,
                   JLoopConfig(total_steps=8, log_every=0, lr=3e-3,
                               events=[JFault(*e) for e in events]))
    st, delay, batcher = _setup(tcore, tdata, cfg.vocab_size)
    tout = train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                 TrainLoopConfig(total_steps=8, log_every=0, lr=3e-3,
                                 events=[FaultEvent(*e) for e in events]),
                 # The loop updates its parameters in place: a copy of the
                 # cached ones.
                 params=tree_map(torch.clone, tp, is_leaf=torch.is_tensor), device="cpu")
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


def test_resume_of_a_mixed_dtype_tree_replays_exactly():
    """A bf16 zamba2 holds f32 leaves (a_log, dt_bias, d_skip) beside bf16
    ones. A run checkpointed at step 8 and resumed by a fresh loop replays
    the uninterrupted run's steps 8-11 field for field and ends with the
    same parameters bit for bit, each leaf in its own dtype. One CPU
    thread: MKL's multi-threaded products are not reproducible run to run."""
    cfg = port_config("zamba2").reduced(dtype="bfloat16", d_model=64, vocab_size=256)
    dtypes = {leaf.dtype for leaf in _leaves(Model(cfg).init(0, device="cpu"))}
    assert dtypes == {torch.bfloat16, torch.float32}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    events = [FaultEvent(3, "fail", 2), FaultEvent(9, "rejoin", 2)]
    with tempfile.TemporaryDirectory() as d:
        def run():
            st, delay, batcher = _setup(tcore, tdata, cfg.vocab_size)
            return train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                         TrainLoopConfig(total_steps=12, log_every=0, lr=3e-3,
                                         checkpoint_dir=d, checkpoint_every=8,
                                         events=events), device="cpu")
        try:
            out1 = run()
            out2 = run()                   # fresh everything, state from disk
        finally:
            torch.set_num_threads(threads)
    tail = [h for h in out1["history"] if h["step"] >= 8]
    assert out2["history"][0]["step"] == 8 and out2["history"] == tail
    assert out2["controller"].state_dict() == out1["controller"].state_dict()
    for a, b in zip(_leaves(out1["params"]), _leaves(out2["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_leaves(out1["opt_state"]), _leaves(out2["opt_state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)

