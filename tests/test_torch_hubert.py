"""hubert-xlarge in the port against the reference, on the CPU: the frames
input (projection and depthwise positional conv), the bidirectional
encoder stack, the tied output head, the loss and its gradients, the
masked fastest-k train step, the frame stream, and K1's plain versions
at the encoder's head dim 80.

The config is the registry's ``.reduced()`` (d_model 128, 4 heads of 32
over 2, vocab 512) at 2 and 3 layers; parameters come from the
reference's ``Model.init``, with seeded noise on the leaves it makes
zeros or ones (LayerNorm's scale and bias, the conv's bias), and cross
through ``params_from_numpy``. Frames come from the reference's seeded
``make_frame_stream``. Everything is f32 and held within 1e-5 of the
largest value (sums in other orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import make_frame_stream as j_frames
from repro.kernels.flash_attention import attention_ref, flash_attention as pallas_flash
from repro.models import attention as jattn
from repro.models import build_model
from repro.models.model import count_params_analytic as j_count
from repro.optim import optimizers as jopt
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config as port_config
from repro_torch.data import make_frame_stream as t_frames
from repro_torch.kernels import flash_attention, flash_attention_bwd_plain, flash_attention_plain
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import Model, count_params_analytic, params_from_numpy
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.runtime.steps import make_train_step
from repro_torch.serve import ServeEngine
from repro_torch.serve.speculative import DraftRunner
from _noisy import with_noise

ARCH = "hubert-xlarge"
RNG = np.random.default_rng(25)


@functools.lru_cache(maxsize=None)
def _pair(n_layers: int):
    """(reference model, its params with noisy constant leaves, port
    config, the same params bridged to the port on the CPU)."""
    ref = build_model(get_config(ARCH).reduced(n_layers=n_layers))
    tree = with_noise(jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0))), seed=n_layers)
    noise = np.random.default_rng(100 + n_layers).standard_normal(tree["pos_conv_b"].shape)
    tree["pos_conv_b"] = (tree["pos_conv_b"] + 0.1 * noise).astype(np.float32)
    cfg = port_config(ARCH).reduced(n_layers=n_layers)
    return ref, jax.tree.map(jnp.asarray, tree), cfg, params_from_numpy(cfg, tree, device="cpu")


def _frames(cfg, B=4, S=24, seed=0):
    x, labels = j_frames(cfg.d_model, seed=seed)(B, S, cfg.vocab_size)
    return x, labels


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, atol=rel * max(1.0, float(np.abs(ref).max())))


def test_config_and_full_width_parameter_count():
    """The registry entry and alias equal the reference's; the full-width
    parameter tree has the reference's leaves and count (946,272,000)."""
    cfg = port_config(ARCH)
    assert port_config("hubert") == cfg and cfg.is_encoder and cfg.input_kind == "frames"
    assert count_params_analytic(cfg) == j_count(get_config(ARCH)) == 946_272_000
    specs = Model(cfg).param_specs()
    ref_specs = build_model(get_config(ARCH)).param_specs()
    for name in ("frame_proj", "pos_conv_w", "pos_conv_b", "embed", "final_norm"):
        a = tree_leaves(specs[name], is_leaf=lambda s: hasattr(s, "shape"))
        b = jax.tree.leaves(ref_specs[name], is_leaf=lambda s: hasattr(s, "shape"))
        assert sorted((s.shape, s.init) for s in a) == sorted((s.shape, s.init) for s in b), name
    assert "head" not in specs and (80, 80) in HEAD_DIMS


@functools.lru_cache(maxsize=None)
def _ref_forward(n_layers: int):
    """The reference's embed_inputs, hidden and logits, jitted (eager JAX
    compiles each op of a first call on its own, which takes longer)."""
    ref = _pair(n_layers)[0]

    def fwd(params, x):
        h, _ = ref.hidden(params, x, jnp.arange(x.shape[1]))
        return ref.embed_inputs(params, x), h, ref.logits(params, h)

    return jax.jit(fwd)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_embed_hidden_and_logits_match_reference(n_layers):
    ref, jp, cfg, tp = _pair(n_layers)
    model = Model(cfg)
    x, _ = _frames(cfg, seed=n_layers)
    S = x.shape[1]
    with torch.no_grad():
        te = model.embed_inputs(tp, torch.from_numpy(x))
        th, _ = model.hidden(tp, torch.from_numpy(x), torch.arange(S))
        tl = model.logits(tp, th)
    je, jh, jl = _ref_forward(n_layers)(jp, jnp.asarray(x))
    _close(te.numpy(), je)
    _close(th.numpy(), jh)
    _close(tl.numpy(), jl)
    assert tl.shape == (x.shape[0], S, cfg.vocab_size)


def _grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params, is_leaf=torch.is_tensor)
    loss, _ = model.train_loss(p, batch)
    loss.backward()
    return loss, [leaf.grad for leaf in leaves]


@functools.lru_cache(maxsize=None)
def _ref_grad():
    return jax.jit(jax.value_and_grad(_pair(2)[0].train_loss, has_aux=True))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_loss_and_grads_match_jax_grad(remat):
    ref, jp, cfg, tp = _pair(2)
    x, labels = _frames(cfg, seed=7)
    mask = (RNG.random(labels.shape) > 0.2).astype(np.float32)
    jb = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}
    (jloss, _), jgrads = _ref_grad()(jp, jb)
    jg = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads), device="cpu"))
    model = Model(dataclasses.replace(cfg, remat=remat))
    loss, grads = _grads(model, tp, {k: torch.tensor(np.asarray(v)) for k, v in jb.items()})
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
    scale = max(float(np.abs(g.numpy()).max()) for g in jg)
    assert len(grads) == len(jg)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale)
    named = dict(zip([id(p) for p in _leaves(tp)], grads))
    for key in ("frame_proj", "pos_conv_w", "pos_conv_b"):
        assert bool((named[id(tp[key])] != 0).any()), key


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("accum", [1, 2])
def test_masked_fastest_k_train_step_matches_reference(accum, optimizer):
    """One clipped step on frames, 8 workers of 2 rows with 6 of 8
    contributing (k = 6), directly and over two microbatches: loss, grad
    norm, contributors and every updated parameter against the
    reference's ``make_train_step``. SGD's update is the clipped gradient
    times lr: within 1e-5 of the largest weight. AdamW's first step moves
    a weight by about lr wherever its gradient is well above eps and
    repeats the gradients' f32 noise where one is near eps: 1e-4, as
    tests/test_torch_train.py holds it."""
    ref, jp, cfg, tp = _pair(2)
    x, labels = _frames(cfg, B=16, S=16, seed=11)
    wm = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    batch = {"inputs": x, "labels": labels, "worker_mask": wm}
    jo, to = jopt.get_optimizer(optimizer), topt.get_optimizer(optimizer)
    step = jax.jit(j_make_train_step(ref, jo, accum_steps=accum))
    jnew, _, jm = step(jp, jo.init(jp), {**{k: jnp.asarray(v) for k, v in batch.items()},
                                         "lr": jnp.float32(1e-3)})
    tp = tree_map(torch.clone, tp, is_leaf=torch.is_tensor)
    tnew, _, tm = make_train_step(Model(cfg), to, accum_steps=accum)(
        tp, to.init(tp), {**{k: torch.from_numpy(v) for k, v in batch.items()}, "lr": 1e-3})
    for key in ("loss", "grad_norm", "denom", "contributors"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5, abs=1e-6), key
    assert float(tm["contributors"]) == 6.0
    jn = _leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jnew), device="cpu"))
    for a, b in zip(_leaves(tnew), jn):
        atol = 1e-4 if optimizer == "adamw" else 1e-5 * max(1.0, float(np.abs(b.numpy()).max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)


def test_encoder_sees_late_frames():
    """Bidirectional: flipping the last frame changes the first position's
    output, by the same amount in both packages (tests/test_models.py's
    encoder test, twinned)."""
    ref, jp, cfg, tp = _pair(2)
    model = Model(cfg)
    x = RNG.normal(size=(1, 16, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[:, -1] = -x2[:, -1]
    pos = torch.arange(16)
    with torch.no_grad():
        h1, _ = model.hidden(tp, torch.from_numpy(x), pos)
        h2, _ = model.hidden(tp, torch.from_numpy(x2), pos)
    delta = float((h1[:, 0] - h2[:, 0]).abs().max())
    assert delta > 1e-6
    _, j1, _ = _ref_forward(2)(jp, jnp.asarray(x))
    _, j2, _ = _ref_forward(2)(jp, jnp.asarray(x2))
    _close((h1 - h2).numpy(), np.asarray(j1) - np.asarray(j2))


def test_make_frame_stream_bit_for_bit():
    a, b = j_frames(1280, seed=3), t_frames(1280, seed=3)
    for n, s, vocab in ((2, 16, 504), (3, 8, 504), (1, 40, 17)):
        (xa, la), (xb, lb) = a(n, s, vocab), b(n, s, vocab)
        assert xa.dtype == xb.dtype == np.float32 and la.dtype == lb.dtype == np.int32
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


def test_serving_refuses_the_encoder():
    """The reference's refusals, word for word: the engine needs a causal
    decoder, and so does a draft."""
    _, _, cfg, tp = _pair(2)
    model = Model(cfg)
    with pytest.raises(ValueError, match="^serving needs a causal decoder architecture$"):
        ServeEngine(model, tp, n_slots=2, max_len=32)
    with pytest.raises(ValueError, match="^draft model must be a causal decoder$"):
        DraftRunner(model, tp, 2, 32)


#: K1 at the encoder's head dim (D = Dv = 80): causal and not, Sq = Skv
#: ragged (the Pallas kernel's cases have Sq = Skv) for the forward, and
#: Sq != Skv for the backward.
D80_FWD = [(1, 100, 100, 4, 2, 80, 80, False), (2, 64, 64, 2, 2, 80, 80, True)]
D80_BWD = [(2, 77, 100, 4, 4, 80, 80, False), (1, 40, 40, 4, 2, 80, 80, True)]


def _flash_inputs(case):
    B, Sq, Skv, H, Hkv, D, Dv, _ = case
    return [RNG.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv))]


@pytest.mark.parametrize("case", D80_FWD)
def test_flash_plain_at_d80_matches_pallas_and_mea(case):
    causal = case[-1]
    q, k, v = _flash_inputs(case)
    out, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    _close(out.numpy(), pallas_flash(qj, kj, vj, causal=causal, interpret=True), rel=2e-5)
    _close(out.numpy(), attention_ref(qj, kj, vj, causal=causal), rel=2e-5)
    _close(out.numpy(), jattn.mea_attention(qj, kj, vj, causal=causal, chunk=64), rel=2e-5)
    assert lse.shape == (case[0], case[3], case[1])


@pytest.mark.parametrize("case", D80_BWD)
def test_flash_bwd_plain_at_d80_matches_jax_vjp(case):
    causal = case[-1]
    q, k, v = _flash_inputs(case)
    do = RNG.normal(size=(case[0], case[1], case[3], case[6])).astype(np.float32)

    def mea(a, b, c):
        return jattn.mea_attention(a, b, c, causal=causal, chunk=64)

    for fn in (functools.partial(attention_ref, causal=causal), mea):
        ref = jax.jit(lambda a, b, c, d: jax.vjp(fn, a, b, c)[1](d))(
            *map(jnp.asarray, (q, k, v, do)))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        out, lse = flash_attention_plain(tq, tk, tv, causal=causal)
        plain = flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(do),
                                          causal=causal)
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        flash_attention(*leaves, causal=causal).backward(torch.from_numpy(do))
        for r, p, leaf in zip(ref, plain, leaves):
            _close(p.numpy(), r, rel=1e-4)
            _close(leaf.grad.numpy(), r, rel=1e-4)
