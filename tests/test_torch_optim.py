"""The port's optimizers against the reference's, on the CPU: momentum
(plain and Nesterov), AdamW and Adafactor over several steps on a tree
that the reference stacks, the in-place chunked step against ``update``
+ ``apply_updates``, the chunked global norm, and Adafactor's sliced
branch against a numpy statement of the reference's rule.

The reference's tree stacks a segment of three layers along a leading
axis; the port's holds the same values as a list of three dicts
(``stacked_groups`` finds it). A one-layer segment is unstacked in both.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import optimizers as topt

D, F = 160, 192
N_STACK = 3


def _layer_shapes():
    """One layer's leaves: a vector, a factored matrix, a 3-D factored
    leaf (as xLSTM's per-head ``w_h``), and a matrix too narrow to factor;
    keys in sorted order, the order of the reference's tree leaves."""
    return {"b": (40, 12), "norm": {"scale": (D,)}, "w": (D, F), "w_h": (2, 128, 144)}


def _trees(rng, dtype):
    """(reference tree, port tree) of the same values; ``dtype`` of the
    parameters (numpy f32 values, rounded alike on both sides)."""
    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    shapes = _layer_shapes()
    layers = [tree_map(draw, shapes, is_leaf=_is_shape) for _ in range(N_STACK + 1)]
    embed, final = draw((300, D)), draw((D,))
    return _pair({"embed": embed, "stack": [layers[:N_STACK], layers[N_STACK:]],
                  "final": final}, dtype)


def _is_shape(s):
    return isinstance(s, tuple) and all(isinstance(d, int) for d in s)


def _pair(tree, dtype):
    """The reference's stacked tree and the port's tree of ``tree``'s numpy
    values (``stack``: a list of segments, each a list of layer dicts)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    is_np = lambda x: isinstance(x, np.ndarray)   # noqa: E731

    def jarr(a):
        return jnp.asarray(a, jdt)

    segs = []
    for seg in tree["stack"]:
        if len(seg) == 1:
            segs.append(tree_map(jarr, seg[0], is_leaf=is_np))
        else:
            segs.append(tree_map(lambda *xs: jarr(np.stack(xs)), *seg, is_leaf=is_np))
    ref = {"embed": jarr(tree["embed"]), "stack": segs, "final": jarr(tree["final"])}
    port = tree_map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree, is_leaf=is_np)
    return ref, port


def _grads(rng, step):
    """Gradients of one step as a numpy tree in the port's layout: layer 0
    of the stacked segment gets 8x larger gradients at step 2, so that its
    Adafactor RMS alone would clip while the pooled one clips less."""
    shapes = _layer_shapes()
    tree = {"embed": rng.standard_normal((300, D)).astype(np.float32),
            "stack": [[tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                                is_leaf=_is_shape) for _ in range(n)] for n in (N_STACK, 1)],
            "final": rng.standard_normal((D,)).astype(np.float32)}
    if step == 2:
        tree["stack"][0][0] = tree_map(lambda a: 8 * a, tree["stack"][0][0],
                                       is_leaf=lambda x: isinstance(x, np.ndarray))
    return tree


def _port_leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _ref_as_port(ref_tree):
    """The reference's stacked tree as numpy leaves in the port's order."""
    out = [np.asarray(ref_tree["embed"], np.float32)]
    for seg, n in zip(ref_tree["stack"], (N_STACK, 1)):
        leaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(seg)]
        for j in range(n):
            out += [a[j] if n > 1 else a for a in leaves]
    out.append(np.asarray(ref_tree["final"], np.float32))
    return out


def _run(name, dtype, kw, steps=3, lr=0.05, pooled=True):
    """``steps`` updates of both packages from the same values -> (the
    reference's parameters, the port's) as lists of numpy leaves. Without
    ``pooled`` the port's stacked segment is handed over as a dict of
    layers, which ``stacked_groups`` does not pool."""
    rng = np.random.default_rng(3)
    jp, tp = _trees(rng, dtype)
    if not pooled:
        tp["stack"][0] = {str(j): layer for j, layer in enumerate(tp["stack"][0])}
    jo, to = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
    js, ts = jo.init(jp), to.init(tp)
    for t in range(steps):
        g = _grads(rng, t)
        jg, tg = _pair(g, dtype)
        if not pooled:
            tg["stack"][0] = {str(j): layer for j, layer in enumerate(tg["stack"][0])}
        ju, js = jo.update(jg, js, jp, jnp.float32(lr))
        tu, ts = to.update(tg, ts, tp, lr)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    return _ref_as_port(jp), [x.float().numpy() for x in _port_leaves(tp)]


OPTIMIZERS = [("momentum", {}), ("momentum", {"nesterov": True}), ("adamw", {}),
              ("adafactor", {})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=["momentum", "nesterov", "adamw",
                                                     "adafactor"])
def test_updates_match_reference_on_a_stacked_tree(name, kw, dtype):
    """Three steps: f32 parameters within 1e-6 of the largest |p| of the
    leaf; bf16 ones within one bf16 step of |p| (an f32 update that
    differs in its last bit may round the sum the other way)."""
    want, got = _run(name, dtype, kw)
    assert len(want) == len(got)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(1.0, np.abs(b).max()))
        else:
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)


def test_adafactor_per_layer_rms_fails_the_stacked_tree():
    """The RMS clip pools over a stacked segment's layers: handed the same
    layers unpooled, the port's update departs from the reference's by far
    more than the pooled one (layer 0's gradients jump at step 2)."""
    want, pooled = _run("adafactor", torch.float32, {})
    _, alone = _run("adafactor", torch.float32, {}, pooled=False)
    err_pooled = max(float(np.abs(a - b).max()) for a, b in zip(pooled, want))
    err_alone = max(float(np.abs(a - b).max()) for a, b in zip(alone, want))
    assert err_pooled < 1e-6
    assert err_alone > 1e-3, err_alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS + [("sgd", {})],
                         ids=["momentum", "nesterov", "adamw", "adafactor", "sgd"])
def test_in_place_step_equals_update_and_apply(name, kw, dtype, monkeypatch):
    """``step`` (clip scale, state, update, add, a chunk at a time) equals
    clipping, ``update`` and ``apply_updates`` bit for bit over three
    steps, with chunks small enough to cut leaves into runs of matrices
    and rows; the chunked norm is within f32 rounding of ``global_norm``."""
    monkeypatch.setattr(topt, "CHUNK_ELEMS", 5000)
    torch.set_num_threads(1)
    rng = np.random.default_rng(4)
    _, tp = _trees(rng, dtype)
    tq = tree_map(torch.clone, tp, is_leaf=torch.is_tensor)
    opt = topt.get_optimizer(name, **kw)
    sa, sb = opt.init(tp), opt.init(tq)
    for t in range(3):
        _, g = _pair(_grads(rng, t), dtype)
        norm = topt.chunked_global_norm(g)
        assert float(norm) == pytest.approx(float(topt.global_norm(g)), rel=1e-6)
        scale = topt.clip_scale(norm, 10.0)
        assert float(scale) < 1.0
        upd, sa = opt.update(tree_map(lambda x: (x.float() * scale).to(x.dtype), g,
                                      is_leaf=torch.is_tensor), sa, tp, 0.05)
        tp = topt.apply_updates(tp, upd)
        sb = opt.step(g, sb, tq, 0.05, scale)
    for a, b in zip(_port_leaves(tp), _port_leaves(tq)):
        assert torch.equal(a, b)
    for a, b in zip(_port_leaves(sa), _port_leaves(sb)):
        assert torch.equal(a, b)
    tree_step = topt.tree_step(opt.update)
    tr = tree_map(torch.clone, tq, is_leaf=torch.is_tensor)
    sc = tree_map(torch.clone, sb, is_leaf=torch.is_tensor)
    _, g = _pair(_grads(rng, 3), dtype)
    opt.step(g, sb, tq, 0.05, scale)
    tree_step(g, sc, tr, 0.05, scale)
    for a, b in zip(_port_leaves(tq), _port_leaves(tr)):
        assert torch.equal(a, b)


def test_stacked_groups():
    _, tp = _trees(np.random.default_rng(0), torch.float32)
    groups = topt.stacked_groups(tp)
    n = len(tree_leaves(_layer_shapes(), is_leaf=_is_shape))
    assert groups[0] == [0]
    assert groups[1:1 + n] == [[1 + k, 1 + n + k, 1 + 2 * n + k] for k in range(n)]
    assert groups[1 + n:] == [[i] for i in range(1 + 3 * n, 2 + 4 * n)]
    assert sorted(i for g in groups for i in g) == list(range(len(_port_leaves(tp))))


def _numpy_adafactor(p, g, row, col, t, lr, dtype, decay=0.8, eps=1e-30):
    """The reference's sliced branch on one reference leaf, in numpy f32:
    each slice along the leading axis is a factored matrix stack with its
    own RMS, its update rounded to ``dtype`` before the learning rate."""
    f32 = np.float32
    beta = f32(1) - f32(t) ** f32(-decay)
    new_p, new_row, new_col = [], [], []
    for s in range(p.shape[0]):
        gf = g[s].astype(f32)
        g2 = gf * gf + f32(eps)
        r_ = beta * row[s] + (f32(1) - beta) * g2.mean(-1)
        c_ = beta * col[s] + (f32(1) - beta) * g2.mean(-2)
        r = r_ / np.maximum(r_.mean(-1, keepdims=True), f32(eps))
        u = gf / np.sqrt(np.maximum(r[..., None] * c_[..., None, :], f32(eps)))
        u = u / max(f32(1), np.sqrt(np.mean(u * u)))
        u = torch.from_numpy(u).to(dtype).float().numpy()
        new_p.append(torch.from_numpy(p[s]).to(dtype) + torch.from_numpy(-f32(lr) * u).to(dtype))
        new_row.append(r_)
        new_col.append(c_)
    return torch.stack(new_p), np.stack(new_row), np.stack(new_col)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adafactor_sliced_branch(dtype, monkeypatch):
    """At a lowered ``MAP_ELEMS``: an unstacked (E, R, C) leaf goes expert
    by expert, a stacked two-layer group layer by layer, each slice with
    its own RMS and its update rounded to the parameter's dtype; three
    steps against the numpy statement (the update's RMS is a sum in
    another order: within 1e-6 of |p| in f32; in bf16 one bf16 step of
    |p|, plus a flipped rounding of u (2^-8 |u|, |u| <= 2) times lr a
    step)."""
    monkeypatch.setattr(topt, "MAP_ELEMS", 2 ** 16)
    rng = np.random.default_rng(6)
    E, R, C = 3, 160, 144
    leaves = [rng.standard_normal((E, R, C)).astype(np.float32) for _ in range(3)]
    tp = {"experts": torch.from_numpy(leaves[0]).to(dtype),
          "stack": [{"w": torch.from_numpy(leaves[1]).to(dtype)},
                    {"w": torch.from_numpy(leaves[2]).to(dtype)}]}
    opt = topt.adafactor()
    state = opt.init(tp)
    # numpy: the unstacked leaf is sliced over E, the stacked (2, E, R, C)
    # leaf over its 2 layers.
    ref_p = [tp["experts"].float().numpy().copy(),
             torch.stack([tp["stack"][0]["w"], tp["stack"][1]["w"]]).float().numpy()]
    ref_row = [np.zeros((E, R), np.float32), np.zeros((2, E, R), np.float32)]
    ref_col = [np.zeros((E, C), np.float32), np.zeros((2, E, C), np.float32)]
    for t in range(1, 4):
        g = [rng.standard_normal((E, R, C)).astype(np.float32) * (1 + t) for _ in range(3)]
        tg = {"experts": torch.from_numpy(g[0]).to(dtype),
              "stack": [{"w": torch.from_numpy(g[1]).to(dtype)},
                        {"w": torch.from_numpy(g[2]).to(dtype)}]}
        gn = [tg["experts"].float().numpy(),
              torch.stack([tg["stack"][0]["w"], tg["stack"][1]["w"]]).float().numpy()]
        state = opt.step(tg, state, tp, 0.05)
        for i in range(2):
            newp, ref_row[i], ref_col[i] = _numpy_adafactor(
                ref_p[i], gn[i], ref_row[i], ref_col[i], t, 0.05, dtype)
            ref_p[i] = newp.float().numpy()
    got = [tp["experts"].float().numpy(),
           torch.stack([tp["stack"][0]["w"], tp["stack"][1]["w"]]).float().numpy()]
    rows = [state["states"]["experts"]["row"].numpy(),
            np.stack([s["w"]["row"].numpy() for s in state["states"]["stack"]])]
    for a, b in zip(got, ref_p):
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=3 * 0.05 * 2 * 2 ** -8)
    for a, b in zip(rows, ref_row):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_get_optimizer_names():
    for name in ("sgd", "momentum", "adamw", "adafactor"):
        opt = topt.get_optimizer(name)
        assert callable(opt.init) and callable(opt.update) and callable(opt.step)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("lion")
