"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the CPU.

Router and expert weights come from the reference's ``moe_specs`` drawn
by seeded numpy; tokens too. The routing must agree exactly (the same
experts, weights within f32 rounding); the dispatch and combine within
1e-5 in f32 (the K contributions are summed in x's dtype, in choice
order); gradients against ``jax.grad`` within 1e-5 of the largest.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config
from repro_torch.configs import get_config as port_config
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-30b-a3b"


def _cfgs(**moe_over):
    """(reference cfg, port cfg): qwen3-moe reduced (8 experts, top 2, d 128)."""
    out = []
    for get in (get_config, port_config):
        cfg = get(ARCH).reduced()
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over)))
    return out


def _params(cfg, seed=0, router_bias=0.0):
    """numpy MoE params: N(0, 1/sqrt(fan_in)) for every leaf; ``router_bias``
    is added to expert 0's router column (with nonnegative tokens, that
    crowds expert 0 past its capacity)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jmoe.moe_specs(cfg).items():
        if isinstance(spec, dict):
            out[name] = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2]))
                         .astype(np.float32) for k, s in spec.items()}
        else:
            out[name] = (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[-2])
                         ).astype(np.float32)
    out["router"][:, 0] += router_bias
    return out


def _x(cfg, B=3, S=10, seed=1, crowd=False):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return np.abs(x) if crowd else x


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed):
    """Experts equal, weights within f32 rounding, the Switch aux loss
    within 1e-6 relative."""
    jcfg, tcfg = _cfgs()
    p = _params(jcfg, seed)
    x = _x(jcfg, seed=seed + 10).reshape(-1, jcfg.d_model)
    jw, je, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), jcfg.moe)
    tw, te, taux = tmoe.route(torch.from_numpy(x), torch.from_numpy(p["router"]), tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("case", ["dropless", "capacity", "crowded", "shared"])
def test_moe_apply_matches_reference_and_grouped_is_flat(case):
    """Dropless (C = T), capacity-dropped (C = 1.25 T K / E) and crowded
    (expert 0 favoured by every token, so most of its choices are
    dropped and the stable sort decides which stay), and with a shared
    expert. The reference's grouped dispatch at one group equals its
    flat one, and the port's equals the reference's within 1e-5; the
    port's modes are one computation, bit for bit."""
    over = {"dropless": dict(dropless=True), "capacity": {}, "crowded": {},
            "shared": dict(n_shared_experts=1, d_shared=64)}[case]
    jcfg, tcfg = _cfgs(**over)
    crowd = case == "crowded"
    p = _params(jcfg, router_bias=0.5 if crowd else 0.0)
    x = _x(jcfg, crowd=crowd)
    jout, jaux = jmoe.moe_apply(_j(p), jnp.asarray(x), jcfg)
    gcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch="grouped"))
    gout, gaux = jmoe.moe_apply(_j(p), jnp.asarray(x), gcfg)
    np.testing.assert_array_equal(np.asarray(gout), np.asarray(jout))
    assert float(gaux) == float(jaux)
    outs = {}
    for mode in tmoe.DISPATCH_MODES:
        cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, dispatch=mode))
        outs[mode] = tmoe.moe_apply(_t(p), torch.from_numpy(x), cfg)
    tout, taux = outs["data"]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    for mode, (o, a) in outs.items():
        assert torch.equal(o, tout) and torch.equal(a, taux), mode
    if crowd:
        # Every token chose expert 0, whose capacity keeps the first
        # C = 9 of 30 in token order: the rest differ from dropless.
        _, dcfg = _cfgs(dropless=True)
        dout, _ = tmoe.moe_apply(_t(p), torch.from_numpy(x), dcfg)
        lost = (dout - tout).abs().amax(-1).gt(1e-3).reshape(-1)
        C = tmoe.moe_capacity(tcfg.moe, lost.numel())
        assert not lost[:C].any() and lost[C:].all()


def test_moe_grads_match_reference():
    """d(sum(out * g) + aux) / d(x, router, w_in, w_gate, w_out) against
    ``jax.grad``, capacity-dropped, within 1e-5 of each leaf's largest."""
    jcfg, tcfg = _cfgs()
    p, x = _params(jcfg, seed=4), _x(jcfg, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(params, x):
        out, aux = jmoe.moe_apply(params, x, jcfg)
        return jnp.sum(out * g) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tp, tx, tcfg)
    (torch.sum(out * torch.from_numpy(g)) + aux).backward()
    for name, leaf in tp.items():
        want = np.asarray(jgp[name])
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())


def test_dropless_output_is_token_local():
    """With dropless routing a token's output does not depend on the
    other tokens of its chunk: the whole (B, S) chunk equals each row
    alone and each half of each row, within f32 rounding of the expert
    products' other row counts."""
    _, tcfg = _cfgs(dropless=True)
    p, x = _t(_params(tcfg, seed=7)), torch.from_numpy(_x(tcfg, seed=8))
    whole, _ = tmoe.moe_apply(p, x, tcfg)
    for b in range(x.shape[0]):
        for lo, hi in ((0, 4), (4, x.shape[1])):
            part, _ = tmoe.moe_apply(p, x[b:b + 1, lo:hi], tcfg)
            torch.testing.assert_close(part[0], whole[b, lo:hi], atol=1e-6, rtol=0)


def test_capacity_matches_reference():
    for over in ({}, dict(dropless=True), dict(capacity_factor=2.0)):
        jcfg, tcfg = _cfgs(**over)
        for T in (1, 4, 7, 64, 1000):
            assert tmoe.moe_capacity(tcfg.moe, T) == jmoe.moe_capacity(jcfg.moe, T)
