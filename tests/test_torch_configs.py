"""The registry's other GQA decoders in the port, against the reference on
the CPU: qwen2.5-3b (q/k/v bias), command-r-35b (LayerNorm, the parallel
attention + FFN block, logit scale), chameleon-34b (qk-norm, untied
head) and qwen3-moe-30b-a3b (top-k MoE, qk-norm).

Each runs reduced (2 layers, d 128, f32; qwen3-moe with 8 experts top 2)
from the reference's ``Model.init`` with seeded noise on its bias and
norm leaves (``tests/_noisy.py``). Prefill, decode and gradients are
held in ``test_torch_model.py`` and ``test_torch_train.py``; here: the
full-width parameter counts, LayerNorm, the serving engine over both
pools, and selective remat.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.layers as jlayers
from repro.configs import get_config
from repro.models import build_model
from repro.models.model import count_params_analytic as ref_count
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, count_params_analytic, params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serve import Scheduler, ServeEngine, generate_offline
from _noisy import NOISY_ARCHS, noisy_pair

#: count_params_analytic of every ported config at full width (spec
#: counting, no allocation), as the reference counts it.
FULL_WIDTH_PARAMS = {
    "qwen2.5-3b": 3_085_938_688,
    "command-r-35b": 30_283_546_624,
    "chameleon-34b": 34_293_436_416,
    "qwen3-moe-30b-a3b": 30_532_122_624,
    "llama3.2-1b": 1_235_814_400,
    "smollm-135m": 134_515_008,
    "zamba2-1.2b": 1_225_003_904,
    "deepseek-v3-671b": 671_712_655_360,
    "xlstm-125m": 155_646_800,
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_full_width_param_count_equals_reference(name):
    n = count_params_analytic(port_config(name))
    assert n == ref_count(get_config(name)) == FULL_WIDTH_PARAMS[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_reference(dtype, bias):
    """f32: within 1e-6 (the mean and variance summed in other orders).
    bf16: the normalized row rounds once to bf16 before the affine, as
    the reference rounds it; an order difference may flip that rounding,
    by one bf16 step of the value (2^-8 relative, doubled through the
    affine's own roundings)."""
    rng = np.random.default_rng(3)
    D = 96
    x = (3.0 + 2.0 * rng.standard_normal((4, 7, D))).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32) if bias else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jlayers.layer_norm(
        jnp.asarray(x, jd), jnp.asarray(scale, jd),
        None if b is None else jnp.asarray(b, jd)).astype(jnp.float32))
    got = tlayers.layer_norm(
        torch.from_numpy(x).to(td), torch.from_numpy(scale).to(td),
        None if b is None else torch.from_numpy(b).to(td)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=2.0 ** -7)
        assert (got == want).mean() > 0.99


def _workload(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(1, 10)), i * 0.004) for i in range(n)]


@pytest.mark.parametrize("arch", NOISY_ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_offline_and_reference_engine(arch, paged):
    """ServeEngine, 3 slots for 5 staggered requests, prefill chunks of 8
    (paged: block 8 on 10 blocks, so admissions queue on the arena):
    each stream equals the port's offline decode and the reference
    engine's, and the scheduling events are equal. qwen3-moe routes
    dropless, as serving must (capacity-dropped routing depends on the
    chunk's other tokens)."""
    ref, jp, cfg, tp = noisy_pair(arch, dropless=get_config(arch).moe is not None)
    model = Model(cfg)
    max_len = 40
    kw = dict(block_size=8, arena_blocks=10) if paged else {}
    reqs = _workload(cfg.vocab_size)
    eng = ServeEngine(model, tp, n_slots=3, max_len=max_len,
                      scheduler=Scheduler(3, prefill_chunk=8, decode_per_prefill=2), **kw)
    ref_eng = RefEngine(ref, jp, n_slots=3, max_len=max_len,
                        scheduler=RefScheduler(3, prefill_chunk=8, decode_per_prefill=2), **kw)
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    ref_rids = [ref_eng.submit(p, m, arrival=a) for p, m, a in reqs]
    results, ref_results = eng.run(), ref_eng.run()
    for rid, ref_rid, (p, m, _) in zip(rids, ref_rids, reqs):
        tokens = results[rid].tokens
        assert len(tokens) == m
        assert tokens == ref_results[ref_rid].tokens, rid
        assert tokens == generate_offline(model, tp, p, m, max_len), rid
    assert eng.events == ref_eng.events
    if paged:
        eng.pool.manager.check()


class _Products(TorchDispatchMode):
    """Counts matrix products without batch dimensions (``aten.mm``, and
    ``aten.bmm`` over a batch of 1) while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.mm.default or (
                func == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads_and_backward_products(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params, is_leaf=torch.is_tensor)]
    it = iter(leaves)
    loss, _ = model.train_loss(tree_map(lambda _: next(it), params, is_leaf=torch.is_tensor),
                               batch)
    mode = _Products()
    with mode:
        loss.backward()
    return [leaf.grad for leaf in leaves], mode.n


@pytest.mark.parametrize("arch", NOISY_ARCHS)
def test_selective_remat(arch):
    """``remat="selective"`` gives the gradients of ``"none"`` bit for bit
    and the reference's ``"selective"`` (``jax.grad``) within 1e-5 of the
    largest; its backward pass runs exactly the unbatched products of
    ``"none"``'s (none of the saved forward projections is recomputed),
    while ``"full"``'s recomputes them."""
    ref, jp, cfg, tp = noisy_pair(arch)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, size=(3, 17)).astype(np.int32)
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:],
             "mask": (rng.random((3, 16)) > 0.2).astype(np.float32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {r: _grads_and_backward_products(Model(dataclasses.replace(cfg, remat=r)), tp, tb)
           for r in ("none", "selective", "full")}
    for a, b in zip(got["none"][0], got["selective"][0]):
        assert torch.equal(a, b)
    assert got["selective"][1] == got["none"][1] < got["full"][1]

    jref = build_model(dataclasses.replace(ref.cfg, remat="selective"))
    jg = jax.grad(lambda p: jref.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]
                  )(jp)
    want = tree_leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jg), device="cpu"),
                       is_leaf=torch.is_tensor)
    scale = max(float(w.abs().max()) for w in want)
    assert len(want) == len(got["selective"][0])
    for a, w in zip(got["selective"][0], want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5 * scale)


def test_unported_families_raise():
    """A family the port does not build (one the reference has no plan
    for either) raises instead of running something else; the audio
    encoder family builds its encoder stack. An MoE config with MLA builds deepseek's
    plan (MLA dense, then MLA MoE). The MTP loss is ported: a GQA MoE with
    an MTP head (a dense block, as the reference's) trains with the term
    in its loss."""
    from repro_torch.configs.base import MLAConfig, MoEConfig
    cfg = port_config("qwen3-moe-30b-a3b").reduced()
    mla = Model(dataclasses.replace(cfg, mla=MLAConfig(), moe=dataclasses.replace(
        cfg.moe, first_k_dense=1), n_layers=3))
    assert [(s.kind, s.count) for s in mla.segments] == [("mla_dense", 1), ("mla_moe", 2)]
    with pytest.raises(ValueError, match="speech"):
        Model(dataclasses.replace(cfg, family="speech"))
    enc = Model(dataclasses.replace(cfg, family="audio", moe=None))
    assert [(s.kind, s.count) for s in enc.segments] == [("encoder", cfg.n_layers)]
    with pytest.raises(ValueError, match="layernorm|norm"):
        tlayers.norm_specs(8, "batchnorm", "float32")
    assert collections.Counter(s.kind for s in Model(cfg).segments) == {"moe": 1}
    mtp = Model(dataclasses.replace(cfg, mtp=True))
    assert mtp.mtp_kind == "dense"
    ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss, metrics = mtp.train_loss(mtp.init(0, device="cpu"),
                                       {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
    assert set(metrics) == {"ce", "aux", "mtp", "loss"} and bool(torch.isfinite(loss))
    expect = metrics["ce"] + cfg.moe.router_aux_weight * metrics["aux"] + 0.3 * metrics["mtp"]
    assert torch.allclose(loss, expect)
    dense_first = dataclasses.replace(cfg, moe=MoEConfig(8, 2, 64, first_k_dense=1))
    assert [(s.kind, s.count) for s in Model(dense_first).segments] == [("dense", 1), ("moe", 1)]
