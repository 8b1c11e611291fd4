"""The port's sharding rules against the reference's, in one process: the
PartitionSpecs of every registry config's parameters and caches, batch
specs, the shape presets, the block of a global array each rank holds
(against jax's own placement on the 8 forced CPU devices), and the
single-device step builders the dry run uses."""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.dist.sharding as jsh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_status as ref_cell_status
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.models import build_model
from repro_torch.configs import SHAPES, cell_status, get_config
from repro_torch.dist import sharding as tsh
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import get_optimizer
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime.steps import make_decode_step, make_init_fn, make_prefill_step


class Stub:
    """A mesh stand-in: only ``shape`` (axis -> size), as the reference's
    tests use."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = [Stub(data=16, model=16), Stub(pod=2, data=16, model=16), Stub(data=4, model=2)]
RULE_SETS = ["DEFAULT_RULES", "FSDP_POD_RULES", "SP_DECODE_RULES", "PURE_DP_RULES"]


def _port_rules(ref_rules):
    return tsh.ShardingRules(**dataclasses.asdict(ref_rules))


def _spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))


def test_rule_sets_equal_reference():
    for name in RULE_SETS:
        assert dataclasses.asdict(getattr(tsh, name)) == dataclasses.asdict(getattr(jsh, name))
    assert [f.name for f in dataclasses.fields(tsh.ShardingRules)] == \
        [f.name for f in dataclasses.fields(jsh.ShardingRules)]


@pytest.mark.parametrize("arch", list_archs())
def test_logical_to_pspec_equals_reference(arch):
    """Every parameter and cache leaf of both packages' full-width spec
    trees, on three meshes, under the four rule sets and the dry run's
    deepseek override (``src/repro/launch/dryrun.py:61-62``)."""
    rule_sets = [getattr(jsh, n) for n in RULE_SETS]
    if arch.startswith("deepseek"):
        rule_sets += [jsh.DEFAULT_RULES.replace(embed=("pod", "data")),
                      jsh.DEFAULT_RULES.replace(embed=("pod", "data"), act_kv_seq="model")]
    ref, port = build_model(ref_config(arch)), Model(get_config(arch))
    specs = (_spec_leaves(ref.param_specs()) + _spec_leaves(ref.cache_specs(4, 64))
             + tree_leaves(port.param_specs()) + tree_leaves(port.cache_specs(4, 64)))
    assert len(specs) > 10
    for mesh in MESHES:
        for rules in rule_sets:
            prules = _port_rules(rules)
            for s in specs:
                want = jsh.logical_to_pspec(s.axes, s.shape, mesh, rules)
                got = tsh.logical_to_pspec(s.axes, s.shape, mesh, prules)
                assert isinstance(got, tsh.PartitionSpec)
                assert tuple(got) == tuple(want), (arch, s, mesh.shape)


@pytest.mark.parametrize("dp", [None, ("pod", "data", "model")])
def test_batch_pspec_equals_reference(dp):
    for mesh in MESHES:
        for batch in range(1, 65):
            for trailing in (0, 2):
                want = jsh.batch_pspec(mesh, batch, trailing, dp_axes=dp)
                got = tsh.batch_pspec(mesh, batch, trailing, dp_axes=dp)
                assert tuple(got) == tuple(want), (mesh.shape, batch, trailing)


@pytest.mark.parametrize("arch", list_archs())
def test_shapes_and_cell_status_equal_reference(arch):
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for shape in REF_SHAPES:
        assert cell_status(get_config(arch), shape) == ref_cell_status(ref_config(arch), shape)


def test_activation_context_resolves_like_reference():
    for mesh in MESHES:
        for kw in ({}, {"dp_axes": ("pod", "data", "model")}, {"dp_axes": ("model",)}):
            with jsh.activation_sharding(mesh, **kw):
                want = jsh._ACT_CTX.get().dp
            with tsh.activation_sharding(mesh, **kw):
                assert tsh.current_context().dp == want
                assert tsh.current_split() is None
            assert tsh.current_context() is None


SPECS = [(), ("data",), ("model", "data"), ("data", "model"), (None, "data"),
         (("data", "model"),), (("model", "data"),), (None, ("model", "data")),
         ("model", None, "data")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_slices_equal_jax_placement(spec):
    """The block ``shard_slices`` gives each mesh coordinate is the block
    jax puts on that device of a (4, 2) mesh over the 8 CPU devices."""
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    shape = (16, 8, 24) if len(spec) == 3 else (16, 24)
    x = jax.device_put(jnp.zeros(shape), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(*spec)))
    coords = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    stub = Stub(data=4, model=2)
    for shard in x.addressable_shards:
        got = tsh.shard_slices(shape, tsh.PartitionSpec(*spec), stub, coords[shard.device.id])
        want = tuple(range(*sl.indices(n)) for sl, n in zip(shard.index, shape))
        assert tuple(range(*sl.indices(n)) for sl, n in zip(got, shape)) == want


def test_placements_and_out_of_order_tuples():
    stub = Stub(pod=2, data=4, model=2)
    P = tsh.PartitionSpec
    assert tsh.NamedSharding(stub, P("model", ("pod", "data"))).placements == \
        (Shard(1), Shard(1), Shard(0))
    assert tsh.NamedSharding(stub, P(None, "data")).placements == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="not in mesh order"):
        tsh.NamedSharding(stub, P(("data", "pod"))).placements


def test_constraints_pass_plain_tensors_through():
    x = torch.ones(8, 4)
    assert tsh.constrain_batch(x) is x
    with tsh.activation_sharding(Stub(data=4, model=2)):
        assert tsh.constrain_batch(x) is x
        assert tsh.constrain_logical(x, ("act_batch", "embed")) is x
        assert tsh.split_sum(x) is x


def test_single_device_step_builders():
    """``make_prefill_step`` (``Model.prefill``) against the reference's
    prefill logits, ``make_decode_step`` as ``Model.decode_step``, and
    ``make_init_fn`` as ``Model.init`` + ``optimizer.init``."""
    ref = build_model(ref_config("smollm-135m").reduced())
    cfg = get_config("smollm-135m").reduced()
    jp = ref.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    model = Model(cfg)
    got = make_prefill_step(model)(tp, torch.from_numpy(ids))
    want = np.asarray(ref.prefill(jp, jnp.asarray(ids)))
    assert got.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    caches = model.blank_caches(2, 16, device="cpu")
    tok, pos = torch.from_numpy(ids[:, :1]), torch.zeros(2, dtype=torch.int32)
    a, _ = make_decode_step(model)(tp, tok, caches, pos)
    with torch.no_grad():
        b, _ = model.decode_step(tp, tok, model.blank_caches(2, 16, device="cpu"), pos)
    assert torch.equal(a, b)

    opt = get_optimizer("adamw")
    params, state = make_init_fn(model, opt, device="cpu")(7)
    for x, y in zip(tree_leaves(params, is_leaf=torch.is_tensor),
                    tree_leaves(model.init(7, device="cpu"), is_leaf=torch.is_tensor)):
        assert torch.equal(x, y)
    assert int(state["step"]) == 0


def test_restore_places_leaves_through_device_put_fn(tmp_path):
    """``restore(..., device_put_fn)``, the reference's elastic-restart
    hook, places each full host leaf; without it a plain leaf lands on
    its ``like`` leaf's device with the stored bits."""
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "n": [torch.ones(2)]}
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree)
    seen = []
    got, _ = mgr.restore(3, tree, device_put_fn=lambda t, like: seen.append(like) or t * 2)
    assert torch.equal(got["w"], tree["w"] * 2) and torch.equal(got["n"][0], tree["n"][0] * 2)
    assert seen[0] is tree["w"] and seen[1] is tree["n"][0]
    step, plain, _ = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(plain["w"], tree["w"])
