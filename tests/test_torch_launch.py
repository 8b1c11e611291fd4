"""The port's dry run (``repro_torch.launch``) against the reference's:
the stand-ins of every registry config x shape on both production meshes
(shape, dtype and PartitionSpec of every input, parameter and optimizer
leaf), the policy functions, the artifact's schema, op_cost's FLOPs
against ``analyze_hlo`` on the same reduced cells, and ``dryrun_cell``
on a (4, 2) test mesh and on one production cell.

The reference runs in a subprocess with 512 forced host devices and the
port in subprocesses of their own on a fake process group
(``tests/_torch_launch_specs.py``): neither a 512-device jax nor a fake
default group may stay alive in a pytest worker beside other tests."""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo_cost import analyze_hlo
from repro.configs import get_config as ref_config
from repro.models import build_model
from repro.optim.optimizers import get_optimizer as ref_optimizer
from repro.runtime.steps import make_decode_step as ref_decode_step
from repro.runtime.steps import make_train_step as ref_train_step
from repro_torch.analysis.op_cost import counting
from repro_torch.configs import SHAPES, cell_status, get_config, list_archs
from repro_torch.launch import dryrun as dr
from repro_torch.launch.specs import abstract_state
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from repro_torch.runtime.steps import make_decode_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "_torch_launch_specs.py"
MESHES = ("pod16x16", "pod2x16x16")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))


def _run(args, timeout=300):
    res = subprocess.run([sys.executable, *args], env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """{"ref": ..., "pod16x16": ..., "pod2x16x16": ...}: each side's stand-ins."""
    d = tmp_path_factory.mktemp("specs")
    procs = {"ref": ["ref", str(d / "ref.json")]}
    procs.update({m: ["port", m, str(d / f"{m}.json")] for m in MESHES})
    running = {k: subprocess.Popen([sys.executable, str(HELPER), *a], env=_env(), cwd=ROOT,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
               for k, a in procs.items()}
    out = {}
    for k, p in running.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        out[k] = json.loads((d / f"{'ref' if k == 'ref' else k}.json").read_text())
    return out


def _is_leaf(t):
    return isinstance(t, dict) and "spec" in t


def _unstack(tree, n):
    """The reference's stacked subtree as ``n`` per-layer subtrees (the
    leading "layers" entry of each spec must be unsharded)."""
    def one(t, i):
        if _is_leaf(t):
            spec = t["spec"]
            assert not spec or spec[0] is None, ("a stacked leaf sharded over its layers", t)
            rest = list(spec[1:]) if spec else []
            while rest and rest[-1] is None:
                rest.pop()
            out = dict(t, spec=rest)
            if "shape" in t:
                out["shape"] = t["shape"][1:]
            return out
        if isinstance(t, dict):
            return {k: one(v, i) for k, v in t.items()}
        return [one(v, i) for v in t]
    return [one(tree, i) for i in range(n)]


def _segments(model, stack):
    return [[t] if seg.count == 1 else _unstack(t, seg.count)
            for seg, t in zip(model.segments, stack)]


def _as_port(arch, tree):
    """A reference parameter-shaped tree (params, a moment, Adafactor's
    states or their own specs) in the port's per-layer structure, as
    ``repro_torch.models.bridge`` carries values."""
    model = Model(get_config(arch))
    tree = dict(tree)
    if model.is_hybrid:
        stack = dict(tree["stack"])
        stack["mamba"] = _unstack(stack["mamba"], model.cfg.n_layers)
    else:
        stack = _segments(model, tree["stack"])
    tree["stack"] = stack
    return tree


def _inputs_as_port(arch, inputs):
    """The reference's decode caches (one stacked tree a segment) per layer;
    the hybrid's cache tree is stacked alike in both packages."""
    model = Model(get_config(arch))
    if "caches" not in inputs or model.is_hybrid:
        return inputs
    return dict(inputs, caches=_segments(model, inputs["caches"]))


def _leaves(tree, path=()):
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _same_leaves(got, want, what):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), (what, sorted(map(str, set(g) ^ set(w)))[:5])
    return [(p, g[p], w[p]) for p in w]


def _cells(arch, mesh):
    cfg = get_config(arch)
    return [f"{cfg.name}__{s}__{mesh}" for s in SHAPES if cell_status(cfg, s) is None]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_inputs_and_params_match_the_reference(dumps, arch, mesh):
    """Every input stand-in and parameter leaf: shape, dtype and
    PartitionSpec exactly (``lr`` is a host float in the port: the step
    reads it with ``float``)."""
    for cell in _cells(arch, mesh):
        ref, port = dumps["ref"][cell], dumps[mesh][cell]
        for path, g, w in _same_leaves(port["inputs"], _inputs_as_port(arch, ref["inputs"]),
                                       (cell, "inputs")):
            if path == ("lr",):
                assert (g["dtype"], w["dtype"], w["shape"]) == ("float", "float32", [])
                continue
            assert g == w, (cell, path)
        for path, g, w in _same_leaves(port["params"], _as_port(arch, ref["params"]),
                                       (cell, "params")):
            assert g == w, (cell, path)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_optimizer_state_matches_the_reference(dumps, arch, mesh):
    """Every optimizer-state leaf of the train cell: shape and dtype; the
    spec is the one the reference's shape-matching attach gives wherever
    that attach lands on the leaf's own parameter's spec (and the own
    spec elsewhere: the cases printed are reference-side facts)."""
    cell = f"{get_config(arch).name}__train_4k__{mesh}"
    ref, port = dumps["ref"][cell], dumps[mesh][cell]
    want, own = dict(ref["opt_state"]), dict(ref["opt_own"])
    for k in want:
        if k != "step":
            want[k], own[k] = _as_port(arch, want[k]), _as_port(arch, own[k])
    owns = {p: o["spec"] for p, o in _leaves(own)}
    elsewhere = []
    for path, g, w in _same_leaves(port["opt_state"], want, (cell, "opt_state")):
        assert (g["shape"], g["dtype"]) == (w["shape"], w["dtype"]), (cell, path)
        if path == ("step",):
            assert g["spec"] is None and w["spec"] == []      # a host scalar / replicated
            continue
        if w["spec"] == owns[path]:
            assert g["spec"] == w["spec"], (cell, path)
        else:
            elsewhere.append((path, w["spec"], owns[path]))
            assert g["spec"] == owns[path], (cell, path)
    if elsewhere:
        print(f"{cell}: {len(elsewhere)} leaves the reference attaches elsewhere, e.g. "
              f"{elsewhere[0]}")


def test_policy_functions_equal_the_reference(dumps):
    """rules_for, dp_axes_for, accum_for, seq_axis_for, optimizer_for and
    apply_variant over every arch x variant x kind."""
    ref = dumps["ref"]["__policy__"]
    for arch in list_archs():
        cfg = get_config(arch)
        assert dr.optimizer_for(cfg).init.__qualname__ == ref[arch]["optimizer"]
        for variant, want in ref[arch].items():
            if variant == "optimizer":
                continue
            try:
                got = json.loads(json.dumps(dataclasses.asdict(dr.apply_variant(cfg, variant))))
            except Exception as e:  # noqa: BLE001 - as the reference's
                got = f"error: {type(e).__name__}"
            assert got == want["config"], (arch, variant)
            for kind in ("train", "prefill", "decode"):
                assert json.loads(json.dumps({
                    "rules": dataclasses.asdict(dr.rules_for(cfg, variant, kind)),
                    "dp": dr.dp_axes_for(variant),
                    "accum": dr.accum_for(cfg, kind, variant),
                    "seq": dr.seq_axis_for(cfg, kind, variant)})) == want[kind], (arch, variant)


# ---------------------------------------------------------------------------
# op_cost's FLOPs against analyze_hlo on the same reduced cells (world 1)
# ---------------------------------------------------------------------------

B, S = 8, 64


def _reduced(arch="llama3.2-1b"):
    return ref_config(arch).reduced(), get_config(arch).reduced()


def test_train_flops_within_ten_percent_of_analyze_hlo():
    rcfg, tcfg = _reduced()
    ref_model = build_model(rcfg)
    opt = ref_optimizer("adamw")
    params = ref_model.init(jax.random.PRNGKey(0))
    batch = {"inputs": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32),
             "worker_mask": jnp.ones((8,), jnp.float32), "lr": jnp.float32(1e-3)}
    compiled = jax.jit(ref_train_step(ref_model, opt)).lower(
        params, opt.init(params), batch).compile()
    want = analyze_hlo(compiled.as_text()).flops

    model = Model(tcfg)
    popt = get_optimizer("adamw")
    mparams, mstate = abstract_state(model, None, None, popt)
    mbatch = {"inputs": torch.empty((B, S), dtype=torch.int32, device="meta"),
              "labels": torch.empty((B, S), dtype=torch.int32, device="meta"),
              "worker_mask": torch.empty((8,), device="meta"), "lr": 1e-3}
    with counting((mparams, mstate, mbatch)) as cost:
        make_train_step(model, popt)(mparams, mstate, mbatch)
    print(f"train: op_cost {cost.flops:.6e} FLOPs, analyze_hlo {want:.6e}")
    assert abs(cost.flops / want - 1) <= 0.10
    assert set(cost.kernel_work) == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                                     "flash_attention_bwd"}


def test_decode_flops_within_ten_percent_of_analyze_hlo():
    rcfg, tcfg = _reduced()
    ref_model = build_model(rcfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    caches = ref_model.blank_caches(B, S)
    compiled = jax.jit(ref_decode_step(ref_model)).lower(
        params, jnp.zeros((B, 1), jnp.int32), caches, jnp.int32(S - 1)).compile()
    want = analyze_hlo(compiled.as_text()).flops

    model = Model(tcfg)
    mparams, _ = abstract_state(model, None, None)
    mcaches = torch.utils._pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        model.blank_caches(B, S, device="cpu"))
    args = (mparams, torch.empty((B, 1), dtype=torch.int32, device="meta"), mcaches,
            torch.empty((), dtype=torch.int32, device="meta"))
    with counting(args) as cost:
        make_decode_step(model)(*args)
    print(f"decode: op_cost {cost.flops:.6e} FLOPs, analyze_hlo {want:.6e}")
    assert abs(cost.flops / want - 1) <= 0.10
    assert cost.kernel_work["decode_attention"]["launches"] == tcfg.n_layers


# ---------------------------------------------------------------------------
# dryrun_cell on a (4, 2) test mesh, one production cell, the mesh's guard
# ---------------------------------------------------------------------------

_TEST_MESH = textwrap.dedent("""
    import json
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.dist.sharding import LeafShards
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import abstract_state
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves

    from repro_torch.analysis.op_cost import counting
    from repro_torch.dist.sharding import full_value, tp_block, tp_placements

    mesh = make_test_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b", "zamba2-1.2b"):
        cfg = get_config(arch).reduced(dtype="bfloat16", remat="full")
        params, _ = abstract_state(Model(cfg), mesh, dr.rules_for(cfg, "baseline", "train"))
        sharded = gathers = tp_gathers = 0
        for p in tree_leaves(params, is_leaf=lambda t: hasattr(t, "shape")):
            if LeafShards.of(p) is None:
                continue
            full = p.numel() * p.element_size()
            with counting() as one:
                full_value(p)
            got = one.collective_bytes["all-gather"]
            # DTensor gathers a leaf one mesh dim at a time: the last
            # gather's output is the full leaf, an earlier one a part.
            assert got == full if sum(len(m) for m in LeafShards.of(p).dims.values()) == 1 \
                else full < got < 2 * full, (p.shape, p.placements, got, full)
            # To the TP-only layout: one gather over "data" of a leaf cut
            # there, whose output is the leaf's block over "model".
            with counting() as one:
                block = tp_block(p, tp_placements(p.placements, mesh))
            tp_got = one.collective_bytes["all-gather"]
            over_data = p.placements[0].is_shard()
            assert tp_got == (block.numel() * block.element_size() if over_data else 0)
            assert block.numel() * LeafShards.of(p).parts() == p.numel() * (
                4 if over_data else 1), (p.shape, p.placements)
            sharded += full
            gathers += got
            tp_gathers += tp_got
        for kind, shape in (("train", ShapeSpec("t", "train", 64, 8)),
                            ("prefill", ShapeSpec("p", "prefill", 64, 8)),
                            ("decode", ShapeSpec("d", "decode", 64, 8))):
            cost, out_bytes, *_ = dr.trace_cell(cfg, shape, mesh)
            products = cost.flops - sum(w["flops"] for w in cost.kernel_work.values())
            out[f"{arch} {kind}"] = dict(cost.as_dict(), sharded_bytes=sharded,
                                         gather_bytes=gathers, tp_gather_bytes=tp_gathers,
                                         product_flops=products,
                                         sources=cost.top_collective_sources(30))
    print(json.dumps(out))
""")


def _llama_split_product_flops(cfg, data: int, model: int, batch: int, seq: int) -> float:
    """The matrix-product FLOPs of reduced llama's tensor-parallel train
    step on one rank, from the config: its rows (batch / data x seq
    tokens) through its blocks of q (H / m heads), k and v (Hkv / m, or
    the one kv head its q heads read), o, the gated MLP (d_ff / m) and
    the tied head (V / m), at 2 FLOPs a multiply-add. Each product runs
    backward once (two products: the input's and the weight's
    gradients). Under full remat each block's forward runs twice, but the
    recompute stops after the last product whose output the backward
    reads (PyTorch's checkpoint early stop): ``w_out``, the block's last
    product, runs forward once."""
    T = batch // data * seq
    d, hd, ffl = cfg.d_model, cfg.head_dim, cfg.d_ff // model
    hl = cfg.n_heads // model
    kvl = cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0 else 1
    layer = 2 * T * (d * hl * hd + 2 * d * kvl * hd + hl * hd * d + 3 * d * ffl)
    w_out = 2 * T * ffl * d
    head = 2 * T * d * (cfg.vocab_size // model)
    return cfg.n_layers * (layer * (2 + 2) - w_out) + head * (1 + 2)


def _llama_decode_product_flops(cfg, data: int, model: int, batch: int) -> float:
    """The matrix-product FLOPs of reduced llama's tensor-parallel decode
    step on one rank under ``sp_decode``: its batch / data tokens through
    its blocks of q (H / m heads), k and v (Hkv / m), o (its H / m heads of
    the merged attention), the gated MLP (d_ff / m) and the tied head
    (V / m), at 2 FLOPs a multiply-add. The attention over the cache is
    K3's own work (its partial form), not a product."""
    T = batch // data
    d, hd, ffl = cfg.d_model, cfg.head_dim, cfg.d_ff // model
    hl, kvl = cfg.n_heads // model, cfg.n_kv_heads // model
    layer = 2 * T * (d * hl * hd + 2 * d * kvl * hd + hl * hd * d + 3 * d * ffl)
    return cfg.n_layers * layer + 2 * T * d * (cfg.vocab_size // model)


def test_dryrun_cell_on_a_test_mesh():
    """Reduced llama (and an MoE and the hybrid) traced on a (4, 2) fake
    mesh. Llama's train, prefill and decode steps compute
    tensor-parallel: their parameter gathers are exactly one gather of
    each leaf to its TP-only layout (over "data" only: a leaf cut there
    gives its block over "model"; nothing else is gathered), the train
    step's products count the FLOPs ``_llama_split_product_flops`` gives
    for the split, and the decode step's (``sp_decode``, the default for
    decode cells) ``_llama_decode_product_flops``; the decode step's
    other all-gathers are its token's heads (``gather_from_tp``), its
    cache never gathered. Every step of the MoE and the hybrid gathers
    exactly one ``full_value`` of each sharded leaf (a leaf cut along one
    mesh dim: its full bytes; cut along both, DTensor gathers one dim at
    a time, and the first gather's part adds to them). Train steps'
    reduce-scatters land the gradients back."""
    got = json.loads(_run(["-c", _TEST_MESH]).strip().splitlines()[-1])
    for name, c in got.items():
        arch, kind = name.split()
        tp = arch == "llama3.2-1b"
        gathered = sum(b for s, b in c["sources"] if "(full_value)" in s)
        to_tp = sum(b for s, b in c["sources"] if "(tp_block)" in s)
        heads = sum(b for s, b in c["sources"] if "via gather_from_tp" in s)
        if tp:
            assert gathered == 0 and to_tp == c["tp_gather_bytes"], name
            assert 0 < to_tp < c["sharded_bytes"], name
            assert c["collective_bytes"]["all-gather"] == to_tp + heads, name
            assert (heads > 0) == (kind == "decode"), name
            assert not any("_rows_block" in s for s, _ in c["sources"]), name
            assert c["collective_bytes"]["all-reduce"] > 0, name
        else:
            assert to_tp == 0 and gathered == c["gather_bytes"], name
            assert c["sharded_bytes"] < gathered < 2 * c["sharded_bytes"], name
        assert c["flops"] > 0 and c["peak_bytes"] > c["argument_bytes"] > 0, name
        assert c["unknown_trip_counts"] == 0
        if kind == "train":
            assert c["collective_bytes"]["reduce-scatter"] > 0, name
            assert {"rmsnorm", "rmsnorm_bwd"} <= set(c["kernel_work"]), name
    cfg = get_config("llama3.2-1b").reduced(dtype="bfloat16", remat="full")
    assert got["llama3.2-1b train"]["product_flops"] == _llama_split_product_flops(
        cfg, 4, 2, 8, 64)
    assert got["llama3.2-1b decode"]["product_flops"] == _llama_decode_product_flops(
        cfg, 4, 2, 8)
    assert "ssd_scan_bwd" in got["zamba2-1.2b train"]["kernel_work"]
    assert "decode_attention" in got["llama3.2-1b decode"]["kernel_work"]


_PRODUCTION = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun as dr
    print(json.dumps(dr.dryrun_cell("smollm-135m", "decode_32k", save=False)))
""")


def test_production_cell_has_the_reference_schema(dumps):
    """smollm-135m x decode_32k x pod16x16 on 256 fake ranks: an OK
    artifact holding every key of the reference's (``_finish``), XLA's
    own figures null, and ``fits``; its decode step tensor-parallel (the
    TP-only gather's all-gathers, the merge's, MLP's and lookup's
    all-reduces; no whole gather)."""
    art = json.loads(_run(["-c", _PRODUCTION], timeout=240).strip().splitlines()[-1])
    schema = dumps["ref"]["__schema__"]
    for k, sub in schema.items():
        assert k in art, k
        if sub:
            assert set(sub) <= set(art[k]), k
    assert art["status"] == "OK" and art["n_devices"] == 256 and art["mesh"] == "pod16x16"
    assert art["cost"]["xla_flops"] is None and art["cost"]["xla_bytes_accessed"] is None
    assert art["fits"] is True and art["memory"]["peak_bytes"] > art["memory"]["argument_bytes"]
    assert art["kernel_work"]["decode_attention"]["launches"] == get_config("smollm-135m").n_layers
    assert set(art["collectives"]) == {"all-gather", "all-reduce"}
    assert not any("(full_value)" in s for s, _ in art["collective_top_sources"])
    assert art["variant_note"] is None


_GUARD = textwrap.dedent("""
    import tempfile
    import torch.distributed as dist
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_test_mesh

    root = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{root}/pg", rank=0, world_size=1)
    try:
        make_test_mesh((1, 1))
        raise SystemExit("a fake mesh beside a real group")
    except RuntimeError as e:
        assert "real process group" in str(e), e
    dist.destroy_process_group()
    mesh = make_test_mesh((2, 2))
    try:
        make_test_mesh((4, 2))
        raise SystemExit("a fake group of another size")
    except RuntimeError as e:
        assert "start another process" in str(e), e
    try:
        make_mesh((2, 2), ("data", "model"), device="cpu")
        raise SystemExit("make_mesh took the fake backend")
    except ValueError as e:
        assert "gloo" in str(e), e

    def boom(*a, **k):
        raise ValueError("seeded failure")
    dr.dryrun_cell = boom
    import sys
    sys.argv = ["dryrun", "--arch", "smollm-135m", "--shape", "train_4k"]
    try:
        dr.main()
    except SystemExit as e:
        print("exit:", e.code)
""")


def test_mesh_guards_and_a_failing_cell():
    """The fake mesh refuses to run beside a real group or at another
    world size, ``make_mesh`` still refuses the fake backend, and a cell
    that raises prints ``[FAIL]`` with its traceback and fails the sweep."""
    res = subprocess.run([sys.executable, "-c", _GUARD], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[FAIL] smollm-135m__train_4k__pod16x16__baseline: seeded failure" in res.stdout
    assert "exit: 1 cells failed" in res.stdout
    assert "Traceback" in res.stderr and "seeded failure" in res.stderr
