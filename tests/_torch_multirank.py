"""The ranks of ``tests/test_torch_multirank.py``: 8 gloo processes on the
CPU run the port's multi-rank paths on a (4, 2) ("data", "model") mesh,
and the tensor-parallel cases on it and on a (2, 4) mesh over the same
ranks.

    python tests/_torch_multirank.py DIR

``DIR/in.npz`` and ``DIR/in.json`` (written by the test) hold each
case's initial parameters and batches; every rank runs every case, and
rank 0 writes the results to ``DIR/out.npz`` and ``DIR/out.json``. The
parent computes the reference's numbers; this file imports only torch,
numpy and the port (the test imports ``CASES``, ``cut`` and ``loop_setup``
from it to build the same configs on both sides).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

WORLD, MESH, MESH2 = 8, (4, 2), (2, 4)
AXES = ("data", "model")
N_WORKERS, ROWS, SEQ = 8, 16, 16
#: The step cases: (a) a step of AdamW whose mask drops both workers of
#: data rank 1 (rows 4-7); (b) qwen3-moe with capacity drops (capacity
#: factor 0.5: half of the mean expert load) under the flat and the
#: grouped dispatch; (c) deepseek-v3 at 3 layers, its MTP loss, Adafactor;
#: (d) one step each of SGD and momentum.
CASES = {
    "a": dict(arch="smollm-135m", over={}, opt="adamw", lr=1e-3, steps=3, drop=(2, 3)),
    "b_data": dict(arch="qwen3-moe-30b-a3b",
                   over={"moe": {"capacity_factor": 0.5, "dispatch": "data"}},
                   opt="sgd", lr=0.1, steps=2, drop=(5,)),
    "b_grouped": dict(arch="qwen3-moe-30b-a3b",
                      over={"moe": {"capacity_factor": 0.5, "dispatch": "grouped"}},
                      opt="sgd", lr=0.1, steps=2, drop=(5,)),
    "c": dict(arch="deepseek-v3", over={"n_layers": 3}, opt="adafactor", lr=1e-3, steps=2,
              drop=(0,)),
    "d_sgd": dict(arch="smollm-135m", over={}, opt="sgd", lr=0.1, steps=1, drop=(6,)),
    "d_momentum": dict(arch="smollm-135m", over={}, opt="momentum", lr=0.1, steps=1,
                       drop=(6,)),
}
#: The tensor-parallel cases, each run on both meshes (``TP_MESHES``):
#: reduced llama3.2-1b (4 / 2 heads: at "model" = 4 the kv heads are
#: replicated and each rank's q head reads kv head index // 2);
#: qwen2.5-3b (q/k/v biases, kv heads replicated at 4); command-r-35b (the
#: parallel block, LayerNorm, logit_scale 0.0625); chameleon-34b (qk-norm,
#: an untied head); smollm-135m at its own 9 / 3 heads, which divide
#: neither 2 nor 4 (its attention computed whole, its MLP and vocab
#: split). ``noisy``: the reference's zero and one leaves (biases, norm
#: scales) get seeded noise (``tests/_noisy.py``) on both sides.
TP_CASES = {
    "llama": dict(arch="llama3.2-1b", over={}, opt="adamw", lr=1e-3, steps=2, drop=(1,)),
    "qwen": dict(arch="qwen2.5-3b", over={}, opt="sgd", lr=0.1, steps=2, drop=(4,),
                 noisy=True),
    "command_r": dict(arch="command-r-35b", over={}, opt="momentum", lr=0.1, steps=2,
                      drop=(7,), noisy=True),
    "chameleon": dict(arch="chameleon-34b", over={}, opt="sgd", lr=0.1, steps=2, drop=(2, 3),
                      noisy=True),
    "smollm": dict(arch="smollm-135m", over={"n_heads": 9, "n_kv_heads": 3}, opt="sgd",
                   lr=0.1, steps=2, drop=(0,)),
}
TP_MESHES = {"4x2": MESH, "2x4": MESH2}
#: The tensor-parallel decode of each ``TP_CASES`` config on each mesh,
#: under both cache layouts of the reference's rules (``DECODE_LAYOUTS``:
#: ``sp_decode``, the cache's rows over "model", and ``no_sp_decode``, its
#: kv heads where they divide "model", else replicated): ``DEC_STEPS``
#: steps of ``DEC_B`` lanes over a seeded cache of ``DEC_S`` rows, each
#: lane at its own position from ``DEC_START``. At "model" = 2 (blocks of
#: 16 rows) and 4 (blocks of 8) lane 1's writes cross a block boundary
#: (15 to 16), and lane 0's sequence never reaches the last block.
DEC_B, DEC_S, DEC_STEPS, DEC_START = 4, 32, 3, (3, 14, 20, 28)
DECODE_LAYOUTS = ("sp_decode", "no_sp_decode")
#: The vocab-parallel cross-entropy alone: logits (ROWS, SEQ, CE_VOCAB).
CE_VOCAB = 96
#: The loop: 6 steps, worker 1 fails at step 1 and rejoins at step 4.
#: Seven workers' batches are 14 rows at beta 0.5, which 4 data ranks do
#: not divide (the relaxed split: every rank computes every row), and 28
#: at beta 1 (7 rows a rank, across workers' boundaries).
LOOP_STEPS, LOOP_EVENTS = 6, [(1, "fail", 1), (4, "rejoin", 1)]
#: The pipeline: the reference test's case (L 8, D 16, 6 x 4 microbatches).
PIPE_L, PIPE_D, PIPE_MICRO, PIPE_MB = 8, 16, 6, 4


def cut(cfg, over: dict):
    """``cfg.reduced()`` with ``over``'s top-level fields and, under
    ``"moe"``, MoE fields; works on either package's configs."""
    over = dict(over)
    moe = over.pop("moe", None)
    cfg = cfg.reduced(**over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def loop_setup(core, data, vocab: int):
    """Strategy, delay model and batcher of the loop case, from the given
    package's copies."""
    st = core.StrategyConfig(
        "adaptive_kbeta", n=N_WORKERS, s=4, k_max=4, beta_grid=(0.5, 1.0),
        diagnostic=core.DiagnosticConfig(kind="loss", rel_tol=0.05, min_iters=2,
                                         consecutive=1))
    batcher = data.StagedBatcher(data.TokenStream(vocab, seed=0), n_workers=N_WORKERS,
                                 global_batch=4 * N_WORKERS, seq_len=SEQ)
    return st, core.SimplifiedDelayModel(lambda_y=1.0, x=0.05), batcher


def _leaves(tree):
    from repro_torch.models.layers import tree_leaves
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _replicas_equal(tree, mesh) -> bool:
    """Every block of every DTensor leaf holds the same bits on every rank
    that holds it (ranks that differ only along mesh dims not sharding
    it)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    mine = []
    for t in _leaves(tree):
        if not isinstance(t, DTensor):
            mine.append((None, t.detach().numpy().tobytes()))
            continue
        coord = mesh.get_coordinate()
        key = tuple(c if pl.is_shard() else None for c, pl in zip(coord, t.placements))
        mine.append((key, t.to_local().detach().contiguous().numpy().tobytes()))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    seen = {}
    for leaves in every:
        for i, (key, data) in enumerate(leaves):
            if seen.setdefault((i, key), data) != data:
                return False
    return True


def run_step_case(name, spec, src, mesh, out, meta, key=None):
    """``spec``'s steps on ``mesh`` from ``src``'s parameters and batches
    under ``name``; results under ``key`` (default ``name``). A
    tensor-parallel case (``key`` given) first runs the prefill step on
    the first batch's inputs, and records the head counts K1 was given."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (
        activation_sharding, make_sharding_fn, shard_tree, tp_rules, DEFAULT_RULES,
    )
    from repro_torch.models import Model
    from repro_torch.models import attention
    from repro_torch.models.layers import ParamSpec, tree_map
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.steps import make_prefill_step, make_train_step

    key = key or name
    cfg = cut(get_config(spec["arch"]), spec["over"])
    model = Model(cfg)
    like = model.init(0, device="cpu")
    it = iter(range(len(_leaves(like))))
    params = tree_map(lambda t: torch.from_numpy(src[f"{name}/p{next(it)}"]).to(t.dtype),
                      like, is_leaf=torch.is_tensor)
    shardings = tree_map(make_sharding_fn(mesh), model.param_specs(),
                         is_leaf=lambda x: isinstance(x, ParamSpec))
    params = shard_tree(params, shardings)
    opt = get_optimizer(spec["opt"])
    state = opt.init(params)
    # The TP-only layout handed over as the reference's ZeRO-1 does.
    gather = tree_map(make_sharding_fn(mesh, tp_rules(DEFAULT_RULES)), model.param_specs(),
                      is_leaf=lambda x: isinstance(x, ParamSpec))
    step = make_train_step(model, opt, param_shardings=shardings, gather_shardings=gather)
    metrics = {k: [] for k in ("loss", "ce", "aux", "denom", "grad_norm", "contributors")}
    heads = set()
    flash = attention._flash_kernel

    def seen(q, k, v, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    attention._flash_kernel = seen
    try:
        with activation_sharding(mesh):
            if key != name:
                logits = make_prefill_step(model)(params, torch.from_numpy(
                    src[f"{name}/inputs"][0]))
                out[f"{key}/prefill"] = logits.full_tensor().numpy()
                meta.setdefault(key, {})["prefill_placements"] = [repr(p) for p in
                                                                  logits.placements]
            for s in range(spec["steps"]):
                batch = {k: torch.from_numpy(src[f"{name}/{k}"][s])
                         for k in ("inputs", "labels", "mask", "worker_mask")}
                batch["lr"] = spec["lr"]
                params, state, m = step(params, state, batch)
                for k in metrics:
                    metrics[k].append(float(m[k]))
    finally:
        attention._flash_kernel = flash
    for i, p in enumerate(_leaves(params)):
        out[f"{key}/p{i}"] = _full(p).numpy()
    meta.setdefault(key, {}).update(
        metrics=metrics, replicas_equal=_replicas_equal(params, mesh),
        state_replicas_equal=_replicas_equal(state, mesh), k1_heads=sorted(heads))


def run_decode_case(name, spec, src, mesh, mesh_name, out, meta):
    """``make_decode_step`` of ``spec``'s config on ``mesh`` from ``src``'s
    initial parameters (laid out by ``DEFAULT_RULES``) and seeded caches
    (laid out by each layout's rules), ``DEC_STEPS`` steps: each step's
    logits and the final caches gathered, whether every replicated block
    of the caches holds the same bits on every rank that holds it, their
    placements, and the (q, k) shapes K3 and its partial form were
    given."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (
        DEFAULT_RULES, SP_DECODE_RULES, activation_sharding, make_sharding_fn, shard_tree,
    )
    from repro_torch.models import Model
    from repro_torch.models import attention
    from repro_torch.models.layers import ParamSpec, tree_map
    from repro_torch.runtime.steps import make_decode_step

    cfg = cut(get_config(spec["arch"]), spec["over"])
    model = Model(cfg)
    like = model.init(0, device="cpu")
    it = iter(range(len(_leaves(like))))
    params = tree_map(lambda t: torch.from_numpy(src[f"{name}/p{next(it)}"]).to(t.dtype),
                      like, is_leaf=torch.is_tensor)
    params = shard_tree(params, tree_map(make_sharding_fn(mesh, DEFAULT_RULES),
                                         model.param_specs(),
                                         is_leaf=lambda x: isinstance(x, ParamSpec)))
    tokens = torch.from_numpy(src[f"{name}/dec_tokens"])
    step = make_decode_step(model)
    k3, partial = attention._decode_kernel, attention._decode_partial_kernel
    for layout in DECODE_LAYOUTS:
        rules = SP_DECODE_RULES if layout == "sp_decode" else DEFAULT_RULES
        blank = model.blank_caches(DEC_B, DEC_S, device="cpu")
        it = iter(range(len(_leaves(blank))))
        caches = tree_map(lambda t: torch.from_numpy(src[f"{name}/dec_c{next(it)}"]), blank,
                          is_leaf=torch.is_tensor)
        caches = shard_tree(caches, tree_map(make_sharding_fn(mesh, rules),
                                             model.cache_specs(DEC_B, DEC_S),
                                             is_leaf=lambda x: isinstance(x, ParamSpec)))
        key = f"{name}@{mesh_name}/{layout}"
        seen = set()

        def seen_k3(q, k, v, lengths):
            seen.add(("k3", tuple(q.shape), tuple(k.shape)))
            return k3(q, k, v, lengths)

        def seen_partial(q, k, v, lengths):
            seen.add(("partial", tuple(q.shape), tuple(k.shape)))
            return partial(q, k, v, lengths)

        attention._decode_kernel, attention._decode_partial_kernel = seen_k3, seen_partial
        try:
            with activation_sharding(mesh, rules=rules):
                for s in range(DEC_STEPS):
                    logits, caches = step(params, tokens[s], caches,
                                          torch.tensor(DEC_START) + s)
                    out[f"{key}/logits{s}"] = logits.full_tensor().numpy()
        finally:
            attention._decode_kernel, attention._decode_partial_kernel = k3, partial
        for i, c in enumerate(_leaves(caches)):
            out[f"{key}/c{i}"] = _full(c).numpy()
        meta[key] = {"replicas_equal": _replicas_equal(caches, mesh),
                     "placements": [repr(p) for p in _leaves(caches)[0].placements],
                     "logits_placements": [repr(p) for p in logits.placements],
                     "kernels": sorted([k, list(q), list(c)] for k, q, c in seen)}


def run_vocab_ce(src, mesh, name, out, meta):
    """``vocab_parallel_ce`` on the rank's rows (over "data") and vocab
    columns (over "model") of ``src``'s logits, with its mask and worker
    mask: the loss summed over the rows' ranks, and the gradient of the
    logits, each block written into a zero array of the full shape and
    summed over every rank."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import (
        activation_sharding, row_split, split_rows, split_sum, tensor_parallel, tp_view,
    )
    from repro_torch.dist.tensor_parallel import vocab_parallel_ce

    logits = torch.from_numpy(src["ce/logits"])
    labels = torch.from_numpy(src["ce/labels"])
    mask, wm = torch.from_numpy(src["ce/mask"]), torch.from_numpy(src["ce/worker_mask"])
    tp = tp_view(mesh)
    with activation_sharding(mesh):
        split = row_split(mesh, logits.shape[0], ("data",))
        per = CE_VOCAB // tp.size
        cols = slice(tp.index * per, (tp.index + 1) * per)
        local = logits[split.rows, :, cols].clone().requires_grad_(True)
        rows_w = wm.repeat_interleave(logits.shape[0] // wm.shape[0])[split.rows]
        with split_rows(split), tensor_parallel(tp):
            loss, denom = vocab_parallel_ce(local, labels[split.rows], mask[split.rows],
                                            rows_w, vocab=CE_VOCAB)
            loss.backward()
            total = split_sum(loss.detach())
    grad = torch.zeros_like(logits)
    grad[split.rows, :, cols] = local.grad
    dist.all_reduce(grad)
    out[f"ce_{name}/grad"] = grad.numpy()
    meta[f"ce_{name}"] = {"loss": float(total), "denom": float(denom)}


def run_pipeline(src, mesh, out, meta):
    from repro_torch.dist.pipeline_parallel import pipeline_forward, stage_params

    Ws, x = torch.from_numpy(src["pipe/W"]), torch.from_numpy(src["pipe/x"])
    with torch.no_grad():
        out["pipe/out"] = pipeline_forward(lambda W, h: torch.tanh(h @ W),
                                           stage_params(Ws, 4), x, mesh).numpy()
    try:
        pipeline_forward(lambda W, h: h, stage_params(Ws, 2), x, mesh)
    except ValueError as e:
        meta["pipe_mismatch"] = str(e)


def run_constrain(mesh, meta):
    """A DTensor activation under the context: ``constrain_batch`` shards
    its rows over "data"; ``constrain_logical`` shards an "embed" dim
    over "data" and an "act_batch" dim over "data" as well."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import activation_sharding, constrain_batch, constrain_logical

    x = DTensor.from_local(torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8), mesh,
                           [Replicate(), Replicate()])
    with activation_sharding(mesh):
        b = constrain_batch(x)
        e = constrain_logical(x, (None, "embed"))
    meta["constrain"] = {"batch": [repr(p) for p in b.placements],
                         "batch_local": list(b.to_local().shape),
                         "batch_equal": bool(torch.equal(b.full_tensor(), x.full_tensor())),
                         "embed": [repr(p) for p in e.placements],
                         "embed_local": list(e.to_local().shape)}


def run_loops(d: Path, mesh, meta):
    from repro_torch import core, data
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import FaultEvent, TrainLoopConfig, train

    cfg = get_config("smollm-135m").reduced()

    def loop(steps, mesh, **kw):
        st, delay, batcher = loop_setup(core, data, cfg.vocab_size)
        res = train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                    TrainLoopConfig(total_steps=steps, log_every=0, lr=3e-3,
                                    events=[FaultEvent(*e) for e in LOOP_EVENTS], **kw),
                    device="cpu", mesh=mesh)
        return res["history"], [list(s) for s in res["compiled_shapes"]]

    meta["loop"], meta["loop_shapes"] = loop(LOOP_STEPS, mesh)
    ckpt = dict(checkpoint_dir=str(d / "ckpt"), checkpoint_every=3)
    meta["loop_first"], _ = loop(3, mesh, **ckpt)
    meta["loop_resumed"], _ = loop(LOOP_STEPS, make_mesh(MESH2, AXES, device="cpu"), **ckpt)


def rank_main(rank: int, d: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'pg'}", rank=rank,
                            world_size=WORLD)
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.runtime.train_loop import _check_ranks_agree

    mesh = make_mesh(MESH, AXES, device="cpu")
    src = np.load(d / "in.npz")
    out, meta = {}, {}
    try:
        for name, spec in CASES.items():
            run_step_case(name, spec, src, mesh, out, meta)
        meshes = {"4x2": mesh, "2x4": make_mesh(MESH2, AXES, device="cpu")}
        for mesh_name, m in meshes.items():
            for name, spec in TP_CASES.items():
                run_step_case(name, spec, src, m, out, meta, key=f"{name}@{mesh_name}")
                run_decode_case(name, spec, src, m, mesh_name, out, meta)
            run_vocab_ce(src, m, mesh_name, out, meta)
        run_pipeline(src, mesh, out, meta)
        run_constrain(mesh, meta)
        run_loops(d, mesh, meta)
        try:
            _check_ranks_agree(0, [float(rank == 3)], torch.device("cpu"))
        except RuntimeError as e:
            meta["digest_error"] = str(e)
    except Exception:
        (d / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    if rank == 0:
        np.savez(d / "out.npz", **out)
        (d / "out.json").write_text(json.dumps(meta))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD, join=True)
