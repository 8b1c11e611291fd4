"""The port's multi-rank training on 8 gloo ranks of the CPU, a (4, 2)
("data", "model") mesh, against the reference's single-device numbers
(its own multi-device step fails on jax 0.9.0, so it is no oracle) and
the port's single-process loop; and its tensor-parallel compute over
"model" (the dense decoders' train, prefill and decode steps, the
vocab-parallel cross-entropy) on that mesh and on a (2, 4) mesh over the
same ranks.

One spawned group (``tests/_torch_multirank.py``) runs every case; the
parent computes the reference's numbers with JAX and hands the ranks the
same initial parameters and batches as ``.npz``. The group starts from a
``file://`` rendezvous, one torch thread a rank, and is killed with its
process group if it has not ended within 300 s.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config as ref_config
from repro.dist.collectives import masked_weighted_ce as j_masked_weighted_ce
from repro.dist.pipeline_parallel import pipeline_forward as j_pipeline_forward
from repro.dist.pipeline_parallel import stage_params as j_stage_params
from repro.models import build_model
from repro.optim import optimizers as jopt
from repro.runtime.steps import make_decode_step as j_make_decode_step
from repro.runtime.steps import make_train_step as j_make_train_step
import repro_torch.core as tcore
import repro_torch.data as tdata
from repro_torch.configs import get_config
from repro_torch.dist.pipeline_parallel import stage_params
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map
from repro_torch.optim import get_optimizer
from repro_torch.runtime import FaultEvent, TrainLoopConfig, train
from _noisy import with_noise
from _torch_multirank import (
    CASES, CE_VOCAB, DEC_B, DEC_S, DEC_START, DEC_STEPS, DECODE_LAYOUTS, LOOP_EVENTS,
    LOOP_STEPS, N_WORKERS, PIPE_D, PIPE_L, PIPE_MB, PIPE_MICRO, ROWS, SEQ, TP_CASES,
    TP_MESHES, cut, loop_setup,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_multirank.py")
TIMEOUT = 300


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def _port_leaves(cfg, jtree):
    """A reference tree's leaves as numpy, in the order of the port's own
    tree (its specs' key order, which ``Model.init`` follows)."""
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jtree), device="cpu")
    ordered = tree_map(lambda _, t: t, Model(cfg).param_specs(), tp,
                       is_leaf=lambda x: isinstance(x, ParamSpec))
    return [p.numpy() for p in _leaves(ordered)]


def _batches(name, spec, vocab):
    rng = np.random.default_rng(sum(map(ord, name)))
    steps = spec["steps"]
    ids = rng.integers(0, vocab, size=(steps, ROWS, SEQ + 1)).astype(np.int32)
    wm = np.ones((steps, N_WORKERS), np.float32)
    wm[:, list(spec["drop"])] = 0.0
    return {"inputs": ids[:, :, :-1], "labels": ids[:, :, 1:],
            "mask": (rng.random((steps, ROWS, SEQ)) > 0.2).astype(np.float32),
            "worker_mask": wm}


def _reference_case(name, spec, src, want):
    """The reference's single-device step on the case's params and batches;
    its inputs into ``src``, its numbers into ``want``."""
    ref = build_model(cut(ref_config(spec["arch"]), spec["over"]))
    cfg = cut(get_config(spec["arch"]), spec["over"])
    jp = jax.jit(ref.init)(jax.random.PRNGKey(0))
    if spec.get("noisy"):
        jp = jax.tree.map(jnp.asarray, with_noise(jax.tree.map(np.asarray, jp), 0))
    init = jp
    for i, p in enumerate(_port_leaves(cfg, jp)):
        src[f"{name}/p{i}"] = p
    batches = _batches(name, spec, cfg.vocab_size)
    src.update({f"{name}/{k}": v for k, v in batches.items()})
    prefill = np.asarray(jax.jit(ref.prefill)(jp, jnp.asarray(batches["inputs"][0])))
    opt = jopt.get_optimizer(spec["opt"])
    step = jax.jit(j_make_train_step(ref, opt))
    state = opt.init(jp)
    metrics = {k: [] for k in ("loss", "grad_norm", "contributors", "aux")}
    for s in range(spec["steps"]):
        batch = {k: jnp.asarray(v[s]) for k, v in batches.items()}
        jp, state, m = step(jp, state, {**batch, "lr": jnp.float32(spec["lr"])})
        for k in metrics:
            metrics[k].append(float(m[k]))
    want[name] = {"metrics": metrics, "params": _port_leaves(cfg, jp), "prefill": prefill}
    if name in TP_CASES:
        want[name]["decode"] = _reference_decode(name, ref, cfg, init, src)


def _reference_decode(name, ref, cfg, jp, src):
    """The reference's single-device ``make_decode_step`` from the case's
    initial parameters over seeded caches (``DEC_B`` x ``DEC_S``, random
    rows standing for earlier tokens) and seeded tokens, ``DEC_STEPS``
    steps at the per-lane positions ``DEC_START`` + step: its inputs into
    ``src`` (the caches in the port's per-layer order), -> (each step's
    logits, the final caches in the port's leaf order). Run once a
    config: the meshes and layouts are all held to it."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    blank = Model(cfg).blank_caches(DEC_B, DEC_S, device="cpu")
    filled = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), blank, is_leaf=torch.is_tensor)
    for i, t in enumerate(_leaves(filled)):
        src[f"{name}/dec_c{i}"] = t.numpy()
    tokens = rng.integers(0, cfg.vocab_size, size=(DEC_STEPS, DEC_B, 1)).astype(np.int32)
    src[f"{name}/dec_tokens"] = tokens
    # The reference stacks a segment's layers on a leading axis.
    jc = [{leaf: jnp.stack([jnp.asarray(layer[leaf].numpy()) for layer in seg])
           for leaf in ("k", "v")} for seg in filled]
    step = jax.jit(j_make_decode_step(ref))
    logits = []
    for s in range(DEC_STEPS):
        lg, jc = step(jp, jnp.asarray(tokens[s]), jc,
                      jnp.asarray(np.array(DEC_START, np.int32) + s))
        logits.append(np.asarray(lg))
    caches = [np.asarray(jc[g][leaf])[i] for g, seg in enumerate(filled)
              for i in range(len(seg)) for leaf in ("k", "v")]
    return {"logits": logits, "caches": caches}


def _reference_ce(src, want):
    """Logits, labels, a token mask and a worker mask dropping workers 1
    and 6 for the vocab-parallel cross-entropy; the reference's
    ``masked_weighted_ce`` on the full logits and ``jax.grad`` of it."""
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((ROWS, SEQ, CE_VOCAB)) * 3).astype(np.float32)
    labels = rng.integers(0, CE_VOCAB, size=(ROWS, SEQ)).astype(np.int32)
    mask = (rng.random((ROWS, SEQ)) > 0.25).astype(np.float32)
    wm = np.ones(N_WORKERS, np.float32)
    wm[[1, 6]] = 0.0
    src.update({"ce/logits": logits, "ce/labels": labels, "ce/mask": mask,
                "ce/worker_mask": wm})

    def loss(lg):
        return j_masked_weighted_ce(lg, jnp.asarray(labels), jnp.asarray(mask),
                                    jnp.asarray(wm))[0]

    value, grad = jax.value_and_grad(loss)(jnp.asarray(logits))
    want["ce"] = {"loss": float(value), "grad": np.asarray(grad),
                  "denom": float((mask * np.repeat(wm, ROWS // N_WORKERS)[:, None]).sum())}


@pytest.fixture(scope="module")
def run(tmp_path_factory, monkeypatch_module):
    d = tmp_path_factory.mktemp("multirank")
    src, want = {}, {}
    for name, spec in CASES.items():
        if spec["over"].get("moe", {}).get("dispatch") == "grouped":
            # The reference's grouped dispatch at the mesh's 4 data groups.
            monkeypatch_module.setattr(jmoe, "_dp_group_count", lambda T: 4)
        _reference_case(name, spec, src, want)
        monkeypatch_module.undo()
    for name, spec in TP_CASES.items():
        _reference_case(name, spec, src, want)
    _reference_ce(src, want)
    rng = np.random.default_rng(0)
    src["pipe/W"] = (rng.standard_normal((PIPE_L, PIPE_D, PIPE_D)) * 0.2).astype(np.float32)
    src["pipe/x"] = rng.standard_normal((PIPE_MICRO, PIPE_MB, PIPE_D)).astype(np.float32)
    Ws = jnp.asarray(src["pipe/W"])

    def ref_fwd(h):
        for i in range(PIPE_L):
            h = jnp.tanh(h @ Ws[i])
        return h

    want["pipe"] = np.asarray(jax.vmap(ref_fwd)(jnp.asarray(src["pipe/x"])))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pipe",))
    with pytest.raises(ValueError) as err:
        j_pipeline_forward(lambda W, h: h, j_stage_params(Ws, 2), jnp.asarray(src["pipe/x"]),
                           mesh, axis="data")
    want["pipe_mismatch"] = str(err.value)
    np.savez(d / "in.npz", **src)

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(WORKER), str(d)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the 8-rank group did not end within {TIMEOUT} s")
    errors = "".join(p.read_text() for p in sorted(d.glob("error_*.txt")))
    assert proc.returncode == 0, (errors or log)[-4000:]
    with np.load(d / "out.npz") as f:
        got = dict(f)
    return want, got, json.loads((d / "out.json").read_text())


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_device_reference(run, name):
    """(a)-(d): loss, router loss and grad norm within 1e-5 relative of
    the reference's single-device step, contributors exact, every
    parameter leaf within 1e-5 relative / 1e-6 absolute (AdamW's: see
    ``_close_adamw``); every block of
    every parameter and optimizer-state leaf bit-identical on the ranks
    that hold it."""
    want, got, meta = run
    w, g = want[name], meta[name]
    for key in ("loss", "grad_norm", "aux"):
        _close(g["metrics"][key], w["metrics"][key], 1e-5, 1e-7, f"{name} {key}")
    assert g["metrics"]["contributors"] == w["metrics"]["contributors"]
    for i, p in enumerate(w["params"]):
        if CASES[name]["opt"] == "adamw":
            _close_adamw(got[f"{name}/p{i}"], p, f"{name} leaf {i}")
        else:
            _close(got[f"{name}/p{i}"], p, 1e-5, 1e-6, f"{name} leaf {i}")
    assert g["replicas_equal"] and g["state_replicas_equal"]


def _close_adamw(got, want, what):
    """1e-5 relative / 1e-6 absolute, but for at most 1e-3 of the leaf's
    elements, which must be within 1e-4 (``tests/test_torch_train.py``'s
    bound on AdamW's step at lr 1e-3). AdamW divides each gradient by its
    own running scale, so where a gradient is near eps (1e-8) it carries
    the f32 noise of a sum taken in another order up to a fraction of lr:
    on (a)'s embedding, 5 of 65,536 elements at up to 7.6e-6."""
    diff = np.abs(got.astype(np.float64) - want)
    over = diff > 1e-6 + 1e-5 * np.abs(want)
    assert over.mean() <= 1e-3, (what, int(over.sum()))
    assert diff.max() <= 1e-4, (what, float(diff.max()))


TP_KEYS = [f"{name}@{mesh}" for mesh in TP_MESHES for name in TP_CASES]


@pytest.mark.parametrize("key", TP_KEYS)
def test_tensor_parallel_step_matches_single_device_reference(run, key):
    """The dense decoders' tensor-parallel train step on each mesh (the
    TP-only layout handed over as ``gather_shardings``): loss and grad
    norm within 1e-5 relative of the reference's single-device step,
    contributors exact, every parameter leaf within 1e-5 relative / 1e-6
    absolute (AdamW's as ``_close_adamw``), and every block of every
    parameter and optimizer-state leaf, the leaves replicated over
    "model" among them, bit-identical on the ranks that hold it."""
    want, got, meta = run
    name = key.split("@")[0]
    w, g = want[name], meta[key]
    for k in ("loss", "grad_norm", "aux"):
        _close(g["metrics"][k], w["metrics"][k], 1e-5, 1e-7, f"{key} {k}")
    assert g["metrics"]["contributors"] == w["metrics"]["contributors"]
    for i, p in enumerate(w["params"]):
        if TP_CASES[name]["opt"] == "adamw":
            _close_adamw(got[f"{key}/p{i}"], p, f"{key} leaf {i}")
        else:
            _close(got[f"{key}/p{i}"], p, 1e-5, 1e-6, f"{key} leaf {i}")
    assert g["replicas_equal"] and g["state_replicas_equal"]


@pytest.mark.parametrize("key", TP_KEYS)
def test_tensor_parallel_prefill_matches_reference(run, key):
    """The prefill step's logits, a DTensor of the rank's rows over "data"
    and its vocab columns over "model", equal the reference's ``prefill``
    within 1e-5 of their largest magnitude once gathered."""
    want, got, meta = run
    name = key.split("@")[0]
    ref = want[name]["prefill"]
    assert got[f"{key}/prefill"].shape == ref.shape
    _close(got[f"{key}/prefill"], ref, 0, 1e-5 * np.abs(ref).max(), f"{key} prefill")
    data = key.split("@")[1].split("x")[0]
    assert meta[key]["prefill_placements"] == [
        "Shard(dim=0)" if ROWS % int(data) == 0 else "Replicate()", "Shard(dim=2)"]


@pytest.mark.parametrize("key", TP_KEYS)
def test_k1_runs_on_the_ranks_heads(run, key):
    """K1 is given the rank's q heads, H / m of them where "model" (m)
    divides H (all H where it does not), and the kv heads they read: the
    rank's Hkv / m where that divides, else one kv head for each local
    where the rank's q heads all read one kv head, else one for each."""
    _, _, meta = run
    name, mesh = key.split("@")
    cfg = cut(get_config(TP_CASES[name]["arch"]), TP_CASES[name]["over"])
    m = TP_MESHES[mesh][1]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H % m:
        want = (H, Hkv)
    elif Hkv % m == 0:
        want = (H // m, Hkv // m)
    else:
        want = (H // m, 1 if (H // Hkv) % (H // m) == 0 else H // m)
    assert [tuple(h) for h in meta[key]["k1_heads"]] == [want], (key, meta[key]["k1_heads"])


DECODE_KEYS = [f"{name}@{mesh}/{layout}" for mesh in TP_MESHES for name in TP_CASES
               for layout in DECODE_LAYOUTS]


@pytest.mark.parametrize("key", DECODE_KEYS)
def test_tensor_parallel_decode_matches_reference(run, key):
    """The dense decoders' tensor-parallel decode step on each mesh under
    each cache layout, ``DEC_STEPS`` steps whose writes cross a rank's
    block of rows: every step's logits, a DTensor of the rank's rows over
    "data" and its vocab columns over "model", and the final caches' full
    values equal the reference's single-device ``make_decode_step``
    within 1e-5 of their largest magnitude (the prefill's tolerance);
    every replicated block of the caches holds the same bits on every
    rank that holds it; the caches come back in their own layout."""
    want, got, meta = run
    name, rest = key.split("@")
    mesh, layout = rest.split("/")
    ref = want[name]["decode"]
    for s, w in enumerate(ref["logits"]):
        assert got[f"{key}/logits{s}"].shape == w.shape
        _close(got[f"{key}/logits{s}"], w, 0, 1e-5 * np.abs(w).max(), f"{key} logits {s}")
    for i, w in enumerate(ref["caches"]):
        _close(got[f"{key}/c{i}"], w, 0, 1e-5 * np.abs(w).max(), f"{key} cache leaf {i}")
    assert meta[key]["replicas_equal"], key
    data, m = TP_MESHES[mesh]
    cfg = cut(get_config(TP_CASES[name]["arch"]), TP_CASES[name]["over"])
    model_dim = ("Shard(dim=1)" if layout == "sp_decode" else
                 "Shard(dim=2)" if cfg.n_kv_heads % m == 0 else "Replicate()")
    assert meta[key]["placements"] == ["Shard(dim=0)", model_dim], key
    assert meta[key]["logits_placements"] == ["Shard(dim=0)", "Shard(dim=2)"], key


@pytest.mark.parametrize("key", DECODE_KEYS)
def test_k3_runs_on_the_ranks_rows_or_heads(run, key):
    """What K3 is given in a decode step (the rank's ``DEC_B`` / data lanes):
    under ``sp_decode`` its partial form, every q head over the rank's
    ``DEC_S`` / m rows of every kv head; under ``no_sp_decode`` K3 at the
    rank's H / m q heads over its Hkv / m kv heads where those divide m,
    over the kv heads its q heads read (as K1 in training) where only the
    q heads do, and whole where neither does."""
    _, _, meta = run
    name, rest = key.split("@")
    mesh, layout = rest.split("/")
    data, m = TP_MESHES[mesh]
    cfg = cut(get_config(TP_CASES[name]["arch"]), TP_CASES[name]["over"])
    H, Hkv, D, b = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, DEC_B // data
    if layout == "sp_decode":
        want = ["partial", [b, H, D], [b, DEC_S // m, Hkv, D]]
    elif H % m:
        want = ["k3", [b, H, D], [b, DEC_S, Hkv, D]]
    elif Hkv % m == 0:
        want = ["k3", [b, H // m, D], [b, DEC_S, Hkv // m, D]]
    else:
        kv = 1 if (H // Hkv) % (H // m) == 0 else H // m
        want = ["k3", [b, H // m, D], [b, DEC_S, kv, D]]
    assert meta[key]["kernels"] == [want], (key, meta[key]["kernels"])


def test_decode_writes_cross_a_block_and_skip_the_last():
    """The decode cases' positions do what their tests claim: at every
    "model" width, lane 1's writes cross from one rank's block of rows
    into the next, and lane 0 never writes into the last rank's block."""
    for _, m in TP_MESHES.values():
        rows = DEC_S // m
        owners = [[(DEC_START[lane] + s) // rows for s in range(DEC_STEPS)]
                  for lane in range(DEC_B)]
        assert len(set(owners[1])) == 2, (m, owners)
        assert max(owners[0]) < m - 1, (m, owners)


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_vocab_parallel_ce_matches_masked_weighted_ce(run, mesh):
    """``vocab_parallel_ce`` over each rank's rows and vocab columns, with a
    token mask and a worker mask: its loss summed over the rows' ranks
    within 1e-6 relative of the reference's ``masked_weighted_ce`` on the
    full logits, the global denominator exact, and the assembled gradient
    of the logits within 1e-7 of ``jax.grad``'s."""
    want, got, meta = run
    w, g = want["ce"], meta[f"ce_{mesh}"]
    _close(g["loss"], w["loss"], 1e-6, 0, f"{mesh} loss")
    assert g["denom"] == w["denom"]
    _close(got[f"ce_{mesh}/grad"], w["grad"], 0, 1e-7, f"{mesh} grad")


def test_dropped_rank_contributes_nothing(run):
    """(a) drops workers 2 and 3, data rank 1's rows: the global
    denominators make its share 0, so the step equals the reference's
    (tested above) with 6 contributors."""
    _, _, meta = run
    assert meta["a"]["metrics"]["contributors"] == [6.0, 6.0, 6.0]
    assert all(d > 0 for d in meta["a"]["metrics"]["denom"])


def test_pipeline_forward_matches_sequential(run):
    """(e) GPipe over the mesh's first axis (4 stages; the mesh has no
    "pipe" axis) equals the sequential forward within 1e-5, and its
    mismatch error is the reference's word for word."""
    want, got, meta = run
    _close(got["pipe/out"], want["pipe"], 0, 1e-5, "pipeline")
    assert meta["pipe_mismatch"] == want["pipe_mismatch"].replace("'pipe'", "'data'")


def test_stage_params_error_is_the_reference():
    Ws = np.zeros((8, 2, 2), np.float32)
    with pytest.raises(ValueError) as ref:
        j_stage_params(jnp.asarray(Ws), 3)
    with pytest.raises(ValueError) as port:
        stage_params(torch.from_numpy(Ws), 3)
    assert str(port.value) == str(ref.value)
    assert tuple(stage_params(torch.from_numpy(Ws), 4).shape) == (4, 2, 2, 2)


def _single_process_loop():
    cfg = get_config("smollm-135m").reduced()
    st, delay, batcher = loop_setup(tcore, tdata, cfg.vocab_size)
    return train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                 TrainLoopConfig(total_steps=LOOP_STEPS, log_every=0, lr=3e-3,
                                 events=[FaultEvent(*e) for e in LOOP_EVENTS]),
                 device="cpu")["history"]


def _same_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want):
        for key in ("k", "beta", "n_workers", "sim_time", "contributors"):
            assert a[key] == b[key], (a["step"], key)
        assert ("switched_to" in a) == ("switched_to" in b)
        if "switched_to" in a:
            assert tuple(a["switched_to"]) == tuple(b["switched_to"])
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)


def test_loop_on_mesh_matches_single_process_loop(run):
    """(f) 6 steps with a fail at 2 and a rejoin at 4 on the mesh: the
    stage walk, k, beta, n_workers and sim_time equal the single-process
    loop's, losses within 1e-5 relative. The fleet's batches of 7 workers
    do not split over 4 data ranks evenly at every beta, so the run takes
    the relaxed row split too."""
    _, _, meta = run
    _same_history(meta["loop"], _single_process_loop())
    assert any(rows % 4 for rows, _ in meta["loop_shapes"]), meta["loop_shapes"]


def test_checkpoint_restores_onto_another_mesh(run):
    """(g) a checkpoint written on the (4, 2) mesh at step 3 restores onto
    a (2, 4) mesh and continues to the uninterrupted run's numbers."""
    _, _, meta = run
    _same_history(meta["loop_first"], meta["loop"][:3])
    _same_history(meta["loop_resumed"], meta["loop"][3:])


def test_constraints_redistribute_dtensors(run):
    """A DTensor activation is redistributed to the derived placements
    (plain tensors pass through: ``tests/test_torch_sharding.py``)."""
    _, _, meta = run
    c = meta["constrain"]
    assert c["batch"] == ["Shard(dim=0)", "Replicate()"] and c["batch_local"] == [2, 8]
    assert c["batch_equal"]
    assert c["embed"] == ["Shard(dim=1)", "Replicate()"] and c["embed_local"] == [8, 2]


def test_ranks_that_diverge_raise(run):
    """The loop's once-a-step digest: a rank whose digest differs makes
    every rank raise (rank 0's error recorded)."""
    _, _, meta = run
    assert "ranks diverged at step 0" in meta["digest_error"]
