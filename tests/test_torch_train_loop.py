"""The slice as a whole: the port's adaptive-(k, beta) training loop
against the reference's, on the CPU, and the port's exact resume.

Both loops get the same reduced config, the reference's initial
parameters (through ``params_from_numpy``), the same seeds, strategy,
delay model and fault schedule. The control plane is numpy on both
sides and draws from the same RNG streams, so every control decision —
stage, fleet, simulated time, contributors — must be equal; losses and
gradient norms come from two frameworks' f32 arithmetic and agree within
a stated tolerance.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import tempfile

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
from repro.configs import get_config
from repro.models import build_model
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro.runtime.train_loop import FaultEvent as JFault
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro.runtime.train_loop import train as j_train
import repro_torch.core as tcore
import repro_torch.data as tdata
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import get_optimizer
from repro_torch.runtime import FaultEvent, TrainLoopConfig, train

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=256, max_seq_len=64)


def _setup(core, data, strategy="adaptive_kbeta", n=4, global_batch=16, seq_len=32):
    """Strategy, delay model and batcher as tests/test_train_integration.py
    sets them up, from the given package's copies."""
    kw = dict(k_max=n // 2, beta_grid=(0.5, 1.0)) if strategy == "adaptive_kbeta" \
        else dict(k0=n // 2)
    st = core.StrategyConfig(
        strategy, n=n, s=global_batch // n,
        diagnostic=core.DiagnosticConfig(kind="loss", rel_tol=0.05, min_iters=5,
                                         consecutive=2), **kw)
    batcher = data.StagedBatcher(data.TokenStream(TINY["vocab_size"], seed=0), n_workers=n,
                                 global_batch=global_batch, seq_len=seq_len)
    return st, core.SimplifiedDelayModel(lambda_y=1.0, x=0.05), batcher


def _both(arch, events, steps, strategy="adaptive_kbeta", **loop):
    ref = build_model(get_config(arch).reduced(**TINY))
    st, delay, batcher = _setup(jcore, jdata, strategy)
    jout = j_train(ref, j_get_optimizer("adamw"), st, delay, batcher,
                   JLoopConfig(total_steps=steps, log_every=0, lr=3e-3,
                               events=[JFault(*e) for e in events], **loop))
    cfg = port_config(arch).reduced(**TINY)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                 ref.init(jax.random.PRNGKey(0))), device="cpu")
    st, delay, batcher = _setup(tcore, tdata, strategy)
    tout = train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                 TrainLoopConfig(total_steps=steps, log_every=0, lr=3e-3,
                                 events=[FaultEvent(*e) for e in events], **loop),
                 params=params, device="cpu")
    return jout, tout


def test_loop_matches_reference_under_fail_and_rejoin():
    """20 steps of adaptive_kbeta with a fail at step 5 and a rejoin at
    step 12. Per step, k, beta, n_workers, sim_time and contributors are
    equal, and so is every stage switch; loss and grad_norm agree within
    1e-4 relative (f32 in two frameworks, 20 AdamW steps apart)."""
    jout, tout = _both("llama3.2-1b", [(5, "fail", 1), (12, "rejoin", 1)], 20)
    jh, th = jout["history"], tout["history"]
    assert len(jh) == len(th) == 20
    for a, b in zip(jh, th):
        for key in ("step", "k", "beta", "n_workers", "sim_time", "contributors"):
            assert a[key] == b[key], (a["step"], key, a[key], b[key])
        assert a.get("switched_to") == b.get("switched_to"), a["step"]
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)
    assert [h["n_workers"] for h in th][4:7] == [4, 3, 3]
    assert th[-1]["n_workers"] == 4 and tout["alive"].all()
    assert len({(h["k"], h["beta"]) for h in th}) >= 2
    assert tout["controller"].state_dict()["stage_history"] == \
        jout["controller"].state_dict()["stage_history"]
    assert [tuple(s) for s in tout["compiled_shapes"]] == \
        [tuple(s) for s in jout["compiled_shapes"]]


def test_demotion_matches_reference():
    """A worker slowed 6x is demoted by the censoring-aware tracker: the
    same worker at the same step as in the reference."""
    jout, tout = _both("smollm-135m", [(0, "slow", 2, 6.0)], 30, strategy="fastest_k",
                       demote_after_ewma=2.0)
    jn = [h["n_workers"] for h in jout["history"]]
    tn = [h["n_workers"] for h in tout["history"]]
    assert tn == jn and min(tn) == 3, (jn, tn)
    np.testing.assert_array_equal(tout["alive"], jout["alive"])
    assert not tout["alive"][2]
    for a, b in zip(jout["history"], tout["history"]):
        assert a["sim_time"] == b["sim_time"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_replays_the_uninterrupted_run_exactly(dtype):
    """A run checkpointed at step 20 and 40 and resumed from 40 by a fresh
    loop replays the uninterrupted run's steps 40-43 field for field and
    ends with the same parameters bit for bit (bf16 weights are stored as
    their 16-bit patterns).

    Runs on one CPU thread: with several, MKL's matrix products are not
    reproducible from run to run (two uninterrupted runs already part
    in the last bit after ~14 steps), so bit-exactness would test MKL,
    not the checkpoint."""
    cfg = port_config("llama3.2-1b").reduced(**TINY, dtype=dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    events = [FaultEvent(8, "slow", 1, 3.0), FaultEvent(15, "fail", 2),
              FaultEvent(32, "rejoin", 2)]
    with tempfile.TemporaryDirectory() as d:
        def run():
            st, delay, batcher = _setup(tcore, tdata)
            return train(Model(cfg), get_optimizer("adamw"), st, delay, batcher,
                         TrainLoopConfig(total_steps=44, log_every=0, lr=3e-3,
                                         checkpoint_dir=d, checkpoint_every=20,
                                         events=events), device="cpu")
        try:
            out1 = run()
            out2 = run()                   # fresh everything, state from disk
        finally:
            torch.set_num_threads(threads)
    tail = [h for h in out1["history"] if h["step"] >= 40]
    assert out2["history"][0]["step"] == 40 and out2["history"] == tail
    assert out2["controller"].state_dict() == out1["controller"].state_dict()
    np.testing.assert_array_equal(out2["alive"], out1["alive"])
    for a, b in zip(tree_leaves(out1["params"], is_leaf=torch.is_tensor),
                    tree_leaves(out2["params"], is_leaf=torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out2["opt_state"]["step"]) == int(out1["opt_state"]["step"]) == 44
