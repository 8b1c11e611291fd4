"""Chaos demo on the PyTorch port: workers slowing, dying, and REJOINING
mid-run, with exact resume from an async checkpoint, on the card.

The twin of ``examples/elastic_failover.py``: the same timeline, config,
assertions and records, through ``repro_torch``.

Timeline (one adaptive-(k, beta) run, n = 8 workers):

  step 12 — worker 1 turns persistently slow (8x). The censoring-aware
            telemetry never *observes* its times (it stops making the
            fastest k); its time-on-test estimate grows from censor
            levels alone until the demotion test fires -> n -= 1.
  step 30 — worker 0 dies outright (fail event) -> n -= 1.
  step 70 — worker 0 rejoins healthy: ``Controller.add_worker`` restores
            n (and k_max up to its cap), telemetry history is reset so
            stale slowness cannot re-demote it.

Training checkpoints asynchronously throughout; we then rerun from the
latest checkpoint and verify EXACT resume: the resumed history must be
identical to the uninterrupted run's tail — same losses, same stages,
same sim-time — because the checkpoint round-trips the parameters and
optimizer state bit for bit, the full controller state, tracker state,
fleet membership, and both RNG streams. On the card that needs a step
whose every sum runs in the same order each time it runs.

Reporting goes through ``repro_torch.obs``: the per-step lines and the
demo's own milestones are echoes of structured ``StructuredLog`` records
(the assertions read the records), and the chaos phase is traced — pass
``--log PATH`` to export the record stream as JSON.

    python examples/elastic_failover_torch.py [--log PATH]        # the card
    python examples/elastic_failover_torch.py --device cpu        # the CPU

``--device`` defaults to ``cuda`` and raises where no card is present.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import DiagnosticConfig, SimplifiedDelayModel, StrategyConfig
from repro_torch.data import StagedBatcher, TokenStream
from repro_torch.models import build_model
from repro_torch.obs import Observability
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime.train_loop import FaultEvent, TrainLoopConfig, train

TOTAL = 100
CKPT_EVERY = 40  # async checkpoints at steps 40 and 80


def build():
    cfg = get_config("smollm-135m").reduced(
        n_layers=2, d_model=64, vocab_size=256, max_seq_len=64
    )
    model = build_model(cfg)
    optimizer = get_optimizer("adamw")
    n = 8
    strategy = StrategyConfig(
        "adaptive_kbeta", n=n, s=4, k_max=4, beta_grid=(0.5, 1.0),
        diagnostic=DiagnosticConfig(kind="loss", rel_tol=0.02, min_iters=8,
                                    consecutive=2),
    )
    delay = SimplifiedDelayModel(lambda_y=1.0, x=0.05)
    batcher = StagedBatcher(TokenStream(cfg.vocab_size), n_workers=n,
                            global_batch=32, seq_len=64)
    return model, optimizer, strategy, delay, batcher


def loop_cfg(ckdir):
    return TrainLoopConfig(
        total_steps=TOTAL, checkpoint_dir=ckdir, checkpoint_every=CKPT_EVERY,
        log_every=25, demote_after_ewma=5.0,
        events=[
            FaultEvent(step=12, kind="slow", worker=1, factor=8.0),
            FaultEvent(step=30, kind="fail", worker=0),
            FaultEvent(step=70, kind="rejoin", worker=0),
        ],
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", type=str, default=None, metavar="PATH",
                    help="export the structured record stream as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, *, params=None) -> dict:
    """Run the chaos timeline and the exact resume, assert the reference's
    guarantees, and return the printed records (``{"records": [...]}``).
    ``params``: the first run's initial weights in place of the port's
    seeded draw (a test hands over the reference's)."""
    args = parse_args(argv)
    threads = torch.get_num_threads()
    if resolve_device(args.device).type == "cpu":
        # PyTorch's threaded CPU products are not reproducible from run to
        # run, and exact resume is asserted bit for bit: one thread.
        torch.set_num_threads(1)
    try:
        return run(args, params)
    finally:
        torch.set_num_threads(threads)


def run(args, params) -> dict:
    obs = Observability(log_echo=True)
    log = obs.log

    model, optimizer, strategy, delay, batcher = build()
    n = strategy.n

    with tempfile.TemporaryDirectory() as ckdir:
        log.emit("phase", name="chaos", steps=TOTAL,
                 chaos="slow@12,fail@30,rejoin@70")
        out = train(model, optimizer, strategy, delay, batcher, loop_cfg(ckdir),
                    params=params, device=args.device, obs=obs)
        ctrl, hist = out["controller"], out["history"]

        n_by_step = {h["step"]: h["n_workers"] for h in hist}
        log.emit("fleet_size", start=n_by_step[0], after_fail=n_by_step[35],
                 after_rejoin=n_by_step[75], final_n=ctrl.cfg.n)
        assert n_by_step[0] == n
        assert n_by_step[35] <= n - 1, "failed worker must be removed"
        assert min(n_by_step.values()) <= n - 2, \
            "persistent straggler must be demoted by telemetry"
        assert n_by_step[75] == n_by_step[69] + 1, \
            "rejoined worker must grow n by one"
        assert not out["alive"][1], "the demoted straggler stays out"
        assert out["alive"][0], "the rejoined worker is back"

        log.emit("phase", name="exact_resume", from_step=80)
        # Fresh model/optimizer/batcher objects: everything live must come
        # back from the checkpoint, not from leftover Python state.
        model2, optimizer2, strategy2, delay2, batcher2 = build()
        out2 = train(model2, optimizer2, strategy2, delay2, batcher2,
                     loop_cfg(ckdir), device=args.device, obs=obs)
        steps2 = [h["step"] for h in out2["history"]]
        assert steps2[0] == 80, "must resume from the saved step"

        tail = [h for h in hist if h["step"] >= 80]
        assert len(tail) == len(out2["history"])
        for a, b in zip(tail, out2["history"]):
            assert a == b, f"resume diverged at step {a['step']}:\n{a}\n{b}"
        log.emit("resume_check", resumed_at=steps2[0], ran_to=steps2[-1],
                 identical_steps=len(tail),
                 note="loss, stage, sim-time, workers all match the "
                      "uninterrupted run")

        assert out2["controller"].cfg.n == ctrl.cfg.n
        np.testing.assert_array_equal(out2["alive"], out["alive"])
        log.emit("verdict", ok=True,
                 stage_decisions=len(obs.decisions.by_domain("train.stage")),
                 note="chaos + exact-resume demo OK")
        if args.log:
            log.export(args.log)
    return {"records": log.to_jsonable()}


if __name__ == "__main__":
    main()
