"""End-to-end training on the PyTorch port: train an LM with the
adaptive-(k, beta) controller, on the card.

The twin of ``examples/train_lm.py``: the same flags, defaults, configs
and printed lines, through ``repro_torch.runtime.train_loop.train``:
synthetic token pipeline -> per-stage beta-scaled batches -> masked
fastest-k aggregation (simulated worker delays) -> AdamW ->
stationarity-diagnostic stage advancement -> async checkpoints. The
default tiny preset trains in seconds; ``--preset smollm`` is
smollm-135m at full width in f32.

    python examples/train_lm_torch.py                        # tiny, the card
    python examples/train_lm_torch.py --preset smollm        # ~135M, the card
    python examples/train_lm_torch.py --fail-worker-at 10    # a worker dies
    python examples/train_lm_torch.py --checkpoint-dir DIR   # rerun to resume
    python examples/train_lm_torch.py --device cpu           # the CPU

``--device`` defaults to ``cuda`` and raises where no card is present;
the CPU runs only when asked for. PyTorch runs eagerly, so nothing is
compiled per batch shape: the loop still reports the shapes it ran
under ``compiled_shapes``.
"""

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core import DiagnosticConfig, SimplifiedDelayModel, StrategyConfig
from repro_torch.data import StagedBatcher, TokenStream
from repro_torch.models import build_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["tiny", "smollm"], default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-workers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--fail-worker-at", type=int, default=None,
                    help="inject a worker failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    return ap.parse_args(argv)


def preset_config(preset: str, seq_len: int):
    """The reference's model config of ``preset``."""
    if preset == "smollm":
        cfg = get_config("smollm-135m")
        return dataclasses.replace(cfg, max_seq_len=seq_len, remat="none",
                                   dtype="float32", scan_layers=True)
    return get_config("smollm-135m").reduced(
        n_layers=4, d_model=128, vocab_size=512, max_seq_len=seq_len
    )


def main(argv=None, *, params=None) -> dict:
    """Train and print the reference's lines; return them as records.
    ``params``: initial weights in place of the port's seeded draw (a
    test hands over the reference's)."""
    args = parse_args(argv)
    cfg = preset_config(args.preset, args.seq_len)
    model = build_model(cfg)
    optimizer = get_optimizer("adamw", weight_decay=0.01)

    n = args.n_workers
    strategy = StrategyConfig(
        "adaptive_kbeta",
        n=n,
        s=args.global_batch // n,
        k_max=n // 2,
        beta_grid=(0.25, 0.5, 0.75, 1.0),
        diagnostic=DiagnosticConfig(kind="loss", rel_tol=0.02, min_iters=10,
                                    consecutive=3),
    )
    delay_model = SimplifiedDelayModel(lambda_y=1.0, x=0.05)
    batcher = StagedBatcher(
        TokenStream(cfg.vocab_size, seed=0),
        n_workers=n,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
    )
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps,
        lr=3e-4,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=100,
        log_every=20,
        fail_worker_at=args.fail_worker_at,
    )
    out = train(model, optimizer, strategy, delay_model, batcher, loop_cfg,
                params=params, device=args.device)
    hist = out["history"]
    rec = {
        "final_loss": hist[-1]["loss"], "start_loss": hist[0]["loss"],
        "stage_path": [(h["k"], h["beta"]) for h in hist if "switched_to" in h],
        "compiled_shapes": [tuple(s) for s in out["compiled_shapes"]],
        "sim_time": out["sim_time"],
    }
    print(f"\nfinal loss {rec['final_loss']:.4f} (start {rec['start_loss']:.4f})")
    print(f"stage path: {rec['stage_path']}")
    print(f"compiled step shapes (one per beta): {out['compiled_shapes']}")
    print(f"simulated wall-clock: {rec['sim_time']:.1f}")
    return rec


if __name__ == "__main__":
    main()
