"""Quickstart on the PyTorch port's copy of the paper's math: the paper
in ~60 seconds.

The twin of ``examples/quickstart.py``: it reproduces the core claims of
Egger, Kas Hanna & Bitar (2023), adaptive-(k, beta) distributed SGD vs
the adaptive-k baseline [39] on the paper's linear-regression setting
(n=20 workers, v=400 samples, lambda_y=1, x=0.01, beta grid {0.2..1},
k <= 10), through ``repro_torch.core``. The analytic schedules and the
scalar event-driven simulator are host numpy work in both packages, so
this twin has no ``--device`` flag: it uses no card.

    python examples/quickstart_torch.py
"""

import argparse

import numpy as np

from repro_torch.core import (
    LinregProblem,
    SGDHyperParams,
    SimplifiedDelayModel,
    StrategyConfig,
    evaluate_schedule,
    simulate,
)

GRID = (0.2, 0.4, 0.6, 0.8, 1.0)


def main(argv=None) -> dict:
    """Print the reference's lines; return them as records."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    print(__doc__)
    problem = LinregProblem.generate(v=400, d=10, n_workers=20, seed=1)
    model = SimplifiedDelayModel(lambda_y=1.0, x=0.01)

    # --- analytic schedules (Thm. 2 + Cor. 4) ---------------------------
    lam = np.linalg.eigvalsh(2.0 * problem.X.T @ problem.X / problem.v)
    c = float(2.0 * lam.min())
    fl1 = 0.1846 * problem.eta / 9.284e-6
    hp = SGDHyperParams(
        eta=problem.eta, L=2.0,
        sigma_grad2=fl1 * 2 * c * problem.s / (problem.eta * 2.0),
        c=c, s=problem.s,
    )
    e0 = problem.gap(np.zeros(problem.d))
    res = {}
    for strat in ("adaptive_kbeta", "adaptive_k"):
        cfg = StrategyConfig(strat, n=20, s=20, k_max=10, beta_grid=GRID)
        res[strat] = evaluate_schedule(cfg, model, hp, e0=e0, target=2e-2)
    ours, ak = res["adaptive_kbeta"], res["adaptive_k"]
    rec = {"analytic": dict(runtime_ratio=ours.runtime / ak.runtime,
                            computation_reduction=1 - ours.comp_cost / ak.comp_cost,
                            communication_overhead=ours.comm_cost / ak.comm_cost - 1,
                            stage_path=[(s.k, s.beta) for s in ours.stages[:8]])}
    a = rec["analytic"]
    print("analytic schedule (paper's theory):")
    print(f"  runtime ratio ours/adaptive-k : {a['runtime_ratio']:.3f}  (paper: ~0.5)")
    print(f"  computation reduction         : {a['computation_reduction']:.1%}  (paper: 59.9%)")
    print(f"  communication overhead        : {a['communication_overhead']:.1%}  (paper: 15.7%)")
    print("\n  ours stage path:",
          " -> ".join(f"(k={s.k},b={s.beta:.1f})" for s in ours.stages[:8]),
          "...")

    # --- one live simulated run per strategy -----------------------------
    print("\nevent-driven simulation (single seed, stationarity diagnostics):")
    rec["simulation"] = {}
    for strat in ("adaptive_kbeta", "adaptive_k"):
        cfg = StrategyConfig(strat, n=20, s=20, k_max=10, beta_grid=GRID)
        r = simulate(problem, cfg, model, seed=0, max_iters=20_000,
                     target_gap=2e-2, eval_every=10)
        last = r.stage_log[-1][1]
        rec["simulation"][strat] = dict(time_to_gap=r.time_to_gap(2e-2),
                                        stages=len(r.stage_log), final=(last.k, last.beta))
        print(f"  {strat:15s}: T(gap<=2e-2) = {r.time_to_gap(2e-2):8.1f}  "
              f"stages: {len(r.stage_log)}  final (k={last.k}, "
              f"beta={last.beta:.1f})")
    return rec


if __name__ == "__main__":
    main()
