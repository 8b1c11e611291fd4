"""Theoretical schedule evaluation (paper Figs. 1-3 machinery; the port's
copy of ``repro.core.schedule``, plain Python).

Given hyper-parameters of the convergence bound (Eq. 1), a delay model,
and a strategy, roll the staged schedule forward analytically:

  stage tau: (k, beta)  ->  mu_tau (order stats), floor_tau,
  switch at t_tau per Thm. 2,  gap update per Eq. 10,

until the target gap is reached; accumulate the paper's cost units
(communication n + k per iteration, computation beta * s per iteration).
This module is pure host-side float math — it is what Figs. 1-3 integrate
over a (lambda_y, x) grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from .controller import Stage, StrategyConfig, next_stage
from .error_model import SGDHyperParams, error_floor, time_to_error
from .order_stats import DelayModel, expected_kth
from .switching import gap_at_switch, switching_interval

__all__ = ["StageRecord", "ScheduleResult", "evaluate_schedule"]


@dataclasses.dataclass(frozen=True)
class StageRecord:
    k: int
    beta: float
    t_start: float
    t_end: float
    iters: float
    gap_start: float
    gap_end: float
    mu: float


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    reached: bool
    runtime: float
    comp_cost: float        # sum over iterations of beta * s   (paper's unit)
    comm_cost: float        # sum over iterations of (n + k)    (paper's unit)
    stages: List[StageRecord]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def evaluate_schedule(
    cfg: StrategyConfig,
    model: DelayModel,
    hp: SGDHyperParams,
    *,
    e0: float,
    target: float,
    max_stages: int = 10_000,
) -> ScheduleResult:
    """Analytic roll-out of ``cfg.strategy`` until the gap reaches ``target``."""
    if target >= e0:
        return ScheduleResult(True, 0.0, 0.0, 0.0, [])

    stage: Optional[Stage] = cfg.initial_stage()
    t = 0.0
    gap = e0
    comp = 0.0
    comm = 0.0
    records: List[StageRecord] = []

    for _ in range(max_stages):
        assert stage is not None
        mu = expected_kth(model, cfg.n, stage.k, stage.beta)
        nxt = next_stage(cfg, stage, model)

        # Time for the *current* stage to reach the target, if it can.
        t_hit = time_to_error(hp, stage.phi, mu, gap, target)

        if nxt is None:
            # Terminal stage: run to target or report failure at the floor.
            if math.isinf(t_hit):
                return ScheduleResult(False, math.inf, comp, comm, records)
            iters = t_hit / mu
            records.append(
                StageRecord(stage.k, stage.beta, t, t + t_hit, iters, gap, target, mu)
            )
            return ScheduleResult(
                True,
                t + t_hit,
                comp + iters * stage.beta * cfg.s,
                comm + iters * (cfg.n + stage.k),
                records,
            )

        mu_next = expected_kth(model, cfg.n, nxt.k, nxt.beta)
        dt = switching_interval(
            hp,
            phi_cur=stage.phi,
            mu_cur=mu,
            phi_next=nxt.phi,
            mu_next=mu_next,
            gap_start=gap,
        )

        if t_hit <= dt:
            # Target reached inside this stage before the optimal switch.
            iters = t_hit / mu
            records.append(
                StageRecord(stage.k, stage.beta, t, t + t_hit, iters, gap, target, mu)
            )
            return ScheduleResult(
                True,
                t + t_hit,
                comp + iters * stage.beta * cfg.s,
                comm + iters * (cfg.n + stage.k),
                records,
            )

        gap_end = gap_at_switch(
            hp, phi_cur=stage.phi, mu_cur=mu, gap_start=gap, dt=dt
        )
        iters = dt / mu
        records.append(
            StageRecord(stage.k, stage.beta, t, t + dt, iters, gap, gap_end, mu)
        )
        comp += iters * stage.beta * cfg.s
        comm += iters * (cfg.n + stage.k)
        t += dt
        gap = gap_end
        stage = nxt

    raise RuntimeError(f"schedule did not terminate in {max_stages} stages")
