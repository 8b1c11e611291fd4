"""The paper's contribution, adaptive-(k, beta) straggler-tolerant SGD:
the port's copies of ``repro.core`` (numpy and plain Python, and torch
for the batched simulator's lane state).

Public surface:
  delay models (Def. 1/2)        -> delay_models
  order statistics (Prop1/Thm5)  -> order_stats
  error model (Eq. 1/10)         -> error_model
  switching times (Thm. 2)       -> switching
  optimal load beta* (Thm3/Cor4) -> beta_opt
  strategies + run-time control  -> controller
  stationarity diagnostics       -> diagnostics
  analytic schedule roll-out     -> schedule
  straggler simulation engine    -> simulation (numpy: the oracle)
  batched (multi-seed) engine    -> vector_sim (lanes in torch tensors on
                                    a device, the card by default)
"""

from .beta_opt import beta_min_for, cor4_beta, numerical_beta, optimal_beta
from .controller import Controller, Stage, StrategyConfig, next_stage, stage_table
from .delay_models import (
    GeneralizedDelayModel,
    SimplifiedDelayModel,
    fit_generalized_mm,
    fit_simplified_mle,
    fit_simplified_mle_censored,
)
from .diagnostics import DiagnosticConfig, DistanceDiagnostic, PflugDiagnostic
from .error_model import SGDHyperParams, error_after, error_floor, time_to_error
from .order_stats import expected_kth, expected_kth_derivative, harmonic_tail
from .schedule import ScheduleResult, StageRecord, evaluate_schedule
from .simulation import LinregProblem, SimResult, simulate
from .switching import gap_at_switch, switching_interval
from .vector_sim import BatchSimResult, simulate_batch

__all__ = [
    "GeneralizedDelayModel",
    "SimplifiedDelayModel",
    "fit_simplified_mle",
    "fit_simplified_mle_censored",
    "fit_generalized_mm",
    "expected_kth",
    "expected_kth_derivative",
    "harmonic_tail",
    "SGDHyperParams",
    "error_floor",
    "error_after",
    "time_to_error",
    "switching_interval",
    "gap_at_switch",
    "beta_min_for",
    "cor4_beta",
    "numerical_beta",
    "optimal_beta",
    "Controller",
    "Stage",
    "StrategyConfig",
    "next_stage",
    "stage_table",
    "DiagnosticConfig",
    "DistanceDiagnostic",
    "PflugDiagnostic",
    "ScheduleResult",
    "StageRecord",
    "evaluate_schedule",
    "LinregProblem",
    "SimResult",
    "simulate",
    "BatchSimResult",
    "simulate_batch",
]
