"""The paper's control plane, as the port's training loop needs it: the
port's own copies of ``repro.core``'s delay models, order statistics,
optimal load, stationarity diagnostics and stage controller (numpy only).

The analytic schedule roll-out, the simulation engines, the error model
and the switching times stay in the reference until a slice needs them.
"""

from .controller import Controller, Stage, StrategyConfig, next_stage, stage_table
from .delay_models import (
    GeneralizedDelayModel,
    SimplifiedDelayModel,
    fit_simplified_mle_censored,
)
from .diagnostics import DiagnosticConfig

__all__ = [
    "Controller",
    "DiagnosticConfig",
    "GeneralizedDelayModel",
    "SimplifiedDelayModel",
    "Stage",
    "StrategyConfig",
    "fit_simplified_mle_censored",
    "next_stage",
    "stage_table",
]
