"""The SGD error-decay model of Eq. (1) and its stage recursion Eq. (10)
(the port's copy of ``repro.core.error_model``, plain Python).

For a stage running with ``k`` workers at load ``beta`` (effective batch
``phi * s`` with ``phi = k * beta``), the expected optimality gap after j
iterations obeys

    E(k, beta, j) <= floor + (1 - eta*c)^j * (e0 - floor),
    floor = eta * L * sigma_grad^2 / (2 * c * s * phi).

Time enters through the per-iteration duration mu_{k:n}(beta): j = t / mu.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["SGDHyperParams", "error_floor", "error_after", "time_to_error", "alpha"]


@dataclasses.dataclass(frozen=True)
class SGDHyperParams:
    """Constants of the convergence bound (Bottou et al. [45])."""

    eta: float          # learning rate
    L: float            # Lipschitz constant of the gradient
    sigma_grad2: float  # upper bound on per-sample gradient variance
    c: float            # strong-convexity parameter
    s: int              # samples per worker

    def __post_init__(self) -> None:
        if not (0.0 < self.eta * self.c < 1.0):
            raise ValueError(
                f"need 0 < eta*c < 1 for contraction, got {self.eta * self.c}"
            )
        if self.s <= 0:
            raise ValueError("s must be positive")


def alpha(hp: SGDHyperParams) -> float:
    """Per-iteration contraction exponent: alpha = -log(1 - eta c) > 0."""
    return -math.log1p(-hp.eta * hp.c)


def error_floor(hp: SGDHyperParams, phi: float) -> float:
    """Stationary error floor for effective batch-size factor phi = k*beta."""
    if phi <= 0:
        raise ValueError("phi must be > 0")
    return hp.eta * hp.L * hp.sigma_grad2 / (2.0 * hp.c * hp.s * phi)


def error_after(
    hp: SGDHyperParams, phi: float, e0: float, iters: float
) -> float:
    """Gap after ``iters`` iterations starting from gap ``e0`` (Eq. 10)."""
    fl = error_floor(hp, phi)
    return fl + math.exp(-alpha(hp) * iters) * (e0 - fl)


def time_to_error(
    hp: SGDHyperParams, phi: float, mu: float, e0: float, target: float
) -> float:
    """Time for the stage (per-iteration cost ``mu``) to reach ``target``.

    Returns ``inf`` if the target lies at or below this stage's floor.
    """
    fl = error_floor(hp, phi)
    if target <= fl or e0 <= target:
        return 0.0 if e0 <= target else math.inf
    return mu / alpha(hp) * math.log((e0 - fl) / (target - fl))
