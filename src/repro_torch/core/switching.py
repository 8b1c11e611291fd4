"""Optimal stage-switching times (Theorem 2; the port's copy of
``repro.core.switching``, plain Python).

Given the current stage ``tau`` (k, beta, started at t_{tau-1} with gap
e(t_{tau-1})) and the parameters of the next stage, the optimal time to
switch is when the *time* derivative of the error bound of the next stage
overtakes that of the current stage (Eq. 9):

    t_tau = t_{tau-1} + (mu_tau / alpha) * log(
        (mu_{tau+1} - mu_tau) * phi_{tau+1} * (2 c phi_tau s e(t_{tau-1}) - eta L sigma^2)
        / (mu_tau * eta L sigma^2 * (phi_{tau+1} - phi_tau)) )

Degenerate cases (switch immediately, i.e. dt = 0):
  * the current gap is already at/below the current stage's floor,
  * the log argument is <= 1 (the next stage dominates from the start).
"""

from __future__ import annotations

import math

from .error_model import SGDHyperParams, alpha, error_floor

__all__ = ["switching_interval"]


def switching_interval(
    hp: SGDHyperParams,
    *,
    phi_cur: float,
    mu_cur: float,
    phi_next: float,
    mu_next: float,
    gap_start: float,
) -> float:
    """Duration dt = t_tau - t_{tau-1} of stage tau per Theorem 2.

    Args:
      phi_cur / phi_next: effective batch factors k*beta of the two stages.
      mu_cur / mu_next: expected per-iteration durations mu_{k:n}(beta).
      gap_start: e(t_{tau-1}), the optimality gap when the stage began.

    Returns:
      Non-negative switching interval (0 means switch immediately).
    """
    if phi_next <= phi_cur:
        raise ValueError(
            f"stages must strictly grow phi: {phi_cur} -> {phi_next}"
        )
    if mu_next <= mu_cur:
        # Next stage is both statistically larger AND faster per iteration:
        # it strictly dominates, switch immediately. (Possible under Def. 2
        # when raising k while slashing beta.)
        return 0.0
    num = 2.0 * hp.c * phi_cur * hp.s * gap_start - hp.eta * hp.L * hp.sigma_grad2
    if num <= 0.0:
        # Gap already at/below the current floor -> no progress left here.
        return 0.0
    arg = (
        (mu_next - mu_cur)
        * phi_next
        * num
        / (mu_cur * hp.eta * hp.L * hp.sigma_grad2 * (phi_next - phi_cur))
    )
    if arg <= 1.0:
        return 0.0
    return mu_cur / alpha(hp) * math.log(arg)


def gap_at_switch(
    hp: SGDHyperParams,
    *,
    phi_cur: float,
    mu_cur: float,
    gap_start: float,
    dt: float,
) -> float:
    """e(t_tau) from e(t_{tau-1}) after running stage tau for dt (Eq. 10)."""
    fl = error_floor(hp, phi_cur)
    return fl + math.exp(-alpha(hp) * dt / mu_cur) * (gap_start - fl)
