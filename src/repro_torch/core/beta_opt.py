"""Optimal next-stage load beta_{tau+1} when raising k (Thm. 3 / Cor. 4):
the port's copy of ``repro.core.beta_opt`` (numpy only).

When beta has saturated at 1 and k must grow (k_next > k_cur), the paper
shows the next load should be *reduced* to the maximizer of

    O(beta) = (phi_next - phi_cur)
              / (phi_cur * phi_next * (mu_{k_next:n}(beta) - mu_cur)),

subject to beta in [beta_min, 1], beta a multiple of 1/s, and
phi_next = k_next * beta > phi_cur.

* Under Def. 1 the problem is concave with the closed-form roots of
  Cor. 4 (``cor4_beta``).
* Under Def. 2 we maximize O numerically over the feasible grid using the
  Thm. 5 order statistics (``numerical_beta``) — the paper prescribes a
  numerical solution for this model.
"""

from __future__ import annotations

import math

from .delay_models import SimplifiedDelayModel
from .order_stats import DelayModel, expected_kth, harmonic_tail

__all__ = ["beta_min_for", "cor4_beta", "numerical_beta", "optimal_beta"]


def beta_min_for(k_cur: int, beta_cur: float, k_next: int, s: int) -> float:
    """Smallest feasible next load: beta_min = ceil(k_cur * beta_cur * s / k_next)/s.

    Paper statement uses beta_cur = 1 (k grows only once beta saturates):
    beta_min = ceil(k_cur s / k_next)/s. We keep the general form so the
    controller may raise k early (e.g. after worker loss).
    """
    phi_cur = k_cur * beta_cur
    bmin = math.ceil(phi_cur * s / k_next) / s
    # phi must STRICTLY grow; bump one grid step on exact equality.
    if k_next * bmin <= phi_cur + 1e-12:
        bmin += 1.0 / s
    return min(bmin, 1.0)


def _objective(
    model: DelayModel,
    n: int,
    k_cur: int,
    beta_cur: float,
    k_next: int,
    beta_next: float,
) -> float:
    """O(beta_next) from the proof of Thm. 3 (larger is better)."""
    phi_cur = k_cur * beta_cur
    phi_next = k_next * beta_next
    if phi_next <= phi_cur:
        return -math.inf
    mu_cur = expected_kth(model, n, k_cur, beta_cur)
    mu_next = expected_kth(model, n, k_next, beta_next)
    if mu_next <= mu_cur:
        # Strictly dominating stage; objective unbounded in the bound's
        # terms — treat as maximal preference.
        return math.inf
    return (phi_next - phi_cur) / (phi_cur * phi_next * (mu_next - mu_cur))


def _snap_to_grid(beta: float, s: int, bmin: float) -> float:
    """Round UP to a multiple of 1/s and clip to [bmin, 1] (paper's rule)."""
    b = math.ceil(beta * s - 1e-9) / s
    return max(bmin, min(1.0, b))


def cor4_beta(
    model: SimplifiedDelayModel,
    n: int,
    k_cur: int,
    beta_cur: float,
    k_next: int,
    s: int,
) -> float:
    """Closed-form beta_{tau+1} under Def. 1 (Corollary 4).

    beta_{1,2} = (phi/k_next) * (1 +- sqrt(1 - (k_next/k_cur) * mu'_cur/mu'_next))
    with mu'(beta) = H(n,k)/lambda_y, so the rate lambda_y cancels:
    the discriminant is 1 - (k_next * H(n,k_cur)) / (k_cur * H(n,k_next)).
    """
    if k_next <= k_cur:
        raise ValueError("Cor. 4 applies when k grows")
    phi_cur = k_cur * beta_cur
    disc = 1.0 - (k_next * harmonic_tail(n, k_cur)) / (
        k_cur * harmonic_tail(n, k_next)
    )
    # Concavity proof (Appendix B) guarantees disc in (0, 1).
    disc = max(disc, 0.0)
    root = math.sqrt(disc)
    cands = [
        phi_cur / k_next * (1.0 - root),
        phi_cur / k_next * (1.0 + root),
    ]
    bmin = beta_min_for(k_cur, beta_cur, k_next, s)
    best_b, best_o = 1.0, -math.inf
    for b in cands:
        b_snapped = _snap_to_grid(b, s, bmin)
        o = _objective(model, n, k_cur, beta_cur, k_next, b_snapped)
        # Tie-break toward the smaller beta: lower computation effort.
        if o > best_o or (o == best_o and b_snapped < best_b):
            best_o, best_b = o, b_snapped
    return best_b


def numerical_beta(
    model: DelayModel,
    n: int,
    k_cur: int,
    beta_cur: float,
    k_next: int,
    s: int,
) -> float:
    """Grid maximization of O over feasible multiples of 1/s (Def. 2 path).

    s is at most a few thousand in the paper's regimes; an exact scan of
    the feasible grid is both simpler and safer than golden-section on a
    function whose concavity is only proven for Def. 1.
    """
    bmin = beta_min_for(k_cur, beta_cur, k_next, s)
    best_b, best_o = 1.0, -math.inf
    steps = int(round((1.0 - bmin) * s)) + 1
    for i in range(steps):
        b = min(1.0, bmin + i / s)
        o = _objective(model, n, k_cur, beta_cur, k_next, b)
        if o > best_o + 1e-15:
            best_o, best_b = o, b
    return best_b


def optimal_beta(
    model: DelayModel,
    n: int,
    k_cur: int,
    beta_cur: float,
    k_next: int,
    s: int,
) -> float:
    """Dispatch: closed form for Def. 1, numerical for Def. 2."""
    if isinstance(model, SimplifiedDelayModel):
        return cor4_beta(model, n, k_cur, beta_cur, k_next, s)
    return numerical_beta(model, n, k_cur, beta_cur, k_next, s)
