"""Worker response-time models from the paper (Definitions 1 and 2): the
port's copy of ``repro.core.delay_models`` (numpy only).

A worker's response time is ``Z_i = X_i + Y_i`` where ``X_i`` is the
communication time and ``Y_i`` the computation time for a load fraction
``beta`` of the worker's ``s`` local samples.

* Definition 1 (simplified): ``X_i = x`` (constant),
  ``Y_i ~ y + Exp(rate = lambda_y / beta)`` (mean ``beta / lambda_y``).
* Definition 2 (generalized): ``X_i ~ x + Exp(rate = lambda_x)``,
  ``Y_i ~ y * beta + Exp(rate = lambda_y / beta)``.

Both models make the paper's key structural point explicit: the mean
computation time scales linearly with the load ``beta`` while the
communication time does not.

This module also provides maximum-likelihood estimation of the model
parameters from observed response times, so the production controller can
run from telemetry instead of oracle knowledge (DESIGN.md §2.4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = [
    "SimplifiedDelayModel",
    "GeneralizedDelayModel",
    "fit_simplified_mle",
    "fit_simplified_mle_censored",
    "fit_generalized_mm",
]


@dataclasses.dataclass(frozen=True)
class SimplifiedDelayModel:
    """Definition 1. ``Z = x + y + Exp(rate=lambda_y/beta)``."""

    lambda_y: float  # computation rate at beta = 1 (mean comp time = beta/lambda_y)
    x: float = 0.0   # constant communication time
    y: float = 0.0   # constant computation offset

    #: number of standard-exponential draws per worker needed by ``compose``
    n_exp_streams = 1

    def __post_init__(self) -> None:
        if self.lambda_y <= 0:
            raise ValueError(f"lambda_y must be > 0, got {self.lambda_y}")
        if self.x < 0 or self.y < 0:
            raise ValueError("shifts x, y must be >= 0")

    @property
    def shift(self) -> float:
        return self.x + self.y

    def comp_rate(self, beta: float) -> float:
        """Rate of the exponential computation component for load ``beta``."""
        _check_beta(beta)
        return self.lambda_y / beta

    def mean(self, beta: float) -> float:
        return self.shift + beta / self.lambda_y

    def sample(self, rng: np.random.Generator, n: int, beta: float) -> np.ndarray:
        """Draw ``n`` i.i.d. response times for load ``beta``."""
        _check_beta(beta)
        return self.shift + rng.exponential(scale=beta / self.lambda_y, size=n)

    def compose(self, E: np.ndarray, beta) -> np.ndarray:
        """Response times from pre-drawn standard exponentials.

        ``E`` has shape ``(..., n_exp_streams, n)``; ``beta`` is a scalar
        or an array broadcastable against the leading axes (one load per
        batch lane). Both simulation engines draw ``E`` in chunks and
        compose lazily, so scalar and batched runs consume identical RNG
        streams per lane regardless of the stage schedule.
        """
        _check_beta(beta)
        scale = np.asarray(beta) / self.lambda_y
        return self.shift + scale * E[..., 0, :]


@dataclasses.dataclass(frozen=True)
class GeneralizedDelayModel:
    """Definition 2. ``Z = (x + Exp(lambda_x)) + (y*beta + Exp(lambda_y/beta))``."""

    lambda_x: float  # communication rate
    lambda_y: float  # computation rate at beta = 1
    x: float = 0.0
    y: float = 0.0

    n_exp_streams = 2

    def __post_init__(self) -> None:
        if self.lambda_x <= 0 or self.lambda_y <= 0:
            raise ValueError("rates must be > 0")
        if self.x < 0 or self.y < 0:
            raise ValueError("shifts x, y must be >= 0")

    def shift(self, beta: float) -> float:
        _check_beta(beta)
        return self.x + self.y * beta

    def comp_rate(self, beta: float) -> float:
        _check_beta(beta)
        return self.lambda_y / beta

    def mean(self, beta: float) -> float:
        return self.shift(beta) + 1.0 / self.lambda_x + beta / self.lambda_y

    def sample(self, rng: np.random.Generator, n: int, beta: float) -> np.ndarray:
        _check_beta(beta)
        comm = rng.exponential(scale=1.0 / self.lambda_x, size=n)
        comp = rng.exponential(scale=beta / self.lambda_y, size=n)
        return self.shift(beta) + comm + comp

    def compose(self, E: np.ndarray, beta) -> np.ndarray:
        """Response times from pre-drawn standard exponentials.

        ``E[..., 0, :]`` feeds the communication term, ``E[..., 1, :]``
        the load-scaled computation term (see ``SimplifiedDelayModel.compose``).
        """
        b = np.asarray(beta)
        comp_scale = b / self.lambda_y
        return (
            self.shift(beta)
            + E[..., 0, :] / self.lambda_x
            + comp_scale * E[..., 1, :]
        )


def _check_beta(beta) -> None:
    b = np.asarray(beta)
    if np.any(b <= 0.0) or np.any(b > 1.0):
        raise ValueError(f"beta must be in (0, 1], got {beta}")


# ---------------------------------------------------------------------------
# Parameter estimation from telemetry
# ---------------------------------------------------------------------------

def fit_simplified_mle(
    samples: np.ndarray, betas: np.ndarray
) -> SimplifiedDelayModel:
    """MLE of the simplified model from (response time, load) telemetry.

    For a shifted exponential with known per-sample scale multiplier
    ``beta_i`` the MLE of the shift is ``min_i (z_i)`` restricted by the
    smallest normalized sample and the rate follows from the mean of the
    normalized excesses:

        z_i = shift + beta_i * E_i / lambda_y,  E_i ~ Exp(1)
        shift_hat = min_i z_i  (consistent, biased by O(1/n))
        lambda_hat = mean_i (beta_i) applied to excess via MLE closed form.
    """
    z = np.asarray(samples, dtype=np.float64)
    b = np.broadcast_to(np.asarray(betas, dtype=np.float64), z.shape)
    if z.size < 2:
        raise ValueError("need at least 2 samples")
    # Normalize to unit load: (z - shift) / beta ~ Exp(lambda_y).
    # Joint MLE: shift_hat minimizes over the normalized support constraint.
    # z_i >= shift for all i; likelihood increases in shift, so
    # shift_hat = min_i z_i (attained where beta smallest matters only via
    # support; the constant shift is load independent under Def. 1).
    shift_hat = float(z.min())
    excess = (z - shift_hat) / b
    mean_excess = float(excess.mean())
    if mean_excess <= 0:
        # Degenerate (all samples equal): fall back to a large rate.
        return SimplifiedDelayModel(lambda_y=1e9, x=shift_hat, y=0.0)
    lambda_hat = 1.0 / mean_excess
    return SimplifiedDelayModel(lambda_y=lambda_hat, x=shift_hat, y=0.0)


def fit_simplified_mle_censored(
    samples: np.ndarray,
    betas: np.ndarray,
    censored: Optional[np.ndarray] = None,
) -> SimplifiedDelayModel:
    """Censoring-aware MLE of the simplified model (type-II censoring).

    On real hardware a fastest-k step observes only the k smallest of n
    response times; the n - k stragglers are *censored* at the step's
    k-th order statistic (we only learn ``Z > z_(k)``). Fitting the
    uncensored MLE to such telemetry is biased fast: the sample mean of
    the k winners underestimates the fleet mean, so ``lambda_y`` comes
    out too large and every ``expected_kth`` price is too optimistic.

    ``censored[i]`` counts the workers censored at observation ``i``'s
    value (the caller attaches ``n - k`` to each step's largest observed
    time; 0 elsewhere). The rate MLE is the classic total-time-on-test
    estimator (Epstein & Sobel): with normalized excesses
    ``e_i = (z_i - shift) / beta_i ~ Exp(lambda_y)``,

        lambda_hat = N_observed / sum_i (1 + censored_i) * e_i,

    which is exactly the exponential MLE when nothing is censored
    (``fit_simplified_mle``). The shift MLE is unchanged: censoring only
    tells us ``Z > z_(k) >= min_i z_i``, so the likelihood still
    increases in the shift up to the smallest *observed* sample.
    """
    if censored is None:
        return fit_simplified_mle(samples, betas)
    z = np.asarray(samples, dtype=np.float64)
    b = np.broadcast_to(np.asarray(betas, dtype=np.float64), z.shape)
    c = np.broadcast_to(np.asarray(censored, dtype=np.float64), z.shape)
    if z.size < 2:
        raise ValueError("need at least 2 samples")
    if np.any(c < 0):
        raise ValueError("censored counts must be >= 0")
    shift_hat = float(z.min())
    excess = (z - shift_hat) / b
    total_time_on_test = float(((1.0 + c) * excess).sum())
    if total_time_on_test <= 0:
        return SimplifiedDelayModel(lambda_y=1e9, x=shift_hat, y=0.0)
    lambda_hat = float(z.size) / total_time_on_test
    return SimplifiedDelayModel(lambda_y=lambda_hat, x=shift_hat, y=0.0)


def fit_generalized_mm(
    samples: np.ndarray,
    betas: np.ndarray,
    *,
    x_shift: float = 0.0,
    y_shift: float = 0.0,
) -> GeneralizedDelayModel:
    """Method-of-moments fit of the generalized model.

    The hypoexponential sum has mean ``1/lx + beta/ly`` and variance
    ``1/lx^2 + (beta/ly)^2`` (after removing known shifts). With telemetry
    at two or more distinct loads the two rates are identified by solving
    the per-load moment equations in the least-squares sense; with a single
    load we split the variance evenly (documented fallback).
    """
    z = np.asarray(samples, dtype=np.float64)
    b = np.broadcast_to(np.asarray(betas, dtype=np.float64), z.shape)
    zc = z - x_shift - y_shift * b
    uniq = np.unique(b)
    if uniq.size >= 2:
        # mean_j = 1/lx + beta_j * (1/ly): linear regression on beta.
        means = np.array([zc[b == u].mean() for u in uniq])
        A = np.stack([np.ones_like(uniq), uniq], axis=1)
        coef, *_ = np.linalg.lstsq(A, means, rcond=None)
        inv_lx, inv_ly = float(coef[0]), float(coef[1])
        inv_lx = max(inv_lx, 1e-12)
        inv_ly = max(inv_ly, 1e-12)
        return GeneralizedDelayModel(
            lambda_x=1.0 / inv_lx, lambda_y=1.0 / inv_ly, x=x_shift, y=y_shift
        )
    # Single load: use mean and variance.
    beta = float(uniq[0])
    m, v = float(zc.mean()), float(zc.var())
    # mean = a + c, var = a^2 + c^2 with a = 1/lx, c = beta/ly.
    # Solve: a + c = m, a^2 + c^2 = v  ->  a,c = (m +- sqrt(2v - m^2)) / 2.
    disc = max(2.0 * v - m * m, 0.0)
    root = math.sqrt(disc)
    a = max((m - root) / 2.0, 1e-12)
    c = max((m + root) / 2.0, 1e-12)
    return GeneralizedDelayModel(
        lambda_x=1.0 / a, lambda_y=beta / c, x=x_shift, y=y_shift
    )
