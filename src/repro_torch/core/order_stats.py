"""Order statistics of worker response times (Prop. 1 and Thm. 5): the
port's copy of ``repro.core.order_stats`` (numpy only), without the
Thm. 5 quadruple sum the reference keeps to cross-check its quadrature.

``mu_{k:n}(beta)`` is the expected time until the k-th fastest of n workers
responds, given per-worker load ``beta``. This is the per-iteration cost of
the fastest-k strategy and the quantity every scheduling decision in the
paper is priced against.

* Simplified model (Def. 1): closed form (Prop. 1)
    mu^(1)_{k:n}(beta) = (beta/lambda_y) * H(n, k) + x + y,
  with the harmonic tail H(n, k) = sum_{j=n-k+1}^n 1/j.

* Generalized model (Def. 2): the paper's Thm. 5 gives an alternating
  quadruple sum which is numerically catastrophic beyond n ~ 20 (binomial
  coefficients up to 2^n with signed cancellation). We evaluate the same
  expectation by exact survival-function integration,

    E[S_{(k)}] = int_0^inf (1 - F_{(k)}(z)) dz,
    F_{(k)}(z) = sum_{j=k}^n C(n,j) F(z)^j (1-F(z))^{n-j},

  with the closed-form hypoexponential CDF F, using Gauss-Legendre
  quadrature. See DESIGN.md §8.5.

Public API contract: everything here is pure math over the two delay
models in ``delay_models`` — no model/runtime state, no
randomness, safe to call from any scheduler at decision frequency.
Every consumer prices decisions with the same two functions:
``expected_kth`` (training controller, ``serve.router.HedgedRouter``
fan-outs, ``serve.speculative`` hedged gamma pricing) and
``expected_kth_derivative`` (beta* line search).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple, Union

import numpy as np

from .delay_models import GeneralizedDelayModel, SimplifiedDelayModel

DelayModel = Union[SimplifiedDelayModel, GeneralizedDelayModel]


def _is_simplified(model: DelayModel) -> bool:
    """Structural dispatch: Def. 2 adds the communication rate
    ``lambda_x``; Def. 1 has none. (Not ``isinstance`` — the module can
    be imported under two package names, e.g. pytest --doctest-modules
    with the src/ namespace layout, and class identity would not
    survive.)"""
    return not hasattr(model, "lambda_x")

__all__ = [
    "harmonic_tail",
    "expected_kth",
    "expected_kth_derivative",
]


@lru_cache(maxsize=4096)
def harmonic_tail(n: int, k: int) -> float:
    """H(n, k) = sum_{j=n-k+1}^{n} 1/j — grows with k, shrinks with n.

    >>> harmonic_tail(4, 1)
    0.25
    >>> round(harmonic_tail(3, 3), 6)       # full wait: H_3
    1.833333
    >>> harmonic_tail(8, 2) < harmonic_tail(4, 2)   # more workers help
    True
    """
    if not (1 <= k <= n):
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    return float(sum(1.0 / j for j in range(n - k + 1, n + 1)))


def expected_kth(model: DelayModel, n: int, k: int, beta: float) -> float:
    """E[Z_{(k:n)}] for per-worker load ``beta`` under either delay model.

    Prop. 1 closed form for the simplified model (shift + scaled
    harmonic tail):

    >>> from repro_torch.core.delay_models import SimplifiedDelayModel
    >>> m = SimplifiedDelayModel(lambda_y=2.0, x=0.05)
    >>> mu = expected_kth(m, 4, 1, 1.0)
    >>> mu == m.shift + 0.5 * harmonic_tail(4, 1)
    True

    Halving the per-worker load beta halves the stochastic part:

    >>> half = expected_kth(m, 4, 1, 0.5)
    >>> round((half - m.shift) / (mu - m.shift), 6)
    0.5
    """
    if not (1 <= k <= n):
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if _is_simplified(model):
        return (beta / model.lambda_y) * harmonic_tail(n, k) + model.shift
    return model.shift(beta) + _hypoexp_kth_mean(
        model.lambda_x, model.comp_rate(beta), n, k
    )


def expected_kth_derivative(
    model: DelayModel, n: int, k: int, beta: float, *, eps: float = 1e-6
) -> float:
    """d mu_{k:n} / d beta. Closed form for Def. 1, central diff for Def. 2."""
    if _is_simplified(model):
        return harmonic_tail(n, k) / model.lambda_y
    lo = max(beta - eps, 1e-9)
    hi = min(beta + eps, 1.0)
    flo = expected_kth(model, n, k, lo)
    fhi = expected_kth(model, n, k, hi)
    return (fhi - flo) / (hi - lo)


# ---------------------------------------------------------------------------
# Hypoexponential order statistics by survival integration
# ---------------------------------------------------------------------------

_GL_NODES = 384  # Gauss-Legendre nodes; integrand is smooth and monotone.


@lru_cache(maxsize=1)
def _gl_rule(nodes: int = _GL_NODES):
    x, w = np.polynomial.legendre.leggauss(nodes)
    return x, w


def _hypoexp_cdf(z: np.ndarray, a: float, b: float) -> np.ndarray:
    """CDF of Exp(a) + Exp(b) at z >= 0 (a, b rates)."""
    z = np.asarray(z, dtype=np.float64)
    if abs(a - b) < 1e-9 * max(a, b):
        # Erlang(2, a) limit.
        r = 0.5 * (a + b)
        return -np.expm1(-r * z) - r * z * np.exp(-r * z)
    return 1.0 - (b * np.exp(-a * z) - a * np.exp(-b * z)) / (b - a)


@lru_cache(maxsize=1024)
def _log_binom_tail_coeffs(n: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(j, log C(n, j)) for j = k..n — the tail's summation support."""
    j = np.arange(k, n + 1, dtype=np.float64)
    lg_n1 = math.lgamma(n + 1)
    logc = np.array(
        [lg_n1 - math.lgamma(jj + 1) - math.lgamma(n - jj + 1) for jj in range(k, n + 1)]
    )
    return j, logc


def _binom_tail(p: np.ndarray, n: int, k: int) -> np.ndarray:
    """P(Binomial(n, p) >= k) = sum_{j=k}^{n} C(n,j) p^j (1-p)^(n-j).

    Fully vectorized over the evaluation points (the quadrature nodes of
    ``_hypoexp_kth_mean``): the log-binomial coefficient vector for the
    (n, k) tail is precomputed once and the whole term matrix is
    evaluated as one broadcasted logsumexp — no Python loop over j. For
    the n <= a few hundred used by schedules, float64 log-space terms
    are accurate.
    """
    p = np.clip(np.asarray(p, dtype=np.float64), 0.0, 1.0)
    logp = np.log(np.clip(p, 1e-300, 1.0))
    log1mp = np.log1p(-np.clip(p, 0.0, 1.0 - 1e-16))
    j, logc = _log_binom_tail_coeffs(n, k)
    # terms[..., m] = log of the j=k+m summand at each evaluation point.
    terms = (
        logc
        + logp[..., None] * j
        + log1mp[..., None] * (n - j)
    )
    m = terms.max(axis=-1, keepdims=True)
    out = np.exp(m[..., 0]) * np.sum(np.exp(terms - m), axis=-1)
    # p == 1 exactly -> tail is 1.
    out = np.where(p >= 1.0 - 1e-16, 1.0, out)
    return np.clip(out, 0.0, 1.0)


def _hypoexp_kth_mean(a: float, b: float, n: int, k: int) -> float:
    """E of the k-th order statistic of n i.i.d. Exp(a)+Exp(b) sums."""
    # Integration horizon: survival of the max decays like n*exp(-r_min z).
    r_min = min(a, b)
    z_max = (math.log(max(n, 2)) + 45.0) / r_min
    x, w = _gl_rule()
    z = 0.5 * z_max * (x + 1.0)
    weights = 0.5 * z_max * w
    cdf = _hypoexp_cdf(z, a, b)
    surv_k = 1.0 - _binom_tail(cdf, n, k)
    return float(np.sum(weights * surv_k))
