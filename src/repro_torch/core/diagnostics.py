"""Stationary-phase detection for constant-step SGD stages (the port's
copy of ``repro.core.diagnostics``, numpy only).

The controller must detect, at run time, when the current stage has hit
its error floor (Murata's stationary phase) so it can advance to the next
(k, beta) stage. Two diagnostics are provided:

* ``PflugDiagnostic`` [41]: the running sum of inner products of
  consecutive stochastic gradients. In the transient phase successive
  gradients are positively correlated (drift dominates), near the floor
  they anti-correlate (bounce around the optimum), so the statistic
  drifts negative at stationarity. Known to be learning-rate sensitive.

* ``DistanceDiagnostic`` (adapted from Pesme et al. [35], as the paper's
  simulations do): track Omega_j = ||w_j - w_anchor||^2 against iteration
  count on a log-log scale at geometrically spaced checkpoints. Ballistic
  transient motion gives slope ~2; diffusive/saturating stationary motion
  gives slope well below 1. Declare stationarity when the measured slope
  drops below ``threshold``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = ["PflugDiagnostic", "DistanceDiagnostic", "make_diagnostic"]


class PflugDiagnostic:
    """Pflug's inner-product statistic with a burn-in."""

    def __init__(self, burn_in: int = 32):
        self.burn_in = burn_in
        self.reset()

    def reset(self) -> None:
        self._prev_grad: Optional[np.ndarray] = None
        self._stat = 0.0
        self._count = 0

    def observe(
        self,
        *,
        grad: np.ndarray,
        w: np.ndarray | None = None,
        loss: float | None = None,
    ) -> None:
        g = np.asarray(grad, dtype=np.float64).ravel()
        if self._prev_grad is not None:
            self._stat += float(np.dot(self._prev_grad, g))
        self._prev_grad = g
        self._count += 1

    def is_stationary(self) -> bool:
        return self._count >= self.burn_in and self._stat < 0.0

    # JSON-serializable state for checkpoint round-trip (exact resume).
    def state_dict(self) -> dict:
        return {
            "prev_grad": (
                None if self._prev_grad is None else self._prev_grad.tolist()
            ),
            "stat": self._stat,
            "count": self._count,
        }

    def load_state_dict(self, d: dict) -> None:
        pg = d["prev_grad"]
        self._prev_grad = None if pg is None else np.asarray(pg, np.float64)
        self._stat = float(d["stat"])
        self._count = int(d["count"])


class DistanceDiagnostic:
    """Log-log slope of ||w - w_anchor||^2 at geometric checkpoints."""

    def __init__(
        self,
        ratio: float = 1.5,
        threshold: float = 1.0,
        min_iters: int = 8,
        consecutive: int = 2,
    ):
        if ratio <= 1.0:
            raise ValueError("ratio must be > 1")
        self.ratio = ratio
        self.threshold = threshold
        self.min_iters = min_iters
        self.consecutive = consecutive
        self.reset()

    def reset(self) -> None:
        self._anchor: Optional[np.ndarray] = None
        self._count = 0
        self._next_check = max(self.min_iters, 2)
        self._prev_check: Optional[tuple[int, float]] = None  # (iter, omega)
        self._hits = 0
        self._stationary = False

    def observe(
        self,
        *,
        w: np.ndarray,
        grad: np.ndarray | None = None,
        loss: float | None = None,
    ) -> None:
        wv = np.asarray(w, dtype=np.float64).ravel()
        if self._anchor is None:
            self._anchor = wv.copy()
            return
        self._count += 1
        if self._count < self._next_check:
            return
        omega = float(np.sum((wv - self._anchor) ** 2))
        if omega <= 0.0:
            omega = 1e-300
        if self._prev_check is not None:
            it0, om0 = self._prev_check
            slope = (math.log(omega) - math.log(om0)) / (
                math.log(self._count) - math.log(it0)
            )
            if slope < self.threshold:
                self._hits += 1
                if self._hits >= self.consecutive:
                    self._stationary = True
            else:
                self._hits = 0
        self._prev_check = (self._count, omega)
        self._next_check = max(self._count + 1, int(self._count * self.ratio))

    def is_stationary(self) -> bool:
        return self._stationary

    def state_dict(self) -> dict:
        return {
            "anchor": None if self._anchor is None else self._anchor.tolist(),
            "count": self._count,
            "next_check": self._next_check,
            "prev_check": (
                None if self._prev_check is None else list(self._prev_check)
            ),
            "hits": self._hits,
            "stationary": self._stationary,
        }

    def load_state_dict(self, d: dict) -> None:
        a = d["anchor"]
        self._anchor = None if a is None else np.asarray(a, np.float64)
        self._count = int(d["count"])
        self._next_check = int(d["next_check"])
        pc = d["prev_check"]
        self._prev_check = None if pc is None else (int(pc[0]), float(pc[1]))
        self._hits = int(d["hits"])
        self._stationary = bool(d["stationary"])


class LossPlateauDiagnostic:
    """EWMA relative-improvement plateau test on the stochastic loss.

    Robust for the small beta-substeps of the paper's scheme, where the
    anchor-distance signal is weak: track fast/slow EWMAs of the observed
    minibatch loss; declare stationarity when the fast EWMA stops
    improving on the slow one by more than ``rel_tol``.
    """

    def __init__(
        self,
        fast: float = 0.2,
        slow: float = 0.05,
        rel_tol: float = 0.02,
        min_iters: int = 10,
        consecutive: int = 3,
    ):
        self.fast_a = fast
        self.slow_a = slow
        self.rel_tol = rel_tol
        self.min_iters = min_iters
        self.consecutive = consecutive
        self.reset()

    def reset(self) -> None:
        self._fast: Optional[float] = None
        self._slow: Optional[float] = None
        self._count = 0
        self._hits = 0
        self._stationary = False

    def observe(
        self,
        *,
        loss: Optional[float] = None,
        w: np.ndarray | None = None,
        grad: np.ndarray | None = None,
    ) -> None:
        if loss is None:
            return
        self._count += 1
        if self._fast is None:
            self._fast = self._slow = float(loss)
            return
        self._fast += self.fast_a * (float(loss) - self._fast)
        self._slow += self.slow_a * (float(loss) - self._slow)
        if self._count < self.min_iters:
            return
        denom = abs(self._slow) + 1e-30
        if (self._slow - self._fast) / denom < self.rel_tol:
            self._hits += 1
            if self._hits >= self.consecutive:
                self._stationary = True
        else:
            self._hits = 0

    def is_stationary(self) -> bool:
        return self._stationary

    def state_dict(self) -> dict:
        return {
            "fast": self._fast,
            "slow": self._slow,
            "count": self._count,
            "hits": self._hits,
            "stationary": self._stationary,
        }

    def load_state_dict(self, d: dict) -> None:
        self._fast = None if d["fast"] is None else float(d["fast"])
        self._slow = None if d["slow"] is None else float(d["slow"])
        self._count = int(d["count"])
        self._hits = int(d["hits"])
        self._stationary = bool(d["stationary"])


@dataclasses.dataclass(frozen=True)
class DiagnosticConfig:
    kind: str = "distance"  # "distance" | "pflug" | "loss"
    ratio: float = 1.5
    threshold: float = 1.0
    min_iters: int = 8
    consecutive: int = 2
    burn_in: int = 32
    rel_tol: float = 0.02
    fast: float = 0.2
    slow: float = 0.05


def make_diagnostic(cfg: DiagnosticConfig):
    if cfg.kind == "pflug":
        return PflugDiagnostic(burn_in=cfg.burn_in)
    if cfg.kind == "distance":
        return DistanceDiagnostic(
            ratio=cfg.ratio,
            threshold=cfg.threshold,
            min_iters=cfg.min_iters,
            consecutive=cfg.consecutive,
        )
    if cfg.kind == "loss":
        return LossPlateauDiagnostic(
            fast=cfg.fast,
            slow=cfg.slow,
            rel_tol=cfg.rel_tol,
            min_iters=cfg.min_iters,
            consecutive=cfg.consecutive,
        )
    raise ValueError(f"unknown diagnostic kind: {cfg.kind}")
