"""Worker response-time telemetry: censoring-aware EWMA + straggler detection
(the port's copy of ``repro.runtime.telemetry``, numpy only).

The controller consumes raw response times for delay-model fitting; this
module adds the ops-level view: per-worker mean-response-time estimates,
relative slowdown scores, and persistent-straggler detection used for
demotion (a worker that is consistently slower than the fleet median by
a large factor is removed from n — the paper's order statistics then
reprice every stage decision automatically).

Censoring discipline
--------------------
On real hardware a fastest-k step observes only the k winners' times; an
alive worker outside the fastest k is *censored* at the step's k-th
order statistic (all we learn is "slower than z_(k)"). A plain EWMA over
observed times can never flag a true persistent straggler — it is never
observed, so its estimate never moves. Instead each worker keeps a
decayed *total-time-on-test* pair (the per-worker analogue of the
censored MLE ``fit_simplified_mle_censored`` uses fleet-wide):

    T_w <- (1 - a) T_w + a * (observed time, or the censor level)
    D_w <- (1 - a) D_w + a * (1 if observed else 0)
    mean_w = T_w / D_w

For a worker that is always observed this reduces exactly to the EWMA of
its times (D_w == 1). For a worker that stops being observed, D_w decays
toward 0 while T_w tracks the censor level, so mean_w grows without
bound — the honest statement that only lower bounds are known.

Because a worker with NO observation ever has an unbounded estimate, the
demotion test adds a fairness guard: a never-observed worker is only
flagged once its *expected* win count under exchangeable response times
(sum of k_t / n_t over its eligible rounds) reaches ``min_expected_wins``
— i.e. only when being shut out is statistically damning (P <= e^-4
under fairness), not merely unlucky.

Both accumulators are seeded per worker on that worker's FIRST eligible
round — never globally — so a worker that joins (or is first observed)
late starts from its own data instead of crawling up from 0 and being
misread as fast.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["StragglerTracker"]


class StragglerTracker:
    def __init__(
        self,
        n_workers: int,
        alpha: float = 0.1,
        warmup: int = 16,
        min_expected_wins: float = 4.0,
        metrics=None,
    ):
        """``metrics``: an optional ``repro_torch.obs.MetricsRegistry``.
        When set, every ``observe`` feeds the
        ``telemetry.censored_fraction`` histogram: the fraction of
        eligible workers whose time was a censor level, the quantity the
        censored MLE's accuracy hinges on."""
        self.n = n_workers
        self.alpha = alpha
        self.warmup = warmup
        self.min_expected_wins = min_expected_wins
        self.ttt = np.zeros(n_workers)      # decayed total time on test
        self.obs = np.zeros(n_workers)      # decayed observed-completion weight
        self.rounds = np.zeros(n_workers, np.int64)  # eligible rounds per worker
        self.wins = np.zeros(n_workers, np.int64)    # actual observations
        self.expw = np.zeros(n_workers)     # expected wins under fairness
        self._h_censored = (
            metrics.histogram("telemetry.censored_fraction")
            if metrics is not None else None
        )

    def observe(
        self,
        response_times: np.ndarray,
        alive: np.ndarray,
        observed: Optional[np.ndarray] = None,
        censor_level: Optional[float] = None,
    ) -> None:
        """Record one step of telemetry.

        ``response_times[w]`` is meaningful only where ``observed[w]``
        (a worker the step actually waited for). With a ``censor_level``
        (the step's k-th order statistic), alive-but-unobserved workers
        contribute that level to their time-on-test — the lower bound
        real hardware knows.

        Back-compat: with ``observed=None`` every finite, alive time is
        treated as observed and nothing is censored (full-information
        telemetry, e.g. the hedged router observing every completion).
        """
        z = np.asarray(response_times, dtype=np.float64)
        alive = np.asarray(alive, dtype=bool)
        if observed is None:
            observed = np.isfinite(z) & alive
        else:
            observed = np.asarray(observed, dtype=bool) & alive
        # Without a censor level unobserved workers carry no information;
        # with one, every alive worker accrues time-on-test.
        eligible = observed if censor_level is None else alive
        contrib = np.where(
            observed, z, 0.0 if censor_level is None else float(censor_level)
        )
        fresh = eligible & (self.rounds == 0)
        cont = eligible & ~fresh
        # Per-worker seed on the first eligible round (never global).
        self.ttt[fresh] = contrib[fresh]
        self.obs[fresh] = observed[fresh].astype(np.float64)
        a = self.alpha
        self.ttt[cont] += a * (contrib[cont] - self.ttt[cont])
        self.obs[cont] += a * (observed[cont].astype(np.float64) - self.obs[cont])
        self.rounds[eligible] += 1
        self.wins[observed] += 1
        if censor_level is None:
            self.expw[observed] += 1.0
        else:
            n_t = int(eligible.sum())
            if n_t:
                self.expw[eligible] += float(observed.sum()) / n_t
        if self._h_censored is not None:
            n_e = int(eligible.sum())
            if n_e:
                self._h_censored.observe(1.0 - float(observed[eligible].sum()) / n_e)

    def reset_worker(self, w: int) -> None:
        """Forget a worker's history (e.g. it rejoined after recovery)."""
        self.ttt[w] = 0.0
        self.obs[w] = 0.0
        self.rounds[w] = 0
        self.wins[w] = 0
        self.expw[w] = 0.0

    def mean_estimate(self) -> np.ndarray:
        """Per-worker censoring-corrected mean response time.

        nan = no data yet; a worker with eligible rounds but no
        observation has an effectively unbounded estimate (only lower
        bounds are known), which is exactly what the slowdown test
        should see.
        """
        est = self.ttt / np.maximum(self.obs, 1e-12)
        return np.where(self.rounds > 0, est, np.nan)

    def slowdown(self) -> np.ndarray:
        """Per-worker mean estimate / fleet median (1.0 = typical).

        The median is taken over workers with at least one real
        observation, so never-observed stragglers cannot drag the
        reference level up.
        """
        est = self.mean_estimate()
        seen = np.isfinite(est) & (est > 0) & (self.wins > 0)
        med = float(np.median(est[seen])) if seen.any() else 1.0
        return est / max(med, 1e-12)

    def persistent_stragglers(self, threshold: float) -> List[int]:
        ready = self.rounds >= self.warmup
        slow = self.slowdown() > threshold  # nan compares False: no data, no flag
        # Fairness guard: a worker with zero observations is only
        # damning once it *should* have won several times.
        fair = (self.wins > 0) | (self.expw >= self.min_expected_wins)
        return [int(i) for i in np.nonzero(ready & slow & fair)[0]]

    # -- checkpoint round-trip ----------------------------------------------
    def state_dict(self) -> dict:
        return {
            "n": self.n,
            "ttt": self.ttt.tolist(),
            "obs": self.obs.tolist(),
            "rounds": self.rounds.tolist(),
            "wins": self.wins.tolist(),
            "expw": self.expw.tolist(),
        }

    def load_state_dict(self, d: dict) -> None:
        if int(d["n"]) != self.n:
            raise ValueError(
                f"tracker sized for {self.n} workers, state has {d['n']}"
            )
        self.ttt = np.asarray(d["ttt"], np.float64)
        self.obs = np.asarray(d["obs"], np.float64)
        self.rounds = np.asarray(d["rounds"], np.int64)
        self.wins = np.asarray(d["wins"], np.int64)
        self.expw = np.asarray(d["expw"], np.float64)
