"""Multi-replica hedged dispatch priced by order statistics (the port's
copy of ``repro.serve.router``; numpy only).

The paper prices every scheduling decision with the expected k-th order
statistic ``mu_{k:n}(beta)`` of random worker response times. Hedged
inference dispatch is the same decision at serving scale: send one
request to ``n_h`` replicas at once, keep the fastest ``k`` responses
(k=1 for plain generation, k>1 for quorum/verification schemes), cancel
the losers. Each extra replica buys latency through the order-statistic
tail ``H(n, k)`` but costs duplicated compute, so the router minimizes

    cost(n) = mu_{k:n}(beta) * slowdown(chosen n) + c_replica * n

by brute force over the feasible fan-outs — ``expected_kth`` makes the
latency term exact for both of the paper's delay models. Per-replica
speed estimates come from the same EWMA ``StragglerTracker`` the
training runtime uses for demotion; replicas the tracker marks slow stop
being chosen, which is the serving analogue of dropping a persistent
straggler from ``n``.

``ReplicaSet`` is the ground-truth simulator (hidden per-replica speed
factors over a ``repro_torch.core.delay_models`` base model); the router only
ever sees observed response times.

Public API contract: MODEL-AGNOSTIC — the router prices opaque
request/response latencies and never sees tokens, caches, or arch
families. Its two dependencies are the paper-math layer
(``repro_torch.core.order_stats.expected_kth`` over a
``repro_torch.core.delay_models`` model) and the training-side EWMA
``StragglerTracker``; the same pricing seam is reused by
``serve.speculative.SpecController.choose_hedged`` for speculative
verify fan-outs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.order_stats import expected_kth
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.runtime.telemetry import StragglerTracker

__all__ = ["HedgePlan", "DispatchOutcome", "ReplicaSet", "HedgedRouter"]


@dataclasses.dataclass(frozen=True)
class HedgePlan:
    n_h: int                      # hedge fan-out
    k: int                        # responses to wait for
    replicas: Tuple[int, ...]     # chosen replica ids (fastest-estimated first)
    expected_latency: float       # mu_{k:n} scaled by the subset's slowdown
    expected_cost: float          # latency + c_replica * n_h


@dataclasses.dataclass(frozen=True)
class DispatchOutcome:
    plan: HedgePlan
    completion_time: float        # k-th fastest response time
    completed: Tuple[int, ...]    # replicas whose responses were used
    cancelled: Tuple[int, ...]    # hedged losers, cancelled at completion


class ReplicaSet:
    """Ground truth for simulation: response time = base-model draw times
    a fixed per-replica speed factor (1.0 = nominal, 3.0 = straggler)."""

    def __init__(self, delay_model, speed_factors: Sequence[float], seed: int = 0):
        self.model = delay_model
        self.speed = np.asarray(speed_factors, np.float64)
        if np.any(self.speed <= 0):
            raise ValueError("speed factors must be > 0")
        self.rng = np.random.default_rng(seed)

    @property
    def n_replicas(self) -> int:
        return int(self.speed.size)

    def sample(self, replicas: Sequence[int], beta: float = 1.0) -> np.ndarray:
        base = self.model.sample(self.rng, len(replicas), beta)
        return base * self.speed[np.asarray(replicas, int)]


class HedgedRouter:
    def __init__(
        self,
        delay_model,
        n_replicas: int,
        *,
        quorum: int = 1,
        cost_per_replica: float = 0.0,
        slots_per_replica: int = 1,
        n_max: Optional[int] = None,
        ewma_alpha: float = 0.1,
        warmup: int = 8,
        slow_cap: float = 1e6,
        obs: Optional[Observability] = None,
    ):
        if not (1 <= quorum <= n_replicas):
            raise ValueError("need 1 <= quorum <= n_replicas")
        self.model = delay_model
        self.n_replicas = n_replicas
        self.quorum = quorum
        self.cost_per_replica = cost_per_replica
        self.slots_per_replica = slots_per_replica
        self.n_max = n_max or n_replicas
        self.obs = obs or NULL_OBS
        self.tracker = StragglerTracker(
            n_replicas, alpha=ewma_alpha, warmup=warmup,
            metrics=self.obs.metrics if self.obs.enabled else None,
        )
        self._last_plan_key = None    # decision-log dedup (reprices only)
        self.inflight = np.zeros(n_replicas, np.int64)
        self.alive = np.ones(n_replicas, bool)
        #: finite stand-in for an unbounded censored estimate (a replica
        #: whose every interaction timed out): priced effectively last,
        #: but a later successful observation can still pull it back.
        self.slow_cap = slow_cap

    # -- fleet membership ----------------------------------------------------
    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    def mark_failed(self, r: int) -> None:
        """Take a replica out of the fleet: it stops being a dispatch
        target and the quorum degrades to the shrunken fleet (pricing
        re-runs over whoever is left instead of stalling)."""
        self.alive[r] = False

    def mark_joined(self, r: int) -> None:
        """A replica (re)joins healthy. Its telemetry history is RESET:
        stale pre-failure estimates must not price it (a replica that
        was slow before dying may come back healthy — and one that was
        fast may come back cold). With zero rounds it is priced at the
        neutral prior 1.0 and, thanks to the tracker's per-worker
        first-observation seeding, its first real response time lands as
        its estimate directly — it is never read as infinitely fast while
        an EWMA crawls up from zero (the training side's cold-start rule,
        mirrored here)."""
        self.alive[r] = True
        self.tracker.reset_worker(r)

    # -- pricing -------------------------------------------------------------
    def slowdowns(self) -> np.ndarray:
        """Public view of the per-replica slowdown estimates (see
        ``_slowdowns``) — the transport prices its retransmission
        timeouts from this, so retry backoff and hedged dispatch work
        from the SAME censored-telemetry picture of the fleet."""
        return self._slowdowns()

    def _slowdowns(self) -> np.ndarray:
        """Per-replica slowdown estimates.

        Fleet-wide cold start prices everyone at 1.0 until ``warmup``
        rounds of telemetry exist. Past that, each replica is priced from
        its OWN state: a finite censoring-corrected estimate where one
        exists; the neutral prior 1.0 for a replica with no history yet
        (fresh or just rejoined — per-worker seeding means its first
        observation will replace the prior wholesale); and ``slow_cap``
        for a replica whose history is all censoring (every interaction
        expired — only lower bounds known, so it prices last)."""
        if int(self.tracker.rounds.max(initial=0)) < self.tracker.warmup:
            return np.ones(self.n_replicas)
        s = self.tracker.slowdown()
        out = np.ones(self.n_replicas)
        seen = np.isfinite(s) & (s > 0)
        out[seen] = s[seen]
        unbounded = (self.tracker.rounds > 0) & (self.tracker.wins == 0)
        out[unbounded] = self.slow_cap
        return out

    def available(self) -> List[int]:
        return [
            r for r in range(self.n_replicas)
            if self.alive[r] and self.inflight[r] < self.slots_per_replica
        ]

    def hedge_cost(self, n: int, beta: float = 1.0, scale: float = 1.0) -> float:
        """Priced cost of fan-out ``n``: expected k-th order statistic of
        the response times plus the duplicated-compute charge."""
        k = min(self.quorum, n)
        return expected_kth(self.model, n, k, beta) * scale + self.cost_per_replica * n

    def choose_hedge(self, beta: float = 1.0) -> Optional[HedgePlan]:
        """Brute-force minimization of ``hedge_cost`` over feasible
        fan-outs, on the fastest-estimated available replicas.

        Degraded fleets re-price rather than stall: the required quorum
        is clamped to the number of ALIVE replicas, so losing replicas
        shrinks k (and the feasible fan-outs) instead of wedging the
        frontend. Busy-but-alive replicas still gate normally — a full
        fleet with too few free slots returns None and the caller
        retries after completions free capacity."""
        slow = self._slowdowns()
        avail = sorted(self.available(), key=lambda r: (slow[r], r))
        k_cap = min(self.quorum, max(self.n_alive, 1))
        if len(avail) < k_cap:
            return None
        best: Optional[HedgePlan] = None
        for n in range(k_cap, min(len(avail), self.n_max) + 1):
            subset = avail[:n]
            scale = float(np.mean(slow[subset]))
            k = min(self.quorum, n)
            lat = expected_kth(self.model, n, k, beta) * scale
            cost = lat + self.cost_per_replica * n
            if best is None or cost < best.expected_cost:
                best = HedgePlan(n, k, tuple(subset), lat, cost)
        if best is not None and self.obs.enabled:
            key = (best.n_h, best.k, best.replicas)
            if key != self._last_plan_key:
                # A reprice: the chosen fan-out / quorum / replica subset
                # changed since the last dispatch.
                self._last_plan_key = key
                self.obs.decisions.record(
                    "serve.hedge",
                    {"n_h": int(best.n_h), "k": int(best.k),
                     "replicas": list(best.replicas)},
                    {"slowdowns": [round(float(s), 6) for s in slow],
                     "n_alive": self.n_alive, "beta": float(beta),
                     "expected_latency": round(best.expected_latency, 9)},
                )
        return best

    # -- dispatch lifecycle --------------------------------------------------
    def begin(self, plan: HedgePlan) -> None:
        """Occupy one slot on each replica of a chosen plan. The caller
        owns releasing them — via ``complete(outcome)`` once the hedge
        resolves, or ``release(r)`` one at a time (e.g. a replica dies
        mid-request and its copy is torn down before any outcome
        exists)."""
        for r in plan.replicas:
            self.inflight[r] += 1

    def release(self, r: int) -> None:
        """Release a single replica's slot (early loser cancellation or
        replica death — cases where no ``DispatchOutcome`` applies)."""
        if self.inflight[r] <= 0:
            raise ValueError(f"replica {r} has no in-flight work")
        self.inflight[r] -= 1

    def occupy(self, r: int) -> None:
        """Occupy a single replica's slot outside a plan (a migrated
        request landing on a new replica)."""
        self.inflight[r] += 1

    def record(
        self,
        times: np.ndarray,
        participants: Sequence[int],
        observed: Optional[Sequence[int]] = None,
        censor_level: Optional[float] = None,
    ) -> None:
        """Feed one hedge's resolution to the tracker.

        ``times`` is dense over the fleet; only ``participants`` (the
        replicas this hedge actually touched) are eligible — censoring a
        loser must not count a round against replicas that never saw the
        request. With ``censor_level`` set, participants NOT in
        ``observed`` are recorded as censored at that level (the hedged
        losers: all we learn is "slower than the winner"/"slower than
        the deadline")."""
        part = np.zeros(self.n_replicas, bool)
        part[list(participants)] = True
        if censor_level is None:
            self.tracker.observe(np.asarray(times, np.float64), part)
        else:
            obs_mask = np.zeros(self.n_replicas, bool)
            if observed is not None:
                obs_mask[list(observed)] = True
            self.tracker.observe(
                np.asarray(times, np.float64), part,
                observed=obs_mask, censor_level=censor_level,
            )

    def dispatch(
        self,
        replica_set: ReplicaSet,
        beta: float = 1.0,
        *,
        auto_complete: bool = True,
    ) -> Optional[DispatchOutcome]:
        """Hedge one request. Occupies one slot on each chosen replica;
        with ``auto_complete=False`` the caller owns releasing them via
        ``complete(outcome)`` (concurrent in-flight hedges)."""
        plan = self.choose_hedge(beta)
        if plan is None:
            return None
        replicas = np.asarray(plan.replicas, int)
        times = replica_set.sample(replicas, beta)
        self.begin(plan)
        order = np.argsort(times, kind="stable")
        completed = tuple(int(r) for r in replicas[order[: plan.k]])
        cancelled = tuple(int(r) for r in replicas[order[plan.k :]])
        outcome = DispatchOutcome(
            plan, float(times[order[plan.k - 1]]), completed, cancelled
        )
        # Telemetry sees only the responses that actually arrived —
        # cancelled losers are censored, never observed.
        dense = np.zeros(self.n_replicas)
        dense[list(completed)] = times[order[: plan.k]]
        self.record(dense, completed)
        if auto_complete:
            self.complete(outcome)
        return outcome

    def complete(self, outcome: DispatchOutcome) -> None:
        """Winner responded: release the winner's slot AND every hedged
        loser's (cancellation is what makes hedging affordable)."""
        for r in outcome.completed + outcome.cancelled:
            if self.inflight[r] <= 0:
                raise ValueError(f"replica {r} has no in-flight work")
            self.inflight[r] -= 1
