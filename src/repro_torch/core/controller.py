"""Stage controller: the paper's adaptive-(k, beta) strategy plus baselines
(the port's copy of ``repro.core.controller``, numpy only).

A *stage* is a pair (k, beta): wait for the k fastest of n workers, each
computing on a fraction beta of its s local samples. The controller owns

  * the stage-advancement rule per strategy:
      - ``naive``          : k = n, beta = 1, single stage  [sync SGD]
      - ``fastest_k``      : fixed (k0, 1), single stage    [32]
      - ``adaptive_k``     : k = 1, 2, ..., k_max at beta=1 [39]
      - ``adaptive_kbeta`` : THE PAPER — grow beta along the grid first;
        when beta saturates, raise k and *drop* beta to the Cor. 4 / Thm. 3
        optimum (closed form under Def. 1, numerical under Def. 2);
  * the stationarity diagnostic that triggers advancement at run time;
  * response-time telemetry and (optionally) online delay-model fitting,
    so beta* can be computed without oracle knowledge of (lambda, x).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .beta_opt import beta_min_for, optimal_beta
from .delay_models import fit_simplified_mle_censored
from .diagnostics import DiagnosticConfig, make_diagnostic
from .order_stats import DelayModel, expected_kth

__all__ = ["StrategyConfig", "Stage", "Controller", "next_stage", "stage_table"]

STRATEGIES = ("naive", "fastest_k", "adaptive_k", "adaptive_kbeta")


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    strategy: str
    n: int                      # total workers
    s: int                      # samples per worker
    k0: int = 1
    beta0: Optional[float] = None   # default: grid minimum for the paper, 1 otherwise
    k_max: Optional[int] = None     # default: n
    k_step: int = 1
    beta_grid: Optional[Sequence[float]] = None  # default: multiples of 1/s
    diagnostic: DiagnosticConfig = dataclasses.field(default_factory=DiagnosticConfig)

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        if self.beta_grid is not None:
            g = tuple(sorted(self.beta_grid))
            if not g or g[0] <= 0 or g[-1] > 1.0:
                raise ValueError("beta_grid must lie in (0, 1]")
            object.__setattr__(self, "beta_grid", g)

    @property
    def grid(self) -> Tuple[float, ...]:
        if self.beta_grid is not None:
            return tuple(self.beta_grid)
        return tuple((i + 1) / self.s for i in range(self.s))

    @property
    def kmax(self) -> int:
        return self.k_max if self.k_max is not None else self.n

    def initial_stage(self) -> "Stage":
        if self.strategy in ("naive",):
            return Stage(self.n, 1.0)
        if self.strategy == "fastest_k":
            # Fixed (k, beta) throughout — [38]-style baselines may pin a
            # reduced load (e.g. (1, 0.2) in the paper's appendix).
            return Stage(self.k0, self.beta0 if self.beta0 is not None else 1.0)
        if self.strategy == "adaptive_k":
            return Stage(self.k0, 1.0)
        beta0 = self.beta0 if self.beta0 is not None else self.grid[0]
        return Stage(self.k0, beta0)


@dataclasses.dataclass(frozen=True)
class Stage:
    k: int
    beta: float

    @property
    def phi(self) -> float:
        return self.k * self.beta


def _grid_next_above(grid: Sequence[float], value: float) -> Optional[float]:
    for g in grid:
        if g > value + 1e-12:
            return g
    return None


def _grid_ceil(grid: Sequence[float], value: float) -> Optional[float]:
    """Smallest grid point >= value."""
    for g in grid:
        if g >= value - 1e-12:
            return g
    return None


def next_stage(
    cfg: StrategyConfig, cur: Stage, model: Optional[DelayModel]
) -> Optional[Stage]:
    """The stage that follows ``cur`` under ``cfg.strategy`` (None = terminal)."""
    if cfg.strategy in ("naive", "fastest_k"):
        return None

    if cfg.strategy == "adaptive_k":
        k_next = min(cur.k + cfg.k_step, cfg.kmax)
        if k_next == cur.k:
            return None
        return Stage(k_next, 1.0)

    # adaptive_kbeta — the paper's scheme.
    grid = cfg.grid
    if cur.beta < 1.0 - 1e-12:
        b_next = _grid_next_above(grid, cur.beta)
        if b_next is not None:
            return Stage(cur.k, b_next)
        # Grid exhausted below 1 (custom grid not reaching 1): fall through.
    k_next = min(cur.k + cfg.k_step, cfg.kmax)
    if k_next == cur.k:
        return None
    if model is None:
        raise ValueError(
            "adaptive_kbeta needs a delay model (oracle or fitted) to pick beta"
        )
    b_opt = optimal_beta(model, cfg.n, cur.k, cur.beta, k_next, cfg.s)
    bmin = beta_min_for(cur.k, cur.beta, k_next, cfg.s)
    b_next = _grid_ceil(grid, max(b_opt, bmin))
    if b_next is None:
        b_next = 1.0
    # phi must strictly grow; climb the grid if rounding collapsed it.
    while k_next * b_next <= cur.phi + 1e-12:
        nb = _grid_next_above(grid, b_next)
        if nb is None:
            return Stage(k_next, 1.0) if k_next * 1.0 > cur.phi else None
        b_next = nb
    return Stage(k_next, b_next)


def stage_table(
    cfg: StrategyConfig, model: Optional[DelayModel]
) -> List[Stage]:
    """The full (k, beta) stage sequence of ``cfg.strategy``, precomputed.

    The grid walk in ``next_stage`` is deterministic given a fixed delay
    model, so a run-time controller only needs an *index* into this table
    plus its diagnostic state; the ``Controller`` walks the same
    sequence incrementally.

    Termination is guaranteed: every strategy either has a single stage
    or strictly grows k (adaptive_k) / phi = k*beta (adaptive_kbeta) up
    to the bounded maximum.
    """
    stages = [cfg.initial_stage()]
    while True:
        nxt = next_stage(cfg, stages[-1], model)
        if nxt is None:
            return stages
        stages.append(nxt)


class Controller:
    """Run-time stage controller fed by per-iteration observations."""

    def __init__(
        self,
        cfg: StrategyConfig,
        *,
        model: Optional[DelayModel] = None,
        estimate_model: bool = False,
    ):
        self.cfg = cfg
        self.oracle_model = model
        self.estimate_model = estimate_model
        self.stage = cfg.initial_stage()
        self.stage_idx = 0
        self.diagnostic = make_diagnostic(cfg.diagnostic)
        self.stage_history: List[Tuple[int, Stage]] = [(0, self.stage)]
        self._iter = 0
        self._rt_samples: list[float] = []
        self._rt_betas: list[float] = []
        self._rt_censored: list[float] = []
        self._terminal = False
        # k_max ceiling from the original config: remove_worker clamps
        # k_max to the shrunken n, add_worker restores it up to this cap
        # (None = "track n", the StrategyConfig default).
        self._kmax_cap = cfg.k_max

    # -- telemetry ----------------------------------------------------------
    def observe(
        self,
        *,
        w: Optional[np.ndarray] = None,
        grad: Optional[np.ndarray] = None,
        loss: Optional[float] = None,
        response_times: Optional[np.ndarray] = None,
        n_unobserved: int = 0,
    ) -> None:
        """Feed one iteration of telemetry.

        ``response_times`` must contain only times that were actually
        observed. A fastest-k step observes the k smallest of n times and
        passes ``n_unobserved = n - k``: those workers are censored at
        the step's largest observed time (we only know they were slower),
        and ``current_model`` fits them with the censored MLE instead of
        pretending the k winners are an i.i.d. fleet sample.
        """
        self._iter += 1
        if grad is not None or w is not None or loss is not None:
            self.diagnostic.observe(w=w, grad=grad, loss=loss)
        if response_times is not None:
            rt = np.asarray(response_times, dtype=np.float64).ravel()
            if n_unobserved < 0:
                raise ValueError("n_unobserved must be >= 0")
            if rt.size:
                cens = np.zeros(rt.size)
                cens[int(np.argmax(rt))] = float(n_unobserved)
                self._rt_samples.extend(rt.tolist())
                self._rt_betas.extend([self.stage.beta] * rt.size)
                self._rt_censored.extend(cens.tolist())
            # Bound memory: keep the freshest 50k samples.
            if len(self._rt_samples) > 50_000:
                self._rt_samples = self._rt_samples[-50_000:]
                self._rt_betas = self._rt_betas[-50_000:]
                self._rt_censored = self._rt_censored[-50_000:]

    def current_model(self) -> Optional[DelayModel]:
        if not self.estimate_model:
            return self.oracle_model
        if len(self._rt_samples) >= 64:
            return fit_simplified_mle_censored(
                np.array(self._rt_samples),
                np.array(self._rt_betas),
                np.array(self._rt_censored),
            )
        return self.oracle_model

    # -- stage advancement ---------------------------------------------------
    def should_switch(self) -> bool:
        if self._terminal:
            return False
        if self.cfg.strategy in ("naive", "fastest_k"):
            return False
        return self.diagnostic.is_stationary()

    def advance(self) -> Optional[Stage]:
        try:
            nxt = next_stage(self.cfg, self.stage, self.current_model())
        except ValueError:
            # The next stage needs a delay model to price beta* but none
            # is available yet (live estimation, too little telemetry):
            # stay in the current stage and keep collecting. The
            # diagnostic stays stationary, so we retry next iteration.
            return None
        if nxt is None:
            self._terminal = True
            return None
        self.stage = nxt
        self.stage_idx += 1
        self.stage_history.append((self._iter, nxt))
        self.diagnostic.reset()
        return nxt

    def maybe_advance(self) -> Optional[Stage]:
        if self.should_switch():
            return self.advance()
        return None

    # -- pricing helpers -----------------------------------------------------
    def expected_iteration_time(self) -> Optional[float]:
        m = self.current_model()
        if m is None:
            return None
        return expected_kth(m, self.cfg.n, self.stage.k, self.stage.beta)

    # -- fault handling ------------------------------------------------------
    def _kmax_for(self, n: int) -> int:
        return n if self._kmax_cap is None else min(self._kmax_cap, n)

    def remove_worker(self) -> None:
        """A worker died: shrink n (order statistics reprice automatically)."""
        n_new = self.cfg.n - 1
        if n_new < 1:
            raise RuntimeError("all workers lost")
        self.cfg = dataclasses.replace(
            self.cfg, n=n_new, k_max=self._kmax_for(n_new)
        )
        if self.stage.k > n_new:
            self.stage = Stage(n_new, self.stage.beta)

    def add_worker(self) -> None:
        """A worker (re)joined: grow n and restore k_max up to the
        original cap — the inverse of ``remove_worker``. The current
        stage is left alone; the stage walk simply reprices against the
        larger fleet (more workers make every mu_{k:n} cheaper)."""
        n_new = self.cfg.n + 1
        self.cfg = dataclasses.replace(
            self.cfg, n=n_new, k_max=self._kmax_for(n_new)
        )

    # -- checkpoint round-trip ----------------------------------------------
    def state_dict(self) -> dict:
        """Full JSON-serializable control state for exact resume.

        Restoring only ``Stage(k, beta)`` is not enough: a resumed
        controller also needs the stage index, terminal flag, stage
        history, diagnostic state, telemetry buffers, and the mutated
        (n, k_max) from any worker removals — otherwise it re-walks
        stages from a wrong index with a cold diagnostic and a fleet
        size that no longer matches the loop's.
        """
        return {
            "n": self.cfg.n,
            "k_max": self.cfg.k_max,
            "kmax_cap": self._kmax_cap,
            "stage": [self.stage.k, self.stage.beta],
            "stage_idx": self.stage_idx,
            "terminal": self._terminal,
            "iter": self._iter,
            "stage_history": [
                [it, s.k, s.beta] for it, s in self.stage_history
            ],
            "rt_samples": list(self._rt_samples),
            "rt_betas": list(self._rt_betas),
            "rt_censored": list(self._rt_censored),
            "diagnostic": self.diagnostic.state_dict(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.cfg = dataclasses.replace(
            self.cfg, n=int(d["n"]),
            k_max=None if d["k_max"] is None else int(d["k_max"]),
        )
        self._kmax_cap = (
            None if d["kmax_cap"] is None else int(d["kmax_cap"])
        )
        self.stage = Stage(int(d["stage"][0]), float(d["stage"][1]))
        self.stage_idx = int(d["stage_idx"])
        self._terminal = bool(d["terminal"])
        self._iter = int(d["iter"])
        self.stage_history = [
            (int(it), Stage(int(k), float(b)))
            for it, k, b in d["stage_history"]
        ]
        self._rt_samples = [float(v) for v in d["rt_samples"]]
        self._rt_betas = [float(v) for v in d["rt_betas"]]
        self._rt_censored = [float(v) for v in d["rt_censored"]]
        self.diagnostic.load_state_dict(d["diagnostic"])
