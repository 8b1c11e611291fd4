"""Event-driven straggler simulation of distributed SGD (paper Fig. 4, 5-9;
the port's copy of ``repro.core.simulation``, numpy only: the scalar
engine is the oracle the batched ``vector_sim.simulate_batch`` is held
to, so it stays a per-worker loop on the host).

Reproduces the paper's linear-regression experiment: n workers hold
disjoint partitions of v samples; at each iteration every worker draws a
random batch of ``beta * s`` of its samples; the main node waits for the k
fastest responses (response times drawn from a delay model), averages
their partial gradients, and steps. The controller advances (k, beta)
stages when the stationarity diagnostic fires.

Paper cost units are accounted verbatim:
  communication += n + k      per iteration
  computation   += beta * s   per iteration  (per-worker task size)

This simulator is the *behavioural* twin of the production runtime in
``repro_torch.runtime.train_loop`` — same controller, same delay models — so
paper-claim regressions run in milliseconds on CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from .controller import Controller, Stage, StrategyConfig
from .order_stats import DelayModel

__all__ = [
    "LinregProblem",
    "SimResult",
    "simulate",
    "spawn_lane_rngs",
    "chunk_len",
    "draw_response_chunk",
    "draw_key_chunk",
]


# ---------------------------------------------------------------------------
# Shared RNG-lane layout (DESIGN.md §9.2)
#
# Scalar and batched engines must consume *identical* per-seed streams so
# ``simulate_batch`` reproduces ``simulate`` lane-for-lane. Each seed owns
# two independent sub-streams (spawned off one SeedSequence):
#
#   z-stream : standard exponentials, chunks of (chunk, n_exp_streams, n),
#              composed into response times via ``model.compose`` — the
#              load ``beta`` only scales the draws, so the stream layout
#              is independent of the stage schedule.
#   u-stream : uniform sort-keys, chunks of (chunk, n, s). Worker ``i``'s
#              batch at load ``beta`` is the ``bs = round(beta * s)``
#              samples with the smallest keys in row ``i`` — an exact
#              without-replacement sample that the scalar engine extracts
#              by argpartition and the batched engine by thresholding.
#
# Both streams advance one slice per iteration unconditionally, so the
# chunk position depends only on the iteration count, never on (k, beta).
# ---------------------------------------------------------------------------

_CHUNK_TARGET_ELEMS = 2_000_000


def chunk_len(n: int, s: int) -> int:
    """Iterations per RNG chunk — part of the stream layout, so it must
    depend only on (n, s), never on lane count or stage state."""
    return max(8, min(256, _CHUNK_TARGET_ELEMS // max(n * s, 1)))


def spawn_lane_rngs(seed: int) -> Tuple[np.random.Generator, np.random.Generator]:
    """(z_rng, u_rng) — the two independent sub-streams of one seed lane."""
    z_child, u_child = np.random.SeedSequence(seed).spawn(2)
    return np.random.default_rng(z_child), np.random.default_rng(u_child)


def draw_response_chunk(
    z_rng: np.random.Generator, model: DelayModel, n: int, chunk: int
) -> np.ndarray:
    """(chunk, model.n_exp_streams, n) standard exponentials."""
    return z_rng.standard_exponential((chunk, model.n_exp_streams, n))


def draw_key_chunk(
    u_rng: np.random.Generator, n: int, s: int, chunk: int
) -> np.ndarray:
    """(chunk, n, s) uniform batch-selection keys."""
    return u_rng.random((chunk, n, s))


@dataclasses.dataclass
class LinregProblem:
    """The paper's simulation task: least squares on random integer data.

    X entries are uniform on {1..100}, labels uniform on {1..10} (paper's
    "[100]"/"[10]" notation). d (feature dim) and eta are unspecified in
    the paper; we fix d=10 and a stable eta and record the choice
    (EXPERIMENTS.md §Paper).
    """

    X: np.ndarray
    y: np.ndarray
    n_workers: int
    eta: float
    w_star: np.ndarray
    f_star: float

    @classmethod
    def generate(
        cls,
        *,
        v: int = 400,
        d: int = 10,
        n_workers: int = 20,
        eta: Optional[float] = None,
        seed: int = 0,
    ) -> "LinregProblem":
        rng = np.random.default_rng(seed)
        X = rng.integers(1, 101, size=(v, d)).astype(np.float64)
        y = rng.integers(1, 11, size=(v,)).astype(np.float64)
        w_star, *_ = np.linalg.lstsq(X, y, rcond=None)
        f_star = float(np.mean((X @ w_star - y) ** 2))
        if eta is None:
            # The paper does not state (d, eta). Calibrated so the paper's
            # quoted readout gap (2e-2) sits ~1.4x ABOVE the k=1, beta=1
            # noise floor: the analytic schedule (Thm. 2 + Cor. 4) then
            # predicts runtime ratio 0.55, comp -59.7%, comm +12.7% vs
            # adaptive-k — matching the paper's 'roughly halves' / -59.9% /
            # +15.7% (EXPERIMENTS.md §Paper records the calibration sweep).
            # eta = 1.9% of the GD stability limit 2/lambda_max(Hessian).
            lam_max = float(np.linalg.eigvalsh(2.0 * X.T @ X / v).max())
            eta = 0.038 / lam_max
        return cls(X=X, y=y, n_workers=n_workers, eta=eta, w_star=w_star,
                   f_star=f_star)

    @property
    def v(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    @property
    def s(self) -> int:
        return self.v // self.n_workers

    def full_loss(self, w: np.ndarray) -> float:
        return float(np.mean((self.X @ w - self.y) ** 2))

    def gap(self, w: np.ndarray) -> float:
        return self.full_loss(w) - self.f_star

    def partition(self, i: int) -> slice:
        return slice(i * self.s, (i + 1) * self.s)


@dataclasses.dataclass
class SimResult:
    times: np.ndarray        # wall-clock at eval points
    gaps: np.ndarray         # F(w_t) - F_star at eval points
    comp_at_eval: np.ndarray # cumulative computation cost at eval points
    comm_at_eval: np.ndarray # cumulative communication cost at eval points
    runtime: float
    comp_cost: float
    comm_cost: float
    iterations: int
    stage_log: List[Tuple[int, Stage]]
    reached: bool

    def time_to_gap(self, target: float) -> float:
        """First wall-clock time at which the recorded gap <= target."""
        idx = np.nonzero(self.gaps <= target)[0]
        return float(self.times[idx[0]]) if idx.size else math.inf

    def cost_at_gap(self, target: float) -> Tuple[float, float]:
        """(comp, comm) cumulative cost when the gap first hits target."""
        idx = np.nonzero(self.gaps <= target)[0]
        if not idx.size:
            return math.inf, math.inf
        i = idx[0]
        return float(self.comp_at_eval[i]), float(self.comm_at_eval[i])


def simulate(
    problem: LinregProblem,
    cfg: StrategyConfig,
    model: DelayModel,
    *,
    seed: int = 0,
    max_iters: int = 200_000,
    target_gap: Optional[float] = None,
    eval_every: int = 1,
    w0: Optional[np.ndarray] = None,
    estimate_model: bool = False,
    oracle_switch_times: Optional[list] = None,
) -> SimResult:
    """Run one simulated distributed-SGD training under ``cfg.strategy``.

    oracle_switch_times: optional wall-clock switch times from the
    analytic schedule (Thm. 2); when given, stages advance at those times
    instead of on the stationarity diagnostic — this isolates the
    strategy's value from diagnostic quality (EXPERIMENTS.md §Paper).

    RNG discipline: this engine is the reference oracle for the batched
    ``repro_torch.core.vector_sim.simulate_batch``; both consume the chunked
    two-stream layout documented at the top of this module, so a batched
    lane run at ``seed`` reproduces this function's trajectory.
    """
    z_rng, u_rng = spawn_lane_rngs(seed)
    n, s = cfg.n, cfg.s
    if n != problem.n_workers or s != problem.s:
        raise ValueError("cfg (n, s) must match the problem partitioning")
    chunk = chunk_len(n, s)

    ctrl = Controller(
        cfg,
        model=None if estimate_model else model,
        estimate_model=estimate_model,
    )
    if estimate_model:
        ctrl.oracle_model = None

    w = np.zeros(problem.d) if w0 is None else w0.copy()
    t = 0.0
    comp = 0.0
    comm = 0.0
    times = [0.0]
    gaps = [problem.gap(w)]
    comps = [0.0]
    comms = [0.0]
    reached = False
    it = 0

    X, y, eta = problem.X, problem.y, problem.eta
    E_chunk = U_chunk = None
    pos = chunk  # forces a draw on the first iteration

    for it in range(1, max_iters + 1):
        stage = ctrl.stage
        k, beta = stage.k, stage.beta
        bs = max(int(round(beta * s)), 1)

        if pos == chunk:
            E_chunk = draw_response_chunk(z_rng, model, n, chunk)
            U_chunk = draw_key_chunk(u_rng, n, s, chunk)
            pos = 0
        # Response times for all n workers at this load.
        z = model.compose(E_chunk[pos], beta)
        U_it = U_chunk[pos]
        pos += 1
        order = np.argpartition(z, k - 1)
        fastest = order[:k]
        t += float(z[fastest].max())

        # Partial gradients of the k fastest workers on random local
        # batches — the bs smallest sort-keys of each worker's row.
        grad = np.zeros_like(w)
        loss_sum = 0.0
        for i in fastest:
            part = problem.partition(int(i))
            if bs < s:
                idx = part.start + np.argpartition(U_it[i], bs - 1)[:bs]
                Xi, yi = X[idx], y[idx]
            else:
                Xi, yi = X[part], y[part]
            resid = Xi @ w - yi
            grad += Xi.T @ resid
            loss_sum += float(resid @ resid)
        grad *= 2.0 / (k * bs)
        w = w - eta * grad

        comp += beta * s
        comm += n + k
        ctrl.observe(w=w, grad=grad, loss=loss_sum / (k * bs), response_times=z)
        if oracle_switch_times is not None:
            while (
                ctrl.stage_idx < len(oracle_switch_times)
                and t >= oracle_switch_times[ctrl.stage_idx]
            ):
                if ctrl.advance() is None:
                    break
        else:
            ctrl.maybe_advance()

        if it % eval_every == 0:
            g = problem.gap(w)
            times.append(t)
            gaps.append(g)
            comps.append(comp)
            comms.append(comm)
            if target_gap is not None and g <= target_gap:
                reached = True
                break

    return SimResult(
        times=np.array(times),
        gaps=np.array(gaps),
        comp_at_eval=np.array(comps),
        comm_at_eval=np.array(comms),
        runtime=t,
        comp_cost=comp,
        comm_cost=comm,
        iterations=it,
        stage_log=list(ctrl.stage_history),
        reached=reached,
    )
