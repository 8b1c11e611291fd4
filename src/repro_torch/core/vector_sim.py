"""Seeds-batched twin of ``simulation.simulate`` with its lane state in
torch tensors (the port's ``repro.core.vector_sim``).

Every paper claim is an expectation over simulation seeds, so the
benchmark layer's hot path is "run the event-driven simulator S times".
``simulate_batch`` steps all S seed lanes as one ``(S, d)`` weight tensor
on ``device`` (the card by default), in float64: response times for all
lanes x workers are composed from chunked pre-drawn exponentials, the
per-worker gradient loop becomes a masked-residual computation (two small
GEMMs per iteration for *all* lanes), and the per-seed ``Controller``
objects collapse to a precomputed (k, beta) stage table
(``controller.stage_table``) indexed by a per-lane stage pointer plus
lane-parallel diagnostic state, all on the device.

The random draws stay where the scalar engine makes them: each lane's
two numpy ``Generator``s (``simulation.spawn_lane_rngs``), drawn a chunk
at a time on the host in the reference's layout and uploaded once per
chunk, so lane ``i`` of ``simulate_batch(..., seeds=S)`` reproduces
``simulate(..., seed=i)``: stage logs exactly, trajectories to
floating-point roundoff (the batched gradient sums in another order).

What differs from the reference engine is only where the host waits for
the device. Stage advances, diagnostic resets and the per-lane stage
constants are masked tensor updates made every iteration, so the loop
reads nothing back from the device except at a chunk draw, at an eval
point with ``target_gap`` set, and in the oracle-switch loop; each lane's
advances are counted per iteration on the device and turned into its
stage log at the end. Each update touches only the lanes the reference's
would, so the values are the same. Where some stage of the table
subsamples (bs < s) every iteration takes the subsampling path; a lane
whose stage keeps its whole partition thresholds its row at the row's
maximum there and selects it all, as the reference's path does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from .controller import Stage, StrategyConfig, stage_table
from .delay_models import GeneralizedDelayModel, SimplifiedDelayModel
from .diagnostics import DiagnosticConfig
from .order_stats import DelayModel
from .simulation import (
    LinregProblem,
    SimResult,
    chunk_len,
    draw_key_chunk,
    draw_response_chunk,
    spawn_lane_rngs,
)

__all__ = ["BatchSimResult", "simulate_batch"]

F64 = torch.float64


# ---------------------------------------------------------------------------
# Lane-parallel stationarity diagnostics
#
# Ports of ``diagnostics``' classes over (lanes,) tensors; each mirrors the
# reference engine's update rule (same checkpoints, truncation and
# latches), every update masked to the lanes it concerns.
# ---------------------------------------------------------------------------


class _BatchDistanceDiagnostic:
    """Lane-parallel ``DistanceDiagnostic``. Counts are float64 (exact
    integers), and the previous checkpoint is kept as the logs of its
    iteration and distance, the only form the slope reads."""

    def __init__(self, cfg: DiagnosticConfig, lanes: int, d: int, device):
        self.ratio = cfg.ratio
        self.threshold = cfg.threshold
        self.first_check = float(max(cfg.min_iters, 2))
        self.consecutive = cfg.consecutive
        f64 = dict(dtype=F64, device=device)
        self._anchor = torch.zeros((lanes, d), **f64)
        self._has_anchor = torch.zeros(lanes, dtype=torch.bool, device=device)
        self._count = torch.zeros(lanes, **f64)
        self._next_check = torch.full((lanes,), self.first_check, **f64)
        self._log_prev_iter = torch.zeros(lanes, **f64)
        self._log_prev_omega = torch.zeros(lanes, **f64)
        self._has_prev = torch.zeros(lanes, dtype=torch.bool, device=device)
        self._hits = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.stationary = torch.zeros(lanes, dtype=torch.bool, device=device)

    def reset_lanes(self, m: torch.Tensor) -> None:
        keep = ~m
        self._has_anchor &= keep
        self._count.masked_fill_(m, 0.0)
        self._next_check.masked_fill_(m, self.first_check)
        self._has_prev &= keep
        self._hits.masked_fill_(m, 0)
        self.stationary &= keep

    def observe(self, *, w, grad=None, loss=None, active) -> None:
        # A lane without an anchor (a fresh stage) takes this iterate as its
        # anchor and is not counted on it.
        new_anchor = active & ~self._has_anchor
        self._anchor = torch.where(new_anchor[:, None], w, self._anchor)
        self._has_anchor |= new_anchor
        obs = active & ~new_anchor
        self._count += obs
        chk = obs & (self._count >= self._next_check)
        dw = w - self._anchor
        omega = (dw * dw).sum(1)
        log_omega = torch.log(torch.where(omega <= 0.0, 1e-300, omega))
        log_count = torch.log(self._count)
        slope = (log_omega - self._log_prev_omega) / (log_count - self._log_prev_iter)
        judged = chk & self._has_prev
        hit = judged & (slope < self.threshold)
        # A judged checkpoint adds one hit or clears the run of them.
        self._hits = torch.where(judged, (self._hits + 1) * hit, self._hits)
        self.stationary |= hit & (self._hits >= self.consecutive)
        self._log_prev_iter = torch.where(chk, log_count, self._log_prev_iter)
        self._log_prev_omega = torch.where(chk, log_omega, self._log_prev_omega)
        self._has_prev |= chk
        nxt = torch.maximum(self._count + 1.0, torch.floor(self._count * self.ratio))
        self._next_check = torch.where(chk, nxt, self._next_check)


class _BatchPflugDiagnostic:
    """Lane-parallel ``PflugDiagnostic``."""

    def __init__(self, cfg: DiagnosticConfig, lanes: int, d: int, device):
        self.burn_in = cfg.burn_in
        self._prev_grad = torch.zeros((lanes, d), dtype=F64, device=device)
        self._has_prev = torch.zeros(lanes, dtype=torch.bool, device=device)
        self._stat = torch.zeros(lanes, dtype=F64, device=device)
        self._count = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.stationary = torch.zeros(lanes, dtype=torch.bool, device=device)

    def reset_lanes(self, m: torch.Tensor) -> None:
        self._has_prev &= ~m
        self._stat.masked_fill_(m, 0.0)
        self._count.masked_fill_(m, 0)
        self.stationary &= ~m

    def observe(self, *, w=None, grad, loss=None, active) -> None:
        dot = (self._prev_grad * grad).sum(1)
        upd = active & self._has_prev
        self._stat = torch.where(upd, self._stat + dot, self._stat)
        self._prev_grad = torch.where(active[:, None], grad, self._prev_grad)
        self._count += active
        self._has_prev |= active
        self.stationary = (self._count >= self.burn_in) & (self._stat < 0.0)


class _BatchLossPlateauDiagnostic:
    """Lane-parallel ``LossPlateauDiagnostic``."""

    def __init__(self, cfg: DiagnosticConfig, lanes: int, d: int, device):
        self.fast_a = cfg.fast
        self.slow_a = cfg.slow
        self.rel_tol = cfg.rel_tol
        self.min_iters = cfg.min_iters
        self.consecutive = cfg.consecutive
        self._fast = torch.zeros(lanes, dtype=F64, device=device)
        self._slow = torch.zeros(lanes, dtype=F64, device=device)
        self._has_init = torch.zeros(lanes, dtype=torch.bool, device=device)
        self._count = torch.zeros(lanes, dtype=torch.int64, device=device)
        self._hits = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.stationary = torch.zeros(lanes, dtype=torch.bool, device=device)

    def reset_lanes(self, m: torch.Tensor) -> None:
        self._has_init &= ~m
        self._count.masked_fill_(m, 0)
        self._hits.masked_fill_(m, 0)
        self.stationary &= ~m

    def observe(self, *, w=None, grad=None, loss, active) -> None:
        self._count += active
        init = active & ~self._has_init
        self._fast = torch.where(init, loss, self._fast)
        self._slow = torch.where(init, loss, self._slow)
        self._has_init |= init
        rest = active & ~init
        self._fast = torch.where(rest, self._fast + self.fast_a * (loss - self._fast), self._fast)
        self._slow = torch.where(rest, self._slow + self.slow_a * (loss - self._slow), self._slow)
        eligible = rest & (self._count >= self.min_iters)
        ratio = (self._slow - self._fast) / (torch.abs(self._slow) + 1e-30)
        hit = eligible & (ratio < self.rel_tol)
        self._hits = torch.where(eligible, (self._hits + 1) * hit, self._hits)
        self.stationary |= hit & (self._hits >= self.consecutive)


_BATCH_DIAGNOSTICS = {
    "distance": _BatchDistanceDiagnostic,
    "pflug": _BatchPflugDiagnostic,
    "loss": _BatchLossPlateauDiagnostic,
}


def _make_batch_diagnostic(cfg: DiagnosticConfig, lanes: int, d: int, device):
    try:
        cls = _BATCH_DIAGNOSTICS[cfg.kind]
    except KeyError:
        raise ValueError(f"unknown diagnostic kind: {cfg.kind}") from None
    return cls(cfg, lanes, d, device)


# ---------------------------------------------------------------------------
# Batched result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchSimResult:
    """Per-lane trajectories of one ``simulate_batch`` run (numpy, on the
    host).

    Eval-point arrays are ``(lanes, T)`` where ``T`` is the longest lane's
    record; lane ``i``'s first ``n_evals[i]`` entries are valid (lanes that
    hit ``target_gap`` early freeze and stop recording). ``lane(i)``
    reconstructs the scalar-engine ``SimResult`` view.
    """

    seeds: Tuple[int, ...]
    times: np.ndarray         # (lanes, T)
    gaps: np.ndarray          # (lanes, T)
    comp_at_eval: np.ndarray  # (lanes, T)
    comm_at_eval: np.ndarray  # (lanes, T)
    n_evals: np.ndarray       # (lanes,) valid prefix length per lane
    runtime: np.ndarray       # (lanes,)
    comp_cost: np.ndarray     # (lanes,)
    comm_cost: np.ndarray     # (lanes,)
    iterations: np.ndarray    # (lanes,)
    reached: np.ndarray       # (lanes,) bool
    stage_logs: List[List[Tuple[int, Stage]]]

    def __len__(self) -> int:
        return len(self.seeds)

    def lane(self, i: int) -> SimResult:
        ne = int(self.n_evals[i])
        return SimResult(
            times=self.times[i, :ne].copy(),
            gaps=self.gaps[i, :ne].copy(),
            comp_at_eval=self.comp_at_eval[i, :ne].copy(),
            comm_at_eval=self.comm_at_eval[i, :ne].copy(),
            runtime=float(self.runtime[i]),
            comp_cost=float(self.comp_cost[i]),
            comm_cost=float(self.comm_cost[i]),
            iterations=int(self.iterations[i]),
            stage_log=list(self.stage_logs[i]),
            reached=bool(self.reached[i]),
        )

    def __iter__(self):
        return (self.lane(i) for i in range(len(self)))

    def mean_time_to_gap(self, target: float) -> float:
        vals = [r.time_to_gap(target) for r in self]
        return float(np.mean(vals))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@torch.inference_mode()
def simulate_batch(
    problem: LinregProblem,
    cfg: StrategyConfig,
    model: DelayModel,
    *,
    seeds: Union[int, Sequence[int]] = 24,
    max_iters: int = 200_000,
    target_gap: Optional[float] = None,
    eval_every: int = 1,
    w0: Optional[np.ndarray] = None,
    estimate_model: bool = False,
    oracle_switch_times: Optional[list] = None,
    device="cuda",
) -> BatchSimResult:
    """Run ``simulate`` for many seeds at once, lanes batched on ``device``.

    ``seeds`` is either a lane count (lanes run seeds ``0..seeds-1``) or an
    explicit seed sequence. All other parameters mirror ``simulate``; lane
    ``i`` reproduces ``simulate(..., seed=seeds[i])`` (same RNG streams,
    same stage decisions, trajectories equal to FP roundoff).
    """
    if estimate_model:
        raise ValueError(
            "online model estimation is sequential per lane; use the scalar "
            "simulate(estimate_model=True) reference engine for it"
        )
    seed_list: Tuple[int, ...] = (
        tuple(range(seeds)) if isinstance(seeds, (int, np.integer)) else tuple(seeds)
    )
    L = len(seed_list)
    if L == 0:
        raise ValueError("need at least one seed lane")
    n, s = cfg.n, cfg.s
    if n != problem.n_workers or s != problem.s:
        raise ValueError("cfg (n, s) must match the problem partitioning")
    dev = resolve_device(device)

    X = torch.as_tensor(problem.X, dtype=F64, device=dev)
    XT = X.t().contiguous()
    y = torch.as_tensor(problem.y, dtype=F64, device=dev)
    eta, v, d, f_star = problem.eta, problem.v, problem.d, problem.f_star

    # -- stage table: every per-lane constant of a stage, formed on the
    # host with the reference's numpy arithmetic, gathered by stage pointer.
    table = stage_table(cfg, model)
    T = len(table)
    k_tab = np.array([st.k for st in table], dtype=np.int64)
    beta_tab = np.array([st.beta for st in table])
    bs_tab = np.maximum(np.rint(beta_tab * s).astype(np.int64), 1)
    is_simple = isinstance(model, SimplifiedDelayModel)
    is_general = isinstance(model, GeneralizedDelayModel)
    ftab = torch.as_tensor(np.stack([
        2.0 / (k_tab * bs_tab),                    # gcoef
        beta_tab * s,                              # computation per iteration
        float(n) + k_tab,                          # communication per iteration
        beta_tab / model.lambda_y,                 # load scale of the draws
        model.x + model.y * beta_tab if is_general else np.zeros(T),
        beta_tab,
    ], axis=1), dtype=F64, device=dev)
    itab = torch.as_tensor(np.stack([k_tab - 1, bs_tab - 1], axis=1), device=dev)
    subsample = bool((bs_tab < s).any())
    stage_idx = torch.zeros(L, dtype=torch.int64, device=dev)
    terminal = torch.zeros(L, dtype=torch.bool, device=dev)

    # -- diagnostics / oracle switching -------------------------------------
    adaptive = cfg.strategy not in ("naive", "fastest_k")
    use_oracle = oracle_switch_times is not None
    diag = None
    if adaptive and not use_oracle:
        diag = _make_batch_diagnostic(cfg.diagnostic, L, d, dev)
    needs_loss = isinstance(diag, _BatchLossPlateauDiagnostic)
    if use_oracle:
        ost = torch.as_tensor(np.asarray(list(oracle_switch_times), dtype=np.float64),
                              device=dev)
        n_ost = int(ost.numel())
    # advances[it, lane]: stage advances of a lane at iteration ``it``.
    advances = torch.zeros((max_iters + 1, L), dtype=torch.int16, device=dev)

    def advance_lanes(mask: torch.Tensor, it: int) -> torch.Tensor:
        """Mirror ``Controller.advance`` for the masked lanes; returns the
        lanes that advanced."""
        nonlocal terminal
        at_end = mask & (stage_idx >= T - 1)
        terminal = terminal | at_end
        adv = mask & ~at_end
        stage_idx.add_(adv)
        advances[it].add_(adv)
        if diag is not None:
            diag.reset_lanes(adv)
        return adv

    # -- per-lane weights and accumulators ----------------------------------
    if w0 is None:
        w = torch.zeros((L, d), dtype=F64, device=dev)
    else:
        w0 = np.asarray(w0, dtype=np.float64)
        wn = np.broadcast_to(w0, (L, d)).copy() if w0.ndim == 1 else w0.copy()
        if wn.shape != (L, d):
            raise ValueError(f"w0 must broadcast to {(L, d)}, got {w0.shape}")
        w = torch.as_tensor(wn, device=dev)
    t = torch.zeros(L, dtype=F64, device=dev)
    cost = torch.zeros((L, 2), dtype=F64, device=dev)   # computation, communication
    active = torch.ones(L, dtype=torch.bool, device=dev)
    # The host's copy of ``active``: it changes only at an eval point with
    # ``target_gap``.
    active_host = np.ones(L, dtype=bool)
    reached = torch.zeros(L, dtype=torch.bool, device=dev)
    iterations = np.zeros(L, dtype=np.int64)
    n_evals = torch.ones(L, dtype=torch.int64, device=dev)

    def residuals() -> torch.Tensor:
        return w @ XT - y

    def gap_all() -> torch.Tensor:
        r = residuals()
        return (r * r).sum(1) / v - f_star

    times_rec = [torch.zeros(L, dtype=F64, device=dev)]
    gaps_rec = [gap_all()]
    costs_rec = [cost.clone()]

    # -- chunked per-lane RNG streams (shared layout with the scalar engine)
    chunk = chunk_len(n, s)
    rngs = [spawn_lane_rngs(sd) for sd in seed_list]
    E_buf = np.empty((chunk, L, model.n_exp_streams, n))
    U_buf = np.empty((chunk, L, n, s))
    E_dev = U_dev = U_sorted = None
    pos = chunk
    it = 0

    for it in range(1, max_iters + 1):
        if pos == chunk:
            for lane in np.nonzero(active_host)[0]:
                z_rng, u_rng = rngs[lane]
                E_buf[:, lane] = draw_response_chunk(z_rng, model, n, chunk)
                U_buf[:, lane] = draw_key_chunk(u_rng, n, s, chunk)
            E_dev = torch.as_tensor(E_buf, device=dev)
            if subsample:
                # Each worker row's keys sorted once a chunk: the row's
                # bs-th smallest is its threshold at any load.
                U_dev = torch.as_tensor(U_buf, device=dev)
                U_sorted = torch.sort(U_dev, dim=-1).values
            pos = 0
        E_it = E_dev[pos]
        pos_it = pos
        pos += 1

        iterations[active_host] = it
        lane_f = ftab[stage_idx]                   # (L, 6) this iteration's stage constants
        lane_i = itab[stage_idx]                   # (L, 2): k - 1, bs - 1

        # Response times, k-th order statistic, fastest-k mask.
        if is_simple:
            z = model.shift + lane_f[:, 3:4] * E_it[:, 0, :]
        elif is_general:
            z = lane_f[:, 4:5] + E_it[:, 0, :] / model.lambda_x + lane_f[:, 3:4] * E_it[:, 1, :]
        else:
            z = torch.as_tensor(model.compose(E_it.cpu().numpy(),
                                              lane_f[:, 5:6].cpu().numpy()), device=dev)
        zs = torch.sort(z, dim=1).values
        kth = torch.gather(zs, 1, lane_i[:, 0:1])[:, 0]
        t = torch.where(active, t + kth, t)
        fast = z <= kth[:, None]

        # Batch-selection mask: worker i contributes its bs smallest-key
        # samples (a row whose bs == s thresholds at its maximum).
        if subsample:
            thr = torch.gather(U_sorted[pos_it], 2, lane_i[:, 1, None, None].expand(L, n, 1))
            Mb = ((U_dev[pos_it] <= thr) & fast[:, :, None]).reshape(L, v)
        else:
            Mb = fast.repeat_interleave(s, dim=1)

        # Gradient of all lanes: residuals on the full data, masked to the
        # selected samples, contracted back through X (two small GEMMs).
        r = residuals()
        Mr = torch.where(Mb, r, 0.0)
        grad = (Mr @ X) * lane_f[:, 0:1]
        w = torch.where(active[:, None], w - eta * grad, w)
        cost = torch.where(active[:, None], cost + lane_f[:, 1:3], cost)

        # Stage control: diagnostics or oracle switch times.
        if diag is not None:
            loss = (Mr * r).sum(1) * (lane_f[:, 0] / 2.0) if needs_loss else None
            diag.observe(w=w, grad=grad, loss=loss, active=active)
            fired = diag.stationary & ~terminal
            advance_lanes(fired & active, it)
        elif use_oracle and n_ost > 0:
            while True:
                idx_c = torch.clamp(stage_idx, max=n_ost - 1)
                due = active & ~terminal & (stage_idx < n_ost) & (t >= ost[idx_c])
                if not bool(due.any()):
                    break
                if not bool(advance_lanes(due, it).any()):
                    break

        if it % eval_every == 0:
            g = gap_all()
            times_rec.append(t.clone())
            gaps_rec.append(torch.where(active, g, gaps_rec[-1]))
            costs_rec.append(cost.clone())
            n_evals += active
            if target_gap is not None:
                done = active & (g <= target_gap)
                reached |= done
                active = active & ~done
                active_host = active.cpu().numpy()
                if not active_host.any():
                    break

    # -- back to the host: per-lane stage logs from the advance counts -------
    adv = advances[: it + 1].cpu().numpy()
    stage_logs: List[List[Tuple[int, Stage]]] = [[(0, table[0])] for _ in range(L)]
    for i, lane in zip(*np.nonzero(adv)):
        log = stage_logs[lane]
        for _ in range(int(adv[i, lane])):
            log.append((int(i), table[len(log)]))

    def host(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    costs = host(torch.stack(costs_rec, dim=1))        # (L, evals, 2)
    final = host(cost)
    return BatchSimResult(
        seeds=seed_list,
        times=host(torch.stack(times_rec, dim=1)),
        gaps=host(torch.stack(gaps_rec, dim=1)),
        comp_at_eval=np.ascontiguousarray(costs[..., 0]),
        comm_at_eval=np.ascontiguousarray(costs[..., 1]),
        n_evals=host(n_evals),
        runtime=host(t),
        comp_cost=np.ascontiguousarray(final[:, 0]),
        comm_cost=np.ascontiguousarray(final[:, 1]),
        iterations=iterations,
        reached=host(reached),
        stage_logs=stage_logs,
    )
