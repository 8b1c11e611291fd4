"""The production training loop: the paper's controller driving the
port's model (port of ``repro.runtime.train_loop``).

Wires together:
  * ``Controller`` (adaptive-(k,beta) stages, stationarity diagnostics,
    online delay-model estimation from CENSORED telemetry);
  * one train step for every stage: the fastest-k worker mask is DATA,
    and the per-stage beta only changes the batch shape (PyTorch runs
    eagerly, so there is nothing to compile per shape; the shapes seen
    are still reported under ``compiled_shapes``);
  * async checkpointing + exact resume (parameters and optimizer state
    bit for bit, control state, telemetry and both RNG streams), so a
    resumed run replays the exact history the uninterrupted run would
    have produced;
  * fault handling: worker failure -> permanent mask + controller n -= 1;
    persistent straggler demotion via censoring-aware telemetry; worker
    REJOIN -> controller n += 1.

Censoring discipline (DESIGN.md §2.5): a fastest-k step only observes the
k response times it waited for; the controller receives exactly those k
order statistics plus the count of censored workers. The response times
are sampled from the paper's delay models with numpy, in the same RNG
streams and order as the reference, so the two loops make the same
control decisions from the same seed.

One deliberate difference from the reference: ``train`` takes an
optional initial ``params`` (default ``model.init(seed, device=...)``,
drawn from a torch generator), so a test can hand it the reference's own
initial parameters. The loop updates the given parameters in place, as
the train step does (at full width a copy would not fit beside them). With ``obs`` it emits the reference's trace events,
metrics, decisions and structured-log records (``repro_torch.obs``).

On a mesh (``mesh=``, a ``DeviceMesh`` over every rank) the loop runs in
``activation_sharding(mesh)``: plain initial parameters are laid out by
``DEFAULT_RULES`` as DTensors, every rank runs the same host control
(controller, tracker, fault schedule, both RNG streams, ``sim_time``)
from the same seeds and steps its rows of the same batch, and the loss
it reads is the global one. Once a step the ranks all-gather a digest of
the step's history entry and raise if any rank differs. Only rank 0
writes checkpoints, traces and logs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.core.controller import Controller, StrategyConfig
from repro_torch.core.order_stats import DelayModel
from repro_torch.data.pipeline import StagedBatcher
from repro_torch.dist.collectives import check_worker_major
from repro_torch.dist.sharding import activation_sharding, make_sharding_fn, shard_tree
from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.obs import NULL_OBS, Observability
from repro_torch.optim.optimizers import Optimizer
from .checkpoint import CheckpointManager
from .faults import FaultEvent, schedule_by_step
from .steps import make_train_step
from .telemetry import StragglerTracker

__all__ = ["FaultEvent", "TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    lr: float = 3e-4
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    estimate_model: bool = True      # fit delay model from (censored) telemetry
    oracle_to_controller: bool = True  # False: controller sees ONLY telemetry
    fail_worker_at: Optional[int] = None   # legacy single-failure injection
    fail_worker_id: int = 0
    demote_after_ewma: Optional[float] = None  # straggler demotion threshold
    events: Sequence[FaultEvent] = ()          # chaos schedule


def _event_schedule(cfg: TrainLoopConfig) -> Dict[int, List[FaultEvent]]:
    events = list(cfg.events)
    if cfg.fail_worker_at is not None:
        events.append(FaultEvent(cfg.fail_worker_at, "fail", cfg.fail_worker_id))
    return schedule_by_step(events)


def _check_ranks_agree(step: int, digest: List[float], dev: torch.device) -> None:
    """All-gather the step's control digest; raise if any rank's differs."""
    mine = torch.tensor(digest, dtype=torch.float64, device=dev)
    every = torch.empty(dist.get_world_size() * mine.numel(), dtype=torch.float64, device=dev)
    dist.all_gather_into_tensor(every, mine)
    every = every.view(-1, mine.numel()).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"ranks diverged at step {step}: (k, beta, n_workers, stage, "
                           f"sim_time) = {every.tolist()}")


def train(
    model: Model,
    optimizer: Optimizer,
    strategy: StrategyConfig,
    delay_model: DelayModel,
    batcher: StagedBatcher,
    loop_cfg: TrainLoopConfig,
    *,
    params: Optional[Dict[str, Any]] = None,
    device="cuda",
    obs: Optional[Observability] = None,
    mesh=None,
) -> Dict[str, Any]:
    """Run the adaptive-(k,beta) training loop on ``device``. Returns the
    history (one dict per step: step, loss, k, beta, n_workers, sim_time,
    contributors, grad_norm, and switched_to on a stage switch), the
    final params and optimizer state, the controller, the tracker, the
    fleet's alive mask, the batch shapes seen and the simulated time.

    ``obs``: the observability bundle. When enabled, every step lands as
    a ``train_step`` complete event on the loop's ``sim_time`` lane,
    chaos and demotion transitions as ``fault`` / ``demote`` instants,
    the per-step wait / compute split as histograms, and every stage
    switch as a ``train.stage`` decision carrying the censored telemetry
    it was priced from. Every value comes from the host (the loss is
    read once a step already).

    ``mesh``: run data-parallel on this ``DeviceMesh`` (see the module
    docstring); ``params`` may be plain (laid out here) or DTensors."""
    lead = mesh is None or dist.get_rank() == 0
    obs = (obs or NULL_OBS) if lead else NULL_OBS
    tr_obs = obs.tracer
    pid = tr_obs.register_process("train")
    dev = resolve_device(device)
    rng = np.random.default_rng(loop_cfg.seed)
    ctrl = Controller(
        strategy,
        model=delay_model if loop_cfg.oracle_to_controller else None,
        estimate_model=loop_cfg.estimate_model,
    )
    n0 = strategy.n  # fleet size at loop start; worker ids are 0..n0-1
    tracker = StragglerTracker(n0, metrics=obs.metrics if obs.enabled else None)
    schedule = _event_schedule(loop_cfg)
    h_step = obs.metrics.histogram("train.step_time")
    # Wait: how long the FASTEST observed worker idled for the k-th (the
    # straggler tax fastest-k buys down); compute: the mean observed
    # response time.
    h_wait = obs.metrics.histogram("train.wait")
    h_compute = obs.metrics.histogram("train.compute")
    g_workers = obs.metrics.gauge("train.n_workers")
    step_fn = make_train_step(model, optimizer)
    shapes: List[Tuple[int, ...]] = []

    if params is None:
        params = model.init(loop_cfg.seed, device=dev)
    if mesh is not None and not any(isinstance(p, DTensor) for p in
                                    tree_leaves(params, is_leaf=torch.is_tensor)):
        shardings = tree_map(make_sharding_fn(mesh), model.param_specs(),
                             is_leaf=lambda x: isinstance(x, ParamSpec))
        params = shard_tree(params, shardings)
    opt_state = optimizer.init(params)

    ckpt = CheckpointManager(loop_cfg.checkpoint_dir) if loop_cfg.checkpoint_dir else None
    alive = np.ones(n0, bool)
    slow_factor = np.ones(n0)
    sim_time = 0.0
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            start_step, state, extras = restored
            params, opt_state = state["params"], state["opt"]
            # Full control-state resume: controller (stage walk +
            # diagnostic + telemetry), straggler tracker, fleet
            # membership, the event clock, and both RNG streams.
            ctrl.load_state_dict(extras["controller"])
            tracker.load_state_dict(extras["tracker"])
            alive = np.asarray(extras["alive"], bool)
            slow_factor = np.asarray(extras["slow_factor"], np.float64)
            sim_time = float(extras["sim_time"])
            rng.bit_generator.state = extras["rng_state"]
            batcher.stream.rng.bit_generator.state = extras["stream_rng_state"]

    history: List[Dict[str, Any]] = []
    ctx = activation_sharding(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        for step in range(start_step, loop_cfg.total_steps):
            # ---- chaos events -----------------------------------------------
            for ev in schedule.get(step, ()):
                applied = False
                if ev.kind == "fail" and alive[ev.worker]:
                    alive[ev.worker] = False
                    ctrl.remove_worker()
                    applied = True
                elif ev.kind == "rejoin" and not alive[ev.worker]:
                    alive[ev.worker] = True
                    slow_factor[ev.worker] = ev.factor
                    tracker.reset_worker(ev.worker)
                    ctrl.add_worker()
                    applied = True
                elif ev.kind == "slow":
                    slow_factor[ev.worker] = ev.factor
                    applied = True
                if applied and obs.enabled:
                    obs.metrics.counter(f"train.fault.{ev.kind}").inc()
                    tr_obs.instant("fault", pid, sim_time,
                                   args={"kind": ev.kind, "worker": ev.worker, "step": step})

            # ---- pending demotions from telemetry ---------------------------
            if loop_cfg.demote_after_ewma is not None:
                for w in tracker.persistent_stragglers(loop_cfg.demote_after_ewma):
                    if alive[w] and alive.sum() > 1:
                        alive[w] = False
                        ctrl.remove_worker()
                        if obs.enabled:
                            obs.metrics.counter("train.demotions").inc()
                            tr_obs.instant("demote", pid, sim_time,
                                           args={"worker": int(w), "step": step})

            # ---- the n-contract: controller and fleet must agree ------------
            n_active = int(alive.sum())
            if n_active != ctrl.cfg.n:
                raise RuntimeError(
                    f"fleet/controller divergence: {n_active} alive workers "
                    f"but controller prices n={ctrl.cfg.n}"
                )
            active_ids = np.nonzero(alive)[0]
            stage = ctrl.stage

            # ---- response times + fastest-k mask ----------------------------
            # Sample the FULL original fleet every step so the RNG stream
            # consumption is independent of membership (exact resume and
            # run-to-run comparability), then restrict to active workers.
            z_full = delay_model.sample(rng, n0, stage.beta) * slow_factor
            z_act = z_full[active_ids]
            k_eff = min(stage.k, n_active)
            order = np.argpartition(z_act, k_eff - 1)[:k_eff]
            t_step = float(z_act[order].max())
            t0_step = sim_time
            sim_time += t_step
            mask = np.zeros(n_active, np.float32)
            mask[order] = 1.0

            # ---- censored telemetry -----------------------------------------
            selected = np.zeros(n0, bool)
            selected[active_ids[order]] = True
            tracker.observe(z_full, alive, observed=selected, censor_level=t_step)

            # ---- batch sized for the CURRENT fleet --------------------------
            np_batch = batcher.batch_for_stage(stage.beta, n_workers=n_active)
            check_worker_major(np_batch["inputs"].shape[0], n_active)
            batch = {
                "inputs": torch.from_numpy(np_batch["inputs"]).to(dev),
                "labels": torch.from_numpy(np_batch["labels"]).to(dev),
                "worker_mask": torch.from_numpy(mask).to(dev),
                "lr": loop_cfg.lr,
            }
            if np_batch["inputs"].shape not in shapes:
                shapes.append(np_batch["inputs"].shape)
            params, opt_state, metrics = step_fn(params, opt_state, batch)

            loss = float(metrics["loss"])
            ctrl.observe(
                loss=loss,
                response_times=np.sort(z_act[order]),
                n_unobserved=n_active - k_eff,
            )
            switched = ctrl.maybe_advance()

            if obs.enabled:
                observed = np.sort(z_act[order])
                h_step.observe(t_step)
                h_wait.observe(t_step - float(observed[0]))
                h_compute.observe(float(observed.mean()))
                g_workers.set(n_active)
                tr_obs.complete("train_step", pid, t0_step, sim_time,
                                args={"step": step, "k": stage.k, "beta": float(stage.beta),
                                      "n_workers": n_active, "loss": round(loss, 6)})
                if switched is not None:
                    tr_obs.instant("stage_switch", pid, sim_time,
                                   args={"step": step, "k": switched.k,
                                         "beta": float(switched.beta)})
                    fitted = ctrl.current_model()
                    obs.decisions.record(
                        "train.stage",
                        {"k": switched.k, "beta": float(switched.beta)},
                        {"stage_idx": ctrl.stage_idx,
                         "n": ctrl.cfg.n,
                         "rt_samples": len(ctrl._rt_samples),
                         "rt_censored": int(sum(ctrl._rt_censored)),
                         "lambda_y": (round(float(fitted.lambda_y), 6)
                                      if fitted is not None else None)},
                        step=step, vtime=sim_time,
                    )

            history.append({
                "step": step,
                "loss": loss,
                "k": stage.k,
                "beta": stage.beta,
                "n_workers": n_active,
                "sim_time": sim_time,
                "contributors": float(metrics["contributors"]),
                "grad_norm": float(metrics["grad_norm"]),
            })
            if switched is not None:
                history[-1]["switched_to"] = (switched.k, switched.beta)
            if mesh is not None:
                _check_ranks_agree(step, [stage.k, stage.beta, n_active, ctrl.stage_idx,
                                          sim_time], dev)

            if ckpt is not None and (step + 1) % loop_cfg.checkpoint_every == 0:
                ckpt.save_async(
                    step + 1,
                    {"params": params, "opt": opt_state},
                    extras={
                        "controller": ctrl.state_dict(),
                        "tracker": tracker.state_dict(),
                        "alive": [int(a) for a in alive],
                        "slow_factor": [float(f) for f in slow_factor],
                        "sim_time": sim_time,
                        "rng_state": rng.bit_generator.state,
                        "stream_rng_state": batcher.stream.rng.bit_generator.state,
                    },
                )

            if lead and loop_cfg.log_every and step % loop_cfg.log_every == 0:
                # The structured record is the source of truth; the print is
                # its stdout view unless the log echoes its own rendering.
                obs.log.emit("train_step", t=sim_time, step=step, loss=round(loss, 4),
                             k=stage.k, beta=float(stage.beta), workers=n_active)
                if not obs.log.echo:
                    print(f"step {step:5d} loss {loss:8.4f} k={stage.k:2d} "
                          f"beta={stage.beta:4.2f} t={sim_time:9.2f} workers={n_active}",
                          flush=True)

    if ckpt is not None:
        ckpt.wait()
    return {
        "history": history,
        "params": params,
        "opt_state": opt_state,
        "controller": ctrl,
        "tracker": tracker,
        "alive": alive,
        "compiled_shapes": shapes,
        "sim_time": sim_time,
    }
