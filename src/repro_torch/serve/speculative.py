"""Speculative decoding: adaptive draft length over the slot pool (port of
``repro.serve.speculative``).

Each round, a cheap DRAFT model proposes ``gamma`` tokens per live slot
(gamma sequential masked draft ticks), and the TARGET model scores all
of them in ONE verify call (``Model.verify_with_cache``). The
exact-argmax rule commits the longest draft prefix the target agrees
with, plus one corrected token, so the greedy stream equals
non-speculative decode and speculation only moves throughput:

  * ``gamma`` is the computation-load knob (the paper's beta): extra
    work bought per round, wasted wherever the chain breaks;
  * the accepted-prefix length is the fastest-k outcome (the paper's k).

``SpecController`` adapts gamma from acceptance telemetry: an EWMA of
the per-draft-token acceptance probability feeds a brute-force
minimization of expected cost per committed token. Where the verify is
dispatched over replicas, its latency is priced with the same
``expected_kth`` order statistics the hedged router uses
(``choose_hedged``).

``DraftRunner`` keeps the draft's own contiguous ``SlotPool`` in
slot-index lockstep with the target's. It talks to the cache only
through the pool's spec tree: the leaves with no sequence axis
(recurrent state) cannot rewind, and the port's caches change in place,
so the snapshot CLONES them (the reference keeps a reference to an
immutable tree); K/V leaves rewind by position alone and are never
copied.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.order_stats import expected_kth, expected_kth_derivative
from repro_torch.models.layers import tree_leaves
from repro_torch.obs import NULL_OBS
from repro_torch.runtime.steps import (
    make_slot_decode_step,
    make_slot_prefill_step,
    make_slot_replay_step,
)

from .kv_pool import SlotPool, is_state_spec
from .scheduler import CostModel

__all__ = ["GammaPlan", "SpecController", "DraftRunner", "hedged_round_cost"]


# ---------------------------------------------------------------------------
# Gamma pricing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GammaPlan:
    gamma: int                   # draft tokens per round (0 = don't speculate)
    expected_tokens: float       # E[committed tokens per round]
    expected_cost: float         # virtual seconds per round
    cost_per_token: float        # what the brute force minimizes
    n_h: int = 1                 # verify fan-out (hedged pricing only)


def expected_round_tokens(gamma: int, p: float) -> float:
    """E[tokens committed by one round] = sum_{i=0}^{gamma} p^i under the
    geometric acceptance model (each draft token independently agrees
    with the target's argmax with probability ``p``; the round commits
    the unbroken prefix plus one corrected token)."""
    return float(sum(p ** i for i in range(gamma + 1)))


def hedged_round_cost(
    delay_model,
    n_h: int,
    gamma: int,
    *,
    draft_time: float,
    beta_unit: float,
    quorum: int = 1,
    cost_per_replica: float = 0.0,
    slowdown: float = 1.0,
) -> float:
    """Expected latency of one round whose verify is hedged over ``n_h``
    replicas:

        cost = gamma * t_draft
             + mu_{k:n_h}(beta_unit * (gamma + 1)) * slowdown
             + c_replica * n_h

    The window width (gamma + 1) scales the per-replica load beta as the
    paper's per-worker batch fraction does, and the k-th fastest verify
    is priced by ``expected_kth``. Past beta = 1 (the delay models'
    domain) the latency extrapolates linearly from beta = 1 through
    ``expected_kth_derivative``, so a wider window always costs more."""
    beta = beta_unit * (gamma + 1)
    k = min(quorum, n_h)
    if beta <= 1.0:
        lat = expected_kth(delay_model, n_h, k, beta)
    else:
        lat = expected_kth(delay_model, n_h, k, 1.0) + (
            beta - 1.0
        ) * expected_kth_derivative(delay_model, n_h, k, 1.0)
    return gamma * draft_time + lat * slowdown + cost_per_replica * n_h


class SpecController:
    """Adapts the draft length from acceptance telemetry.

    ``observe(accepted, offered)`` feeds per-token Bernoulli outcomes into
    an EWMA acceptance probability (the chain stops at the first
    disagreement, so at most one failure is observed and later positions
    are censored). ``choose_gamma`` brute-forces the gamma minimizing
    expected virtual cost per committed token under the engine's
    ``CostModel``; gamma = 0 means speculation loses and the engine runs
    plain ticks, probing with gamma = 1 every ``probe_every`` rounds."""

    def __init__(
        self,
        gamma_max: int = 4,
        *,
        alpha: float = 0.1,
        p0: float = 0.8,
        warmup: int = 4,
        probe_every: int = 16,
    ):
        if gamma_max < 1:
            raise ValueError("need gamma_max >= 1")
        self.gamma_max = gamma_max
        self.alpha = alpha
        self.p0 = p0
        self.warmup = warmup
        self.probe_every = probe_every
        self.p = p0                  # EWMA per-draft-token acceptance
        self.observations = 0        # Bernoulli outcomes absorbed
        self.rounds = 0              # choose_gamma calls (probe clock)
        #: set by the engine: fused-prefill drafts resync by position
        #: rewind (+ one expected tick), the others by a replay scan.
        self.draft_fused = True
        #: hist[a] = lane-rounds that accepted exactly ``a`` draft tokens.
        self.hist = np.zeros(gamma_max + 1, np.int64)
        #: observability bundle, attached by the engine (as ``draft_fused``
        #: is); the disabled singleton by default.
        self.obs = NULL_OBS
        self._last_gamma: Optional[int] = None   # decision-log dedup

    # -- telemetry -----------------------------------------------------------
    def observe(self, accepted: int, offered: int) -> None:
        if offered <= 0:
            return
        if not (0 <= accepted <= offered):
            raise ValueError(f"accepted {accepted} outside [0, {offered}]")
        self.hist[min(accepted, self.gamma_max)] += 1
        if self.obs.enabled:
            self.obs.metrics.counter("spec.offered").inc(offered)
            self.obs.metrics.counter("spec.accepted").inc(accepted)
        outcomes = [1.0] * accepted + ([0.0] if accepted < offered else [])
        for x in outcomes:
            self.p += self.alpha * (x - self.p)
            self.observations += 1

    @property
    def p_effective(self) -> float:
        """Acceptance estimate the pricing uses (the prior until warmed)."""
        return self.p if self.observations >= self.warmup else self.p0

    # -- pricing -------------------------------------------------------------
    def round_cost(self, gamma: int, cost: CostModel) -> float:
        """Expected virtual cost of one round at draft length ``gamma``.
        gamma = 0 is a plain tick plus the draft's lockstep tick.
        Fused-prefill drafts pay one extra expected tick with probability
        p^gamma (the all-accepted repair of ``DraftRunner.resync``), the
        others a replay scan."""
        if gamma == 0:
            return cost.decode() + cost.draft_decode()
        if self.draft_fused:
            p_all = self.p_effective ** gamma
            return cost.spec_round(gamma, gamma + 1) + p_all * cost.draft_decode()
        return cost.spec_round(gamma, gamma + 1, replay=True)

    def choose_gamma(self, cost: CostModel) -> GammaPlan:
        """Brute-force argmin over gamma of cost per committed token."""
        self.rounds += 1
        p = self.p_effective
        best: Optional[GammaPlan] = None
        for gamma in range(self.gamma_max + 1):
            toks = expected_round_tokens(gamma, p)
            c = self.round_cost(gamma, cost)
            plan = GammaPlan(gamma, toks, c, c / toks)
            if best is None or plan.cost_per_token < best.cost_per_token:
                best = plan
        if best.gamma == 0 and self.probe_every > 0 and self.rounds % self.probe_every == 0:
            toks = expected_round_tokens(1, p)
            c = self.round_cost(1, cost)
            best = GammaPlan(1, toks, c, c / toks)
        if best.gamma != self._last_gamma:
            # Log a reprice (a CHANGED gamma), not every evaluation.
            self._last_gamma = best.gamma
            self.obs.decisions.record(
                "serve.gamma",
                {"gamma": int(best.gamma), "n_h": int(best.n_h)},
                {"p": round(p, 6), "observations": self.observations,
                 "cost_per_token": round(best.cost_per_token, 9)},
                step=self.rounds,
            )
        return best

    def choose_hedged(
        self,
        delay_model,
        *,
        draft_time: float,
        beta_unit: float,
        n_max: int,
        quorum: int = 1,
        cost_per_replica: float = 0.0,
        slowdown: float = 1.0,
    ) -> GammaPlan:
        """Joint (gamma, n_h) brute force with the verify latency priced by
        ``expected_kth`` (``hedged_round_cost``). ``n_max`` is the live
        replica count; a fleet smaller than the quorum clamps the quorum."""
        quorum = min(quorum, max(n_max, 1))
        p = self.p_effective
        best: Optional[GammaPlan] = None
        for gamma in range(self.gamma_max + 1):
            toks = expected_round_tokens(gamma, p)
            for n in range(quorum, n_max + 1):
                c = hedged_round_cost(
                    delay_model, n, gamma, draft_time=draft_time, beta_unit=beta_unit,
                    quorum=quorum, cost_per_replica=cost_per_replica, slowdown=slowdown,
                )
                plan = GammaPlan(gamma, toks, c, c / toks, n_h=n)
                if best is None or plan.cost_per_token < best.cost_per_token:
                    best = plan
        return best


# ---------------------------------------------------------------------------
# Draft runner: the draft model's twin slot pool
# ---------------------------------------------------------------------------

class DraftRunner:
    """A second, contiguous ``SlotPool`` on the device of ``params``, kept
    in slot-index lockstep with the target engine's pool: same
    admissions, same frees, same defrag permutation.

    Rollback, by cache leaf kind (read off the spec tree):

      * K/V leaves rewind by position: rows past the committed position
        are dead and rewritten before anything reads them;
      * recurrent state leaves cannot rewind, so ``snapshot`` clones them
        before drafting and ``resync`` copies the clones back in place,
        then replays exactly the committed tokens through one masked scan
        (``make_slot_replay_step``).
    """

    def __init__(self, model, params, n_slots: int, max_len: int):
        if model.cfg.is_encoder:
            raise ValueError("draft model must be a causal decoder")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.pool = SlotPool(model, n_slots, max_len, device=self.device)
        self._prefill = make_slot_prefill_step(model)
        self._decode = make_slot_decode_step(model)
        self._replay = make_slot_replay_step(model)
        self._state = [is_state_spec(s) for s in tree_leaves(self.pool.specs)]
        self._snap: Optional[List[Optional[torch.Tensor]]] = None
        self._snap_positions: Optional[np.ndarray] = None

    # -- admission mirror ----------------------------------------------------
    def prefill_chunk(self, slot: int, chunk: torch.Tensor, n_tok: int, start: int,
                      owner: Optional[int] = None) -> None:
        """Mirror one target prefill chunk into the draft cache. ``chunk``
        is the engine's (1, bucket) token tensor."""
        if start == 0:
            got = self.pool.allocate(owner=owner)
            assert got == slot, f"draft pool desync: slot {got} != {slot}"
            self.pool.reset_slot(slot)
        _, slot_caches = self._prefill(
            self.params, chunk.to(self.device), self.pool.read_slot(slot),
            torch.tensor([n_tok], device=self.device), start, None,
        )
        self.pool.write_slot(slot, slot_caches, position=start + n_tok)

    # -- draft loop ----------------------------------------------------------
    def snapshot(self) -> None:
        """Mark the committed state before drafting: clone every recurrent
        state leaf (the ticks below change the pool in place) and keep the
        positions. K/V leaves are not copied."""
        self._snap = [leaf.clone() if state else None for leaf, state in
                      zip(tree_leaves(self.pool.caches, is_leaf=torch.is_tensor),
                          self._state)]
        self._snap_positions = self.pool.positions.copy()

    def decode_tick(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One masked draft tick over the pool -> greedy proposals
        (n_slots,); advances the positions of masked-in lanes. A
        masked-out lane keeps its recurrent state and writes one K/V row
        at its position, which is dead or (for a lane that drafted its
        budget) the row its next token writes anyway."""
        pool = self.pool
        positions = torch.as_tensor(np.clip(pool.positions, 0, pool.max_len - 1),
                                    device=self.device)
        logits, pool.caches = self._decode(
            self.params, torch.as_tensor(tokens[:, None], device=self.device),
            pool.caches, positions, None, torch.as_tensor(mask, device=self.device),
        )
        pool.positions[mask] += 1
        greedy = torch.argmax(logits[:, -1, :], dim=-1)
        return greedy.cpu().numpy().astype(np.int32)

    # -- post-verify resync --------------------------------------------------
    def resync(self, inputs: np.ndarray, n_commit: np.ndarray) -> Tuple[int, bool]:
        """Roll the draft back to the committed stream: exactly
        ``n_commit[b]`` tokens of ``inputs[b]`` a lane (0 = lane left
        alone). Returns ``(extra_ticks, replayed)`` for the event clock.

        Dense drafts rewind for free: the drafting ticks wrote the K/V
        rows of every token they consumed, and the committed prefix is a
        subset of them. The one gap is an ALL-ACCEPTED lane, whose last
        committed token the draft proposed but never consumed: one masked
        tick feeds it. Drafts with recurrent state copy the snapshot back
        and replay the committed tokens through one masked scan."""
        assert self._snap is not None, "resync without snapshot"
        pool = self.pool
        starts = self._snap_positions
        live = n_commit > 0
        extra_ticks, replayed = 0, False
        if self.model.fused_prefill:
            drafted = pool.positions - starts            # ticks consumed a lane
            need = live & (n_commit > drafted)           # all-accepted lanes
            if need.any():
                toks = np.take_along_axis(
                    inputs, np.maximum(n_commit - 1, 0)[:, None], axis=1)[:, 0]
                self.decode_tick(toks.astype(np.int32), need)
                extra_ticks = 1
            rewind = live & ~need
            pool.positions[rewind] = starts[rewind] + n_commit[rewind]
        else:
            leaves = tree_leaves(pool.caches, is_leaf=torch.is_tensor)
            for leaf, snap in zip(leaves, self._snap):
                if snap is not None:
                    leaf.copy_(snap)
            pool.caches = self._replay(
                self.params, torch.as_tensor(inputs, device=self.device), pool.caches,
                torch.as_tensor(n_commit, device=self.device),
                torch.as_tensor(np.clip(starts, 0, pool.max_len - 1), device=self.device),
                None,
            )
            pool.positions[live] = starts[live] + n_commit[live]
            replayed = True
        self._snap = self._snap_positions = None
        return extra_ticks, replayed
