"""Controller decision log: every adaptive reprice, with its inputs (the
port's copy of ``repro.obs.decisions``).

The paper's whole contribution is a sequence of *decisions* — which
(k, beta) stage to run, how wide to draft (gamma), how far to fan a
hedge out (n_h) — each priced from noisy, censored telemetry. A run
that merely *executes* those decisions is unexplainable after the fact;
this log records each one WITH the inputs it was priced from (fitted
lambda from the censored MLE, sample/censor counts, acceptance
estimates, slowdown vectors, stage index), so "why did the controller
switch at step 83?" has a machine-readable answer.

Domains used by the instrumented planes:

* ``train.stage``  — Controller stage walk: decision {k, beta},
  inputs {stage_idx, n, lambda_hat, rt_samples, rt_censored, ...}
* ``serve.hedge``  — HedgedRouter fan-out: decision {n_h, k, replicas},
  inputs {slowdowns, n_alive, beta}
* ``serve.gamma``  — SpecController draft length: decision {gamma, n_h},
  inputs {p, observations, rounds, cost_per_token}

Producers log a decision when it CHANGES (a reprice), not on every
evaluation of an unchanged policy — the log stays proportional to the
number of adaptation events, and a bounded ``cap`` guards against a
pathological flip-flopping controller (drops are counted, never
silent).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["Decision", "DecisionLog"]


@dataclasses.dataclass(frozen=True)
class Decision:
    domain: str                   # e.g. "train.stage", "serve.gamma"
    decision: Dict[str, Any]      # what was chosen
    inputs: Dict[str, Any]        # the telemetry it was priced from
    step: Optional[int] = None    # producer-local step/round index
    vtime: Optional[float] = None  # virtual time of the reprice

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "domain": self.domain,
            "step": self.step,
            "vtime": self.vtime,
            "decision": dict(self.decision),
            "inputs": dict(self.inputs),
        }


class DecisionLog:
    def __init__(self, enabled: bool = True, cap: int = 10_000):
        self.enabled = bool(enabled)
        self.cap = int(cap)
        self.entries: List[Decision] = []
        self.dropped = 0              # entries past cap (never silent)

    def record(
        self,
        domain: str,
        decision: Dict[str, Any],
        inputs: Dict[str, Any],
        *,
        step: Optional[int] = None,
        vtime: Optional[float] = None,
    ) -> None:
        if not self.enabled:
            return
        if len(self.entries) >= self.cap:
            self.dropped += 1
            return
        self.entries.append(Decision(domain, decision, inputs, step, vtime))

    def by_domain(self, domain: str) -> List[Decision]:
        return [d for d in self.entries if d.domain == domain]

    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "entries": [d.to_jsonable() for d in self.entries],
            "dropped": self.dropped,
        }
