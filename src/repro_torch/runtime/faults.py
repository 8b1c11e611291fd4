"""Declarative fault schedules shared by the training and serving planes
(the port's copy of ``repro.runtime.faults``).

One schema describes chaos for both workloads: a ``FaultEvent`` names a
unit of capacity (a training *worker* or a serving *replica* — the field
is ``worker`` for historical reasons), a step at which the event fires,
and what happens to it:

  * ``"fail"``   — the unit dies (permanent unless it rejoins);
  * ``"rejoin"`` — a previously removed unit comes back healthy
    (capacity += 1, telemetry history reset so stale slowness cannot
    re-demote it);
  * ``"slow"``   — the unit's response times are multiplied by
    ``factor`` from this step on (1.0 = recovered);
  * ``"drain"``  — serving plane only: graceful decommission — every
    in-flight request migrates off (KV block handoff) before the unit
    leaves the fleet; the training loop ignores this kind.

``step`` is whatever discrete clock the consuming loop advances: the
training loop counts optimizer steps (``runtime.train_loop``), the
serving plane counts engine actions (``serve.frontend``). Both consume
the schedule through :func:`schedule_by_step`.

The schema is intentionally *injection only*: it describes what the
environment does to the fleet. How the control plane reacts — censored
telemetry, demotion, re-pricing ``(k, beta)`` or ``(n_h, k)`` from the
shrunken fleet — must come from observations alone, never from reading
this schedule (that is the oracle-free contract both chaos demos pin).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

__all__ = ["FaultEvent", "schedule_by_step"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """A scheduled chaos event: unit ``worker`` at step ``step``.

    Validated at CONSTRUCTION — a malformed event (unknown kind,
    negative step/worker, non-positive slow factor) raises here, at the
    point where the schedule is written, instead of failing deep inside
    the consuming plane's event loop."""

    step: int
    kind: str
    worker: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in ("fail", "rejoin", "slow", "drain"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.worker < 0:
            raise ValueError(f"fault worker must be >= 0, got {self.worker}")
        if self.factor <= 0:
            raise ValueError(
                f"slow factor must be > 0, got {self.factor} "
                "(use kind='fail' to remove a unit, factor=1.0 to restore)"
            )

    def as_dict(self) -> dict:
        """JSON-serializable form (chaos-search repro schedules)."""
        return {"step": self.step, "kind": self.kind,
                "worker": self.worker, "factor": self.factor}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(step=int(d["step"]), kind=str(d["kind"]),
                   worker=int(d["worker"]), factor=float(d.get("factor", 1.0)))


def schedule_by_step(events: Iterable[FaultEvent]) -> Dict[int, List[FaultEvent]]:
    """Index a flat event list by step, preserving in-step order."""
    by_step: Dict[int, List[FaultEvent]] = {}
    for ev in events:
        by_step.setdefault(ev.step, []).append(ev)
    return by_step
