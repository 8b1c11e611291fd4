"""Unified observability plane: tracing, metrics, decisions, structured log
(the port's copy of ``repro.obs``, with its own :data:`NULL_OBS`).

One :class:`Observability` bundle travels through a run — the serve
engine/frontend/router, the train loop, the benchmarks all take an
optional ``obs`` and default to the shared :data:`NULL_OBS` singleton,
whose sub-components are all disabled no-ops. Enabling observability is
therefore a call-site decision (demos, tests, trace_report), never a
code-path fork, and the instrumented hot paths cost one attribute check
when it is off.

Components (each usable standalone):

* :class:`~repro_torch.obs.trace.Tracer` — virtual-clock span/event tracer
  with Chrome/Perfetto ``trace_event`` export (``docs/observability.md``).
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  streaming histograms, snapshot-able into ``BENCH_*.json``.
* :class:`~repro_torch.obs.decisions.DecisionLog` — every adaptive
  (k, beta, gamma, n_h) reprice with the telemetry it was priced from.
* :class:`~repro_torch.obs.log.StructuredLog` — typed run records; stdout is
  a formatted view of the same records (used by the examples).
"""

from __future__ import annotations

import json
from typing import Any, Dict

from repro_torch.obs.decisions import Decision, DecisionLog
from repro_torch.obs.log import LogRecord, StructuredLog
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import TID_MAIN, Tracer, validate_trace

__all__ = [
    "Observability",
    "NULL_OBS",
    "Tracer",
    "validate_trace",
    "TID_MAIN",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DecisionLog",
    "Decision",
    "StructuredLog",
    "LogRecord",
]


class Observability:
    """Bundle of tracer + metrics + decision log + structured log.

    ``enabled`` is True iff any recording component is on; hot paths use
    it to skip building args dicts entirely. The structured log is
    always constructed (it is cheap and the examples drive it directly)
    but records only when the bundle is enabled (or ``log_echo`` asks
    for it) and echoes to stdout only when asked.
    """

    def __init__(
        self,
        *,
        trace: bool = True,
        metrics: bool = True,
        decisions: bool = True,
        log_echo: bool = False,
    ):
        self.tracer = Tracer(enabled=trace)
        self.metrics = MetricsRegistry(enabled=metrics)
        self.decisions = DecisionLog(enabled=decisions)
        self.enabled = bool(trace or metrics or decisions)
        # A fully-disabled bundle (NULL_OBS) must not accumulate records
        # either — emit becomes a pure constructor.
        self.log = StructuredLog(echo=log_echo,
                                 enabled=self.enabled or log_echo)

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(trace=False, metrics=False, decisions=False)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able cross-component summary (metrics + decisions +
        structured records + trace size). Trace events themselves are
        exported separately via ``tracer.export`` — they can be large."""
        return {
            "metrics": self.metrics.snapshot(),
            "decisions": self.decisions.to_jsonable(),
            "log": self.log.to_jsonable(),
            "trace_events": len(self.tracer.events),
            "open_spans": list(self.tracer.open_spans),
        }

    def export_snapshot(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


#: Shared disabled bundle — the default ``obs`` everywhere. Do not
#: mutate; instruments handed out by its registry are stateless nulls.
NULL_OBS = Observability.disabled()
