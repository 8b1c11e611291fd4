"""Metrics registry: counters, gauges, and streaming histograms (the
port's copy of ``repro.obs.metrics``).

The registry is the numbers-over-a-run companion to the tracer's
timeline: arena block occupancy, slot high-water, draft acceptance,
hedge win/cancel ratios, censoring fraction, per-step train wait/compute
split. Everything is plain host arithmetic — no tensors, no device sync —
and a disabled registry hands out shared null instruments whose methods
are no-ops, so instrumented hot paths cost one attribute call when
observability is off.

Determinism: histograms keep an exact count/sum/min/max and a bounded
sample reservoir for quantiles. The reservoir decimates
DETERMINISTICALLY (sort, keep every other sample) when it exceeds its
cap — no RNG — so two identical runs snapshot identical p50/p99 and
benchmark JSON stays reproducible.

Instrument names are dotted paths (``engine.generated_tokens``,
``sched.queue_wait``); a name is bound to one instrument kind for the
registry's lifetime (reusing it as a different kind raises).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotone event count (``inc`` by any non-negative amount)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, v: Union[int, float] = 1) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v

    def snapshot(self) -> Union[int, float]:
        return self.value


class Gauge:
    """Point-in-time level plus its high-water mark (slot occupancy,
    arena blocks in use, queue depth)."""

    __slots__ = ("name", "value", "high_water")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0
        self.high_water: float = 0.0

    def set(self, v: Union[int, float]) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value, "high_water": self.high_water}


class Histogram:
    """Streaming distribution: exact count/sum/min/max, quantiles from a
    deterministically decimated reservoir (default cap 4096 samples)."""

    __slots__ = ("name", "cap", "count", "total", "min", "max", "_values")

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._values: List[float] = []

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._values.append(v)
        if len(self._values) > self.cap:
            self._values.sort()
            self._values = self._values[::2]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        if not self._values:
            return float("nan")
        return float(np.percentile(np.asarray(self._values), q))

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.total, 9),
            "min": self.min if self.count else "nan",
            "max": self.max if self.count else "nan",
            "mean": round(self.mean, 9) if self.count else "nan",
            "p50": round(self.percentile(50), 9) if self.count else "nan",
            "p99": round(self.percentile(99), 9) if self.count else "nan",
        }


class _NullCounter:
    __slots__ = ()

    def inc(self, v: Union[int, float] = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0
    high_water = 0.0

    def set(self, v: Union[int, float]) -> None:
        pass


class _NullHistogram:
    __slots__ = ()

    def observe(self, v: Union[int, float]) -> None:
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Get-or-create registry of named instruments. Disabled registries
    hand out shared null instruments (no state, no allocation)."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        return self._get(name, Histogram, cap=cap)

    def get(self, name: str) -> Optional[object]:
        """The instrument registered under ``name``, or None."""
        return self._instruments.get(name)

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view of every instrument, sorted by name — this is
        what benchmarks embed in their ``BENCH_*.json`` payloads."""
        return {
            name: inst.snapshot()
            for name, inst in sorted(self._instruments.items())
        }
