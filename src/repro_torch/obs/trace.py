"""Span/event tracer keyed on the repo's VIRTUAL clocks (the port's copy
of ``repro.obs.trace``).

Every plane in this repo already runs on deterministic virtual time (the
serve ``EventClock`` / ``FaultyClock`` family, the train loop's
``sim_time``), which makes runs perfectly replayable — and, until now,
perfectly opaque. The tracer turns those clocks into an inspectable
timeline: callers stamp spans and instants with virtual seconds, and the
tracer exports Chrome/Perfetto ``trace_event`` JSON (open
``chrome://tracing`` or https://ui.perfetto.dev and drop the file in).

Design rules (docs/observability.md):

* **Virtual time is the timeline.** ``ts`` fields are virtual
  microseconds. Wall-clock (``time.perf_counter``) is captured per event
  in a parallel buffer and merged into ``args`` only on
  ``to_json(include_wall=True)`` — the default export contains no wall
  time, so two runs with identical seeds produce BYTE-IDENTICAL JSON
  (pinned in tests/test_obs.py).
* **Wall time on the card is dispatch time.** CUDA launches are
  asynchronous, so the ``perf_counter`` stamp of an event is when the
  host dispatched its work, not when the device ran it. The tracer never
  synchronizes to make the stamp "right": that would add a device wait
  to every engine action it observes.
* **Zero cost when disabled.** A disabled tracer's methods return
  immediately (one attribute check); hot paths may additionally guard
  arg-dict construction on ``tracer.enabled``.
* **Span hygiene is checkable.** Request-lifecycle spans are async
  ("b"/"e") events with tracer-assigned ids; ``open_spans`` lists every
  begun-but-unclosed span so tests can assert none leak, even under
  chaos (cancel / deadline-expiry / migration paths must close them).
* **Tracks are processes.** Each engine replica, the frontend, and the
  train loop register a Chrome "process" (``register_process``) so the
  timeline renders one lane per virtual clock; within a process, action
  events (prefill chunks, decode ticks, spec rounds, idle jumps) are
  complete ("X") events on tid 0, emitted in clock order — which is the
  monotonicity invariant ``validate_trace`` enforces.

Event vocabulary used by the instrumented planes (all optional — the
tracer itself is name-agnostic):

==============  ====  =====================================================
name            ph    emitted by
==============  ====  =====================================================
``request``     b/e   engine per local request; frontend per logical gid
``prefill``     X     one prefill chunk (args: rid, start, n_tokens, done)
``decode``      X     one pool-wide decode tick (args: lanes)
``spec_round``  X     one draft+verify round (args: gamma, lanes, committed)
``idle``        X     clock jump to the next arrival
``train_step``  X     one fastest-k training step (args: step, k, beta, ...)
``cancel``      i     explicit cancel / deadline expiry (args: rid, reason)
``migrate_out`` i     request exported as a MigrationTicket
``migrate_in``  i     ticket restored into an engine
``dispatch``    i     frontend hedge fan-out (args: gid, replicas)
``fault``       i     chaos FaultEvent applied (args: kind, worker)
==============  ====  =====================================================
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "validate_trace", "TID_MAIN"]

#: default track id inside a registered process (one lane per clock).
TID_MAIN = 0


def _us(t: float) -> float:
    """Virtual seconds -> trace microseconds, rounded so JSON stays
    compact and stable (sub-nanosecond float dust would still be
    deterministic, but renders horribly in Perfetto tooltips)."""
    return round(float(t) * 1e6, 3)


class Tracer:
    """Chrome ``trace_event`` collector over virtual clocks."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: List[Dict[str, Any]] = []
        self._wall: List[float] = []        # perf_counter per event (parallel)
        self._wall0 = time.perf_counter()
        self._procs: Dict[int, str] = {}    # pid -> display name
        self._next_pid = 1
        self._next_sid = 1
        self._open: Dict[int, Dict[str, Any]] = {}   # sid -> begin event

    # -- low-level emit ------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        self._wall.append(time.perf_counter() - self._wall0)

    # -- processes (one per virtual clock) -----------------------------------
    def register_process(self, name: str) -> int:
        """Allocate a trace process (= timeline lane) and name it. Safe
        to call on a disabled tracer (returns pid 0, emits nothing).
        Names need not be unique; pids always are."""
        if not self.enabled:
            return 0
        pid = self._next_pid
        self._next_pid += 1
        self._procs[pid] = name
        self._emit({
            "ph": "M", "name": "process_name", "pid": pid, "tid": TID_MAIN,
            "args": {"name": name},
        })
        return pid

    # -- spans (async: request lifecycles overlap across slots) --------------
    def begin_span(
        self, name: str, pid: int, ts: float,
        args: Optional[Dict[str, Any]] = None, cat: str = "lifecycle",
    ) -> int:
        """Open an async span; returns the span id to close it with.
        Disabled tracers return 0 (``end_span(0, ...)`` is a no-op)."""
        if not self.enabled:
            return 0
        sid = self._next_sid
        self._next_sid += 1
        ev = {
            "ph": "b", "cat": cat, "name": name, "pid": pid, "tid": TID_MAIN,
            "id": sid, "ts": _us(ts),
        }
        if args:
            ev["args"] = args
        self._emit(ev)
        self._open[sid] = ev
        return sid

    def end_span(
        self, sid: int, ts: float, args: Optional[Dict[str, Any]] = None,
    ) -> None:
        if not self.enabled or sid == 0:
            return
        begin = self._open.pop(sid, None)
        if begin is None:
            raise ValueError(f"end_span for unknown/closed span id {sid}")
        ev = {
            "ph": "e", "cat": begin["cat"], "name": begin["name"],
            "pid": begin["pid"], "tid": TID_MAIN, "id": sid, "ts": _us(ts),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    @property
    def open_spans(self) -> List[str]:
        """Names of begun-but-unclosed spans (must be [] after a clean
        run — the span-hygiene invariant)."""
        return [ev["name"] for ev in self._open.values()]

    # -- complete events (engine actions: one per clock advance) -------------
    def complete(
        self, name: str, pid: int, t0: float, t1: float,
        args: Optional[Dict[str, Any]] = None, cat: str = "action",
    ) -> None:
        if not self.enabled:
            return
        ev = {
            "ph": "X", "cat": cat, "name": name, "pid": pid, "tid": TID_MAIN,
            "ts": _us(t0), "dur": round(_us(t1) - _us(t0), 3),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- instants -------------------------------------------------------------
    def instant(
        self, name: str, pid: int, ts: float,
        args: Optional[Dict[str, Any]] = None, cat: str = "event",
    ) -> None:
        if not self.enabled:
            return
        ev = {
            "ph": "i", "cat": cat, "name": name, "pid": pid, "tid": TID_MAIN,
            "ts": _us(ts), "s": "p",
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- counter series -------------------------------------------------------
    def counter(
        self, name: str, pid: int, ts: float, values: Dict[str, float],
    ) -> None:
        """Chrome counter ("C") sample — renders as a stacked area chart
        under the process (e.g. arena block occupancy over time)."""
        if not self.enabled:
            return
        self._emit({
            "ph": "C", "name": name, "pid": pid, "tid": TID_MAIN,
            "ts": _us(ts), "args": dict(values),
        })

    # -- export ---------------------------------------------------------------
    def to_json(self, include_wall: bool = False) -> str:
        """Chrome ``trace_event`` JSON. Without ``include_wall`` the
        output is a pure function of the virtual execution — identical
        seeds produce byte-identical strings."""
        if include_wall:
            events = []
            for ev, w in zip(self.events, self._wall):
                ev = dict(ev)
                args = dict(ev.get("args", ()))
                args["wall_s"] = round(w, 6)
                ev["args"] = args
                events.append(ev)
        else:
            events = self.events
        return json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"},
            sort_keys=True, separators=(",", ":"),
        )

    def export(self, path: str, include_wall: bool = False) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(include_wall))


def validate_trace(events: List[Dict[str, Any]]) -> List[str]:
    """Structural invariants a healthy trace must satisfy. Returns a
    list of human-readable violations (empty = valid). Enforced by the
    obs-smoke CI job and tests/test_obs.py.

    1. every async "b" has exactly one matching "e" (same pid/cat/id)
       with ``end.ts >= begin.ts`` — no orphan or inverted spans;
    2. every "X" has ``dur >= 0``;
    3. per (pid, tid), "X" and "i" timestamps are non-decreasing in file
       order — each process is one virtual clock, and clocks only move
       forward.
    """
    errors: List[str] = []
    open_spans: Dict[tuple, Dict[str, Any]] = {}
    last_ts: Dict[tuple, float] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None or "pid" not in ev:
            errors.append(f"event {i}: missing ph/pid: {ev}")
            continue
        key = (ev["pid"], ev.get("tid", 0))
        if ph == "b":
            sk = (ev["pid"], ev.get("cat"), ev.get("id"))
            if sk in open_spans:
                errors.append(f"event {i}: duplicate open span {sk}")
            open_spans[sk] = ev
        elif ph == "e":
            sk = (ev["pid"], ev.get("cat"), ev.get("id"))
            begin = open_spans.pop(sk, None)
            if begin is None:
                errors.append(f"event {i}: orphan span end {sk}")
            elif ev["ts"] < begin["ts"]:
                errors.append(
                    f"event {i}: span {begin['name']!r} ends at {ev['ts']} "
                    f"before it begins at {begin['ts']}"
                )
        elif ph == "X":
            if ev.get("dur", 0) < 0:
                errors.append(f"event {i}: negative duration: {ev}")
            if ev["ts"] < last_ts.get(key, float("-inf")):
                errors.append(
                    f"event {i}: non-monotone ts on track {key}: "
                    f"{ev['ts']} < {last_ts[key]} ({ev.get('name')})"
                )
            last_ts[key] = ev["ts"]
        elif ph == "i":
            if ev["ts"] < last_ts.get(key, float("-inf")):
                errors.append(
                    f"event {i}: non-monotone ts on track {key}: "
                    f"{ev['ts']} < {last_ts[key]} ({ev.get('name')})"
                )
            last_ts[key] = ev["ts"]
    for sk, begin in open_spans.items():
        errors.append(f"unclosed span {begin.get('name')!r} {sk}")
    return errors
