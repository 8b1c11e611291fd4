#!/usr/bin/env python
"""Chaos search over the PyTorch port's serving plane: randomized
fault-schedule exploration with invariant oracles and delta-debugged
minimal repros (the twin of ``tools/chaos_search.py`` for
``repro_torch``).

The plane is deterministic in virtual time end to end: the same workload,
node-fault schedule and transport-fault plan give the same token streams,
the same wire history and the same trace. So this script is a model
checker in the Jepsen style: it samples seeded chaos schedules (replica
fail / slow / rejoin / drain x message drop / dup / reorder / delay /
corrupt / one-way partition), runs each against the full oracle set, and
when one fails shrinks the schedule one atom at a time (ddmin) to a
minimal JSON repro that replays bit for bit. Schedules, repro files and
violation details are those of ``tools/chaos_search.py``: a repro written
by either replays through the other.

Invariant oracles (each failure names the oracle and a detail):

* ``liveness``      - the run finishes (no stall past ``max_ticks``, no
                      stranded frontend, no transport give-up);
* ``zero_drop``     - no request exhausts its retry budget;
* ``byte_identity`` - every final stream equals the fault-free offline
                      decode exactly;
* ``no_leaks``      - after drain: every slot pool empty, every paged
                      arena fully free, no live engine requests, router
                      in-flight counts zero, transport drained;
* ``trace``         - ``repro_torch.obs.validate_trace`` passes and no
                      span is left open;
* ``conservation``  - every submitted gid reaches exactly one terminal
                      state and submitted == completed + dropped;
* ``exactly_once``  - no ``(gid, attempt)`` admitted twice on one replica;
* ``block_conservation`` - every replica's paged arena passes
                      ``BlockManager.audit()`` after drain.

With the reliability layer on, every schedule must pass every oracle.
``--no-reliable`` and ``--no-dedup`` show why the layer exists (a single
dropped message strands the plane, a single duplicated submit
double-admits); ``--leak-blocks`` arms the engine's seeded cancel-path
refcount bug (``ServeEngine._chaos_leak_blocks``), so that
``block_conservation`` can be seen to fail.

The workload is ``get_config(arch).reduced()`` with the port's seeded
weights by default; ``Workload(..., reduced=False)`` runs the
architecture at full width. Everything runs on ``--device`` (the card by
default; ``--device cpu`` takes every kernel's plain version).

Usage:
    python tools/chaos_search_torch.py --schedules 120 --fast
    python tools/chaos_search_torch.py --device cpu --schedules 6 --fast
    python tools/chaos_search_torch.py --replay chaos_repros/repro_s0_i3.json
    python tools/chaos_search_torch.py --schedules 40 --fast --no-reliable \\
        --expect-violations

Exit code 0 iff the campaign matches expectations (no violations, or
``--expect-violations`` and at least one found, shrunk and replayed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import resolve_device                        # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core.delay_models import SimplifiedDelayModel  # noqa: E402
from repro_torch.models import Model                          # noqa: E402
from repro_torch.obs import Observability, validate_trace     # noqa: E402
from repro_torch.runtime.faults import FaultEvent             # noqa: E402
from repro_torch.serve import (                               # noqa: E402
    FaultDirective,
    Frontend,
    Partition,
    Replica,
    TransportFaults,
    generate_offline,
)

REPRO_SCHEMA = 1
MAX_LEN = 64
N_REPLICAS = 3
N_SLOTS = 2
BLOCK_SIZE = 8


# ---------------------------------------------------------------------------
# Schedules: node events + transport plan, JSON round-trip, ddmin atoms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Schedule:
    """One complete chaos schedule: pure data, every entry individually
    removable (the shrinker's atoms are the three lists' entries)."""

    events: List[FaultEvent]
    directives: List[FaultDirective]
    partitions: List[Partition]
    # Dispatch regime, not a removable atom: cheap hedging fans every
    # request across the fleet, expensive hedging forces singleton
    # dispatch (every guarantee rides on the at-least-once layer).
    cost_per_replica: float = 0.001

    def as_dict(self) -> dict:
        return {
            "events": [e.as_dict() for e in self.events],
            "directives": [d.as_dict() for d in self.directives],
            "partitions": [p.as_dict() for p in self.partitions],
            "cost_per_replica": self.cost_per_replica,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(
            events=[FaultEvent.from_dict(x) for x in d.get("events", ())],
            directives=[FaultDirective.from_dict(x) for x in d.get("directives", ())],
            partitions=[Partition.from_dict(x) for x in d.get("partitions", ())],
            cost_per_replica=float(d.get("cost_per_replica", 0.001)),
        )

    def atoms(self) -> List[Tuple[str, int]]:
        return ([("event", i) for i in range(len(self.events))]
                + [("directive", i) for i in range(len(self.directives))]
                + [("partition", i) for i in range(len(self.partitions))])

    def without(self, removed: Sequence[Tuple[str, int]]) -> "Schedule":
        rm = set(removed)
        return Schedule(
            events=[e for i, e in enumerate(self.events) if ("event", i) not in rm],
            directives=[d for i, d in enumerate(self.directives)
                        if ("directive", i) not in rm],
            partitions=[p for i, p in enumerate(self.partitions)
                        if ("partition", i) not in rm],
            cost_per_replica=self.cost_per_replica,
        )

    def size(self) -> int:
        return len(self.events) + len(self.directives) + len(self.partitions)


def sample_schedule(rng: np.random.Generator) -> Schedule:
    """Draw one schedule (the reference's draws, in its order). Liveness
    stays satisfiable by construction: replica 0 is never failed or
    drained, and the node-event count stays well below the retry
    budget."""
    events: List[FaultEvent] = []
    for _ in range(int(rng.integers(0, 4))):
        kind = str(rng.choice(["fail", "slow", "rejoin", "drain"]))
        worker = (int(rng.integers(1, N_REPLICAS)) if kind in ("fail", "drain")
                  else int(rng.integers(0, N_REPLICAS)))
        events.append(FaultEvent(
            step=int(rng.integers(0, 120)), kind=kind, worker=worker,
            factor=float(np.round(rng.uniform(1.5, 4.0), 3)),
        ))
    links = ([("fe", f"r{i}") for i in range(N_REPLICAS)]
             + [(f"r{i}", "fe") for i in range(N_REPLICAS)])
    directives: List[FaultDirective] = []
    for _ in range(int(rng.integers(0, 5))):
        src, dst = links[int(rng.integers(0, len(links)))]
        op = str(rng.choice(["drop", "dup", "delay", "reorder", "corrupt"]))
        # Low-biased ordinals: these links carry a handful of messages;
        # a tail keeps late retransmissions reachable.
        nth = int(rng.integers(0, 6)) if rng.random() < 0.7 else int(rng.integers(0, 60))
        directives.append(FaultDirective(src=src, dst=dst, op=op, nth=nth,
                                         ticks=int(rng.integers(1, 7))))
    partitions: List[Partition] = []
    if rng.random() < 0.4:
        src, dst = links[int(rng.integers(0, len(links)))]
        t0 = int(rng.integers(0, 100))
        partitions.append(Partition(src=src, dst=dst, t0=t0,
                                    t1=t0 + int(rng.integers(4, 21))))
    cost = float(rng.choice([0.001, 10.0]))
    return Schedule(events, directives, partitions, cost_per_replica=cost)


# ---------------------------------------------------------------------------
# Workload + oracles
# ---------------------------------------------------------------------------

class Workload:
    """A fixed request set over a fixed fleet geometry, with fault-free
    offline references computed once. The model and parameters are shared
    by every run of a campaign.

    By default the parameters are the port's own, drawn from seed 0 on
    ``device``; ``model`` and ``params`` take a given pair instead (the
    parity tests pass the reference's, bridged), and the fleet runs where
    they live. ``reduced=False`` serves the architecture at full width."""

    def __init__(self, arch: str = "smollm-135m", n_requests: int = 6, seed: int = 1,
                 prefix_sharing: bool = False, *, model=None, params=None,
                 reduced: bool = True, device="cuda"):
        cfg = get_config(arch)
        cfg = cfg.reduced() if reduced else cfg
        self.arch = arch
        self.n_requests = n_requests
        self.seed = seed
        self.prefix_sharing = bool(prefix_sharing)
        self.reduced = bool(reduced)
        self.model = model if model is not None else Model(cfg)
        self.params = (params if params is not None
                       else self.model.init(0, device=resolve_device(device)))
        self.device = self.params["embed"].device
        rng = np.random.default_rng(seed)
        self.requests = []
        for i in range(n_requests):
            p = int(rng.integers(4, 16))
            m = int(rng.integers(6, 12))
            prompt = rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
            self.requests.append((prompt, m, i * 0.002))
        self.refs = [generate_offline(self.model, self.params, p, m, MAX_LEN)
                     for p, m, _ in self.requests]

    def as_dict(self) -> dict:
        out = {"arch": self.arch, "n_requests": self.n_requests, "seed": self.seed,
               "n_replicas": N_REPLICAS, "n_slots": N_SLOTS, "block_size": BLOCK_SIZE,
               "max_len": MAX_LEN, "prefix_sharing": self.prefix_sharing}
        if not self.reduced:
            out["reduced"] = False
        return out

    def fleet(self, obs) -> List[Replica]:
        return [Replica(i, self.model, self.params, n_slots=N_SLOTS, max_len=MAX_LEN,
                        block_size=BLOCK_SIZE, prefix_sharing=self.prefix_sharing, obs=obs)
                for i in range(N_REPLICAS)]


@dataclasses.dataclass
class RunReport:
    violations: List[dict]
    summary: dict
    ticks: int
    #: gid -> final token stream of every completed request (not part of
    #: the signature or of a repro file).
    streams: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def signature(self) -> Tuple[str, ...]:
        """Order-insensitive violation fingerprint: two runs of the same
        schedule must give the same signature."""
        return tuple(sorted(v["oracle"] for v in self.violations))


def run_schedule(
    wl: Workload,
    sched: Schedule,
    *,
    reliable: bool = True,
    dedup: bool = True,
    retry_budget: int = 8,
    max_ticks: int = 20_000,
    leak_blocks: bool = False,
    trace_out: Optional[str] = None,
) -> RunReport:
    """One deterministic run of ``sched`` against the oracle set.
    ``trace_out`` dumps the run's virtual-clock trace (Perfetto JSON);
    ``leak_blocks`` arms the engines' seeded cancel-path refcount bug."""
    obs = Observability()
    fleet = wl.fleet(obs)
    for rep in fleet:
        rep.engine._chaos_leak_blocks = leak_blocks
    fe = Frontend(
        fleet, SimplifiedDelayModel(lambda_y=2.0),
        cost_per_replica=sched.cost_per_replica,
        retry_budget=retry_budget,
        events=list(sched.events),
        transport_faults=TransportFaults(sched.directives, sched.partitions),
        reliable=reliable, dedup=dedup,
        max_ticks=max_ticks,
        obs=obs,
    )
    gids = [fe.submit(p, m, arrival=a) for p, m, a in wl.requests]
    violations: List[dict] = []
    try:
        results = fe.run()
    except RuntimeError as e:
        # Stall, stranded frontend or transport give-up. Leaks and open
        # spans in a wedged plane are consequences: report the root cause
        # alone, so that shrinking targets it.
        if trace_out:
            obs.tracer.export(trace_out)
        return RunReport([{"oracle": "liveness", "detail": str(e)}], {}, fe.ticks)

    if fe.dropped:
        violations.append({"oracle": "zero_drop",
                           "detail": f"dropped gids {sorted(fe.dropped)}"})
    for g in gids:
        fr = results.get(g)
        if fr is not None and fr.done and list(fr.tokens) != list(wl.refs[g]):
            violations.append({
                "oracle": "byte_identity",
                "detail": f"gid {g}: got {list(fr.tokens)[:8]}..., "
                          f"want {list(wl.refs[g])[:8]}...",
            })
    for rep in fleet:
        live = rep.engine.live_rids()
        if live:
            violations.append({"oracle": "no_leaks",
                               "detail": f"replica {rep.id} has live requests {live} "
                                         "after drain"})
        if rep.engine.pool.n_active != 0:
            violations.append({"oracle": "no_leaks",
                               "detail": f"replica {rep.id} pool has "
                                         f"{rep.engine.pool.n_active} active slots"})
        mgr = rep.engine.pool.manager
        if mgr is not None and mgr.n_used_blocks != 0:
            violations.append({"oracle": "no_leaks",
                               "detail": f"replica {rep.id} arena leaks "
                                         f"{mgr.n_used_blocks} blocks"})
        errs = [] if mgr is None else mgr.audit()
        if errs:
            violations.append({"oracle": "block_conservation",
                               "detail": f"replica {rep.id}: " + "; ".join(errs[:3])})
    if not (fe.router.inflight == 0).all():
        violations.append({"oracle": "no_leaks",
                           "detail": f"router inflight {fe.router.inflight.tolist()}"})
    if fe.transport.busy():
        violations.append({"oracle": "no_leaks", "detail": "transport not drained at exit"})
    errs = validate_trace(obs.tracer.events)
    if errs:
        violations.append({"oracle": "trace", "detail": "; ".join(errs[:3])})
    if obs.tracer.open_spans:
        violations.append({"oracle": "trace",
                           "detail": f"open spans {obs.tracer.open_spans[:5]}"})
    terminal = {g: (results[g].done, results[g].dropped) for g in gids if g in results}
    if set(terminal) != set(gids):
        violations.append({"oracle": "conservation",
                           "detail": f"missing results for "
                                     f"{sorted(set(gids) - set(terminal))}"})
    for g, (done, dropped) in terminal.items():
        if done == dropped:     # both or neither
            violations.append({"oracle": "conservation",
                               "detail": f"gid {g} terminal state done={done} "
                                         f"dropped={dropped}"})
    summary = fe.summary()
    if summary["completed"] + summary["dropped"] != len(gids):
        violations.append({"oracle": "conservation",
                           "detail": f"completed {summary['completed']} + dropped "
                                     f"{summary['dropped']} != submitted {len(gids)}"})
    for port in fe.ports:
        seen: Dict[Tuple[int, int], int] = {}
        for key in port.admission_log:
            seen[key] = seen.get(key, 0) + 1
        dups = {k: c for k, c in seen.items() if c > 1}
        if dups:
            violations.append({"oracle": "exactly_once",
                               "detail": f"replica {port.rep.id} admitted copies "
                                         f"{sorted(dups)} more than once"})
    if trace_out:
        obs.tracer.export(trace_out)
    streams = {g: list(results[g].tokens) for g in gids if g in results and results[g].done}
    return RunReport(violations, summary, fe.ticks, streams)


# ---------------------------------------------------------------------------
# Shrinking: greedy one-atom-at-a-time ddmin to a fixpoint
# ---------------------------------------------------------------------------

def shrink(wl: Workload, sched: Schedule, signature: Tuple[str, ...], **knobs) -> Schedule:
    """Remove schedule atoms one at a time, keeping a removal whenever the
    same violation signature still reproduces, until no single removal
    keeps it (1-minimal in the ddmin sense)."""
    cur = sched
    changed = True
    while changed:
        changed = False
        for atom in cur.atoms():
            cand = cur.without([atom])
            if run_schedule(wl, cand, **knobs).signature() == signature:
                cur = cand
                changed = True
                break
    return cur


# ---------------------------------------------------------------------------
# Campaigns and repro files
# ---------------------------------------------------------------------------

def write_repro(path: str, *, seed: int, index: int, wl: Workload, sched: Schedule,
                report: RunReport, knobs: dict) -> dict:
    payload = {
        "schema": REPRO_SCHEMA,
        "seed": seed,
        "index": index,
        "knobs": knobs,
        "workload": wl.as_dict(),
        "schedule": sched.as_dict(),
        "violations": report.violations,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return payload


def replay_repro(path: str, *, device="cuda") -> RunReport:
    with open(path) as f:
        payload = json.load(f)
    w = payload["workload"]
    wl = Workload(arch=w["arch"], n_requests=w["n_requests"], seed=w["seed"],
                  prefix_sharing=w.get("prefix_sharing", False),
                  reduced=w.get("reduced", True), device=device)
    sched = Schedule.from_dict(payload["schedule"])
    return run_schedule(wl, sched, **payload["knobs"])


def run_campaign(
    *, schedules: int, seed: int, fast: bool, reliable: bool, dedup: bool,
    repro_dir: str, out: Optional[str], expect_violations: bool,
    leak_blocks: bool = False, prefix_sharing: bool = False, device="cuda",
) -> int:
    wl = Workload(n_requests=4 if fast else 6, prefix_sharing=prefix_sharing, device=device)
    knobs = {
        "reliable": reliable, "dedup": dedup,
        "retry_budget": 8, "max_ticks": 6_000 if fast else 20_000,
        "leak_blocks": leak_blocks,
    }
    t0 = time.perf_counter()
    n_bad, repros, op_counts = 0, [], {}
    for i in range(schedules):
        sched = sample_schedule(np.random.default_rng([seed, i]))
        for ev in sched.events:
            op_counts[ev.kind] = op_counts.get(ev.kind, 0) + 1
        for d in sched.directives:
            op_counts[d.op] = op_counts.get(d.op, 0) + 1
        op_counts["partition"] = op_counts.get("partition", 0) + len(sched.partitions)
        report = run_schedule(wl, sched, **knobs)
        if report.ok:
            continue
        n_bad += 1
        sig = report.signature()
        small = shrink(wl, sched, sig, **knobs)
        os.makedirs(repro_dir, exist_ok=True)
        path = os.path.join(repro_dir, f"repro_s{seed}_i{i}.json")
        trace = os.path.join(repro_dir, f"trace_s{seed}_i{i}.json")
        confirm = run_schedule(wl, small, trace_out=trace, **knobs)
        replay = run_schedule(wl, small, **knobs)
        deterministic = confirm.signature() == replay.signature() == sig
        write_repro(path, seed=seed, index=i, wl=wl, sched=small, report=confirm,
                    knobs=knobs)
        repros.append({"index": i, "file": path, "signature": list(sig),
                       "atoms": small.size(), "deterministic": deterministic})
        print(f"[chaos-search] schedule {i}: VIOLATION {sig} shrunk {sched.size()} -> "
              f"{small.size()} atoms (deterministic={deterministic}) -> {path}")
    wall = time.perf_counter() - t0
    print(f"[chaos-search] {schedules} schedules, {n_bad} violations, {wall:.1f}s wall "
          f"on {wl.device}")
    if out:
        dev = wl.device
        with open(out, "w") as f:
            json.dump({
                "benchmark": "chaos_search",
                "mode": "fast" if fast else "full",
                "schedules": schedules,
                "seed": seed,
                "reliable": reliable,
                "dedup": dedup,
                "violations": n_bad,
                "wall_seconds": round(wall, 3),
                "fault_mix": op_counts,
                "repros": repros,
                "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else dev.type),
            }, f, indent=2)
        print(f"[chaos-search] summary -> {out}")
    if expect_violations:
        ok = n_bad > 0 and all(r["deterministic"] for r in repros)
        if not ok:
            print("[chaos-search] expected violations but the campaign passed (or a "
                  "repro replayed non-deterministically)")
        return 0 if ok else 1
    return 0 if n_bad == 0 else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedules", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="smaller workload + tighter stall cap (CI)")
    ap.add_argument("--no-reliable", action="store_true",
                    help="disable ack/retransmit (violation demo)")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable receiver dedup (violation demo)")
    ap.add_argument("--leak-blocks", action="store_true",
                    help="seed a cancel-path refcount bug (conservation oracle "
                         "violation demo)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="run the fleet with copy-on-write prefix sharing")
    ap.add_argument("--expect-violations", action="store_true",
                    help="exit 0 iff the campaign FINDS (and deterministically "
                         "shrinks) a violation")
    ap.add_argument("--repro-dir", default="chaos_repros")
    ap.add_argument("--out", default=None, help="write the campaign summary JSON here")
    ap.add_argument("--replay", default=None,
                    help="replay one minimal-repro JSON and report")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet (default: the card; 'cpu' runs "
                         "every kernel's plain version)")
    args = ap.parse_args(argv)

    if args.replay:
        report = replay_repro(args.replay, device=args.device)
        print(json.dumps({"violations": report.violations, "ticks": report.ticks},
                         indent=2))
        return 0 if report.violations else 1

    return run_campaign(
        schedules=args.schedules, seed=args.seed, fast=args.fast,
        reliable=not args.no_reliable, dedup=not args.no_dedup,
        repro_dir=args.repro_dir, out=args.out,
        expect_violations=args.expect_violations,
        leak_blocks=args.leak_blocks, prefix_sharing=args.prefix_sharing,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
