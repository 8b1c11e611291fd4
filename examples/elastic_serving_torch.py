"""Chaos demo on the PyTorch port: a 3-replica serving plane losing a
node mid-saturation, on the card.

The twin of ``examples/elastic_serving.py``: the same timeline, traffic,
assertions and records, through ``repro_torch``; the weights are the
port's own, drawn from the reference's seed (0).

Timeline (one hedged-dispatch run, 3 engine replicas x 2 slots, paged
KV, deterministic virtual time):

  step 12 — replica 1 FAILS with requests in flight. Hedge copies on
            the surviving replicas cover most of them; any request
            whose only copy died requeues from its longest emitted
            prefix (greedy decode is deterministic, so every partial is
            a prefix of the same stream). The router marks the replica
            out and re-prices dispatch from the 2-node fleet.
  step 40 — replica 2 turns SLOW (6x). Nothing is told to the router —
            it just starts seeing slower completions and censored
            hedge losers, and the EWMA telemetry re-prices it toward
            the back of the dispatch order.
  step 90 — replica 1 REJOINS healthy at the fleet's time frontier.
            Its telemetry history is reset: it prices at the neutral
            prior and its first real completion seeds its estimate
            directly (no crawl-up from zero).

The demo asserts the plane's two hard guarantees:

  * ZERO dropped requests — every submission completes despite the
    failure;
  * BYTE-IDENTICAL tokens — each request's stream equals a per-request
    offline greedy decode, fault or no fault.

Reporting goes through ``repro_torch.obs``: every line printed is the
echo of a structured ``StructuredLog`` record (the assertions below read
the records, not the text), and the whole run is traced — pass ``--trace
PATH`` to export the Chrome/Perfetto timeline, ``--log PATH`` for the
record stream as JSON.

    python examples/elastic_serving_torch.py [--trace PATH] [--log PATH]
    python examples/elastic_serving_torch.py --device cpu

``--device`` defaults to ``cuda`` and raises where no card is present.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import SimplifiedDelayModel
from repro_torch.models import build_model
from repro_torch.obs import Observability, validate_trace
from repro_torch.runtime.faults import FaultEvent
from repro_torch.serve import Frontend, Replica, generate_offline

MAX_LEN = 64
N_REPLICAS = 3
N_SLOTS = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="export the run's Chrome trace JSON")
    ap.add_argument("--log", type=str, default=None, metavar="PATH",
                    help="export the structured record stream as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, *, params=None) -> dict:
    """Run the chaos timeline, assert the reference's guarantees, and
    return the printed records (``{"records": [...]}``) and the streams.
    ``params``: weights in place of the port's seeded draw (a test hands
    over the reference's)."""
    args = parse_args(argv)
    obs = Observability(log_echo=True)
    log = obs.log

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=args.device)

    rng = np.random.default_rng(5)
    reqs = []
    for i in range(10):
        p = int(rng.integers(4, 16))
        m = int(rng.integers(6, 14))
        prompt = rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
        reqs.append((prompt, m, i * 0.002))

    log.emit("reference_decode", requests=len(reqs),
             note="offline greedy oracle for byte-identity")
    refs = [generate_offline(model, params, p, m, MAX_LEN) for p, m, _ in reqs]

    events = [
        FaultEvent(step=12, kind="fail", worker=1),
        FaultEvent(step=40, kind="slow", worker=2, factor=6.0),
        FaultEvent(step=90, kind="rejoin", worker=1),
    ]
    replicas = [
        Replica(i, model, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                block_size=8, obs=obs)
        for i in range(N_REPLICAS)
    ]
    fe = Frontend(
        replicas, SimplifiedDelayModel(lambda_y=2.0),
        cost_per_replica=0.001, events=events,
        deadline=0.5, retry_budget=3, obs=obs,
    )
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    log.emit("dispatch_begin", requests=len(gids), replicas=N_REPLICAS,
             chaos="fail@12,slow@40,rejoin@90")
    out = fe.run()

    s = fe.summary()
    log.emit("plane_summary", t=fe._frontier(),
             completed=int(s["completed"]), dropped=int(s["dropped"]),
             retries=int(s["retries"]),
             cancelled_copies=int(s["cancelled_copies"]),
             p99_latency=float(s["p99_latency"]))
    slow = fe.router._slowdowns()
    log.emit("router_slowdowns",
             estimates=[round(float(x), 2) for x in slow])

    # Assertions read the records, not the printed text.
    summary = log.last("plane_summary").fields
    assert summary["dropped"] == 0, "chaos must not drop requests"
    streams = [out[g].tokens for g in gids]
    assert streams == refs, "streams must be byte-identical to offline"
    # The slowed replica's telemetry reflects what the router observed.
    assert slow[2] >= slow[0], "slow replica should not price first"

    errors = validate_trace(obs.tracer.events)
    assert not errors, f"trace invariant violations: {errors[:5]}"
    assert not obs.tracer.open_spans, "spans leaked across chaos"
    log.emit("verdict", ok=True, trace_events=len(obs.tracer.events),
             note="zero drops, byte-identical streams, valid trace "
                  "under fail/slow/rejoin")

    if args.trace:
        obs.tracer.export(args.trace)
        log.emit("artifact", artifact="trace", path=args.trace)
    if args.log:
        log.export(args.log)
    return {"records": log.to_jsonable(), "streams": streams, "summary": s}


if __name__ == "__main__":
    main()
