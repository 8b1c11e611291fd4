"""Serving demo on the PyTorch port: continuous batching over the
slot-pooled caches, on the card.

The twin of ``examples/serve_lm.py``: the same flags, defaults, traffic
and printed lines, through ``repro_torch.serve.ServeEngine``, which
admits each request with one batched cache-writing prefill and decodes
all live slots in one fixed-shape step a tick. Works for every
registered causal arch family (attention KV caches, MLA latent caches,
SSM / xLSTM recurrent states). The weights are the port's own, drawn from
the reference's seeds (0 for the target, 1 for the draft).

    python examples/serve_lm_torch.py --arch smollm              # the card
    python examples/serve_lm_torch.py --arch xlstm --tokens 32
    python examples/serve_lm_torch.py --arch smollm --device cpu # the CPU

``--device`` defaults to ``cuda`` and raises where no card is present;
the CPU runs only when asked for.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Scheduler, ServeEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split long prompts into chunks this size "
                         "(bounds how long one admission stalls decoding)")
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache into a block arena with "
                         "admit-by-budget (DESIGN.md §11); greedy tokens "
                         "are byte-identical to the contiguous pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged mode: cache rows per block")
    ap.add_argument("--speculative", action="store_true",
                    help="attach a draft model for draft-then-verify "
                         "decoding (DESIGN.md §12); greedy tokens are "
                         "byte-identical, throughput is the only change")
    ap.add_argument("--draft", type=str, default=None, metavar="CFG",
                    help="draft arch (default: the target arch with "
                         "freshly initialized params — a deliberately "
                         "weak draft; watch the controller back off)")
    ap.add_argument("--gamma-max", type=int, default=4,
                    help="speculation: max draft tokens per round")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def workload(args, vocab_size: int):
    """The reference's traffic: (prompt, new tokens, arrival) a request,
    drawn from ``default_rng(0)``."""
    host_rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(host_rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1))
        prompt = host_rng.integers(0, vocab_size, size=plen).astype(np.int32)
        ntok = int(host_rng.integers(max(args.tokens // 2, 1), args.tokens + 1))
        reqs.append((prompt, ntok, i * 1e-3))
    return reqs


def build(args, *, params=None, draft_params=None):
    """(engine, the target's config). ``params`` / ``draft_params``:
    weights to serve in place of the port's seeded draw (a test hands
    over the reference's)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)

    draft_model = draft = None
    if args.speculative:
        draft_cfg = get_config(args.draft).reduced() if args.draft else cfg
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise SystemExit("--draft must share the target's vocabulary")
        draft_model = build_model(draft_cfg)
        draft = draft_params if draft_params is not None else draft_model.init(1, device=dev)

    max_len = args.prompt_len + args.tokens + 1
    engine = ServeEngine(
        model, params, n_slots=args.slots, max_len=max_len,
        scheduler=Scheduler(args.slots, prefill_chunk=args.prefill_chunk),
        block_size=args.block_size if args.paged else None,
        draft_model=draft_model, draft_params=draft, gamma_max=args.gamma_max,
    )
    return engine, cfg


def main(argv=None, *, params=None, draft_params=None) -> dict:
    """Serve the traffic and print the reference's lines; return them as
    records, plus every request's prompt and budget (``requests``) and
    stream (``streams``), by request id."""
    args = parse_args(argv)
    engine, cfg = build(args, params=params, draft_params=draft_params)
    dev = engine.params["embed"].device
    max_len = args.prompt_len + args.tokens + 1

    reqs = workload(args, cfg.vocab_size)
    rids = [engine.submit(prompt, ntok, arrival=arrival) for prompt, ntok, arrival in reqs]

    t0 = time.perf_counter()
    results = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    s = engine.stats
    on = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    mode = f"paged(block={args.block_size})" if args.paged else "contiguous"
    rec = {"serve": dict(arch=cfg.name, slots=args.slots, requests=args.requests,
                         max_len=max_len, kv=mode, device=on)}
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"max_len={max_len} kv={mode}")
    if engine.pool.paged:
        mgr = engine.pool.manager
        rec["kv_arena"] = dict(high_water=mgr.used_high_water, blocks=mgr.num_blocks,
                               bytes_high_water=engine.pool.kv_bytes_high_water(),
                               bytes_contiguous=engine.pool.kv_bytes_contiguous())
        print(f"kv arena: {mgr.used_high_water}/{mgr.num_blocks} blocks "
              f"high-water ({engine.pool.kv_bytes_high_water()} B vs "
              f"{engine.pool.kv_bytes_contiguous()} B contiguous)")
    rec["prefill"] = dict(calls=s.prefill_calls, tokens=s.prefill_tokens,
                          decode_ticks=s.decode_ticks)
    print(f"prefill: {s.prefill_calls} calls / {s.prefill_tokens} tokens; "
          f"decode: {s.decode_ticks} ticks")
    if engine.speculative:
        hist = np.asarray(engine.spec.hist).tolist()
        rec["speculation"] = dict(rounds=s.spec_rounds, draft_ticks=s.draft_ticks,
                                  accepted=s.spec_accepted, p_ewma=engine.spec.p,
                                  accept_hist=hist)
        print(f"speculation: {s.spec_rounds} rounds, {s.draft_ticks} draft "
              f"ticks, {s.spec_accepted} draft tokens accepted "
              f"(p_ewma={engine.spec.p:.3f}, accept hist {hist})")
    rec["generated"] = dict(tokens=s.generated_tokens, wall_s=wall,
                            tokens_per_s=s.generated_tokens / max(wall, 1e-9),
                            tokens_per_vsec=s.tokens_per_vsec)
    print(f"generated {s.generated_tokens} tokens in {wall:.2f}s wall "
          f"({s.generated_tokens / max(wall, 1e-9):.1f} tok/s on {on}) — "
          f"{s.tokens_per_vsec:.1f} tok/s virtual")
    rec["shown"] = []
    for rid in sorted(results)[:2]:
        r = results[rid]
        rec["shown"].append(dict(rid=rid, prompt=r.prompt_len, new=len(r.tokens),
                                 latency=r.latency, head=list(r.tokens[:12])))
        print(f"  req{rid}: prompt={r.prompt_len} new={len(r.tokens)} "
              f"latency={r.latency:.4f}v  {r.tokens[:12]} ...")
    rec["requests"] = {rid: (p, n) for rid, (p, n, _) in zip(rids, reqs)}
    rec["streams"] = {rid: list(results[rid].tokens) for rid in rids}
    return rec


if __name__ == "__main__":
    main()
