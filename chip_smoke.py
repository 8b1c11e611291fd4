#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 or another sm_90a part) and ``nvcc``. It
runs, in order, and exits non-zero at the first phase that fails:

1. prints the card (name, power limit), the torch and CUDA versions, and
   turns TF32 off for float32 matrix products and convolutions;
2. builds the port's CUDA kernels from ``src/repro_torch/csrc``;
3. holds every kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in f32 and bf16;
4. serves llama3.2-1b at full width in bf16 (random weights from a seed)
   through ``ServeEngine`` — 8 requests, 4 slots, chunked prefill — once
   over the contiguous pool and once over the paged pool, checks every
   position of every stream against ``generate_offline`` fed the same
   stream, and checks from the kernels' launch counters that the whole
   path ran through them;
5. times each kernel (CUDA events, cold L2, median of 60 launches)
   beside its plain version, one library call and its bound, and
   reports decode tokens/s of each pool;
6. profiles decode ticks and prefill chunks with ``torch.profiler`` —
   host wall time, device time, the device's idle share, launches, and
   device time by kernel class;

and prints the ``kernels`` JSON line (the profile under ``profile``), the
card line and, last, the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 RMSNorm outputs reach |y| of 4-5, where one bf16 rounding step is
#: 2^-5 = 3.1e-2: a one-rounding flip between the kernel's and PyTorch's
#: sum order exceeds 2e-2 alone, so bf16 RMSNorm is held to
#: 2e-2 + |ref| / 128 (one bf16 ulp of the reference value on top).
RMS_RTOL_BF16 = 1.0 / 128
#: Greedy streams may part from offline decode only where the offline
#: logits' top-2 gap is below this: 4 bf16 ulps at the top logit's
#: magnitude (4-8 for these random weights, where one ulp is 2^-5).
TIE_TOL = 0.125

ARCH = "llama3.2-1b"
N_SLOTS, MAX_LEN, PREFILL_CHUNK, BLOCK_SIZE, SEED = 4, 1024, 256, 16, 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scatter_to_arena(k, v, lengths, block_size, gen):
    """Scatter contiguous (B, S, ...) caches into a shuffled block arena
    holding random values everywhere a live block is not (the NULL block
    0 and every unreferenced row)."""
    B, S = k.shape[:2]
    T = S // block_size
    dev = k.device
    ids = torch.randperm(B * T, generator=gen, device="cpu") + 1
    k_arena = torch.randn((B * T + 1, block_size, *k.shape[2:]), generator=gen).to(dev, k.dtype)
    v_arena = torch.randn((B * T + 1, block_size, *v.shape[2:]), generator=gen).to(dev, v.dtype)
    tables = torch.zeros((B, T), dtype=torch.int32)
    nxt = 0
    for b in range(B):
        for t in range(-(-int(lengths[b]) // block_size)):
            bid = int(ids[nxt])
            nxt += 1
            tables[b, t] = bid
            k_arena[bid] = k[b, t * block_size:(t + 1) * block_size]
            v_arena[bid] = v[b, t * block_size:(t + 1) * block_size]
    return k_arena, v_arena, tables.to(dev)


def check_kernels() -> dict:
    """Every kernel vs its plain version; returns {kernel: max |err| in bf16}."""
    from repro_torch.kernels import (
        decode_attention, decode_attention_plain, paged_decode_attention,
        paged_decode_attention_plain, rms_norm, rms_norm_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    worst = {"rmsnorm": 0.0, "decode_attention": 0.0, "paged_decode_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for rows in (4, 512):
            x = torch.randn((rows, 2048), generator=gen).to(dev, dtype)
            scale = (1 + 0.1 * torch.randn(2048, generator=gen)).to(dev, dtype)
            out, ref = rms_norm(x, scale), rms_norm_plain(x, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            rtol = RMS_RTOL_BF16 if dtype == torch.bfloat16 else 0.0
            ok = bool((err <= TOL[dtype] + rtol * ref.float().abs()).all())
            print(f"  K2 rmsnorm {name} rows={rows} D=2048: max|err|={err.max().item():.3e}"
                  f" ({'ok' if ok else 'FAIL'})")
            check(ok, f"rmsnorm {name} rows={rows} disagrees with its plain version")
            if dtype == torch.bfloat16:
                worst["rmsnorm"] = max(worst["rmsnorm"], err.max().item())
        for H, Hkv in ((32, 8), (9, 3)):
            for lens in ([1, 15, 16, 17], [1000, 1024, 500, 33], [0, 1, 15, 1000]):
                B, S, D = len(lens), 1024, 64
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                q = torch.randn((B, H, D), generator=gen).to(dev, dtype)
                k = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dtype)
                v = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dtype)
                k_ar, v_ar, tables = scatter_to_arena(k, v, lens, BLOCK_SIZE, gen)
                paged = paged_decode_attention(q, k_ar, v_ar, tables, lengths)
                paged_ref = paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)
                torch.cuda.synchronize()
                perr = (paged.float() - paged_ref.float()).abs().max().item()
                print(f"  K4 paged_decode {name} H={H} Hkv={Hkv} lengths={lens}: "
                      f"max|err|={perr:.3e}")
                check(perr <= TOL[dtype], f"paged decode {name} {lens} disagrees")
                live = lengths > 0
                check(bool((paged[~live] == 0).all()), "length-0 row is not exact zeros")
                if 0 not in lens:   # K3's contract is lengths >= 1
                    out = decode_attention(q, k, v, lengths)
                    ref = decode_attention_plain(q, k, v, lengths)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    print(f"  K3 decode {name} H={H} Hkv={Hkv} lengths={lens}: "
                          f"max|err|={err:.3e}; K3 == K4 bitwise: "
                          f"{bool(torch.equal(out, paged))}")
                    check(err <= TOL[dtype], f"decode {name} {lens} disagrees")
                    check(torch.equal(out, paged), "K3 and K4 differ on identical rows")
                    if dtype == torch.bfloat16:
                        worst["decode_attention"] = max(worst["decode_attention"], err)
                if dtype == torch.bfloat16:
                    worst["paged_decode_attention"] = max(worst["paged_decode_attention"], perr)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve llama3.2-1b through both pools
# ---------------------------------------------------------------------------

def workload(vocab: int):
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(8):
        p = int(rng.integers(64, 601))
        m = int(rng.integers(16, 65))
        reqs.append((rng.integers(0, vocab, size=p).astype(np.int32), m, i * 0.02))
    return reqs


def serve(model, params) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Scheduler, ServeEngine, generate_offline

    cfg = model.cfg
    reqs = workload(cfg.vocab_size)
    L = cfg.n_layers
    norms = 2 * L + 1
    runs = {}
    for pool, block_size in (("contiguous", None), ("paged", BLOCK_SIZE)):
        eng = ServeEngine(
            model, params, n_slots=N_SLOTS, max_len=MAX_LEN, block_size=block_size,
            scheduler=Scheduler(N_SLOTS, prefill_chunk=PREFILL_CHUNK),
        )
        rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
        torch.cuda.synchronize()
        reset_launch_counts()
        results = eng.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        st = eng.stats
        print(f"  {pool}: {st.prefill_calls} prefill calls, {st.decode_ticks} decode "
              f"ticks, {st.generated_tokens} tokens in {st.wall_seconds:.2f} s; "
              f"decode {st.decode_tokens_per_wsec:.1f} tokens/s; KV high-water "
              f"{eng.pool.kv_bytes_high_water() / 2**20:.1f} MiB of "
              f"{eng.pool.kv_bytes_contiguous() / 2**20:.1f} MiB contiguous; "
              f"launches {counts}")
        check(counts["rmsnorm"] == norms * (st.decode_ticks + st.prefill_calls),
              f"{pool}: rmsnorm launched {counts['rmsnorm']} times, expected "
              f"{norms} x {st.decode_ticks + st.prefill_calls}")
        attn = "paged_decode_attention" if block_size else "decode_attention"
        other = "decode_attention" if block_size else "paged_decode_attention"
        check(counts[attn] == L * st.decode_ticks and st.decode_ticks > 0,
              f"{pool}: {attn} launched {counts[attn]} times, expected {L} x "
              f"{st.decode_ticks}")
        check(counts[other] == 0, f"{pool}: {other} launched on the wrong pool")
        for rid, (p, m, _) in zip(rids, reqs):
            toks = results[rid].tokens
            check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{pool}: request {rid} produced a malformed stream")
        runs[pool] = {"tokens": [results[r].tokens for r in rids], "stats": st,
                      "launches": counts}

    # Offline decode is fed each served stream (teacher forcing), so every
    # position is checked: the engine's token equals offline's choice on
    # the same prefix, or offline's top-2 gap there is a near-tie. Where
    # paged and contiguous part on a shared prefix, offline's one choice
    # differs from one of them, so the check also covers that split.
    compared = near_ties = identical = 0
    for i, (p, m, _) in enumerate(reqs):
        scored = {}
        for pool in runs:
            got = runs[pool]["tokens"][i]
            key = tuple(got)
            if key not in scored:
                scored[key] = generate_offline(model, params, p, m, MAX_LEN, forced=got)
            choice, margins = scored[key]
            ties = [j for j in range(m) if got[j] != choice[j]]
            for j in ties:
                check(margins[j] < TIE_TOL,
                      f"{pool}: request {i} token {j} is {got[j]}, offline decode on the "
                      f"same prefix picks {choice[j]} at a top-2 gap {margins[j]:.4f} "
                      f">= {TIE_TOL}")
                print(f"  {pool}: request {i} token {j}/{m} differs from offline "
                      f"(offline top-2 gap {margins[j]:.4f} < {TIE_TOL}: near-tie)")
            compared += m
            near_ties += len(ties)
            identical += not ties
    same = sum(a == b for a, b in zip(runs["contiguous"]["tokens"], runs["paged"]["tokens"]))
    print(f"  streams vs teacher-forced offline: {compared} positions compared, "
          f"{identical} of {2 * len(reqs)} streams identical, {near_ties} near-ties "
          f"accepted (top-2 gap < {TIE_TOL}); paged == contiguous for {same} of "
          f"{len(reqs)}")
    return runs


# ---------------------------------------------------------------------------
# Phase 5: timing
# ---------------------------------------------------------------------------

def time_ms(fn, n: int = 60, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``n`` launches, each bracketed by
    CUDA events after an L2 flush (a 128 MiB write); a GPU-side sleep
    before the batch lets the host enqueue ahead, so host launch overhead
    is not timed."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(cfg, reqs) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import (
        decode_attention, decode_attention_plain, paged_decode_attention,
        paged_decode_attention_plain, rms_norm, rms_norm_plain,
    )
    from repro_torch.kernels.decode_attention import paged_kv_view

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    D = cfg.d_model
    for rows, label in ((N_SLOTS, "decode"), (PREFILL_CHUNK, "prefill")):
        x = torch.randn((rows, 1, D), generator=gen).to(dev, dt)
        scale = torch.ones(D, dtype=dt, device=dev)
        b, kind = bound(2 * rows * D * 2 + D * 2, 4 * rows * D)
        out[f"rmsnorm_{label}"] = dict(
            shape=f"x ({rows}, 1, {D}) bf16",
            ms=time_ms(lambda: rms_norm(x, scale)),
            plain_ms=time_ms(lambda: rms_norm_plain(x, scale)),
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6)),
            bound_ms=b, bound_by=kind,
        )
    # Decode attention at the serving run's geometry: 4 lanes mid-flight,
    # each at its prompt length plus half its new tokens.
    lens = [len(p) + m // 2 for p, m, _ in reqs[:N_SLOTS]]
    B, H, Hkv, hd, S = N_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, MAX_LEN
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, hd), generator=gen).to(dev, dt)
    k = torch.randn((B, S, Hkv, hd), generator=gen).to(dev, dt)
    v = torch.randn((B, S, Hkv, hd), generator=gen).to(dev, dt)
    k_ar, v_ar, tables = scatter_to_arena(k, v, lens, BLOCK_SIZE, gen)
    live = sum(lens)
    io = 2 * (B * H * hd * 2) + B * 4
    kv = live * Hkv * hd * 2 * 2
    flops = live * H * (4 * hd + 5)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    kp, vp = paged_kv_view(k_ar, tables).transpose(1, 2), paged_kv_view(v_ar, tables).transpose(1, 2)

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask, enable_gqa=True)

    b, kind = bound(io + kv, flops)
    out["decode_attention"] = dict(
        shape=f"q ({B}, {H}, {hd}), cache ({B}, {S}, {Hkv}, {hd}) bf16, lengths {lens}",
        ms=time_ms(lambda: decode_attention(q, k, v, lengths)),
        plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, lengths)),
        library_ms=time_ms(lambda: sdpa(ks, vs)), bound_ms=b, bound_by=kind,
    )
    n_blocks = sum(-(-n // BLOCK_SIZE) for n in lens)
    b, kind = bound(io + kv + n_blocks * 4, flops)
    out["paged_decode_attention"] = dict(
        shape=f"q ({B}, {H}, {hd}), arenas {tuple(k_ar.shape)} bf16, block {BLOCK_SIZE}, "
              f"lengths {lens}",
        ms=time_ms(lambda: paged_decode_attention(q, k_ar, v_ar, tables, lengths)),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)),
        library_ms=time_ms(lambda: sdpa(kp, vp)), bound_ms=b, bound_by=kind,
    )
    for name, r in out.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# Phase 6: where serving time goes
# ---------------------------------------------------------------------------

def kernel_class(name: str) -> str:
    if "rmsnorm" in name:
        return "K2 rmsnorm"
    if "decode_kernel" in name and "PagedRows" in name:
        return "K4 paged decode"
    if "decode_kernel" in name:
        return "K3 decode"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "gemv", "nvjet", "cublas")):
        return "GEMM (cuBLAS)"
    return "other PyTorch kernels"


def window(label: str, timed, profiled, n_units: int, unit: str) -> dict:
    """Host wall time of ``timed()`` without the profiler, and device
    kernel time of ``profiled()`` (the same amount of the same work) under
    it; both end in a device sync."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled()
        torch.cuda.synchronize()
    by_class, by_name, launches = defaultdict(float), defaultdict(float), 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_class[kernel_class(evt.name)] += evt.device_time_total / 1e3   # ms
            by_name[evt.name[:90]] += evt.device_time_total / 1e3
            launches += 1
    device = sum(by_class.values())
    out = {
        "window": label, "units": n_units, "unit": unit,
        "wall_ms_per_unit": wall_ms / n_units,
        "device_ms_per_unit": device / n_units,
        "idle_share": 1 - device / wall_ms,
        "kernel_launches_per_unit": launches / n_units,
        "device_ms_per_unit_by_class": {k: v / n_units for k, v in
                                         sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_unit": {k: v / n_units for k, v in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }
    print(f"  {label}: {out['wall_ms_per_unit']:.3f} ms wall / {unit}, "
          f"{out['device_ms_per_unit']:.3f} ms device / {unit}, idle share "
          f"{out['idle_share']:.3f}, {out['kernel_launches_per_unit']:.1f} launches / {unit}")
    for k, v in out["device_ms_per_unit_by_class"].items():
        print(f"      {k}: {v:.4f} ms / {unit} ({v / max(out['device_ms_per_unit'], 1e-12):.1%})")
    for k, v in out["top_kernels_ms_per_unit"].items():
        print(f"        {v:.4f} ms  {k}")
    return out


def profile_serving(model, params) -> list:
    """Three steady windows, each after a warm-up of the same work: 20
    decode ticks of 4 lanes (prompts of 400-600 tokens) over the
    contiguous pool, the same over the paged pool, and the 3 prefill
    chunks of one 600-token prompt. For each: host wall time, device
    kernel time, the device's idle share (1 - device / wall), kernel
    launches, and device time by kernel class."""
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    results = []

    def engine(block_size):
        return ServeEngine(model, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           block_size=block_size,
                           scheduler=Scheduler(N_SLOTS, prefill_chunk=PREFILL_CHUNK))

    for pool, bsz in (("contiguous", None), ("paged", BLOCK_SIZE)):
        eng = engine(bsz)
        for _ in range(N_SLOTS):
            eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(400, 600))),
                       200)
        while not eng._decoding.all():        # admit and prefill all lanes
            eng.step()

        def ticks(eng=eng):
            for _ in range(20):
                eng.step()

        ticks()                               # warm-up
        results.append(window(f"decode tick, {pool} pool, 4 lanes", ticks, ticks,
                              20, "tick"))

    def prefill_fresh():
        eng = engine(None)
        eng.submit(rng.integers(0, cfg.vocab_size, size=600), 2)
        return eng

    def prefill_all(eng):
        while eng.sched.running or eng.sched.waiting:
            eng.step()

    prefill_all(prefill_fresh())              # warm-up
    a, b = prefill_fresh(), prefill_fresh()
    results.append(window("prefill, 600-token prompt in 256-token chunks",
                          lambda: prefill_all(a), lambda: prefill_all(b), 3, "chunk"))
    return results


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.load_library()
    print(f"[2] built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())

    print("[3] kernels vs plain PyTorch on the card")
    worst = check_kernels()

    cfg = get_config(ARCH)
    print(f"[4] serving {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}")
    model = Model(cfg)
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    runs = serve(model, params)

    print("[5] timing (CUDA events, cold L2, median of 60)")
    times = time_kernels(cfg, workload(cfg.vocab_size))
    print("[6] where serving time goes (torch.profiler)")
    profiled = profile_serving(model, params)
    name, limit = [s.strip() for s in card.split(",", 1)]
    sources = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:26",
                    "rmsnorm_decode", runs["contiguous"]["launches"]["rmsnorm"]
                    + runs["paged"]["launches"]["rmsnorm"]),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:74",
                             "decode_attention",
                             runs["contiguous"]["launches"]["decode_attention"]),
        "paged_decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:187",
                                   "paged_decode_attention",
                                   runs["paged"]["launches"]["paged_decode_attention"]),
    }
    kernels = []
    for kname, (src, replaces, tkey, launches) in sources.items():
        t = times[tkey]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": worst[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    report = {
        "kernels": kernels,
        "card": name, "power_limit": limit,
        "rmsnorm_prefill_shape": times["rmsnorm_prefill"],
        "decode_tokens_per_s": {p: runs[p]["stats"].decode_tokens_per_wsec for p in runs},
        "profile": profiled,
        "seconds": time.perf_counter() - t_start,
    }
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
