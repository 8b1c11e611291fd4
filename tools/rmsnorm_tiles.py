#!/usr/bin/env python3
"""Launch plans of the RMSNorm kernels (K2) on the card.

    python3 tools/rmsnorm_tiles.py [--baseline DIR] [--out FILE]

Needs one CUDA card and ``nvcc``. Builds the port's kernels
(``src/repro_torch/csrc``) and, at each main-path shape (``SHAPES``: the
serving forward at 4 rows and at a 256-row prefill chunk, and the training
rows of llama3.2-1b, D 2048, and of zamba2-1.2b's 4096-wide norms, forward
and backward, bf16), calls the forward and backward C entry points
through ctypes, as the wrappers do, with every plan ``launch_plan`` can
make: each width of row group an instance takes (a warp, or a block of 64
to 1024 threads) and, where the rows fill the card, 256 to 2048
resident threads asked per SM. Each plan is first held to the plain
versions (``parity.within``; bf16 dscale with ``dscale_bf16_slack``) and
then timed with ``chip_smoke.time_ms`` (CUDA events, cold L2, median of
30), the plans in order and then reversed, so each is timed twice around
the others. Beside them: the plan ``launch_plan`` picks by default,
``F.rms_norm`` (forward; forward and backward less forward), the bound,
one PyTorch elementwise call that moves the same bytes (``y.copy_(x)``;
``torch.add(x, g, out=dx)`` for the backward), and the launch floor
(``t.add_(0)`` on a one-element tensor under the same timer). The
default plan's kernels are also timed by name under ``torch.profiler``
after the same flush (their own device time, without the launch latency;
the backward's two launches apart).

``--baseline DIR``: a checkout whose ``src/repro_torch/csrc/rmsnorm.cu``
has the earlier two-pass kernels and their C interface
(``repro_rmsnorm_fwd(x, scale, out, rows, dim, eps, dtype, stream)``,
``repro_rmsnorm_bwd_groups(rows, dim)`` and ``repro_rmsnorm_bwd(g, x, scale,
dx, dscale, part, rows, dim, eps, dtype, stream)``). That file is built
alone and its kernels are held and timed at the same shapes, in turns with
the default plans (baseline, default, default, baseline), and profiled the
same way.

``VARIANTS``: copies of the source with one design point changed, built
alone and timed at every shape in turns with the committed source
(variant, committed, committed, variant), at each resident thread count
where the rows fill the card, and then launch by launch in turns
(``time_pair``), as the baseline is too. Few rows are a matter of latency:
their timings take 200 launches each, and the baseline's turns run three
times.

Reports every K2 instance's registers and spills (ptxas ``-v``) and exits
1 if one spills (``chip_smoke.check_rmsnorm_resources``). Prints the card
line and one JSON line, and writes the JSON to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

#: (label, kind, x shape): the main paths' K2 calls.
SHAPES = [
    ("serving forward", "fwd", (4, 1, 2048)),
    ("prefill forward", "fwd", (256, 1, 2048)),
    ("llama forward", "fwd", (16384, 2048)),
    ("zamba2 forward", "fwd", (16384, 4096)),
    ("llama backward", "bwd", (16384, 2048)),
    ("zamba2 backward", "bwd", (16384, 4096)),
]
WIDTHS = (32, 64, 128, 256, 512, 1024)
#: Copies of ``csrc/rmsnorm.cu`` with one design point changed, timed at
#: the training shapes beside the committed source, each at every resident
#: thread count with the default plan's width: name -> [(text in the
#: source, its replacement)].
VARIANTS = {
    # One row in flight per group: the main paths' instances (bf16
    # vectors, J 1 to 4) load the next row after the stores, not before
    # the reduction.
    "no_prefetch": [
        ("{0, 2, 1, 1, 1024, 1}, {0, 2, 1, 2, 512, 1}, {0, 2, 1, 4, 512, 1}",
         "{0, 2, 1, 1, 1024, 0}, {0, 2, 1, 2, 512, 0}, {0, 2, 1, 4, 512, 0}"),
        ("{1, 2, 1, 1, 512, 1}, {1, 2, 1, 2, 512, 1}",
         "{1, 2, 1, 1, 512, 0}, {1, 2, 1, 2, 512, 0}"),
    ],
    # The warps' partial sums added by a second xor-shuffle tree (lane w
    # reads warp w's), not in warp order one load at a time.
    "shuffle_partials": [
        ("""    float t = red[k][0];
#pragma unroll
    for (int w = 1; w < 32; ++w)
      if (w < n_warps) t += red[k][w];""",
         """    float t = (threadIdx.x & 31) < n_warps ? red[k][threadIdx.x & 31] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);"""),
    ],
    # mean(x^2) as sum * (1 / D), the reciprocal formed off the critical
    # path, instead of an IEEE division after the reduction.
    "reciprocal": [
        ("rsqrtf(ss[0] / (float)dim + eps)", "rsqrtf(ss[0] * (1.f / (float)dim) + eps)"),
        ("rsqrtf(v[0] / (float)dim + eps)", "rsqrtf(v[0] * (1.f / (float)dim) + eps)"),
    ],
    # 16-byte loads and stores with the evict-first hint (ld/st.global.cs):
    # every row is read and written once.
    "streaming": [
        ("if (u < units) a[j] = reinterpret_cast<const Raw*>(p)[u];",
         "if (u < units) { if constexpr (sizeof(Raw) == 16) { const int4 t = "
         "__ldcs(reinterpret_cast<const int4*>(p) + u); a[j] = *reinterpret_cast<const Raw*>"
         "(&t); } else { a[j] = reinterpret_cast<const Raw*>(p)[u]; } }"),
        ("        o[u] = y;",
         "        if constexpr (sizeof(Raw) == 16) __stcs(reinterpret_cast<int4*>(o) + u, "
         "*reinterpret_cast<const int4*>(&y)); else o[u] = y;"),
        ("        o[u] = d;",
         "        if constexpr (sizeof(Raw) == 16) __stcs(reinterpret_cast<int4*>(o) + u, "
         "*reinterpret_cast<const int4*>(&d)); else o[u] = d;"),
    ],
}
THREADS_PER_SM = (256, 512, 1024, 2048)


def baseline_library(src_dir: Path, out_dir: Path):
    """The earlier kernels of ``src_dir``, built alone, with their C
    interface bound."""
    from repro_torch.kernels import _build

    cu = src_dir / "src" / "repro_torch" / "csrc" / "rmsnorm.cu"
    lib = out_dir / "librmsnorm_baseline.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the baseline:\n{res.stdout}")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll = ctypes.CDLL(str(lib))
    cdll.repro_rmsnorm_fwd.argtypes = [P, P, P, I, I, F, I, P]
    cdll.repro_rmsnorm_bwd_groups.argtypes = [I, I]
    cdll.repro_rmsnorm_bwd.argtypes = [P] * 6 + [I, I, F, I, P]
    return cdll


def baseline_calls(lib, x, scale, g):
    """(forward, backward) of the baseline library, as its wrapper made them."""
    rows, D = x.numel() // x.shape[-1], x.shape[-1]
    dt = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        out = torch.empty_like(x)
        rc = lib.repro_rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                                   1e-6, dt, stream())
        if rc:
            raise RuntimeError(f"baseline forward failed ({rc})")
        return out

    def bwd():
        dx, ds = torch.empty_like(x), torch.empty_like(scale)
        part = torch.empty((lib.repro_rmsnorm_bwd_groups(rows, D), D), dtype=torch.float32,
                           device=x.device)
        rc = lib.repro_rmsnorm_bwd(g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(),
                                   ds.data_ptr(), part.data_ptr(), rows, D, 1e-6, dt, stream())
        if rc:
            raise RuntimeError(f"baseline backward failed ({rc})")
        return dx, ds

    return fwd, bwd


def variant_libraries(out_dir: Path) -> dict:
    """{name: ctypes library} of each ``VARIANTS`` copy of the source,
    built alone (all ``nvcc`` runs at once), with the committed C
    interface bound (as ``_build`` binds it)."""
    from repro_torch.kernels import _build

    text = (_build._CSRC / "rmsnorm.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is in the source {src.count(old)} times")
            src = src.replace(old, new)
        cu, lib = out_dir / f"rmsnorm_{name}.cu", out_dir / f"librmsnorm_{name}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        cdll.repro_rmsnorm_fwd.argtypes = [P, P, P, I, I, F] + [I] * 6 + [P]
        cdll.repro_rmsnorm_bwd.argtypes = [P] * 6 + [I, I, F] + [I] * 6 + [P]
        libs[name] = cdll
    return libs


def launch(lib, bwd, plan, x, scale, g):
    """A call that launches the forward or backward of ``lib`` (the
    committed library or a variant's) once with ``plan``, as the wrappers
    do."""
    from repro_torch.kernels.rmsnorm import bwd_scratch

    rows, D = x.numel() // x.shape[-1], x.shape[-1]
    dt = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]
    p = (int(plan.vec), plan.tpr, plan.j, plan.rows_per_block, plan.blocks)

    def fwd():
        out = torch.empty_like(x)
        rc = lib.repro_rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                                   1e-6, dt, *p, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rmsnorm forward failed ({rc}, {plan})")
        return out

    def bwd_():
        dx, ds = torch.empty_like(x), torch.empty_like(scale)
        part = bwd_scratch(plan, D, x.device)
        rc = lib.repro_rmsnorm_bwd(g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(),
                                   ds.data_ptr(), part.data_ptr(), rows, D, 1e-6, dt, *p,
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rmsnorm backward failed ({rc}, {plan})")
        return dx, ds

    return bwd_ if bwd else fwd


def time_pair(fa, fb, n: int) -> tuple:
    """Median device ms of ``fa`` and of ``fb``, launched in turns launch
    by launch (each after the same 128 MiB L2 flush as
    ``chip_smoke.time_ms``), so that drifts of clock and power fall on both."""
    import statistics

    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fa()
        fb()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for sa, ea, sb, eb in ev:
        flush.zero_()
        sa.record()
        fa()
        ea.record()
        flush.zero_()
        sb.record()
        fb()
        eb.record()
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b, _, _ in ev),
            statistics.median(c.elapsed_time(d) for _, _, c, d in ev))


def hold(kind, got, x, scale, g) -> None:
    from repro_torch.kernels import rms_norm_bwd_plain, rms_norm_plain
    from repro_torch.kernels.parity import NEAR_ULPS, dscale_bf16_slack, within

    if kind == "fwd":
        ok = within(got, rms_norm_plain(x, scale), x.dtype)[1]
    else:
        rx, rs = rms_norm_bwd_plain(g, x, scale)
        ok = within(got[0], rx, x.dtype)[1] and within(
            got[1], rs, x.dtype, dscale_bf16_slack(g, x, near_ulps=NEAR_ULPS)[0])[1]
    if not ok:
        raise RuntimeError(f"{kind} {tuple(x.shape)} disagrees with its plain version")


def kernel_ms(fn, n: int = 50) -> dict:
    """{kernel name: device ms a call} of the K2 kernels ``fn`` launches,
    under torch.profiler, each call after the same 128 MiB L2 flush as
    ``chip_smoke.time_ms``: the kernels' own time on the card, without the
    launch latency that CUDA events around one call include."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and "rmsnorm" in evt.key:
            out[evt.key.split("<")[0].split("::")[-1]] += evt.device_time_total / 1e3 / n
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from chip_smoke import bound, card_line, check_rmsnorm_resources, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import sm_count
    from repro_torch.kernels.rmsnorm import launch_plan

    card = card_line()
    lib = _build.load_library()
    print("K2 instances (ptxas -v):")
    resources = check_rmsnorm_resources(_build.build_log(), fail=False)
    n_sms = sm_count(0)
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(23)
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(0), n=60)
    print(f"launch floor (t.add_(0), one element): {floor:.5f} ms")
    report = {"card": card, "n_sms": n_sms, "launch_floor_ms": floor, "shapes": {},
              "resources": resources}
    with tempfile.TemporaryDirectory() as tmp:
        base = baseline_library(args.baseline, Path(tmp)) if args.baseline else None
        variants = variant_libraries(Path(tmp))
        profiled = []
        for label, kind, shape in SHAPES:
            bwd = kind == "bwd"
            D = shape[-1]
            rows = torch.Size(shape[:-1]).numel()
            x = torch.randn(shape, generator=gen).to(dev, dt)
            g = torch.randn(shape, generator=gen).to(dev, dt)
            scale = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
            plans = {}
            for tpr in WIDTHS:
                for tps in (THREADS_PER_SM if rows >= 4 * n_sms else THREADS_PER_SM[:1]):
                    try:
                        p = launch_plan(bwd, rows, D, 2, True, n_sms, tpr, tps)
                    except ValueError:
                        continue
                    plans.setdefault(p, f"tpr {tpr}, J {p.j}, {tps} threads/SM, "
                                        f"{p.groups} groups")
            default = launch_plan(bwd, rows, D, 2, True, n_sms)
            plans.setdefault(default, f"tpr {default.tpr}, J {default.j}, {default.groups} groups")

            def call(p, bwd=bwd, x=x, scale=scale, g=g):
                return launch(lib, bwd, p, x, scale, g)

            for p in plans:
                hold(kind, call(p)(), x, scale, g)
            ms = {p: [] for p in plans}
            for p in list(plans) + list(plans)[::-1]:
                ms[p].append(time_ms(call(p), n=30))
            if bwd:
                xr, sr = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
                lib_ms = (time_ms(lambda: F.rms_norm(xr, (D,), sr, 1e-6).backward(g), n=30)
                          - time_ms(lambda: F.rms_norm(xr, (D,), sr, 1e-6), n=30))
                b = bound(3 * rows * D * 2 + 2 * D * 2, 10 * rows * D)
            else:
                lib_ms = time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6), n=30)
                b = bound(2 * rows * D * 2 + D * 2, 4 * rows * D)
            # The same bytes moved by one PyTorch elementwise call: y = x
            # (forward), dx = x + g (backward).
            y = torch.empty_like(x)
            copy_ms = time_ms((lambda: torch.add(x, g, out=y)) if bwd else (lambda: y.copy_(x)),
                              n=30)
            entry = {
                "kind": kind, "shape": list(shape), "bound_ms": b[0], "bound_by": b[1],
                "library_ms": lib_ms, "same_bytes_elementwise_ms": copy_ms,
                "plans": [{"plan": plans[p], "tpr": p.tpr, "j": p.j, "blocks": p.blocks,
                           "groups": p.groups, "ms": ms[p], "default": p == default}
                          for p in plans],
            }
            fastest = min(plans, key=lambda p: sum(ms[p]))
            entry["fastest"] = plans[fastest]
            print(f"{label} {tuple(shape)} bf16: bound {b[0]:.5f} ms ({b[1]}), F.rms_norm "
                  f"{lib_ms:.5f} ms, {'x + g' if bwd else 'copy'} (same bytes) {copy_ms:.5f} ms")
            for p in plans:
                mark = " (default)" if p == default else ""
                print(f"  {plans[p]}: {ms[p][0]:.5f} / {ms[p][1]:.5f} ms{mark}")
            print(f"  fastest: {plans[fastest]}")
            # Each variant at the default plan's width (and, where the rows
            # fill the card, every resident thread count), in turns with the
            # committed source; few rows (a matter of latency) get 200
            # launches a timing.
            n = 30 if rows >= 4 * n_sms else 200
            entry["variants"] = {}
            for vname, vlib in variants.items():
                vms = {}
                for tps in (THREADS_PER_SM if rows >= 4 * n_sms else (None,)):
                    p = launch_plan(bwd, rows, D, 2, True, n_sms, default.tpr, tps)
                    fn = launch(vlib, bwd, p, x, scale, g)
                    hold(kind, fn(), x, scale, g)
                    vms[tps or "default"] = t = [time_ms(fn, n=n), time_ms(call(p), n=n),
                                                 time_ms(call(p), n=n), time_ms(fn, n=n)]
                    t += time_pair(fn, call(p), 2 * n)
                    print(f"  variant {vname}, tpr {p.tpr}, {tps or 'default'} threads/SM: "
                          f"{t[0]:.5f} / {t[3]:.5f} ms; committed {t[1]:.5f} / {t[2]:.5f} ms; "
                          f"launch by launch {t[4]:.5f} / {t[5]:.5f} ms")
                entry["variants"][vname] = vms
            if base is not None:
                b_fwd, b_bwd = baseline_calls(base, x, scale, g)
                old = b_bwd if bwd else b_fwd
                hold(kind, old(), x, scale, g)
                turns = {"baseline": [], "default": []}
                for who in ("baseline", "default", "default", "baseline") * (1 if n == 30 else 3):
                    turns[who].append(time_ms(old if who == "baseline" else call(default), n=n))
                entry["baseline_turns_ms"] = turns
                print(f"  in turns: baseline {' / '.join(f'{t:.5f}' for t in turns['baseline'])}"
                      f" ms, default plan {' / '.join(f'{t:.5f}' for t in turns['default'])} ms")
                entry["baseline_paired_ms"] = pair = time_pair(old, call(default), 4 * n)
                print(f"  launch by launch ({4 * n} pairs): baseline {pair[0]:.5f} ms, default "
                      f"plan {pair[1]:.5f} ms")
            profiled.append((label, call(default), old if base is not None else None))
            report["shapes"][label] = entry
        # Profiled after every event timing: a profiler session slows the
        # event timings that follow it at the few-row shapes.
        for label, fn, old in profiled:
            entry = report["shapes"][label]
            entry["kernels_ms"] = kernel_ms(fn)
            print(f"{label}: by kernel (profiler, cold L2, default plan): {entry['kernels_ms']}")
            if old is not None:
                entry["baseline_kernels_ms"] = kernel_ms(old)
                print(f"{label}: baseline by kernel (profiler, cold L2): "
                      f"{entry['baseline_kernels_ms']}")
    print(card)
    line = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    spills = [k for k, r in resources.items() if r["spill_bytes"]]
    print(f"K2 instances spilling: {spills or 'none'}")
    return 1 if spills else 0


if __name__ == "__main__":
    sys.exit(main())
