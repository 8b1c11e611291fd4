#!/usr/bin/env python3
"""Blocks per SM of the bf16 SSD scan kernels (K5) on the card.

    python3 tools/ssd_tiles.py

Needs one CUDA card and ``nvcc``. Builds ``src/repro_torch/csrc/
ssd_scan.cu`` alone once per entry of ``VARIANTS`` (all ``nvcc`` runs at
once): as committed (``__launch_bounds__`` asks for three forward blocks
an SM, so at most 85 registers a thread, and two backward blocks, at most
128), and copies asking for one block an SM in both (up to 255
registers) or two in the forward. For each build it calls the C entry points ``repro_ssd_scan_fwd``
and ``repro_ssd_scan_bwd`` through ctypes at zamba2-1.2b's training shape
(x (32, 512, 64, 64), B/C (32, 512, 1, 64) bf16, chunk 128, its initial
decay), holds each to the plain versions (``parity.ssd_within``) and times
it (``chip_smoke.time_ms``: CUDA events, cold L2, median of 30), the
builds in order and then reversed, so each is timed twice around the
others. Reports each build's registers and spills (ptxas ``-v``). Prints
the card line and one JSON line; writes nothing else.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

SHAPE = (32, 512, 64, 64, 1, 64, 128)          # B, S, H, P, G, N, chunk
FWD_BOUNDS, BWD_BOUNDS = ("__launch_bounds__(kTcThreads, 3)\nssd_fwd_mma",
                          "__launch_bounds__(kTcThreads, 2)\nssd_bwd_mma")
#: name: [(text in csrc/ssd_scan.cu, its replacement, times found)]; the
#: first is the source as committed.
VARIANTS = {
    "committed": [],
    "one_block_per_sm": [
        (FWD_BOUNDS, FWD_BOUNDS.replace("3)", "1)"), 1),
        (BWD_BOUNDS, BWD_BOUNDS.replace("2)", "1)"), 1),
    ],
    "fwd_two_blocks_per_sm": [(FWD_BOUNDS, FWD_BOUNDS.replace("3)", "2)"), 1)],
}


def build(out_dir: Path) -> tuple:
    """({variant: ctypes library}, {variant: {kernel: (registers, spill)}})."""
    from chip_smoke import K5_ENTRY, ptxas_resources
    from repro_torch.kernels import _build

    nvcc, text = _build._nvcc(), (_build._CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new, times in patches:
            if src.count(old) != times:
                raise RuntimeError(f"{name}: {old!r} is in the source "
                                   f"{src.count(old)} times, not {times}")
            src = src.replace(old, new)
        cu, lib = out_dir / f"ssd_{name}.cu", out_dir / f"libssd_{name}.so"
        cu.write_text(src)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, resources = {}, {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        resources[name] = {"%s<%s, %s>" % K5_ENTRY.search(fn).groups(): r
                           for fn, r in ptxas_resources(out).items() if K5_ENTRY.search(fn)}
        cdll = ctypes.CDLL(str(lib))
        cdll.repro_ssd_scan_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
        cdll.repro_ssd_scan_bwd.argtypes = [P] * 15 + [I] * 8 + [P]
        libs[name] = cdll
    return libs, resources


def calls(name: str, lib, x, dt, A, Bm, Cm, dy):
    """(forward, backward) of one build, as the wrappers make them; the
    backward reads the states of one forward call."""
    B, S, H, P, G, N, Q = SHAPE
    nc = -(-S // Q)
    stream = torch.cuda.current_stream().cuda_stream
    dev = x.device

    def fwd():
        y = torch.empty_like(x)
        states = torch.empty((B, H, nc + 1, P, N), dtype=torch.float32, device=dev)
        rc = lib.repro_ssd_scan_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                                    Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                                    B, S, H, P, G, N, Q, 1, stream)
        if rc:
            raise RuntimeError(f"{name}: forward failed ({rc})")
        return y, states

    states = fwd()[1]

    def bwd():
        dx, ddt = torch.empty_like(x), torch.empty_like(dt)
        dB, dC, dA = torch.empty_like(Bm), torch.empty_like(Cm), torch.empty_like(A)
        dB_part = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
        dC_part = torch.empty_like(dB_part)
        dA_part = torch.empty((B, H), dtype=torch.float32, device=dev)
        rc = lib.repro_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            states.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dA.data_ptr(), B, S, H, P, G, N, Q, 1, stream)
        if rc:
            raise RuntimeError(f"{name}: backward failed ({rc})")
        return dx, ddt, dA, dB, dC

    return fwd, bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import card_line, ssd_inputs, time_ms
    from repro_torch.kernels import ssd_scan_bwd_plain
    from repro_torch.kernels.parity import ssd_within
    from repro_torch.kernels.ssd_scan import _states_plain, _unlay, ssd_bwd_term_sums

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)
    x, dt, A, Bm, Cm, dy = ssd_inputs(SHAPE, torch.bfloat16, gen, zamba=True)
    chunk = SHAPE[-1]
    ref_y, ref_states = _states_plain(x, dt, A, Bm, Cm, chunk)
    ref_y = _unlay(ref_y, SHAPE[1]).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        libs, resources = build(Path(tmp))
        choices = list(libs)
        funcs = {c: calls(c, libs[c], x, dt, A, Bm, Cm, dy) for c in choices}
        refs = grads_terms = None
        for c, (fwd, bwd) in funcs.items():
            y, states = fwd()
            ok = ssd_within(y, ref_y, torch.bfloat16)[1] and ssd_within(
                states, ref_states, torch.float32)[1]
            if refs is None:
                refs = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
                grads_terms = (None,) + ssd_bwd_term_sums(x, dt, A, Bm, Cm, states, dy,
                                                          chunk=chunk)
            for a, b, t in zip(bwd(), refs, grads_terms):
                ok = ok and ssd_within(a, b, a.dtype, t)[1]
            if not ok:
                raise RuntimeError(f"{c} disagrees with the plain versions")
        ms = {c: {"fwd": [], "bwd": []} for c in choices}
        for c in choices + choices[::-1]:
            fwd, bwd = funcs[c]
            ms[c]["fwd"].append(time_ms(fwd, n=30))
            ms[c]["bwd"].append(time_ms(bwd, n=30))
    for c in choices:
        print(f"{c}: forward {ms[c]['fwd'][0]:.4f} / "
              f"{ms[c]['fwd'][1]:.4f} ms, backward {ms[c]['bwd'][0]:.4f} / "
              f"{ms[c]['bwd'][1]:.4f} ms")
    for v, r in resources.items():
        print(f"{v} registers / spill bytes: " + ", ".join(f"{k} {a}/{b}"
                                                           for k, (a, b) in sorted(r.items())))
    best = {k: min(choices, key=lambda c: sum(ms[c][k])) for k in ("fwd", "bwd")}
    print(card)
    print(json.dumps({
        "card": card, "shape": SHAPE, "ms": ms, "fastest": best,
        "resources": {v: {k: {"registers": a, "spill_bytes": b} for k, (a, b) in r.items()}
                      for v, r in resources.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
