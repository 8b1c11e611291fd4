#!/usr/bin/env python3
"""Tile choices of the bf16 flash-attention kernels (K1) on the card.

    python3 tools/flash_tiles.py

Needs one CUDA card and ``nvcc``. Builds ``src/repro_torch/csrc/
flash_attention.cu`` alone four times (all four ``nvcc`` runs at once):
as committed, and three copies with one tile choice changed in the
source text (``VARIANTS``): 8 warps in the forward (q tiles of 128 rows,
not 64); causal q tiles of the forward and the dQ launch issued longest
first, not in order; and one block per SM asked of ``__launch_bounds__``
in the forward and dQ launches too, not only in dK/dV. For each it
reports which bf16 kernels spill (ptxas ``-v``), holds K1 forward and
backward to the plain versions (``parity.flash_within``) and times them
(``chip_smoke.time_ms``: CUDA events, cold L2, median of 30) at
llama3.2-1b's training shape (q (32, 512, 32, 64), k/v (32, 512, 8,
64)) and zamba2-1.2b's shared block's (q, k, v (32, 512, 32, 128)),
causal, in the order a b c d d c b a, so that each choice is timed twice
around the others. Prints the card line and one JSON line; writes
nothing else.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

#: name: [(text in csrc/flash_attention.cu, its replacement, times found)];
#: the first is the source as committed.
VARIANTS = {
    "committed": [],
    "fwd_8_warps": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 8;", 1)],
    "longest_first": [("  const int q0 = blockIdx.x * BQ,",
                       "  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ,",
                       2)],
    "min_blocks_1": [("__launch_bounds__(NW * 32)\nfa_fwd_mma",
                      "__launch_bounds__(NW * 32, 1)\nfa_fwd_mma", 1),
                     ("__launch_bounds__(kMmaWarps * 32)\nfa_bwd_dq_mma",
                      "__launch_bounds__(kMmaWarps * 32, 1)\nfa_bwd_dq_mma", 1)],
}
SHAPES = {"llama3.2-1b": (32, 512, 32, 8, 64), "zamba2-1.2b": (32, 512, 32, 32, 128)}


def build(out_dir: Path) -> tuple:
    """({variant: library}, {variant: bytes spilled by its bf16 kernels})."""
    from chip_smoke import k1_instance, ptxas_resources
    from repro_torch.kernels import _build

    nvcc, text = _build._nvcc(), (_build._CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new, times in patches:
            if src.count(old) != times:
                raise RuntimeError(f"{name}: {old!r} is in the source "
                                   f"{src.count(old)} times, not {times}")
            src = src.replace(old, new)
        cu, lib = out_dir / f"flash_{name}.cu", out_dir / f"libflash_{name}.so"
        cu.write_text(src)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, spills = {}, {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        spills[name] = {"%s<%d, %d>" % k1_instance(fn): spill
                        for fn, (_, spill) in ptxas_resources(out).items()
                        if k1_instance(fn) and spill}
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        cdll = ctypes.CDLL(str(lib))
        cdll.repro_flash_attention_fwd.argtypes = [P] * 5 + [I] * 7 + [F, I, I, P]
        cdll.repro_flash_attention_bwd.argtypes = [P] * 10 + [I] * 7 + [F, I, I, P]
        libs[name] = cdll
    return libs, spills


def fwd(lib, q, k, v):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out, lse = torch.empty_like(q), torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Sq, Skv,
        H, Hkv, D, D, 1.0 / math.sqrt(D), 1, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"forward launch failed ({rc})")
    return out, lse


def bwd(lib, q, k, v, o, lse, do):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, Hkv, D,
        D, 1.0 / math.sqrt(D), 1, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"backward launch failed ({rc})")
    return dq, dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import card_line, time_ms
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_attention_rounding_terms,
    )
    from repro_torch.kernels.parity import flash_within

    card = card_line()
    print(card)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs, spills = build(Path(tmp))
        for name, sp in spills.items():
            print(f"{name}: bf16 kernels that spill: {sp or 'none'}")
        gen = torch.Generator().manual_seed(0)
        report = {"card": card, "spill_bytes": spills, "ms": {}}
        for label, (B, S, H, Hkv, D) in SHAPES.items():
            dev, dt = torch.device("cuda"), torch.bfloat16
            q, do = (torch.randn((B, S, H, D), generator=gen).to(dev, dt) for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, D), generator=gen).to(dev, dt) for _ in range(2))
            ref, lse = flash_attention_plain(q, k, v, causal=True)
            refs = flash_attention_bwd_plain(q, k, v, ref, lse, do, causal=True)
            terms = flash_attention_rounding_terms(q, k, v, ref, lse, do, causal=True)
            for name, lib in libs.items():
                got = fwd(lib, q, k, v)[:1] + bwd(lib, q, k, v, ref, lse, do)
                for a, b, t in zip(got, (ref,) + refs, terms):
                    err, ok = flash_within(a, b, dt, t)
                    if not ok:
                        raise RuntimeError(f"{name} at {label} disagrees with plain ({err:.3e})")
            del refs, terms
            times = {name: {"fwd": [], "bwd": []} for name in libs}
            for name in list(libs) + list(reversed(libs)):
                lib = libs[name]
                times[name]["fwd"].append(time_ms(lambda: fwd(lib, q, k, v), n=30))
                times[name]["bwd"].append(
                    time_ms(lambda: bwd(lib, q, k, v, ref, lse, do), n=30))
            report["ms"][label] = times
            for name, t in times.items():
                print(f"{label} {name}: fwd {t['fwd'][0]:.4f} / {t['fwd'][1]:.4f} ms, "
                      f"bwd {t['bwd'][0]:.4f} / {t['bwd'][1]:.4f} ms")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
