#!/usr/bin/env python3
"""Tile choices of the flash-attention kernels (K1) on the card.

    python3 tools/flash_tiles.py [--f32] [--baseline DIR]

Needs one CUDA card and ``nvcc``. Builds flash attention's sources
(``src/repro_torch/csrc/flash_attention*.cu``) alone four times (all
four ``nvcc`` runs at once): as committed, and three copies with one tile choice changed in the
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

``--f32``: the same for the f32 (3xTF32) kernels (``VARIANTS_F32``: rows
padded by 4 or 8 words, not 12; KV and q tiles of 64 rows, not 32; a
causal launch's shortest blocks issued first, not its longest; q and dO
split by each warp of the dK/dV launch as it reads them, not once for the
block) at ``SHAPES_F32`` (smollm-135m's training step, q (32, 128,
9, 64), and elastic_failover_torch's largest, q (32, 64, 4, 32)), held
by ``parity.within``'s f32 rule and, as committed, a second launch bit
for bit. ``--baseline DIR``: a checkout (a ``git archive`` of another
commit) whose flash sources are built and timed in the same turns as
one more variant.
"""

from __future__ import annotations

import argparse
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
VARIANTS_F32 = {
    "committed": [],
    "pad_4": [("constexpr int kF32Pad = 12;", "constexpr int kF32Pad = 4;", 1)],
    "pad_8": [("constexpr int kF32Pad = 12;", "constexpr int kF32Pad = 8;", 1)],
    "tiles_64": [("constexpr int kF32Tile = 32;", "constexpr int kF32Tile = 64;", 1)],
    "shortest_first": [("  return causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;",
                        "  return blockIdx.z;", 1),
                       ("  const int k0 = blockIdx.z * BKV, hk = blockIdx.x, b = blockIdx.y;",
                        "  const int k0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BKV,"
                        " hk = blockIdx.x, b = blockIdx.y;", 1)],
    "dkdv_split_per_warp": [("    split_tile<BQ, D, NT>(cQ, sQs, scale);\n"
                             "    split_tile<BQ, DV, NT>(cO, sdOs, 1.f);\n"
                             "    __syncthreads();\n"
                             "    const SplitTile tQ{cQ, sQs}, tO{cO, sdOs};",
                             "    const RawTile tQ{cQ, scale}, tO{cO, 1.f};", 1)],
}
SHAPES_F32 = {"smollm-135m": (32, 128, 9, 3, 64), "elastic_failover": (32, 64, 4, 2, 32)}
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def build(out_dir: Path, variants: dict, baseline: Path = None) -> tuple:
    """({variant: library}, {variant: bytes spilled by its K1 tensor-core
    kernels}); ``baseline``'s sources are built as the variant "baseline".
    A variant's patches apply to whichever flash source holds their text."""
    from chip_smoke import k1_instance, ptxas_resources
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    texts = {p.name: p.read_text() for p in sorted(_build._CSRC.glob("flash_attention*.cu*"))}
    sources = {name: (texts, patches) for name, patches in variants.items()}
    if baseline is not None:
        base = baseline / "src" / "repro_torch" / "csrc"
        sources["baseline"] = ({p.name: p.read_text()
                                for p in sorted(base.glob("flash_attention*.cu*"))}, [])
    procs = {}
    for name, (files, patches) in sources.items():
        for old, new, times in patches:
            found = sum(t.count(old) for t in files.values())
            if found != times:
                raise RuntimeError(f"{name}: {old!r} is in the sources {found} times, "
                                   f"not {times}")
            files = {n: t.replace(old, new) for n, t in files.items()}
        src_dir, lib = out_dir / name, out_dir / f"libflash_{name}.so"
        src_dir.mkdir()
        for n, t in files.items():
            (src_dir / n).write_text(t)
        cus = [str(src_dir / n) for n in sorted(files) if n.endswith(".cu")]
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *cus, "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, spills = {}, {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        spills[name] = {fn: spill for fn, (_, spill) in ptxas_resources(out).items()
                        if spill and "fa_" in fn}
        regs = {"%s<%d, %d>" % k1_instance(fn): r for fn, (r, _) in
                ptxas_resources(out).items() if k1_instance(fn)}
        print(f"{name}: registers {regs}")
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
        H, Hkv, D, D, 1.0 / math.sqrt(D), 1, _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
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
        D, 1.0 / math.sqrt(D), 1, _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"backward launch failed ({rc})")
    return dq, dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true", help="the f32 (3xTF32) kernels")
    ap.add_argument("--baseline", type=Path, help="a checkout timed as one more variant")
    args = ap.parse_args(argv)
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
    dt = torch.float32 if args.f32 else torch.bfloat16
    variants, shapes = (VARIANTS_F32, SHAPES_F32) if args.f32 else (VARIANTS, SHAPES)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs, spills = build(Path(tmp), variants, args.baseline)
        for name, sp in spills.items():
            print(f"{name}: K1 kernels that spill: {sp or 'none'}")
        gen = torch.Generator().manual_seed(0)
        report = {"card": card, "dtype": str(dt), "spill_bytes": spills, "ms": {},
                  "max_abs_err": {}}
        for label, (B, S, H, Hkv, D) in shapes.items():
            dev = torch.device("cuda")
            q, do = (torch.randn((B, S, H, D), generator=gen).to(dev, dt) for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, D), generator=gen).to(dev, dt) for _ in range(2))
            ref, lse = flash_attention_plain(q, k, v, causal=True)
            refs = flash_attention_bwd_plain(q, k, v, ref, lse, do, causal=True)
            terms = flash_attention_rounding_terms(q, k, v, ref, lse, do, causal=True)
            report["max_abs_err"][label] = {}
            for name, lib in libs.items():
                got = fwd(lib, q, k, v)[:1] + bwd(lib, q, k, v, ref, lse, do)
                errs = []
                for a, b, t in zip(got, (ref,) + refs, terms):
                    err, ok = flash_within(a, b, dt, t)
                    errs.append(err)
                    if not ok:
                        raise RuntimeError(f"{name} at {label} disagrees with plain ({err:.3e})")
                report["max_abs_err"][label][name] = errs
                print(f"{label} {name}: max |err| out / dq / dk / dv "
                      f"{' / '.join(f'{e:.2e}' for e in errs)}")
                if name == "committed":
                    again = fwd(lib, q, k, v)[:1] + bwd(lib, q, k, v, ref, lse, do)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise RuntimeError(f"{name} at {label}: a second launch differs")
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
