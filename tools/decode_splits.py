#!/usr/bin/env python3
"""Split counts of the flash-decode kernels (K3, K4) on the card.

    python3 tools/decode_splits.py

Needs one CUDA card and ``nvcc``. Builds the port's kernels as committed
and calls the C entry points of K3 and K4 through ctypes with the number
of KV splits forced to each of ``COUNTS`` and to the plan's choice
(``split_plan``; the Python wrappers always pass the plan). At each of
``chip_smoke.py``'s phase-5 decode shapes for llama3.2-1b's heads (32/8,
D 64, bf16, block 16: the serving shape and the long-context shapes
``LONG_DECODE``) it holds every count to the plain versions (bf16, 2e-2)
and times it (``chip_smoke.time_ms``: CUDA events, cold L2, median of
60), in the order of ``COUNTS`` and then reversed, so each count is timed
twice around the others; then once more with L2 flushed by a read
(``flush_by_read``: no dirty lines to write back). Beside them, as a
yardstick of the bytes alone, one PyTorch sum over a bf16 buffer as large
as the live K and V rows, timed both ways; and, at the plan's count, a
copy of the kernels built from the source with the arithmetic skipped
(``LOADS_ONLY``: each warp still issues and waits for every load), which
says whether the loads or the arithmetic bound the time. Prints the card
line and one JSON line; writes nothing else.
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

COUNTS = [1, 2, 4, 8, 16, 32, 64]
TOL_BF16 = 2e-2
#: (text in csrc/decode_attention.cu, its replacement): after each stage's
#: loads land, skip to the next stage.
LOADS_ONLY = ("    const int stage = i % kStages;\n    const int base = stage_base(i);\n",
              "    const int stage = i % kStages;\n    const int base = stage_base(i);\n"
              "    if (head_dim > 0) continue;\n")


def build_loads_only(out_dir: Path):
    """The kernels' library built from csrc/decode_attention.cu alone with
    ``LOADS_ONLY`` applied, bound as ``_build`` binds the real one."""
    from repro_torch.kernels import _build

    text = (_build._CSRC / "decode_attention.cu").read_text()
    if text.count(LOADS_ONLY[0]) != 1:
        raise RuntimeError("LOADS_ONLY's anchor is not in the source exactly once")
    cu, lib = out_dir / "decode_loads_only.cu", out_dir / "libdecode_loads_only.so"
    cu.write_text(text.replace(*LOADS_ONLY))
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the loads-only copy:\n{res.stdout}")
    P, I = ctypes.c_void_p, ctypes.c_int
    cdll = ctypes.CDLL(str(lib))
    cdll.repro_decode_attention_fwd.argtypes = [P] * 6 + [I] * 7 + [P]
    cdll.repro_paged_decode_attention_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
    return cdll


def launch(lib, paged: bool, n_splits: int, q, k, v, lengths, tables=None):
    """One K3 (or K4) call with ``n_splits`` splits, as the wrappers make it."""
    from repro_torch.kernels.decode_attention import _DTYPES

    B, H, D = q.shape
    out = torch.empty_like(q)
    ws = (torch.empty(B * H * n_splits * (D + 2), dtype=torch.float32, device=q.device)
          if n_splits > 1 else None)
    wsp = None if ws is None else ws.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if paged:
        rc = lib.repro_paged_decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), wsp, B, H, k.shape[2], D, k.shape[1], tables.shape[1], n_splits,
            _DTYPES[q.dtype], stream)
    else:
        rc = lib.repro_decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(), wsp,
            B, H, k.shape[2], D, k.shape[1], n_splits, _DTYPES[q.dtype], stream)
    if rc:
        raise RuntimeError(f"launch with {n_splits} splits failed ({rc})")
    return out


def time_shape(libs, label: str, B: int, S: int, lens, heads, gen) -> dict:
    """Every count of K3 and K4 at one shape, held to plain and timed;
    the yardstick sum; the loads-only copy at the plan's count."""
    from chip_smoke import decode_inputs, time_ms
    from repro_torch.kernels import decode_attention_plain, paged_decode_attention_plain
    from repro_torch.kernels.decode_attention import sm_count, split_plan

    lib, loads_only = libs
    q, k, v, lengths, k_ar, v_ar, tables = decode_inputs(B, S, *heads, lens, gen)
    plan = split_plan(heads[1], S, sm_count(q.device.index))
    counts = sorted(set(COUNTS) | {plan})

    def calls(cdll):
        return {
            "decode_attention": lambda n: launch(cdll, False, n, q, k, v, lengths),
            "paged_decode_attention": lambda n: launch(cdll, True, n, q, k_ar, v_ar, lengths,
                                                        tables),
        }

    real = calls(lib)
    refs = {"decode_attention": decode_attention_plain(q, k, v, lengths),
            "paged_decode_attention": paged_decode_attention_plain(q, k_ar, v_ar, tables,
                                                                   lengths)}
    for n in counts:
        for name, call in real.items():
            err = (call(n).float() - refs[name].float()).abs().max().item()
            if not err <= TOL_BF16:
                raise RuntimeError(f"{name} at {label} with {n} splits disagrees ({err:.3e})")
    ms = {name: {n: [] for n in counts} for name in real}
    for n in counts + counts[::-1]:
        for name, call in real.items():
            ms[name][n].append(time_ms(lambda: call(n)))
    read_ms = {name: {n: time_ms(lambda: call(n), flush_by_read=True) for n in counts}
               for name, call in real.items()}
    best = {name: min(counts, key=lambda n: sum(t[n])) for name, t in ms.items()}
    live = torch.empty(2 * sum(lens) * heads[1] * heads[2], dtype=torch.bfloat16,
                       device=q.device).normal_()
    yardstick = {"write_flush": time_ms(live.sum),
                 "read_flush": time_ms(live.sum, flush_by_read=True)}
    bare = {name: time_ms(lambda: call(plan)) for name, call in calls(loads_only).items()}
    for name, t in ms.items():
        row = ", ".join(f"{n}: {t[n][0]:.4f}/{t[n][1]:.4f}/{read_ms[name][n]:.4f}"
                        for n in counts)
        print(f"{label} {name} (plan {plan}, fastest {best[name]}; write/write/read "
              f"flush): {row} ms")
    print(f"{label} sum over {live.numel() * 2} bytes: {yardstick['write_flush']:.4f} / "
          f"{yardstick['read_flush']:.4f} ms; loads only at {plan} splits: K3 "
          f"{bare['decode_attention']:.4f}, K4 {bare['paged_decode_attention']:.4f} ms")
    return {"B": B, "S": S, "lengths": lens, "plan": plan, "ms": ms, "read_flush_ms": read_ms,
            "fastest": best, "sum_of_live_bytes_ms": yardstick, "loads_only_ms_at_plan": bare}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_splits: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import (
        ARCH, BLOCK_SIZE, LONG_DECODE, MAX_LEN, N_SLOTS, SEED, card_line, workload,
    )
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = card_line()
    print(card)
    cfg = get_config(ARCH)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    serving = [len(p) + m // 2 for p, m, _ in workload(cfg.vocab_size)[:N_SLOTS]]
    shapes = {"serving": (N_SLOTS, MAX_LEN, serving), **LONG_DECODE}
    gen = torch.Generator().manual_seed(SEED + 2)
    report = {"card": card, "block_size": BLOCK_SIZE, "shapes": {}}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = (_build.load_library(), build_loads_only(Path(tmp)))
        for label, (B, S, lens) in shapes.items():
            report["shapes"][label] = time_shape(libs, label, B, S, lens, heads, gen)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
