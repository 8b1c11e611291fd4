"""Three-term roofline from dry-run artifacts, at the H100's rates (port
of ``repro.analysis.roofline``).

    compute    = FLOPs_per_device       / 989e12   [dense bf16 FLOP/s]
    memory     = bytes_per_device       / 3.35e12  [HBM3 bytes/s]
    collective = coll_bytes_per_device  / 50e9     [bytes/s, one NIC]

The rates are the datasheet's for one H100 SXM5 80GB HBM3 at 700 W, not
measurements. ``LINK_BW`` is one 400 Gb/s NDR NIC a GPU: every axis of
16 ranks spans nodes of 8 GPUs, so the NIC binds before NVLink's
450 GB/s. All inputs are per device (the artifacts of either dry run:
the port's ``artifacts/dryrun_torch/`` or the reference's
``artifacts/dryrun/``). The bottleneck is the largest term; beside it we
track MODEL_FLOPS / (global counted FLOPs): how much of the executed
compute is algorithmically necessary (6 N_active D for training,
2 N_active D for prefill, 2 N_active B for decode) -- remat recompute,
rows repeated over the "model" axis (a port step that gathers its
parameters whole: ``WHOLE_MARK`` in the artifact's ``variant_note``) and
capacity padding all show here.
The port's ``hbm_bytes`` is its eager traffic (every op's operands and
outputs), so its memory term is an upper bound a fused program would
undercut.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

__all__ = ["RooflineRow", "model_flops_for", "analyze_artifact", "load_rows", "format_table",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW", "WHOLE_MARK"]

PEAK_FLOPS = 989e12     # dense bf16 / card (H100 SXM5 datasheet)
HBM_BW = 3.35e12        # bytes/s / card (HBM3)
LINK_BW = 50e9          # bytes/s: one 400 Gb/s NIC


@dataclasses.dataclass
class RooflineRow:
    cell: str
    arch: str
    shape: str
    kind: str
    mesh: str
    variant: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    mem_gib: float
    note: str

    def step_time_bound(self) -> float:
        """Lower bound on step time assuming perfect overlap of the
        three engines: the max term."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops_for(art: dict) -> float:
    """Algorithmically-necessary FLOPs for this cell (global, per step)."""
    n_active = art["params_active"]
    S, B = art["seq_len"], art["global_batch"]
    if art["kind"] == "train":
        return 6.0 * n_active * S * B
    if art["kind"] == "prefill":
        return 2.0 * n_active * S * B
    # decode: one token per sequence.
    return 2.0 * n_active * B


#: How a port artifact's ``variant_note`` marks a step that gathers every
#: parameter whole (no tensor-parallel compute over "model").
WHOLE_MARK = "parameters gathered whole"


def _note(art: dict, dominant: str, useful: float) -> str:
    whole = WHOLE_MARK in (art.get("variant_note") or "")
    if dominant == "collective" and not whole and "fits" in art:
        return (
            "collective-bound: the gather over the FSDP axis and the all_reduces over "
            "'model' of tensor-parallel compute; overlap them with the products or "
            "reuse gathered weights across accumulation microbatches"
        )
    if dominant == "collective":
        return (
            "collective-bound: every parameter gathered whole each step; cut by "
            "tensor-parallel compute over 'model' (gather only over the FSDP axis) or "
            "by reusing gathered weights across accumulation microbatches"
        )
    if dominant == "memory":
        return (
            "HBM-bound: fuse the f32 elementwise chains into CUDA kernels (norm, "
            "rope, softmax, optimizer), keep attention tiles resident (K1 / K3), "
            "drop f32 intermediates"
        )
    if useful < 0.25 and (whole or "fits" not in art):
        return (
            "compute-bound but <25% useful: rows repeated over 'model' (no "
            "tensor-parallel compute) and remat recompute -- shard the products "
            "over 'model' or use selective remat"
        )
    if useful < 0.25:
        return (
            "compute-bound but <25% useful: remat recompute and the products a dim "
            "'model' does not divide leaves whole on every rank -- selective remat"
        )
    return "compute-bound: push tensor-core utilization (bf16 GEMMs, K1 / K5 tiles)"


def analyze_artifact(art: dict) -> Optional[RooflineRow]:
    if art.get("status") != "OK":
        return None
    flops_dev = art["cost"]["flops"]
    hbm_dev = art["cost"]["hbm_bytes"]
    coll_dev = sum(art["collectives"].values())
    n = art["n_devices"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = hbm_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_for(art)
    hlo_global = flops_dev * n
    useful = mf / hlo_global if hlo_global else 0.0
    return RooflineRow(
        cell=art["cell"],
        arch=art["arch"],
        shape=art["shape"],
        kind=art["kind"],
        mesh=art["mesh"],
        variant=art["variant"],
        n_devices=n,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=useful,
        mem_gib=art["memory"]["peak_bytes"] / 2**30,
        note=_note(art, dominant, useful),
    )


def load_rows(
    artifacts_dir: Path, mesh: Optional[str] = None, variant: str = "baseline"
) -> List[RooflineRow]:
    rows = []
    for f in sorted(Path(artifacts_dir).glob("*.json")):
        art = json.loads(f.read_text())
        if art.get("status") != "OK":
            continue
        if mesh and art.get("mesh") != mesh:
            continue
        if variant and art.get("variant") != variant:
            continue
        row = analyze_artifact(art)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (
        "| cell | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful | GiB/dev |\n"
        "|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r.arch} × {r.shape} ({r.mesh}) | {r.compute_s:.3f} | "
            f"{r.memory_s:.3f} | {r.collective_s:.3f} | **{r.dominant}** | "
            f"{r.model_flops:.2e} | {r.useful_ratio:.1%} | {r.mem_gib:.1f} |"
        )
    return hdr + "\n".join(lines)
