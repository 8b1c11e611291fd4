"""Multi-pod dry run of the port: trace every (arch x shape x mesh x
variant) cell on meta tensors over a fake process group (port of
``repro.launch.dryrun``).

For each cell this builds the abstract state (DTensors over meta blocks,
``launch.specs``), runs the port's OWN ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` once inside
``activation_sharding`` under ``analysis.op_cost.counting``, and writes
one JSON artifact under ``artifacts/dryrun_torch/`` in the reference's
schema: per-device FLOPs, bytes, collective bytes by kind and source,
and the peak of live bytes, with nothing allocated.

What the port cannot reproduce, and how the artifact says so:
  * There is no compiled module and no fusion: ``cost.hbm_bytes`` is the
    eager program's traffic (every op's operands and outputs), and
    ``xla_flops`` / ``xla_bytes_accessed`` are null. ``lower_s`` is the
    time to build the abstract state, ``compile_s`` the time to trace.
  * Only rank 0 is traced, over a backend that moves nothing: collective
    bytes are counted, not timed.
  * The dense decoders' train, prefill and decode steps compute
    tensor-parallel over "model" (``runtime/steps.py``,
    ``dist/tensor_parallel.py``): each parameter gathered over the FSDP
    axes to its TP-only block once a step, each product split where its
    weight is cut, the collectives over "model" counted by source (a
    decode step's gather of the token's heads, the two reduces of its
    partial-softmax merge, the row-parallel reduces). Their decode caches
    stay in their rules' layout: cut along their rows under
    ``sp_decode`` (K3's partial form over the rank's rows), along their
    kv heads under ``no_sp_decode`` where those divide "model". Every
    step of the other families (MoE, MLA, the Mamba2 hybrid, xLSTM, the
    audio encoder) gathers every parameter whole and computes the same
    rows along "model": there the per-device FLOPs and peak exceed the
    reference's, ``variant_note`` says so, and ``useful_ratio``
    (``analysis.roofline``) and ``fits`` (peak <= the card's 80 GiB) show
    it cell by cell.
  * Variants that only change XLA's layout trace the baseline program;
    ``variant_note`` names what was dropped. ``zero1`` hands the step the
    TP-only layout (``sharding.tp_rules``) as ``gather_shardings``, as
    the reference's does; the baseline derives the same layout from the
    parameters' own placements.
  * Decode caches are built on meta at full length (``long_500k``'s
    524,288 rows too): they cost nothing here, and ``fits`` judges them.
    The decode kernels count every row of the rank's block as live (a
    full cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--multi-pod] [--variant baseline]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The fake group fixes its world size for the process: one process runs
one mesh (256 or 512 ranks).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis.op_cost import counting, tensor_bytes
from repro_torch.analysis.roofline import WHOLE_MARK
from repro_torch.configs import SHAPES, cell_status, get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    DEFAULT_RULES, PURE_DP_RULES, ShardingRules, activation_sharding, make_sharding_fn,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    abstract_state, decode_input_specs, gather_shardings, global_batch, prefill_input_specs,
    train_input_specs,
)
from repro_torch.models.layers import ParamSpec, tree_map
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["ARTIFACTS", "CARD_BYTES", "WHOLE_NOTE", "variant_note", "rules_for", "dp_axes_for", "accum_for",
           "seq_axis_for", "optimizer_for", "apply_variant", "dryrun_cell", "trace_cell",
           "main"]

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
#: Device memory of one H100 SXM5 80GB: a cell ``fits`` if its peak does not exceed it.
CARD_BYTES = 80 * 2**30

#: Variants whose effect in the reference is a layout XLA alone acts on:
#: the port traces the baseline program for them.
_LAYOUT_ONLY = {
    "zero1_state": "the TP-only parameter layout dropped: the port's optimizer steps "
                   "blocks laid out as their parameters",
    "zero1_state_noseq": "the TP-only parameter layout dropped (as zero1_state); "
                         "the port's activations carry no sequence layout",
    "seq_shard": "the port's activations are plain tensors: no sequence layout",
    "no_seq_shard": "the port's activations are plain tensors: no sequence layout",
}


#: ``variant_note`` of a cell whose step gathers every parameter whole.
WHOLE_NOTE = (f"{WHOLE_MARK}: tensor-parallel compute covers the dense decoders' train, "
              "prefill and decode steps")


def variant_note(model: Model, variant: str):
    """What the cell's trace leaves out: a layout-only variant's dropped
    layout, and the whole gather of a step without tensor-parallel
    compute; None where nothing is."""
    notes = [_LAYOUT_ONLY.get(variant)]
    if not model.tensor_parallel:
        notes.append(WHOLE_NOTE)
    notes = [n for n in notes if n]
    return "; ".join(notes) or None


# -- the reference's policy functions, word for word ------------------------

def rules_for(cfg: ModelConfig, variant: str, kind: str) -> ShardingRules:
    if variant == "pure_dp":
        return PURE_DP_RULES
    rules = DEFAULT_RULES
    if cfg.name.startswith("deepseek"):
        rules = rules.replace(embed=("pod", "data"))  # pod-wide ZeRO for 671B
    if kind == "decode" and variant != "no_sp_decode":
        # Sequence-parallel KV caches: the only way 32k x 128 caches fit
        # when kv_heads < the model-axis width (distributed flash-decode).
        rules = rules.replace(act_kv_seq="model")
    return rules


def dp_axes_for(variant: str):
    return ("pod", "data", "model") if variant == "pure_dp" else None


def accum_for(cfg: ModelConfig, kind: str, variant: str = "baseline") -> int:
    """Gradient-accumulation microbatches for train cells (memory)."""
    if kind != "train":
        return 1
    if variant in ("zero1_state_noseq", "accum8"):
        return 8
    if cfg.param_count() > 100e9:
        return 8
    if cfg.d_model >= 8192:
        return 4
    return 1


def seq_axis_for(cfg: ModelConfig, kind: str, variant: str):
    # Megatron-style sequence-parallel activations for the wide archs.
    if variant in ("no_seq_shard", "zero1_state_noseq"):
        return None
    if kind == "train" and cfg.d_model >= 4096:
        return "model"
    return None


def optimizer_for(cfg: ModelConfig):
    # Adafactor for the giant configs (fits 16 GB/chip), AdamW elsewhere.
    if cfg.param_count() > 20e9:
        return get_optimizer("adafactor")
    return get_optimizer("adamw")


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    if variant == "baseline":
        return cfg
    if variant == "mla_absorb":
        return dataclasses.replace(cfg, mla_absorb=True)
    if variant == "mla_materialize":
        return dataclasses.replace(cfg, mla_absorb=False)
    if variant == "no_remat":
        return dataclasses.replace(cfg, remat="none")
    if variant == "selective_remat":
        return dataclasses.replace(cfg, remat="selective")
    if variant in ("moe_ep", "moe_grouped"):
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, dispatch="model" if variant == "moe_ep" else "grouped"
            )
        )
    if variant in ("sp_decode", "no_sp_decode", "seq_shard", "no_seq_shard",
                   "zero1", "zero1_state", "zero1_state_noseq", "pure_dp",
                   "accum8"):
        return cfg
    raise ValueError(f"unknown variant {variant}")


# -- one cell -----------------------------------------------------------------

def _names(multi_pod: bool, cfg_name: str, shape_name: str, variant: str):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    return mesh_name, f"{cfg_name}__{shape_name}__{mesh_name}__{variant}"


def trace_cell(cfg: ModelConfig, shape, mesh, variant: str = "baseline"):
    """Build the abstract state of one cell on ``mesh`` and run its step
    once under the counter -> (OpCost, output bytes, seconds to build,
    seconds to trace, accum, seq_axis)."""
    rules = rules_for(cfg, variant, shape.kind)
    model = Model(cfg)
    seq_axis = seq_axis_for(cfg, shape.kind, variant)
    accum = accum_for(cfg, shape.kind, variant)
    t0 = time.time()
    with activation_sharding(mesh, seq_axis=seq_axis, dp_axes=dp_axes_for(variant),
                             rules=rules):
        if shape.kind == "train":
            optimizer = optimizer_for(cfg)
            params, opt_state = abstract_state(model, mesh, rules, optimizer)
            shardings = tree_map(make_sharding_fn(mesh, rules), model.param_specs(),
                                 is_leaf=lambda x: isinstance(x, ParamSpec))
            gather = gather_shardings(model, mesh, rules) if variant == "zero1" else None
            step = make_train_step(model, optimizer, accum_steps=accum,
                                   param_shardings=shardings, gather_shardings=gather)
            args = (params, opt_state,
                    global_batch(train_input_specs(cfg, shape, mesh, rules=rules)))
        elif shape.kind == "prefill":
            params, _ = abstract_state(model, mesh, rules)
            step = make_prefill_step(model)
            args = (params, global_batch(prefill_input_specs(cfg, shape, mesh))["inputs"])
        else:  # decode
            params, _ = abstract_state(model, mesh, rules)
            step = make_decode_step(model)
            ins = global_batch(decode_input_specs(cfg, shape, mesh, rules))
            args = (params, ins["token"], ins["caches"], ins["cache_index"])
        t_build = time.time() - t0
        with counting(args) as cost:
            out = step(*args)
        t_trace = time.time() - t0 - t_build
    # The rank's own output: a DTensor's local block.
    out = tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, out,
                   is_leaf=torch.is_tensor)
    return cost, tensor_bytes(out), t_build, t_trace, accum, seq_axis


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                variant: str = "baseline", save: bool = True) -> dict:
    """Trace one cell on the production mesh (a fake group of 256 or 512
    ranks) and return (and save) its artifact."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = cell_status(cfg, shape_name)
    mesh_name, cell_id = _names(multi_pod, cfg.name, shape_name, variant)
    if skip is not None:
        result = {"cell": cell_id, "status": "SKIP", "reason": skip}
        if save:
            _save(result)
        return result

    cfg = apply_variant(cfg, variant)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cost, out_bytes, t_build, t_trace, accum, seq_axis = trace_cell(cfg, shape, mesh, variant)
    peak = cost.peak_bytes
    d = cost.as_dict()
    result = {
        "cell": cell_id,
        "status": "OK",
        "arch": cfg.name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "variant": variant,
        "variant_note": variant_note(Model(cfg), variant),
        "n_devices": mesh.size(),
        "lower_s": round(t_build, 1),
        "compile_s": round(t_trace, 1),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "accum_steps": accum,
        "seq_axis": seq_axis,
        "memory": {
            "argument_bytes": cost.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - cost.argument_bytes,
            "peak_bytes": peak,
        },
        "fits": peak <= CARD_BYTES,
        "cost": {
            # No compiled module: XLA's own figures have no counterpart.
            "xla_flops": None,
            "xla_bytes_accessed": None,
            "flops": cost.flops,
            "hbm_bytes": cost.hbm_bytes,
            "unknown_trip_counts": cost.unknown_trip_counts,
        },
        "collectives": d["collective_bytes"],
        "collective_counts": d["collective_counts"],
        "collective_top_sources": [[src, b] for src, b in cost.top_collective_sources(10)],
        "kernel_work": d["kernel_work"],
        "n_ops": cost.n_ops,
    }
    if save:
        _save(result)
    return result


def _save(result: dict) -> None:
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    (ARTIFACTS / f"{result['cell']}.json").write_text(json.dumps(result, indent=2))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", type=str, default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]

    failures = 0
    for arch, shape_name in cells:
        _, cell_id = _names(args.multi_pod, get_config(arch).name, shape_name, args.variant)
        if args.skip_existing and (ARTIFACTS / f"{cell_id}.json").exists():
            prev = json.loads((ARTIFACTS / f"{cell_id}.json").read_text())
            print(f"[cached] {cell_id}: {prev['status']}", flush=True)
            continue
        try:
            r = dryrun_cell(arch, shape_name, multi_pod=args.multi_pod, variant=args.variant)
            if r["status"] == "OK":
                mem_gb = r["memory"]["peak_bytes"] / 2**30
                print(
                    f"[ok] {cell_id}: {mem_gb:.2f} GiB/device, "
                    f"flops={r['cost']['flops']:.3e}, "
                    f"hbm={r['cost']['hbm_bytes']:.3e}, "
                    f"coll={sum(r['collectives'].values())/2**30:.3f} GiB "
                    f"(lower {r['lower_s']}s compile {r['compile_s']}s)",
                    flush=True,
                )
            else:
                print(f"[skip] {cell_id}: {r['reason']}", flush=True)
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures += 1
            print(f"[FAIL] {cell_id}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
