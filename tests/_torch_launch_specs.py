"""Dump the dry run's stand-ins of every (arch x shape) cell as JSON, from
the reference (``ref``: 512 forced host devices) or from the port
(``port MESH``: a fake process group of 256 or 512 ranks), for
``tests/test_torch_launch.py``:

    python tests/_torch_launch_specs.py ref OUT.json
    python tests/_torch_launch_specs.py port pod16x16 OUT.json

Each cell maps "inputs", "params" and (train) "opt_state" to trees of
leaves ``{"shape", "dtype", "spec"}`` (``spec`` a list of None, axis
names or lists of them, trailing Nones trimmed; None for a host scalar or
a leaf with no layout). The reference's opt-state leaves also carry
``own``: the spec of the parameter leaf they belong to, less the reduced
dim (Adafactor's row and column statistics).
"""

import json
import os
import sys

MESHES = {"pod16x16": False, "pod2x16x16": True}


def _trim(entries):
    entries = [list(e) if isinstance(e, tuple) else e for e in entries]
    while entries and entries[-1] is None:
        entries.pop()
    return entries


def ref_main(out_path):
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(["--xla_force_host_platform_device_count=512"] + flags)
    import jax

    from repro.configs import SHAPES, cell_status, get_config, list_archs
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import (abstract_state, decode_input_specs,
                                    prefill_input_specs, train_input_specs)
    from repro.models.model import Model

    def leaf(x):
        sh = getattr(x, "sharding", None)
        spec = None if sh is None else _trim(tuple(sh.spec))
        return {"shape": list(x.shape), "dtype": str(x.dtype), "spec": spec}

    def walk(t):
        if hasattr(t, "_asdict"):
            return {k: walk(v) for k, v in t._asdict().items()}
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    class Own:
        def __init__(self, spec):
            self.spec = spec

    def own_specs(state, params):
        """Each opt-state leaf's own spec, derived from its parameter."""
        def one(p, s):
            spec = list(p.sharding.spec) + [None] * (len(p.shape) - len(p.sharding.spec))
            if isinstance(s, dict) and "row" in s:
                return {"row": Own(_trim(spec[:-1])), "col": Own(_trim(spec[:-2] + spec[-1:]))}
            if isinstance(s, dict):
                return {"v": Own(_trim(spec))}
            return Own(_trim(spec))
        return jax.tree.map(one, params, state, is_leaf=lambda x: hasattr(x, "shape"))

    def walk_own(t):
        if isinstance(t, Own):
            return {"spec": t.spec}
        if isinstance(t, dict):
            return {k: walk_own(v) for k, v in t.items()}
        return [walk_own(v) for v in t]

    out = {}
    for mesh_name, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for arch in list_archs():
            cfg = get_config(arch)
            for shape_name, shape in SHAPES.items():
                if cell_status(cfg, shape_name) is not None:
                    continue
                rules = dr.rules_for(cfg, "baseline", shape.kind)
                model = Model(cfg)
                cell = {}
                if shape.kind == "train":
                    params, opt = abstract_state(model, mesh, rules, dr.optimizer_for(cfg))
                    cell["inputs"] = walk(train_input_specs(cfg, shape, mesh, rules=rules))
                    cell["opt_state"] = walk(opt)
                    own = ({"states": own_specs(opt.states, params)} if hasattr(opt, "states")
                           else {"m": own_specs(opt.m, params), "v": own_specs(opt.v, params)})
                    cell["opt_own"] = walk_own(own)
                elif shape.kind == "prefill":
                    params, _ = abstract_state(model, mesh, rules)
                    cell["inputs"] = walk(prefill_input_specs(cfg, shape, mesh))
                else:
                    params, _ = abstract_state(model, mesh, rules)
                    cell["inputs"] = walk(decode_input_specs(cfg, shape, mesh, rules))
                cell["params"] = walk(params)
                out[f"{cfg.name}__{shape_name}__{mesh_name}"] = cell
    out["__policy__"] = policy(dr, get_config, list_archs)
    out["__schema__"] = schema(dr, get_config, SHAPES)
    with open(out_path, "w") as f:
        json.dump(out, f)


#: Every variant the reference's dry run names.
VARIANTS = ("baseline", "mla_absorb", "mla_materialize", "no_remat", "selective_remat",
            "moe_ep", "moe_grouped", "sp_decode", "no_sp_decode", "seq_shard",
            "no_seq_shard", "zero1", "zero1_state", "zero1_state_noseq", "pure_dp",
            "accum8")


def policy(dr, get_config, list_archs):
    """The dry run's policy functions over every arch x variant x kind:
    rules, dp axes, accum, sequence axis, optimizer, varied config."""
    import dataclasses

    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        out[arch] = {"optimizer": dr.optimizer_for(cfg).init.__qualname__}
        for variant in VARIANTS:
            try:
                varied = json.loads(json.dumps(dataclasses.asdict(dr.apply_variant(cfg, variant))))
            except Exception as e:  # noqa: BLE001 - a variant a config cannot take
                varied = f"error: {type(e).__name__}"
            out[arch][variant] = {"config": varied}
            for kind in ("train", "prefill", "decode"):
                out[arch][variant][kind] = json.loads(json.dumps({
                    "rules": dataclasses.asdict(dr.rules_for(cfg, variant, kind)),
                    "dp": dr.dp_axes_for(variant),
                    "accum": dr.accum_for(cfg, kind, variant),
                    "seq": dr.seq_axis_for(cfg, kind, variant)}))
    return out


def schema(dr, get_config, SHAPES):
    """The keys of the reference's artifact: its ``_finish`` on a stub
    compiled module."""
    class Compiled:
        def memory_analysis(self):
            return type("M", (), {"argument_size_in_bytes": 1, "output_size_in_bytes": 1,
                                  "temp_size_in_bytes": 1})()

        def cost_analysis(self):
            return {"flops": 1.0, "bytes accessed": 1.0}

        def as_text(self):
            return "ENTRY %main.1 (p: f32[]) -> f32[] {\n}\n"

    mesh = type("Mesh", (), {"size": 256})()
    art = dr._finish(get_config("smollm-135m"), SHAPES["decode_32k"], mesh, None, "baseline",
                     "cell", "pod16x16", Compiled(), 0.0, 0.0, 1, None, False)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k in ("memory", "cost") else None
                for k, v in d.items()}
    return keys(art)


def port_main(mesh_name, out_path):
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import SHAPES, cell_status, get_config, list_archs
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import (abstract_state, decode_input_specs,
                                          prefill_input_specs, train_input_specs)
    from repro_torch.models.model import Model

    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    names = list(mesh.mesh_dim_names)

    def leaf(x):
        if not torch.is_tensor(x):
            return {"shape": [], "dtype": type(x).__name__, "spec": None}
        dtype = str(x.dtype).replace("torch.", "")
        if not isinstance(x, DTensor):
            return {"shape": list(x.shape), "dtype": dtype, "spec": None}
        entries = [[] for _ in x.shape]
        for i, pl in enumerate(x.placements):
            if pl.is_shard():
                entries[pl.dim].append(names[i])
        spec = [None if not e else (e[0] if len(e) == 1 else e) for e in entries]
        return {"shape": list(x.shape), "dtype": dtype, "spec": _trim(spec)}

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if cell_status(cfg, shape_name) is not None:
                continue
            rules = dr.rules_for(cfg, "baseline", shape.kind)
            model = Model(cfg)
            cell = {}
            if shape.kind == "train":
                params, opt = abstract_state(model, mesh, rules, dr.optimizer_for(cfg))
                cell["inputs"] = walk(train_input_specs(cfg, shape, mesh, rules=rules))
                cell["opt_state"] = walk(opt)
            elif shape.kind == "prefill":
                params, _ = abstract_state(model, mesh, rules)
                cell["inputs"] = walk(prefill_input_specs(cfg, shape, mesh))
            else:
                params, _ = abstract_state(model, mesh, rules)
                cell["inputs"] = walk(decode_input_specs(cfg, shape, mesh, rules))
            cell["params"] = walk(params)
            out[f"{cfg.name}__{shape_name}__{mesh_name}"] = cell
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        ref_main(sys.argv[2])
    else:
        port_main(sys.argv[2], sys.argv[3])
