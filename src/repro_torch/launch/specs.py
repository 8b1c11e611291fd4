"""Meta-tensor stand-ins for every (arch x shape) cell (port of
``repro.launch.specs``).

No storage: the dry run traces against these. Where the reference's
``ShapeDtypeStruct`` carries a sharding, the stand-in is a DTensor over
the mesh, its local block a meta tensor laid out as
``repro_torch.dist.sharding.NamedSharding`` places the same spec.
Parameters come from ``Model.param_specs`` through the rules (and
``gather_shardings`` gives their TP-only layout, which the dense
decoders' tensor-parallel steps compute on); the
optimizer state from the port's own DTensor-aware ``Optimizer.init`` on
those parameters (each leaf laid out as its parameter, Adafactor's row
and column statistics without the reduced dim), not from matching shapes
as the reference attaches it.

The port's steps take the GLOBAL batch on every rank and cut their own
rows (``row_split``), so ``global_batch`` turns the batch stand-ins into
plain meta tensors of the global shapes for the call; ``lr`` is a host
float, as the train step reads ``float(batch["lr"])``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist.sharding import (
    NamedSharding, PartitionSpec as P, ShardingRules, batch_pspec, make_sharding_fn, tp_rules,
)
from repro_torch.models.layers import DTYPES, ParamSpec, tree_map
from repro_torch.models.model import Model

__all__ = ["train_input_specs", "prefill_input_specs", "decode_input_specs",
           "abstract_state", "gather_shardings", "n_workers_for", "global_batch", "stand_in"]

#: The learning rate the dry run's train step is given.
DRY_LR = 1e-4


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def n_workers_for(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= _sizes(mesh).get(a, 1)
    return n


def stand_in(shape, dtype: torch.dtype, mesh, pspec) -> DTensor:
    """A DTensor of global ``shape`` laid out by ``pspec`` on ``mesh``,
    its local block a meta tensor; without a mesh, a plain meta tensor."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    placements = NamedSharding(mesh, pspec).placements
    local = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh,
                              placements, run_check=False)


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, *, beta: float = 1.0,
                      rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """Batch stand-ins for the train step. beta scales the per-worker batch
    (the paper's computation-load knob; it changes the step's shapes)."""
    n = n_workers_for(mesh)
    B = shape.global_batch
    per_worker = max(int(round(B * beta)) // n, 1)
    Bb = per_worker * n
    S = shape.seq_len
    dp = None
    if rules is not None:
        ab = rules.get("act_batch")
        if ab is not None:
            dp = (ab,) if isinstance(ab, str) else tuple(ab)
    if cfg.input_kind == "tokens":
        inputs = stand_in((Bb, S), torch.int32, mesh, batch_pspec(mesh, Bb, 1, dp_axes=dp))
    else:
        inputs = stand_in((Bb, S, cfg.d_model), DTYPES[cfg.dtype], mesh,
                          batch_pspec(mesh, Bb, 2, dp_axes=dp))
    return {
        "inputs": inputs,
        "labels": stand_in((Bb, S), torch.int32, mesh, batch_pspec(mesh, Bb, 1, dp_axes=dp)),
        "worker_mask": stand_in((n,), torch.float32, mesh, P()),
        "lr": DRY_LR,
    }


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_kind == "tokens":
        inputs = stand_in((B, S), torch.int32, mesh, batch_pspec(mesh, B, 1))
    else:
        inputs = stand_in((B, S, cfg.d_model), DTYPES[cfg.dtype], mesh,
                          batch_pspec(mesh, B, 2))
    return {"inputs": inputs}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       rules: ShardingRules) -> Dict[str, Any]:
    """One-token decode against a cache of length ``shape.seq_len``: the
    token, the caches (DTensors laid out by ``rules``) and the position
    written, a 0-dim int32 meta tensor."""
    model = Model(cfg)
    B, S = shape.global_batch, shape.seq_len
    sharding_for = make_sharding_fn(mesh, rules)
    caches = tree_map(lambda s: stand_in(s.shape, DTYPES[s.dtype], mesh, sharding_for(s).spec),
                      model.cache_specs(B, S), is_leaf=lambda x: isinstance(x, ParamSpec))
    return {
        "token": stand_in((B, 1), torch.int32, mesh, batch_pspec(mesh, B, 1)),
        "caches": caches,
        "cache_index": torch.empty((), dtype=torch.int32, device="meta"),
    }


def abstract_state(model: Model, mesh, rules: ShardingRules, optimizer=None):
    """(params, opt_state) as DTensors over meta blocks, laid out by
    ``rules`` (plain meta tensors with ``mesh`` None); the state is
    ``optimizer.init(params)`` (None without an optimizer)."""
    sharding_for = None if mesh is None else make_sharding_fn(mesh, rules)

    def one(s: ParamSpec):
        spec = None if sharding_for is None else sharding_for(s).spec
        return stand_in(s.shape, DTYPES[s.dtype], mesh, spec)

    params = tree_map(one, model.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    if optimizer is None:
        return params, None
    return params, optimizer.init(params)


def gather_shardings(model: Model, mesh, rules: ShardingRules):
    """Every parameter's TP-only layout (``sharding.tp_rules``: the FSDP
    axis replicated), the reference's ZeRO-1 ``gather_shardings``: the
    blocks the tensor-parallel train step gathers each parameter to."""
    return tree_map(make_sharding_fn(mesh, tp_rules(rules)), model.param_specs(),
                    is_leaf=lambda x: isinstance(x, ParamSpec))


def global_batch(specs: Dict[str, Any]) -> Dict[str, Any]:
    """The batch the port's steps take: each DTensor stand-in as a plain
    meta tensor of its global shape (every rank is given the whole batch
    and cuts its rows); other entries as they are."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            if isinstance(v, DTensor) else v for k, v in specs.items()}
