"""Distributed-execution substrate of the port (``repro.dist``): the
logical-axis sharding rules and the ambient activation-sharding context
on ``torch.distributed`` (``sharding.py``), masked fastest-k aggregation
(``collectives.py``), tensor-parallel compute over ``"model"``
(``tensor_parallel.py``), the int8 error-feedback codec
(``compression.py``) and GPipe over a mesh axis (``pipeline_parallel.py``).

A mesh is a ``DeviceMesh`` (``make_mesh``); parameters and optimizer
state on it are DTensors laid out by the rules, and the train step
(``repro_torch.runtime.steps``) runs the loss on each rank's rows of the
batch: the dense decoders' tensor-parallel on the rank's blocks of the
TP-only layout, the other families on full parameters."""

from .collectives import check_worker_major, contributors, example_weights, masked_weighted_ce
from .compression import Int8Codec, ef_compress_tree
from .sharding import (
    DEFAULT_RULES,
    FSDP_POD_RULES,
    PURE_DP_RULES,
    SP_DECODE_RULES,
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    activation_sharding,
    batch_pspec,
    constrain_batch,
    constrain_logical,
    logical_to_pspec,
    make_mesh,
    make_sharding_fn,
    shard_slices,
    shard_tree,
)

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "FSDP_POD_RULES",
    "PURE_DP_RULES",
    "SP_DECODE_RULES",
    "PartitionSpec",
    "NamedSharding",
    "logical_to_pspec",
    "batch_pspec",
    "make_sharding_fn",
    "shard_slices",
    "shard_tree",
    "make_mesh",
    "activation_sharding",
    "constrain_batch",
    "constrain_logical",
    "check_worker_major",
    "contributors",
    "example_weights",
    "masked_weighted_ce",
    "Int8Codec",
    "ef_compress_tree",
]
