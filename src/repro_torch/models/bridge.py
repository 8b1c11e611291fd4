"""Carry the reference's parameters into the port.

``params_from_numpy(cfg, tree)`` takes the reference model's parameter
tree after it was converted to numpy arrays (``Model(cfg).init(key)``
mapped through ``np.asarray``) and returns the port's parameter tree
with the same values, each leaf in its own spec's dtype (the Mamba2
decay rates, dt biases and skips are f32 in a bf16 model). The reference
stacks layers on a leading axis; the port keeps one dict per layer, so
each stacked leaf is cut along that axis: a segment's layers (an MoE
layer's (E, ...) expert weights stay stacked within the layer), or the
hybrid's ``stack["mamba"]`` (its per-call LoRA stacks stay stacked, as
in the port's specs). Other subtrees (DeepSeek's ``mtp`` head, a single
block, unstacked in both) cross as they are. Nothing here imports JAX:
the caller converts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from .layers import DTYPES, tree_map
from .model import Model

__all__ = ["params_from_numpy"]


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _unstack(tree, count: int):
    """One tree per layer from a tree whose leaves stack ``count`` layers."""
    return [tree_map(lambda a, i=i: np.asarray(a)[i], tree, is_leaf=_is_array)
            for i in range(count)]


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's parameter tree for ``cfg`` holding the values of the
    reference tree ``tree`` (numpy leaves), each leaf in its spec's dtype,
    on ``device``."""
    dev = resolve_device(device)
    model = Model(cfg)
    tree = dict(tree)
    if model.is_hybrid:
        stack = dict(tree["stack"])
        stack["mamba"] = _unstack(stack["mamba"], cfg.n_layers)
    else:
        segs = model.segments
        if len(tree["stack"]) != len(segs):
            raise ValueError(f"tree has {len(tree['stack'])} segments, config "
                             f"{cfg.name} has {len(segs)}")
        stack = [[seg_tree] if seg.count == 1 else _unstack(seg_tree, seg.count)
                 for seg, seg_tree in zip(segs, tree["stack"])]
    tree["stack"] = stack

    def conv(a, spec) -> torch.Tensor:
        if tuple(np.shape(a)) != tuple(spec.shape):
            raise ValueError(f"leaf of shape {np.shape(a)} where the spec says {spec.shape}")
        # bf16 numpy arrays (ml_dtypes) have no torch twin: widen to f32
        # first, which is exact, then round back in torch.
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=dev, dtype=DTYPES[spec.dtype])

    return tree_map(conv, tree, model.param_specs(), is_leaf=_is_array)
