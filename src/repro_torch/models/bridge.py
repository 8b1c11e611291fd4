"""Carry the reference's parameters into the port.

``params_from_numpy(cfg, tree)`` takes the reference model's parameter
tree after it was converted to numpy arrays (``Model(cfg).init(key)``
mapped through ``np.asarray``) and returns the port's parameter tree
with the same values. The reference stacks a segment's layers on a
leading axis; the port keeps one dict per layer, so each stacked leaf is
cut along that axis. Nothing here imports JAX: the caller converts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from .layers import DTYPES, tree_map
from .transformer import segment_plan

__all__ = ["params_from_numpy"]


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's parameter tree for ``cfg`` holding the values of the
    reference tree ``tree`` (numpy leaves), in ``cfg.dtype`` on ``device``."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]

    def conv(a) -> torch.Tensor:
        # bf16 numpy arrays (ml_dtypes) have no torch twin: widen to f32
        # first, which is exact, then round back in torch.
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device=dev, dtype=dt)

    segs = segment_plan(cfg)
    if len(tree["stack"]) != len(segs):
        raise ValueError(f"tree has {len(tree['stack'])} segments, config "
                         f"{cfg.name} has {len(segs)}")
    out = {k: tree_map(conv, v, is_leaf=_is_array)
           for k, v in tree.items() if k != "stack"}
    stack = []
    for seg, seg_tree in zip(segs, tree["stack"]):
        if seg.count == 1:
            layers = [seg_tree]
        else:
            layers = [tree_map(lambda a, i=i: np.asarray(a)[i], seg_tree, is_leaf=_is_array)
                      for i in range(seg.count)]
        stack.append([tree_map(conv, layer, is_leaf=_is_array) for layer in layers])
    out["stack"] = stack
    return out
