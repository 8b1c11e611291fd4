"""Optimizers of the training slice (port of ``repro.optim.optimizers``):
SGD and AdamW, with global-norm clipping, in plain tensor code.

The API mirrors the reference's: ``init(params) -> state`` and
``update(grads, state, params, lr) -> (updates, state)``, applied with
``apply_updates``. Trees are the port's nested dicts and lists of
tensors. Every update is computed in f32 and cast to the parameter's
dtype only in ``apply_updates``, in the reference's order. Unlike the
reference (pure functions), AdamW updates its f32 moment tensors IN
PLACE and returns the same state: at llama3.2-1b's width the two
moments are 10 GB, and a second copy per step would be pure waste.

Momentum and Adafactor wait for a slice that needs them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map

__all__ = [
    "Optimizer",
    "sgd",
    "adamw",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "get_optimizer",
]


def _map(fn: Callable, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=torch.is_tensor)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (updates, new_state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree, is_leaf=torch.is_tensor)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm); each leaf keeps its
    dtype (scaled in f32, then cast back)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def apply_updates(params, updates):
    """p + u, with the update cast to the parameter's dtype first."""
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return _map(lambda g: -lr * g.float(), grads), state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments, bias correction, and decoupled weight decay
    folded into the update: u = -lr (m^ / (sqrt(v^) + eps) + wd p)."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": _map(zeros, params), "v": _map(zeros, params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        # Bias corrections in f32, as the reference forms them; an f32
        # value held in a Python float enters every op below exactly.
        c1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
        c2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))

        def one(m, v, g, p):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            mh = m / c1
            vh = v / c2
            return -lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p.float())

        upd = _map(one, state["m"], state["v"], grads, params)
        return upd, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name == "adamw":
        return adamw(**kw)
    if name in ("momentum", "adafactor"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(f"unknown optimizer {name}")
