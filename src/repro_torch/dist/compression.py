"""Gradient compression with error feedback (port of
``repro.dist.compression``).

The paper's scheme trades a slight increase in communication load
(smaller beta -> more iterations -> more result uploads) for reduced
computation. This module buys that communication back: workers upload
int8-quantized results and carry the quantization error forward into the
next round (error feedback, as in EF-SGD), which restores convergence to
the uncompressed fixed point.

``Int8Codec`` is a per-tensor absmax codec: 4x smaller uploads than
float32 with a largest elementwise error of scale/2. ``ef_compress_tree``
applies it leaf by leaf over a gradient tree (nested dicts, lists or
tuples of tensors, as ``params_from_numpy`` builds them) while threading
the residual state. Plain PyTorch, on whatever device the tensors are on.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["Int8Codec", "ef_compress_tree"]


class Int8Codec:
    """Per-tensor symmetric absmax int8 quantization."""

    @staticmethod
    def encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (float) -> (q int8, scale float32 0-d); x ~= q * scale."""
        xf = x.float()
        # Divide by a device tensor, not a Python float: CUDA divides by a
        # CPU scalar as a product with its reciprocal, one rounding away
        # from the IEEE quotient the reference computes.
        scale = xf.abs().max() / torch.full((), 127.0, device=xf.device)
        safe = torch.clamp(scale, min=torch.finfo(torch.float32).tiny)
        # torch.round rounds half to even, as jnp.round does.
        q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
        return q, scale

    @staticmethod
    def decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return q.float() * scale


def _structure(tree):
    """A comparable description of a tree's containers (dict keys in
    sorted order, as a jax treedef sees them)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "leaf"


def _ef(g, r):
    if isinstance(g, dict):
        pairs = {k: _ef(g[k], r[k]) for k in g}
        return {k: d for k, (d, _) in pairs.items()}, {k: n for k, (_, n) in pairs.items()}
    if isinstance(g, (list, tuple)):
        pairs = [_ef(a, b) for a, b in zip(g, r)]
        return type(g)(d for d, _ in pairs), type(g)(n for _, n in pairs)
    v = g.float() + r.float()
    d = Int8Codec.decode(*Int8Codec.encode(v))
    return d.to(g.dtype), v - d


def ef_compress_tree(grads, residual):
    """Quantize a gradient tree with error feedback.

    Each leaf is compensated (``g + residual``), int8 round-tripped, and
    the new residual is the quantization error. Returns
    ``(decoded_grads, new_residual)`` with the input tree's structure: the
    decoded values (in each gradient leaf's dtype) are what the aggregator
    would rebuild from the workers' int8 uploads; the residuals are
    float32.
    """
    if _structure(grads) != _structure(residual):
        raise ValueError(
            f"grads and residual tree structures do not match: "
            f"{_structure(grads)} vs {_structure(residual)}"
        )
    return _ef(grads, residual)
