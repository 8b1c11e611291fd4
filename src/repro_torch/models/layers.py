"""Common layers, spec-first (port of ``repro.models.layers``).

Every layer exposes ``*_specs(...) -> dict[name, ParamSpec]`` describing
shape, dtype, logical axes and initializer, plus a plain apply function on
tensors. ``init_from_specs`` materializes a spec tree with an explicit
``torch.Generator`` (so the values differ from the reference's
``jax.random`` bits; tests carry the reference's values across with
``bridge.params_from_numpy``).

Trees are nested dicts and lists; ``tree_map`` / ``tree_leaves`` walk
them. Unlike the reference, the slot helpers mutate the pooled cache in
place where that saves a copy of the whole pool, and say so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.tensor_parallel import copy_to_tp, reduce_from_tp
from repro_torch.kernels import rms_norm as _rms_norm_kernel

__all__ = [
    "ParamSpec",
    "DTYPES",
    "tree_map",
    "tree_leaves",
    "init_from_specs",
    "count_specs",
    "batch_axis_of",
    "is_paged_spec",
    "slot_read",
    "slot_write",
    "slot_reset",
    "slot_take",
    "slot_block_copy",
    "slot_mask_select_",
    "rms_norm",
    "layer_norm",
    "norm_apply",
    "norm_specs",
    "rope_freqs",
    "apply_rope",
    "mlp_specs",
    "mlp_apply",
    "activation",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | scaled(fan_in)
    dtype: str = "bfloat16"
    scale: float = 1.0                # stddev multiplier for normal inits

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = _is_spec):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples, walking
    ``rest`` (same structure) in lockstep with ``tree``."""
    if is_leaf(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    return type(tree)(
        tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
        for i, t in enumerate(tree)
    )


def tree_leaves(tree, is_leaf: Callable = _is_spec) -> List:
    out: List = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


def _fan_in(shape: Tuple[int, ...]) -> int:
    # Convention: the LAST axis is the output axis; everything else is input.
    return max(int(np.prod(shape[:-1])), 1) if len(shape) > 1 else max(shape[0], 1)


def init_from_specs(specs, generator: torch.Generator, device):
    """Materialize a param tree from a ParamSpec tree, drawing every
    random leaf from ``generator`` (which must live on ``device``) in
    tree order."""
    def make(spec: ParamSpec) -> torch.Tensor:
        dt = DTYPES[spec.dtype]
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "normal":
            std = 0.02 * spec.scale
        elif spec.init == "scaled":
            std = spec.scale / math.sqrt(_fan_in(spec.shape))
        else:
            raise ValueError(f"unknown init {spec.init}")
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        # In place: a leaf's f32 draw is its only temporary (deepseek's
        # (256, 7168, 2048) expert leaves draw 14 GiB each).
        return w.mul_(std).to(dt)

    return tree_map(make, specs)


def count_specs(specs) -> int:
    return sum(s.size for s in tree_leaves(specs))


# ---------------------------------------------------------------------------
# Slot-indexed cache helpers (repro_torch.serve)
#
# Serving caches are trees whose leaves each carry an "act_batch" axis
# (contiguous KV stripes, one per slot) or are paged block arenas (axes
# "kv_blocks"/"kv_block"), whose slot membership lives in the host-side
# block table. Every helper walks (values, specs) together: read passes
# an arena through, write adopts it, reset/take leave it alone.
# ---------------------------------------------------------------------------

def is_paged_spec(spec: ParamSpec) -> bool:
    """True for block-arena cache leaves (slot axis replaced by a
    (kv_blocks, kv_block) pair addressed through a block table)."""
    return "kv_blocks" in spec.axes


def batch_axis_of(spec: ParamSpec) -> int:
    """Index of the slot ("act_batch") axis of a cache leaf."""
    return spec.axes.index("act_batch")


def slot_read(caches, specs, slot: int):
    """One slot as a batch-1 cache tree. Contiguous leaves are VIEWS into
    the pool (a prefill through them writes the pool in place); paged
    arenas pass through whole."""
    def read(c, s):
        if is_paged_spec(s):
            return c
        return c.narrow(batch_axis_of(s), slot, 1)
    return tree_map(read, caches, specs)


def slot_write(caches, specs, slot: int, slot_caches):
    """Write a batch-1 cache tree into slot ``slot`` of the pooled cache,
    in place. A leaf that already is the pool's own view or arena (what
    ``slot_read`` handed out) needs no copy."""
    def write(c, s, v):
        dst = c if is_paged_spec(s) else c.narrow(batch_axis_of(s), slot, 1)
        if v.data_ptr() != dst.data_ptr() or v.shape != dst.shape:
            dst.copy_(v)
        return c
    return tree_map(write, caches, specs, slot_caches)


def slot_reset(caches, specs, slot: int):
    """Restore one slot to its spec-defined initial value (zeros/ones), in
    place. Paged leaves are untouched: freed blocks are recycled by the
    BlockManager and overwritten on reallocation."""
    def reset(c, s):
        if not is_paged_spec(s):
            c.narrow(batch_axis_of(s), slot, 1).fill_(1.0 if s.init == "ones" else 0.0)
        return c
    return tree_map(reset, caches, specs)


def slot_take(caches, specs, perm: torch.Tensor):
    """Permute slots (defrag). Returns new contiguous leaves; paged leaves
    are a no-op (block tables are host arrays that permute for free)."""
    def take(c, s):
        if is_paged_spec(s):
            return c
        return torch.index_select(c, batch_axis_of(s), perm.to(c.device))
    return tree_map(take, caches, specs)


def slot_block_copy(caches, specs, src: int, dst: int):
    """Copy arena block ``src`` into block ``dst`` on every paged leaf, in
    place: the device half of a copy-on-write fork. The BlockManager swaps
    the writer's table entry to ``dst`` on the host; after this copy a
    write through the writer's table lands in the private clone, never in
    the shared original. Contiguous leaves are never shared and stay."""
    def cp(c, s):
        if is_paged_spec(s):
            ax = s.axes.index("kv_blocks")
            c.select(ax, dst).copy_(c.select(ax, src))
        return c
    return tree_map(cp, caches, specs)


def slot_mask_select_(state: torch.Tensor, new: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``slot_mask_select`` for one recurrent state leaf
    (batch on axis 0), in place: lanes where ``mask`` (B,) is True take
    ``new``, the others keep ``state``; ``mask`` None takes every lane.

    The reference selects every contiguous leaf after the tick. The port
    selects only the recurrent states (no sequence axis), inside the layer
    that updates them: a K/V row a masked lane writes lies at or past its
    length and is rewritten before anything reads it, but a recurrent
    state would absorb the lane's token for good."""
    if mask is None:
        return state.copy_(new)
    keep = mask.to(state.device).reshape(-1, *([1] * (state.dim() - 1)))
    return state.copy_(torch.where(keep, new.to(state.dtype), state))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(d: int, kind: str, dtype: str) -> Dict[str, ParamSpec]:
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {kind!r}")
    out = {"scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype)}
    if kind == "layernorm":
        out["bias"] = ParamSpec((d,), ("embed",), init="zeros", dtype=dtype)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``layers.rms_norm`` through kernel K2 (plain PyTorch on the CPU)."""
    return _rms_norm_kernel(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """``layers.layer_norm`` in its order and roundings: f32 mean and
    population variance, ``(x - mean) * rsqrt(var + eps)`` rounded to x's
    dtype, then ``* scale`` and ``+ bias`` in that dtype. Plain PyTorch:
    the reference has no kernel here (``F.layer_norm`` would apply the
    affine before the rounding)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(dt) * scale
    if bias is not None:
        y = y + bias
    return y


def norm_apply(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"))
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,) in float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Split-half rotation computed in f32, rounded back to x's dtype."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs    # (..., s, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP / gated FFN
# ---------------------------------------------------------------------------

def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def mlp_specs(d: int, d_ff: int, glu: bool, dtype: str) -> Dict[str, ParamSpec]:
    out = {
        "w_in": ParamSpec((d, d_ff), ("embed", "ffn"), init="scaled", dtype=dtype),
        "w_out": ParamSpec((d_ff, d), ("ffn", "embed"), init="scaled", dtype=dtype),
    }
    if glu:
        out["w_gate"] = ParamSpec(
            (d, d_ff), ("embed", "ffn"), init="scaled", dtype=dtype
        )
    return out


def mlp_apply(params: Dict, x: torch.Tensor, act: str, glu: bool,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The (gated) MLP. Under a tensor-parallel view, ``w_in`` / ``w_gate``
    holding fewer than ``d_ff`` columns are the rank's ffn block: the
    products are column-parallel on them and row-parallel on ``w_out``,
    whose partial sum is made whole before it is returned."""
    split = d_ff is not None and params["w_in"].shape[-1] != d_ff
    if split:
        x = copy_to_tp(x)
    h = x @ params["w_in"]
    if glu:
        g = x @ params["w_gate"]
        h = activation(act)(g) * h
    else:
        h = activation(act)(h)
    out = h @ params["w_out"]
    return reduce_from_tp(out) if split else out
