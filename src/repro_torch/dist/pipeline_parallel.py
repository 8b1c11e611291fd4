"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.dist.pipeline_parallel``).

``stage_params`` splits a layer-stacked parameter tree into per-stage
chunks; ``pipeline_forward`` runs the classic GPipe schedule on the ranks
of one mesh axis: microbatch ``m`` enters stage 0 at tick ``m``, each
tick every stage runs its layers and passes its activation to the next
stage around a ring (``dist.batch_isend_irecv``, every send posted with
its receive, so no rank waits on another's order), and the last stage
emits microbatch ``m`` at tick ``m + n_stages - 1``. Total ticks:
``n_micro + n_stages - 1`` (the usual bubble). A final ``all_reduce``
over the axis replicates the outputs, which only the last stage wrote.

Forward only, as every caller of the reference runs it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import tree_leaves, tree_map

__all__ = ["stage_params", "pipeline_forward"]


def _leaves(tree):
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def stage_params(params, n_stages: int):
    """Split layer-stacked params (L, ...) into (n_stages, L/n_stages, ...).

    Works leaf-wise on trees; every leaf's leading dim must be the layer
    dim and divisible by ``n_stages``."""

    def split(w):
        L = w.shape[0]
        if L % n_stages != 0:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return w.reshape(n_stages, L // n_stages, *w.shape[1:])

    return tree_map(split, params, is_leaf=torch.is_tensor)


def pipeline_forward(layer_fn: Callable, staged_params, x: torch.Tensor, mesh,
                     axis: str = "pipe") -> torch.Tensor:
    """Run ``layer_fn`` over all layers of ``staged_params`` in a GPipe
    schedule on the ``axis`` dim of ``mesh`` (a ``DeviceMesh``).

    layer_fn: ``(layer_params, h) -> h`` for a single layer.
    staged_params: output of :func:`stage_params` (full tensors, or
        DTensors sharded on their leading dim over ``axis``); the leading
        dim must equal the mesh axis size.
    x: (n_micro, microbatch, ...) microbatched inputs, the same on every
        rank.

    Returns (n_micro, microbatch, ...) outputs on every rank, equal to
    applying all layers sequentially to each microbatch."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        axis = names[0]
    n_stages = mesh.size(names.index(axis))
    leading = {w.shape[0] for w in _leaves(staged_params)}
    if leading != {n_stages}:
        raise ValueError(
            f"staged_params leading dim(s) {sorted(leading)} != pipeline axis "
            f"{axis!r} size {n_stages}; re-split with stage_params(params, "
            f"{n_stages}) or pass the intended mesh axis"
        )
    stage = mesh.get_local_rank(axis)
    params = tree_map(lambda w: w.to_local()[0] if isinstance(w, DTensor) else w[stage],
                      staged_params, is_leaf=torch.is_tensor)
    layers = [tree_map(lambda w, i=i: w[i], params, is_leaf=torch.is_tensor)
              for i in range(_leaves(params)[0].shape[0])]
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group) if n_stages > 1 else []
    n_micro = x.shape[0]
    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # Stage 0 ingests microbatch t (clipped: the tail ticks feed
        # inputs that never reach an output slot); the others take the
        # neighbour's activation from tick t - 1.
        h = x[min(t, n_micro - 1)] if stage == 0 else state
        for layer in layers:
            h = layer_fn(layer, h)
        m = t - (n_stages - 1)
        if stage == n_stages - 1 and m >= 0:
            outs[m] = h
        if n_stages == 1:
            state = h
            continue
        state = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h.contiguous(), ranks[(stage + 1) % n_stages], group),
               dist.P2POp(dist.irecv, state, ranks[(stage - 1) % n_stages], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if n_stages > 1:
        dist.all_reduce(outs, group=group)
    return outs
