"""Step functions (port of ``repro.runtime.steps``): the train step, the
prefill, decode and init builders, and the serving slot steps (prefill,
decode, and the speculative verify and replay).

Plain functions, no tracing: PyTorch runs eagerly, so each step is the
model call itself. The fastest-k worker mask, occupancy and ragged
lengths enter as data, as in the reference. The train, prefill and
decode steps also run on a mesh (``repro_torch.dist.sharding``): see
``make_train_step`` and ``make_decode_step``. The dense decoders' train,
prefill and decode steps compute tensor-parallel over ``"model"``
(``repro_torch.dist.tensor_parallel``); the other families gather every
parameter whole. The dry run
(``repro_torch.launch.dryrun``) traces all three there.
``make_init_fn`` is single-device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.collectives import contributors, example_weights
from repro_torch.dist.sharding import (
    TP_AXIS, current_context, full_value, kv_layout, land, row_split, split_rows, split_sum,
    tensor_parallel, tp_block, tp_placements, tp_view,
)
from repro_torch.dist.tensor_parallel import vocab_parallel_ce
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, chunked_global_norm, clip_scale

__all__ = ["train_loss_fn", "make_train_step", "make_prefill_step", "make_decode_step",
           "make_init_fn", "make_slot_prefill_step", "make_slot_decode_step",
           "make_slot_verify_step", "make_slot_replay_step"]

#: Fields of a batch with one entry a row.
_ROWS = ("inputs", "labels", "mask")


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like, is_leaf=torch.is_tensor)


def train_loss_fn(model: Model, params, batch) -> Tuple[torch.Tensor, Dict]:
    """The train step's loss -> (loss, {"ce", "aux", "denom"}): the masked
    fastest-k cross-entropy, plus ``router_aux_weight`` times the router
    loss for an MoE, plus 0.3 times DeepSeek's multi-token-prediction loss
    with ``cfg.mtp``. As in the reference, the MTP term is masked by
    ``batch["mask"]`` alone, not by ``worker_mask``: the stragglers' rows
    enter it. Under a row split every term is this rank's share of the
    global one (the normalizers are global)."""
    cfg = model.cfg
    inputs, labels = batch["inputs"], batch["labels"]
    positions = torch.arange(labels.shape[1], device=labels.device)
    h, aux = model.hidden(params, inputs, positions)
    ce, denom = vocab_parallel_ce(model.logits(params, h), labels, batch.get("mask"),
                                  batch.get("worker_mask"), vocab=cfg.vocab_size)
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        loss = loss + 0.3 * model.mtp_loss(params, h, inputs, labels, mask, positions)
    return loss, {"ce": ce, "aux": aux, "denom": denom}


def _mesh_context(params):
    """The ambient context when the step runs on a mesh: one of more than
    one rank, or DTensor params; else None."""
    ctx = current_context()
    if ctx is not None and (ctx.mesh.size() > 1 or any(
            isinstance(p, DTensor) for p in tree_leaves(params, is_leaf=torch.is_tensor))):
        return ctx
    return None


def _full_params(params):
    return _unflatten(params, [full_value(p) for p in tree_leaves(params, is_leaf=torch.is_tensor)])


def _tp_for(model: Model, ctx):
    """The step's tensor-parallel view: the dense decoders' on a mesh whose
    ``"model"`` axis does not split the batch (``pure_dp`` takes every axis
    for rows), else None (compute whole)."""
    if not model.tensor_parallel or TP_AXIS in ctx.dp:
        return None
    return tp_view(ctx.mesh)


def _tp_blocks(params, mesh):
    """Each parameter gathered over the FSDP axes to its TP-only block (its
    own placements with every mesh dim but ``"model"`` replicated)."""
    leaves = tree_leaves(params, is_leaf=torch.is_tensor)
    return _unflatten(params, [tp_block(p, tp_placements(_own(p, mesh), mesh))
                               for p in leaves])


def _split_logits(logits, model: Model, mesh, split):
    """A tensor-parallel step's logits as a DTensor: the rank's rows over the
    split's axes, its vocab columns over ``"model"`` where the layout cuts
    ``vocab`` (replicated where it does not)."""
    vocab_cut = logits.shape[-1] != model.cfg.vocab_size
    placements = [Shard(0) if name in split.axes else
                  Shard(logits.ndim - 1) if name == TP_AXIS and vocab_cut else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(logits, mesh, placements, run_check=False)


def _own(p, mesh) -> Tuple:
    """A parameter leaf's placements (a plain tensor: replicated)."""
    return tuple(p.placements) if isinstance(p, DTensor) else (Replicate(),) * mesh.ndim


def _gather_layout(leaves, places, gather_shardings, mesh) -> List[Tuple]:
    """Each leaf's placements in the TP-only layout: ``gather_shardings``'
    (NamedShardings matching the params), else its own ``places`` with
    every mesh dim but ``"model"`` replicated."""
    if gather_shardings is None:
        return [tp_placements(pl, mesh) for pl in places]
    want = [tuple(sh.placements) for sh in tree_leaves(gather_shardings)]
    if len(want) != len(leaves):
        raise ValueError(f"gather_shardings has {len(want)} leaves, the params {len(leaves)}")
    return want


def make_train_step(model: Model, optimizer: Optimizer, *,
                    clip_norm: Optional[float] = 1.0, accum_steps: int = 1,
                    param_shardings=None, gather_shardings=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    batch = {inputs, labels, [mask], worker_mask, lr}.

    The loss is ``train_loss_fn``'s, over f32 logits. With ``accum_steps``
    = A > 1 the worker-major batch is split so that every worker's rows
    spread evenly over A microbatches; their gradients are summed in
    f32, each weighted by its contributed-token count ``denom``, and
    divided by the total (the reference's ``_grads_accum``, with a Python
    loop for ``lax.scan``). Gradients are clipped to global norm
    ``clip_norm`` (the norm summed a chunk of a leaf at a time) and the
    optimizer's ``step`` updates the parameters and its state IN PLACE,
    a leaf at a time (see ``repro_torch.optim``): the returned params
    are the given tensors. The metrics are ``loss``, ``ce``, ``aux``,
    ``denom``, ``grad_norm`` and ``contributors`` as 0-dim tensors.

    On a mesh: inside an ``activation_sharding`` context whose mesh has
    more than one rank, or with DTensor params, every rank is given the
    same global batch and
      * gathers each parameter once a step (the reference's ZeRO-1
        discipline, reused by every microbatch): for the dense decoders
        (``Model.tensor_parallel``) over the FSDP axes only, to its block
        in the TP-only layout (``gather_shardings``, by default the
        parameter's own placements with every mesh dim but ``"model"``
        replicated: ``DEFAULT_RULES.replace(embed=None)`` for parameters
        laid out by the default rules), and the forward and backward run
        tensor-parallel on those blocks (``dist.tensor_parallel``); the
        other families gather each parameter to its full value and
        compute whole;
      * runs the loss on its own rows of each microbatch (``row_split``:
        ``batch_pspec``'s block at its coordinate; ranks along axes
        ``batch_pspec`` relaxed compute the same rows, ranks along
        ``"model"`` different shards of their products), as plain
        tensors, so the kernels see plain tensors; the normalizers are
        global, so its loss is its share;
      * sums the gradients over the data axes it split (and, for a leaf
        replicated over ``"model"`` but read by split products,
        ``Model.tp_partial``, over ``"model"`` as well) and lands each in
        its parameter's placements (``Partial`` -> the parameter's, a
        reduce-scatter where the parameter is sharded);
      * takes the norm from local squares summed over the mesh dims that
        shard each leaf, and steps the local blocks in place.
    The metrics are the global ones, the same on every rank.
    ``param_shardings`` (NamedShardings matching params) names the
    gradients' layout, which must be the params' own."""

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, list]:
        """loss, metrics and the gradient tree (in the params' dtypes)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params, is_leaf=torch.is_tensor)]
        loss, metrics = train_loss_fn(model, _unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _unflatten(params, list(grads)))

    def micro_batches(batch) -> List[Dict]:
        """The A microbatches: each worker's rows spread evenly over them.
        Row fields (and per-row weights ``row_w``) are split; the worker
        mask goes to every microbatch."""
        A = accum_steps
        if A == 1:
            return [batch]
        n = batch["worker_mask"].shape[0]
        bw = batch["inputs"].shape[0] // n
        if bw % A:
            raise ValueError(f"per-worker batch {bw} not divisible by accum {A}")

        def resh(x):
            x = x.reshape(n, A, bw // A, *x.shape[1:]).transpose(0, 1)
            return x.reshape(A, n * (bw // A), *x.shape[3:])

        mb = {k: resh(batch[k]) for k in _ROWS + ("row_w",) if batch.get(k) is not None}
        return [dict({k: v[a] for k, v in mb.items()}, worker_mask=batch["worker_mask"])
                for a in range(A)]

    def grads_accum(params, micros):
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params, is_leaf=torch.is_tensor)
        dev = micros[0]["labels"].device
        lsum = dsum = auxsum = torch.zeros((), dtype=torch.float32, device=dev)
        for micro in micros:
            loss, metrics, grads = grads_of(params, micro)
            w = metrics["denom"]
            gsum = tree_map(lambda s, g: s + w * g.float(), gsum, grads,
                            is_leaf=torch.is_tensor)
            lsum = lsum + w * loss
            dsum = dsum + w
            auxsum = auxsum + metrics["aux"]
        dsum = torch.clamp(dsum, min=1.0)
        grads = tree_map(lambda g: g / dsum, gsum, is_leaf=torch.is_tensor)
        loss = lsum / dsum
        return loss, {"ce": loss, "aux": auxsum / len(micros), "denom": dsum}, grads

    def grads_for(params, micros):
        if len(micros) == 1:
            return grads_of(params, micros[0])
        return grads_accum(params, micros)

    def targets(leaves, mesh):
        """Each parameter's placements, checked against ``param_shardings``."""
        want = ([sh.placements for sh in tree_leaves(param_shardings)]
                if param_shardings is not None else [None] * len(leaves))
        out = []
        for p, pl in zip(leaves, want):
            own = _own(p, mesh)
            if pl is not None and tuple(pl) != own:
                raise ValueError(f"a parameter laid out {own} where param_shardings says "
                                 f"{tuple(pl)}: distribute it with shard_tree first")
            out.append(own)
        return out

    def sharded_grads(params, batch, ctx):
        mesh = ctx.mesh
        leaves = tree_leaves(params, is_leaf=torch.is_tensor)
        places = targets(leaves, mesh)
        tp = _tp_for(model, ctx)
        if tp is None:
            held = [None] * len(leaves)
            full = _full_params(params)
        else:
            held = _gather_layout(leaves, places, gather_shardings, mesh)
            full = _unflatten(params, [tp_block(p, h) for p, h in zip(leaves, held)])
        wm = batch.get("worker_mask")
        rows = dict(batch)
        if wm is not None:
            rows["row_w"] = example_weights(wm, batch["inputs"].shape[0])
        micros = micro_batches(rows)
        split = row_split(mesh, micros[0]["inputs"].shape[0], ctx.dp)
        local = []
        for micro in micros:
            m = {k: micro[k][split.rows] for k in _ROWS if micro.get(k) is not None}
            if wm is not None:
                # One "worker" a row: the rank's rows need not be whole workers.
                m["worker_mask"] = micro["row_w"][split.rows]
            local.append(m)
        with split_rows(split), tensor_parallel(tp):
            loss, metrics, grads = grads_for(full, local)
            loss = split_sum(loss)
            metrics = dict(metrics, ce=split_sum(metrics["ce"]), aux=split_sum(metrics["aux"]))
        partial = ([False] * len(leaves) if tp is None else
                   model.tp_partial(full))
        out = []
        for g, p, pl, h, part in zip(tree_leaves(grads, is_leaf=torch.is_tensor), leaves,
                                     places, held, partial):
            g = land(g, mesh, split.axes + ((TP_AXIS,) if part else ()), pl, held=h)
            out.append(g if isinstance(p, DTensor) else g.to_local())
        return loss, metrics, _unflatten(params, out)

    def train_step(params, opt_state, batch):
        ctx = _mesh_context(params)
        if ctx is not None:
            loss, metrics, grads = sharded_grads(params, batch, ctx)
        else:
            loss, metrics, grads = grads_for(params, micro_batches(batch))
        gnorm = chunked_global_norm(grads)
        scale = clip_scale(gnorm, clip_norm) if clip_norm is not None else None
        with torch.no_grad():
            opt_state = optimizer.step(grads, opt_state, params, float(batch["lr"]), scale)
        wm = batch.get("worker_mask")
        metrics = dict(metrics)
        metrics.update(
            loss=loss, grad_norm=gnorm,
            contributors=contributors(wm) if wm is not None else torch.zeros(()),
        )
        return params, opt_state, metrics

    return train_step


def _rows_block(t, mesh, split, tp: bool = False):
    """(the block of cache leaf ``t`` holding the split's rows, its
    placements): the leaf's shards over the split's axes kept (they cut
    its batch dim) and, with ``tp``, its shard over ``"model"`` (its rows
    or its kv heads: ``sharding.kv_layout``); every other mesh dim of size
    > 1 gathered. A plain tensor is taken whole."""
    if not isinstance(t, DTensor):
        return t, None
    names = list(mesh.mesh_dim_names)
    keep = [pl if names[i] in split.axes or (tp and names[i] == TP_AXIS) or mesh.size(i) == 1
            else Replicate() for i, pl in enumerate(t.placements)]
    dims = {pl.dim for i, pl in enumerate(keep) if pl.is_shard() and names[i] in split.axes}
    if any(not t.placements[names.index(a)].is_shard() for a in split.axes) or len(dims) > 1:
        raise ValueError(f"a cache leaf laid out {t.placements} is not cut along its batch "
                         f"dim over the batch split's axes {split.axes}")
    if tuple(keep) == tuple(t.placements):
        return t.to_local(), keep
    return t.redistribute(mesh, keep).to_local(), keep


def make_prefill_step(model: Model) -> Callable:
    """(params, inputs (B, S)) -> the last position's logits (B, 1, V).

    On a mesh (as ``make_train_step``): the rank runs the prefill on its
    own rows (``row_split``). The dense decoders gather each parameter
    over the FSDP axes to its TP-only block (its own placements with every
    mesh dim but ``"model"`` replicated) and run tensor-parallel,
    returning the logits as a
    DTensor: the rank's rows over the split's axes, its vocab columns
    over ``"model"`` where the layout cuts ``vocab`` (replicated where it
    does not). The other families gather each parameter to its full value
    and return their rows' logits."""

    @torch.no_grad()
    def prefill_step(params, inputs):
        ctx = _mesh_context(params)
        if ctx is None:
            return model.prefill(params, inputs)
        mesh = ctx.mesh
        split = row_split(mesh, inputs.shape[0], ctx.dp)
        tp = _tp_for(model, ctx)
        if tp is None:
            with split_rows(split):
                return model.prefill(_full_params(params), inputs[split.rows])
        with split_rows(split), tensor_parallel(tp):
            logits = model.prefill(_tp_blocks(params, mesh), inputs[split.rows])
        return _split_logits(logits, model, mesh, split)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """(params, token (B, 1), caches, cache_index) -> (logits, caches).

    On a mesh (as ``make_train_step``), the rank runs the decode step on
    its own rows (``row_split``); each cache leaf is a DTensor laid out by
    the rules. The dense decoders (``Model.tensor_parallel``) gather each
    parameter over the FSDP axes to its TP-only block and run
    tensor-parallel over ``"model"`` on each cache leaf's local block,
    never gathered: cut along its rows (``SP_DECODE_RULES``' act_kv_seq),
    along its kv heads (``DEFAULT_RULES`` where they divide ``"model"``)
    or replicated (``sharding.kv_layout``; ``attention._tp_decode``); the
    logits come back as a DTensor as ``make_prefill_step``'s. The other
    families, and a mesh whose ``"model"`` splits the batch
    (``pure_dp``), gather each parameter to its full value and each cache
    leaf to the rank's rows whole along its other dims, run the
    single-device step on those rows and return their logits. The
    updated caches come back in their leaves' own placements."""

    @torch.no_grad()
    def decode_step(params, token, caches, cache_index):
        ctx = _mesh_context(params)
        if ctx is None:
            return model.decode_step(params, token, caches, cache_index)
        mesh = ctx.mesh
        split = row_split(mesh, token.shape[0], ctx.dp)
        tp = _tp_for(model, ctx)
        leaves = tree_leaves(caches, is_leaf=torch.is_tensor)
        blocks = [_rows_block(c, mesh, split, tp is not None) for c in leaves]
        idx = cache_index
        if torch.is_tensor(idx) and idx.dim() == 1:
            idx = idx[split.rows]
        local = _unflatten(caches, [b for b, _ in blocks])
        if tp is None:
            with split_rows(split):
                logits, new = model.decode_step(_full_params(params), token[split.rows], local,
                                                idx)
        else:
            with split_rows(split), tensor_parallel(tp._replace(kv=kv_layout(leaves))):
                logits, new = model.decode_step(_tp_blocks(params, mesh), token[split.rows],
                                                local, idx)
            logits = _split_logits(logits, model, mesh, split)
        out = []
        for c, n, (_, keep) in zip(leaves, tree_leaves(new, is_leaf=torch.is_tensor), blocks):
            if keep is not None:
                n = DTensor.from_local(n, mesh, keep, run_check=False)
                if tuple(keep) != tuple(c.placements):
                    n = n.redistribute(mesh, c.placements)
            out.append(n)
        return logits, _unflatten(caches, out)

    return decode_step


def make_init_fn(model: Model, optimizer: Optimizer, *, device="cuda") -> Callable:
    """(seed) -> (params, opt_state) on ``device``."""

    def init(seed: int):
        params = model.init(seed, device=device)
        return params, optimizer.init(params)

    return init


def make_slot_prefill_step(model: Model) -> Callable:
    """Cache-writing batched prefill for the serving engine.

    (params, inputs (B, P) right-padded, caches, length (B,), start_index,
    [block_tables]) -> (last-valid logits (B, 1, V), caches).
    ``block_tables`` (B, T) routes the chunk's cache rows through paged
    arenas (None = contiguous slot stripes)."""

    @torch.no_grad()
    def slot_prefill_step(params, inputs, caches, length, start_index,
                          block_tables=None):
        return model.prefill_with_cache(
            params, inputs, caches, length=length, start_index=start_index,
            block_tables=block_tables,
        )

    return slot_prefill_step


def make_slot_decode_step(model: Model) -> Callable:
    """One decode tick over the whole slot pool.

    ``cache_index`` is the per-slot position vector (n_slots,) and
    ``mask`` (n_slots,) bool marks the decoding lanes. Free and
    mid-prefill lanes ride along: each writes one K/V row at its own
    position, which nothing reads before it is rewritten (a mid-prefill
    lane's position is where its next prefill chunk starts; a free lane is
    reset at admission; a dead paged lane's NULL table sends its write to
    the sink). A recurrent state (the hybrid's) would keep such a lane's
    token, so the model keeps the old state wherever ``mask`` is False; a
    dense model ignores ``mask``, and the engine sends None for it."""

    @torch.no_grad()
    def slot_decode_step(params, tokens, caches, cache_index, block_tables=None, mask=None):
        return model.decode_step(
            params, tokens, caches, cache_index, block_tables=block_tables, mask=mask,
        )

    return slot_decode_step


def make_slot_verify_step(model: Model) -> Callable:
    """Speculative verify over the whole slot pool: one call scores every
    lane's draft window at its own position.

    (params, tokens (B, S), caches, n_input (B,), positions (B,),
    [block_tables]) -> (greedy tokens (B, S) int32, caches). Per-lane
    draft lengths ride along as data (``n_input``: 0 = a free or
    mid-prefill lane, 1 = plain decode, 1 + gamma = speculating). The
    caches come back committed as ``Model.verify_with_cache`` says: the
    caller applies the exact-argmax rule to the greedy tokens and rewinds
    its per-slot positions to the accepted prefix."""

    @torch.no_grad()
    def slot_verify_step(params, tokens, caches, n_input, positions, block_tables=None):
        logits, caches = model.verify_with_cache(
            params, tokens, caches, n_input, positions, block_tables=block_tables,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return slot_verify_step


def make_slot_replay_step(model: Model) -> Callable:
    """The draft's resync after a verify round: commit exactly
    ``n_input`` known tokens a lane into the caches (no acceptance chain:
    the tokens are the committed stream). Same arguments as
    ``make_slot_verify_step``; returns only the caches."""

    @torch.no_grad()
    def slot_replay_step(params, tokens, caches, n_input, positions, block_tables=None):
        _, caches = model.verify_with_cache(
            params, tokens, caches, n_input, positions, block_tables=block_tables,
            greedy_commit=False,
        )
        return caches

    return slot_replay_step
