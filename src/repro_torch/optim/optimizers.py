"""Optimizers (port of ``repro.optim.optimizers``): SGD, momentum, AdamW
and Adafactor, with global-norm clipping, in plain tensor code.

The API mirrors the reference's: ``init(params) -> state`` and
``update(grads, state, params, lr) -> (updates, state)``, applied with
``apply_updates``. Trees are the port's nested dicts and lists of
tensors. Every update is computed in f32 and cast to the parameter's
dtype only when it is applied, in the reference's order. Unlike the
reference (pure functions), the optimizers update their f32 state
tensors IN PLACE and return the same tensors: at llama3.2-1b's width
AdamW's two moments are 10 GB, and a second copy per step would be pure
waste.

Each optimizer also has ``step(grads, state, params, lr, scale) ->
state``, what the train step runs: it clips (scales each gradient by
``scale`` and rounds it back to its dtype, as ``clip_by_global_norm``
does), updates the state and adds the update to the parameters in
place, one leaf at a time and, within a leaf, one chunk of
``CHUNK_ELEMS`` elements at a time. So it never holds the update tree,
a clipped gradient tree or a second parameter tree, and its f32
temporaries are one chunk's. Given the same ``scale`` it equals
``tree_step(update)`` (clip, ``update``, ``apply_updates``) bit for bit:
both run the same operations on the same chunks.

Adafactor and the reference's stacked layers. The reference stacks a
segment's layers along a leading axis; the port keeps one dict per
layer, so a list of two or more dicts of the same structure in the tree
is such a segment, and each of its leaf paths is ONE reference leaf
(``stacked_groups``). Adafactor's row and column means are per matrix in
both packages, but its update RMS (the clip at ``clip_threshold``) is
taken over the reference's whole leaf, so the port pools it over the
group. A reference leaf of at least ``MAP_ELEMS`` elements and three or
more dimensions, counted at its stacked size, is updated slice by slice
along its leading axis (the reference's ``lax.map``): each slice has its
own RMS and its update is rounded to the parameter's dtype before the
learning rate multiplies it. A stacked group's slices are its layers;
an unstacked leaf's are its leading entries (one MoE layer's experts).

Sharded leaves. ``init`` and ``step`` take trees of DTensors (parameters
and state laid out by ``repro_torch.dist.sharding``): the state is made
with its parameter's placements (Adafactor's row and column statistics
drop the reduced dim's), and ``step`` runs on the local blocks in place.
SGD, momentum and AdamW are elementwise, so that is exact; Adafactor's
row and column means, and its update RMS, are sums over dims the rules
may shard, which it all-reduces over exactly the mesh dims that cut
them. ``chunked_global_norm`` adds each sharded leaf's local square sum
over the mesh dims that cut it, so a leaf replicated over a mesh dim is
counted once. A leaf that no mesh dim of size > 1 cuts runs the
single-device code unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import LeafShards
from repro_torch.models.layers import tree_leaves, tree_map

__all__ = [
    "Optimizer",
    "sgd",
    "momentum",
    "adamw",
    "adafactor",
    "apply_updates",
    "global_norm",
    "chunked_global_norm",
    "clip_scale",
    "clip_by_global_norm",
    "stacked_groups",
    "tree_step",
    "get_optimizer",
    "MAP_ELEMS",
    "CHUNK_ELEMS",
]

#: The reference's per-slice threshold for Adafactor (``MAP_ELEMS``).
MAP_ELEMS = 2 ** 31
#: Elements of a chunk of the in-place step (f32 temporaries of 256 MiB).
CHUNK_ELEMS = 2 ** 26


def _map(fn: Callable, tree, *rest):
    return tree_map(fn, tree, *rest, is_leaf=torch.is_tensor)


def _leaves(tree) -> List[torch.Tensor]:
    return tree_leaves(tree, is_leaf=torch.is_tensor)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (updates, new_state)
    step: Callable[[Any, Any, Any, float, Optional[torch.Tensor]], Any]
    # step(grads, state, params, lr, clip scale or None) -> new_state;
    # the parameters are updated in place


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def _flat_chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK_ELEMS):
        yield flat[i:i + CHUNK_ELEMS]


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("the in-place optimizer step needs contiguous tensors")
    return t


def _local(tree):
    """The tree with each DTensor replaced by its local block (a view)."""
    return _map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def chunked_global_norm(tree) -> torch.Tensor:
    """``global_norm`` with each leaf's square summed a chunk at a time
    (one chunk's f32 copy at most); equal to it within f32 rounding. A
    sharded leaf's local sum is summed over the mesh dims that cut it (one
    all-reduce for all the leaves cut alike) before it joins the total."""
    parts, cut = [], {}
    for x in _leaves(tree):
        sh = LeafShards.of(x)
        sums = [torch.sum(torch.square(c.float()))
                for c in _flat_chunks(_local(x).contiguous())]
        if sh is None:
            parts.append(sums)
            continue
        key = tuple(sorted(md for mds in sh.dims.values() for md in mds))
        cut.setdefault(key, (sh, []))[1].append((len(parts), sum(sums)))
        parts.append(None)
    for sh, items in cut.values():
        summed = sh.sum_(torch.stack([s for _, s in items]))
        for (i, _), s in zip(items, summed):
            parts[i] = [s]
    total = None
    for sums in parts:
        for s in sums:
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm), the factor ``clip_by_global_norm`` applies."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The clipped gradient in f32: scaled in f32, rounded to its dtype."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm); each leaf keeps its
    dtype (scaled in f32, then cast back)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return _map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def apply_updates(params, updates):
    """p + u, with the update cast to the parameter's dtype first."""
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def tree_step(update: Callable) -> Callable:
    """The in-place step of a tree ``update``: clip every gradient by
    ``scale``, run ``update`` and add each update to its parameter."""

    def step(grads, state, params, lr, scale=None):
        if scale is not None:
            grads = _map(lambda g: (g.float() * scale).to(g.dtype), grads)
        updates, state = update(grads, state, params, lr)
        for p, u in zip(_leaves(params), _leaves(updates)):
            p.add_(u.to(p.dtype))
        return state

    return step


def _elementwise(one: Callable) -> Tuple[Callable, Callable]:
    """(update, step) of an optimizer whose per-leaf rule ``one(g, p, k,
    *state) -> f32 update`` (``k``: the step's constants) is elementwise
    and updates its state chunks in place: ``update`` runs it on whole
    leaves, ``step`` chunk by chunk."""

    def update(grads, states, params, k):
        return [one(g.float(), p, k, *s) for g, p, s in zip(grads, params, states)]

    def step(grads, states, params, k, scale):
        for g, p, s in zip(grads, params, states):
            pieces = zip(_flat_chunks(g.contiguous()), _flat_chunks(_flat(p)),
                         *(_flat_chunks(_flat(x)) for x in s))
            for gc, pc, *sc in pieces:
                pc.add_(one(_clipped(gc, scale), pc, k, *sc).to(p.dtype))

    return update, step


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def sgd() -> Optimizer:
    upd, stp = _elementwise(lambda g, p, lr: -lr * g)

    def init(params):
        return ()

    def update(grads, state, params, lr):
        n = len(_leaves(params))
        return _unflatten(params, upd(_leaves(grads), [()] * n, _leaves(params), lr)), state

    def step(grads, state, params, lr, scale, shards):
        n = len(_leaves(params))
        stp(_leaves(grads), [()] * n, _leaves(params), lr, scale)
        return state

    return Optimizer(init, update, _on_shards(step))


def _zeros_f32(p: torch.Tensor, drop: Optional[int] = None) -> torch.Tensor:
    """f32 zeros of p's shape, less dim ``drop`` if given; for a DTensor p,
    a DTensor laid out as p (the dropped dim's shards replicated)."""
    local = p.to_local() if isinstance(p, DTensor) else p
    shape = tuple(local.shape)
    if drop is not None:
        drop %= len(shape)
        shape = shape[:drop] + shape[drop + 1:]
    z = torch.zeros(shape, dtype=torch.float32, device=local.device)
    if not isinstance(p, DTensor):
        return z

    def place(pl):
        if not pl.is_shard() or drop is None:
            return pl
        d = pl.dim % p.ndim
        return Replicate() if d == drop else Shard(d - (d > drop))

    return DTensor.from_local(z, p.device_mesh, tuple(place(pl) for pl in p.placements),
                              run_check=False)


def _on_shards(step: Callable) -> Callable:
    """The optimizer's ``step`` on trees that may hold DTensors: the inner
    ``step(grads, state, params, lr, scale, shards)`` runs on the local
    blocks (views), with each parameter leaf's ``LeafShards`` (None where
    no mesh dim of size > 1 cuts it); the returned state keeps the given
    DTensors, which it updated in place."""

    def run(grads, state, params, lr, scale=None):
        shards = [LeafShards.of(p) for p in _leaves(params)]
        new = step(_local(grads), _local(state), _local(params), lr, scale, shards)
        return _map(lambda old, n: old if isinstance(old, DTensor) else n, state, new)

    return run


def momentum(mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum with an f32 state m = mu m + g; the update is
    -lr m, or -lr (mu m + g) with ``nesterov``."""

    def one(g, p, lr, m):
        m.mul_(mu).add_(g)
        return -lr * (mu * m + g) if nesterov else -lr * m

    upd, stp = _elementwise(one)

    def init(params):
        return _map(_zeros_f32, params)

    def update(grads, state, params, lr):
        ms = [(m,) for m in _leaves(state)]
        return _unflatten(params, upd(_leaves(grads), ms, _leaves(params), lr)), state

    def step(grads, state, params, lr, scale, shards):
        stp(_leaves(grads), [(m,) for m in _leaves(state)], _leaves(params), lr, scale)
        return state

    return Optimizer(init, update, _on_shards(step))


def _f32_scalar(x: torch.Tensor) -> float:
    """An f32 value as a Python float (exact), so that it enters every op
    on f32 tensors as the same f32 number."""
    return float(x.float())


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments, bias correction, and decoupled weight decay
    folded into the update: u = -lr (m^ / (sqrt(v^) + eps) + wd p)."""

    def one(g, p, k, m, v):
        lr, c1, c2 = k
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / c1
        vh = v / c2
        return -lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p.float())

    upd, stp = _elementwise(one)

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": _map(_zeros_f32, params), "v": _map(_zeros_f32, params)}

    def advance(state, lr):
        """(new state, per-leaf (m, v), the step's constants)."""
        step = state["step"] + 1
        t = step.float()
        # Bias corrections in f32, as the reference forms them.
        c1 = _f32_scalar(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
        c2 = _f32_scalar(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))
        mv = list(zip(_leaves(state["m"]), _leaves(state["v"])))
        return {"step": step, "m": state["m"], "v": state["v"]}, mv, (lr, c1, c2)

    def update(grads, state, params, lr):
        state, mv, k = advance(state, lr)
        return _unflatten(params, upd(_leaves(grads), mv, _leaves(params), k)), state

    def step(grads, state, params, lr, scale, shards):
        state, mv, k = advance(state, lr)
        stp(_leaves(grads), mv, _leaves(params), k, scale)
        return state

    return Optimizer(init, update, _on_shards(step))


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return torch.is_tensor(b) and a.shape == b.shape and a.dtype == b.dtype


def stacked_groups(tree) -> List[List[int]]:
    """Groups of leaf indices (``tree_leaves`` order) that the reference
    holds as one leaf: the same leaf path across the layers of a segment,
    which the port holds as a list of two or more dicts of one structure.
    Every other leaf is a group of its own."""
    groups: List[List[int]] = []

    def walk(t, base: int) -> int:
        if torch.is_tensor(t):
            groups.append([base])
            return base + 1
        if (isinstance(t, list) and len(t) >= 2 and all(isinstance(x, dict) for x in t)
                and all(_same_structure(t[0], x) for x in t[1:])):
            n = len(_leaves(t[0]))
            groups.extend([base + j * n + k for j in range(len(t))] for k in range(n))
            return base + n * len(t)
        items = t.values() if isinstance(t, dict) else t
        for sub in items:
            base = walk(sub, base)
        return base

    walk(tree, 0)
    return groups


def _matrix_chunks(shape: Tuple[int, ...]) -> List[Tuple[slice, slice]]:
    """Chunks of an (N, R, C) view: runs of whole matrices, or runs of rows
    of one matrix where a matrix exceeds ``CHUNK_ELEMS``."""
    N, R, C = shape
    if R * C <= CHUNK_ELEMS:
        nb = max(1, CHUNK_ELEMS // (R * C))
        return [(slice(n, n + nb), slice(None)) for n in range(0, N, nb)]
    rb = max(1, CHUNK_ELEMS // C)
    return [(slice(n, n + 1), slice(r, r + rb)) for n in range(N) for r in range(0, R, rb)]


def adafactor(decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              min_dim_factored: int = 128) -> Optimizer:
    """Adafactor (Shazeer & Stern) as the reference's: factored second
    moments (a row and a column mean of g^2 + eps per matrix) for leaves
    whose two trailing dims are both >= ``min_dim_factored``, a full f32
    ``v`` elsewhere, beta = 1 - t^-decay, and the update u = g / sqrt(v^)
    divided by max(1, RMS(u) / clip_threshold). The RMS is pooled over
    the reference's stacked leaf; large leaves go slice by slice (see the
    module docstring)."""

    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored)

    def plan(params, shapes) -> List[Tuple[List[int], bool, bool]]:
        """(group, factored, sliced) for every group of ``stacked_groups``,
        decided from the reference's stacked shape (``shapes``: each
        leaf's global shape)."""
        out = []
        for group in stacked_groups(params):
            shape = tuple(shapes[group[0]])
            stacked = shape if len(group) == 1 else (len(group),) + shape
            fac = factored(stacked)
            if fac != factored(shape):
                raise ValueError(f"a stacked leaf {stacked} is factored over its layers "
                                 f"axis, which per-layer leaves {shape} cannot hold")
            n = 1
            for d in stacked:
                n *= d
            out.append((group, fac, fac and n >= MAP_ELEMS and len(stacked) >= 3))
        return out

    def init(params):
        facs = {}
        for group, fac, _ in plan(params, [p.shape for p in _leaves(params)]):
            for i in group:
                facs[i] = fac
        it = iter(range(len(facs)))

        def one(p):
            if facs[next(it)]:
                return {"row": _zeros_f32(p, drop=-1), "col": _zeros_f32(p, drop=-2)}
            return {"v": _zeros_f32(p)}

        return {"step": torch.zeros((), dtype=torch.int32), "states": _map(one, params)}

    def factored_unit(pieces, beta, omb, lr, scale, round_u, sink, sh):
        """Pieces (g, dst, dtype, row, col) of one RMS unit: the row and
        column means of g^2 + eps, the update's sum of squares, then the
        update into ``sink(dst chunk, u)``, each pass a chunk at a time
        (the update is formed twice). ``sh``: how the pieces' dims are cut
        across ranks (None: not at all); a cut row or column dim makes
        its mean a sum over the ranks that hold its other blocks."""
        cut_c = sh is not None and sh.parts((-1,)) > 1
        cut_r = sh is not None and sh.parts((-2,)) > 1
        mats = []
        for g, dst, dtype, row, col in pieces:
            R, C = dst.shape[-2:]
            g3, d3 = g.contiguous().view(-1, R, C), _flat(dst).view(-1, R, C)
            row2, col2 = _flat(row).view(-1, R), _flat(col).view(-1, C)
            col_sum = torch.zeros_like(col2)
            row_sum = torch.zeros_like(row2) if cut_c else None
            chunks = _matrix_chunks(tuple(g3.shape))
            for ns, rs in chunks:
                gf = _clipped(g3[ns, rs], scale)
                g2 = gf * gf + eps
                if cut_c:
                    row_sum[ns, rs] = g2.sum(dim=-1)
                else:
                    row2[ns, rs].mul_(beta).add_(omb * g2.mean(dim=-1))
                col_sum[ns] += g2.sum(dim=-2)
            if cut_c:
                row2.mul_(beta).add_(omb * (sh.sum_(row_sum, (-1,)) / (C * sh.parts((-1,)))))
            if cut_r:
                col2.mul_(beta).add_(omb * (sh.sum_(col_sum, (-2,)) / (R * sh.parts((-2,)))))
                rmean = sh.sum_(row2.sum(dim=-1, keepdim=True), (-2,)) / (R * sh.parts((-2,)))
            else:
                col2.mul_(beta).add_(omb * (col_sum / R))
                rmean = row2.mean(dim=-1, keepdim=True)
            r = row2 / torch.clamp(rmean, min=eps)
            mats.append((g3, d3, dtype, r, col2, chunks))

        def u_of(g3, r, col2, ns, rs):
            vhat = r[ns, rs][..., None] * col2[ns][:, None, :]
            return _clipped(g3[ns, rs], scale) / torch.sqrt(torch.clamp(vhat, min=eps))

        sumsq = count = 0
        for g3, _, _, r, col2, chunks in mats:
            count += g3.numel() * (sh.parts() if sh is not None else 1)
            for ns, rs in chunks:
                u = u_of(g3, r, col2, ns, rs)
                sumsq = sumsq + torch.sum(u * u)
        if sh is not None:
            sumsq = sh.sum_(sumsq)
        denom = torch.clamp(torch.sqrt(sumsq / count) / clip_threshold, min=1.0)
        for g3, d3, dtype, r, col2, chunks in mats:
            for ns, rs in chunks:
                u = u_of(g3, r, col2, ns, rs) / denom
                if round_u:
                    u = u.to(dtype).float()
                sink(d3[ns, rs], -lr * u)

    def full_unit(pieces, beta, omb, lr, scale, sink, sh):
        """Pieces (g, dst, v) of one RMS unit with a full second moment."""
        def u_of(gc, vc):
            return _clipped(gc, scale) / torch.sqrt(torch.clamp(vc, min=eps))

        sumsq = count = 0
        for g, _, v in pieces:
            count += g.numel() * (sh.parts() if sh is not None else 1)
            for gc, vc in zip(_flat_chunks(g.contiguous()), _flat_chunks(_flat(v))):
                gf = _clipped(gc, scale)
                vc.mul_(beta).add_(omb * (gf * gf + eps))
                u = u_of(gc, vc)
                sumsq = sumsq + torch.sum(u * u)
        if sh is not None:
            sumsq = sh.sum_(sumsq)
        denom = torch.clamp(torch.sqrt(sumsq / count) / clip_threshold, min=1.0)
        for g, dst, v in pieces:
            for gc, vc, dc in zip(_flat_chunks(g.contiguous()), _flat_chunks(_flat(v)),
                                  _flat_chunks(_flat(dst))):
                sink(dc, -lr * (u_of(gc, vc) / denom))

    def run(grads, state, params, dsts, lr, scale, sink, shards):
        """One step: every update lands in ``sink(chunk of dsts, f32 u)``."""
        step = state["step"] + 1
        beta_t = 1.0 - torch.pow(step.float(), -decay)
        beta, omb = _f32_scalar(beta_t), _f32_scalar(1.0 - beta_t)
        gl, pl, dl = _leaves(grads), _leaves(params), _leaves(dsts)
        sl: List[dict] = []
        _map(lambda p, s: sl.append(s), params, state["states"])
        shapes = [sh.shape if sh is not None else p.shape for sh, p in zip(shards, pl)]
        for group, fac, sliced in plan(params, shapes):
            sh = shards[group[0]]
            if not fac:
                full_unit([(gl[i], dl[i], sl[i]["v"]) for i in group],
                          beta, omb, lr, scale, sink, sh)
                continue
            pieces = [(gl[i], dl[i], pl[i].dtype, sl[i]["row"], sl[i]["col"]) for i in group]
            if not sliced:
                units = [pieces]
            elif len(group) > 1:
                units = [[pc] for pc in pieces]          # a slice is a layer
            else:
                g, d, dtype, row, col = pieces[0]        # a slice is a leading entry
                units = [[(g[j], d[j], dtype, row[j], col[j])] for j in range(d.shape[0])]
                sh = sh.drop(0) if sh is not None else None
            for unit in units:
                factored_unit(unit, beta, omb, lr, scale, sliced, sink, sh)
        return {"step": step, "states": state["states"]}

    def update(grads, state, params, lr):
        updates = _map(_zeros_f32, params)
        state = run(grads, state, params, updates, lr, None, lambda d, u: d.copy_(u),
                    [None] * len(_leaves(params)))
        return updates, state

    def step(grads, state, params, lr, scale, shards):
        return run(grads, state, params, params, lr, scale,
                   lambda d, u: d.add_(u.to(d.dtype)), shards)

    return Optimizer(init, update, _on_shards(step))


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
