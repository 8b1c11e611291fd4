"""Logical-axis sharding rules and the ambient activation-sharding context
(port of ``repro.dist.sharding``) on ``torch.distributed``.

Model code never names mesh axes. Parameters carry LOGICAL axis names in
their ``ParamSpec.axes`` (``"embed"``, ``"ffn"``, ``"vocab"``, ...). This
module owns the single mapping from logical names to mesh axes
(:class:`ShardingRules`) and derives a ``PartitionSpec`` from it, with
the reference's three safety rules applied in order:

  1. axes absent from the mesh are dropped (a single-pod mesh has no
     ``"pod"`` axis: ``act_batch = ("pod", "data")`` degrades to
     ``("data",)``),
  2. a mesh axis is never used twice in one spec (first dim wins),
  3. a dim that is not divisible by the prospective axis-size product is
     progressively relaxed by dropping trailing axes, down to replicated.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims (see
:func:`make_mesh`), or, for the pure functions, any object whose
``shape`` maps axis names to sizes. ``NamedSharding(mesh, spec)`` turns a
spec into DTensor placements: one ``Shard(d)`` or ``Replicate()`` a mesh
dim; a tuple entry such as ``("pod", "data")`` shards its tensor dim over
both mesh dims, the first one major, which is the DTensor layout only
when the tuple is in mesh order (others raise). :func:`shard_slices`
gives the block of a global shape held at a mesh coordinate, the layout
jax's ``NamedSharding`` gives the same spec.

The ambient context (:func:`activation_sharding`) carries ``(mesh,
dp_axes, seq_axis, rules)`` as in the reference, plus the rank's row
split of the batch being stepped (:class:`RowSplit`, set by the train
step through :func:`split_rows`) and its tensor-parallel view
(:class:`TPView`, set through :func:`tensor_parallel`). Under a split the
model computes on its own rows as plain tensors; the MoE dispatch and the
losses read the split to reduce their global counts (:func:`split_sum`).
Under a tensor-parallel view the dense decoders compute on the rank's
blocks of the TP-only layout (:func:`tp_rules`: the rules with ``embed``
replicated, as the reference's ZeRO-1 gather): each product is split over
``"model"`` exactly where its parameter's block is cut there
(``repro_torch.dist.tensor_parallel`` holds the collectives GSPMD would
insert). Activations are plain (local) tensors, so :func:`constrain_batch`
/ :func:`constrain_logical` return them unchanged; a ``DTensor`` is
redistributed to the derived placements. Outside a context both are
no-ops, as in the reference.

Mesh axes of size 1 never communicate: every reduction here skips them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import resolve_device

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "ShardingRules",
    "DEFAULT_RULES",
    "FSDP_POD_RULES",
    "PURE_DP_RULES",
    "SP_DECODE_RULES",
    "logical_to_pspec",
    "batch_pspec",
    "make_sharding_fn",
    "shard_slices",
    "local_block",
    "shard_tree",
    "make_mesh",
    "activation_sharding",
    "constrain_batch",
    "constrain_logical",
    "current_context",
    "RowSplit",
    "row_split",
    "split_rows",
    "current_split",
    "split_sum",
    "split_gather",
    "in_context",
    "TP_AXIS",
    "TPView",
    "tp_view",
    "tensor_parallel",
    "current_tp",
    "tp_rules",
    "tp_placements",
    "tp_block",
    "kv_layout",
    "LeafShards",
    "full_value",
    "land",
]

# A logical axis maps to: None (replicated), one mesh axis, or an ordered
# tuple of mesh axes (sharded over their product).
AxisRule = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """jax's ``PartitionSpec``: one entry a dim, each None (replicated), a
    mesh axis name or a tuple of them. As jax's, it keeps what it is given
    (``logical_to_pspec`` trims trailing Nones itself)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping. One field per logical axis."""

    # parameter axes
    embed: AxisRule = None         # d_model rows (FSDP axis by default)
    embed_out: AxisRule = None     # d_model columns of square projections
    vocab: AxisRule = None
    ffn: AxisRule = None
    ffn_out: AxisRule = None
    heads: AxisRule = None
    head_dim: AxisRule = None
    kv_heads: AxisRule = None
    kv_lora: AxisRule = None       # MLA latent dims
    q_lora: AxisRule = None
    expert: AxisRule = None        # MoE expert dim (EP axis)
    expert_ffn: AxisRule = None
    ssm_heads: AxisRule = None
    ssm_inner: AxisRule = None
    layers: AxisRule = None        # stacked-segment leading dim
    # activation / cache axes
    act_batch: AxisRule = None
    act_kv_seq: AxisRule = None

    def get(self, name: str) -> AxisRule:
        return getattr(self, name, None)

    def replace(self, **kwargs) -> "ShardingRules":
        return dataclasses.replace(self, **kwargs)


# FSDP over the data axis + tensor parallelism over the model axis. The
# batch shards over (pod, data): the fastest-k worker grain.
DEFAULT_RULES = ShardingRules(
    embed="data",
    embed_out="model",
    vocab="model",
    ffn="model",
    ffn_out="model",
    heads="model",
    kv_heads="model",
    expert="model",
    ssm_heads="model",
    ssm_inner="model",
    act_batch=("pod", "data"),
)

# Pod-wide ZeRO: FSDP axis spans (pod, data), for the largest configs.
FSDP_POD_RULES = DEFAULT_RULES.replace(embed=("pod", "data"))

# Sequence-parallel KV caches for distributed flash-decode.
SP_DECODE_RULES = DEFAULT_RULES.replace(act_kv_seq="model")

# Pure data parallelism: params replicated, batch over every mesh axis.
PURE_DP_RULES = ShardingRules(act_batch=("pod", "data", "model"))


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order: a ``DeviceMesh``'s named dims, or
    a stub's ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Sequence[str]):
    return None if not axes else (axes[0] if len(axes) == 1 else tuple(axes))


def _fit_axes(candidate: Sequence[str], dim: int, sizes: dict, used: set) -> Tuple[str, ...]:
    """Filter a candidate mesh-axis tuple against the mesh (rules 1-3)."""
    cand = tuple(a for a in candidate if a in sizes and a not in used)
    while cand and dim % math.prod(sizes[a] for a in cand) != 0:
        cand = cand[:-1]
    return cand


def logical_to_pspec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                     rules: ShardingRules) -> PartitionSpec:
    """Derive a PartitionSpec for one array from its logical axes."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        entry = None
        rule = rules.get(name) if name is not None else None
        if rule is not None:
            cand = _fit_axes(_entry_axes(rule), dim, sizes, used)
            used.update(cand)
            entry = _entry(cand)
        entries.append(entry)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def batch_pspec(mesh, batch: int, n_trailing: int = 0, *,
                dp_axes: Optional[Sequence[str]] = None) -> PartitionSpec:
    """PartitionSpec sharding dim 0 (the batch) over the data-parallel
    axes, with ``n_trailing`` replicated trailing dims."""
    sizes = _axis_sizes(mesh)
    cand = _fit_axes(tuple(dp_axes) if dp_axes is not None else ("pod", "data"),
                     batch, sizes, set())
    entry = _entry(cand)
    if entry is None:
        return P()
    return P(entry, *(None,) * n_trailing)


def shard_slices(shape: Sequence[int], spec: Sequence, mesh, coord) -> Tuple[slice, ...]:
    """The block of a ``shape`` array that ``spec`` places at mesh
    coordinate ``coord`` (a sequence in mesh order, or axis -> index): a
    dim sharded over axes (a0, a1, ...) is cut into prod(sizes) equal
    parts, part index row-major over the axes in the entry's order (the
    first major), as jax lays out ``NamedSharding(mesh, spec)``."""
    sizes = _axis_sizes(mesh)
    if not isinstance(coord, dict):
        coord = dict(zip(sizes, coord))
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * sizes[a] + coord[a], parts * sizes[a]
        if n % parts:
            raise ValueError(f"dim {d} of size {n} does not split into {parts} parts")
        size = n // parts
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: jax's ``NamedSharding`` for the port."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple:
        """One ``Shard(dim)`` or ``Replicate()`` a mesh dim. A tuple entry
        shards its dim over each of its mesh dims; DTensor puts the
        earlier mesh dim major, so an entry out of mesh order, which jax
        would lay out the other way, raises."""
        names = list(_axis_sizes(self.mesh))
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _entry_axes(entry)]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec entry {entry!r} is not in mesh order {tuple(names)}: DTensor "
                    "would shard the dim with the mesh's order, not the entry's")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


def make_sharding_fn(mesh, rules: Optional[ShardingRules] = None
                     ) -> Callable[[object], NamedSharding]:
    """Returns ``spec -> NamedSharding`` for ParamSpec-like objects
    (anything with ``.axes`` and ``.shape``)."""
    rules = DEFAULT_RULES if rules is None else rules

    def sharding_for(spec) -> NamedSharding:
        return NamedSharding(mesh, logical_to_pspec(spec.axes, spec.shape, mesh, rules))

    return sharding_for


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under DTensor
    ``placements`` on ``mesh``, contiguous (a view where it already is:
    a block of leading rows, or the whole tensor)."""
    names = list(_axis_sizes(mesh))
    spec = [()] * t.ndim
    for name, pl in zip(names, placements):
        if pl.is_shard():
            spec[pl.dim % t.ndim] += (name,)
    return t[shard_slices(t.shape, spec, mesh, mesh.get_coordinate())].contiguous()


def shard_tree(tree, shardings):
    """DTensors holding ``tree``'s full tensors, each as its sharding in
    the ``shardings`` tree (same structure) lays it out. Every rank holds
    the same full values (the same seed), so each keeps its own block
    (``local_block``): no communication."""
    from repro_torch.models.layers import tree_map  # models imports this module

    def one(t: torch.Tensor, sh: NamedSharding) -> DTensor:
        return DTensor.from_local(local_block(t, sh.mesh, sh.placements), sh.mesh,
                                  sh.placements, run_check=False)

    return tree_map(one, tree, shardings, is_leaf=torch.is_tensor)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              backend: Optional[str] = None):
    """The port's ``jax.make_mesh``: a ``DeviceMesh`` of ``shape`` named
    ``axes`` over the default process group, whose world size must be
    the product of ``shape``. On the card (the default) the group must
    run NCCL, on the CPU gloo: there is no fallback to another backend.
    ``backend="gloo"`` asks for a CUDA mesh over gloo explicitly: ranks
    that share one card, where NCCL refuses two ranks on a device (gloo
    stages CUDA tensors through host memory)."""
    kind = torch.device(device).type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the world "
                         f"has {dist.get_world_size()}")
    if backend is not None and (kind, backend) != ("cuda", "gloo"):
        raise ValueError(f"an explicit backend is gloo on a cuda mesh, not {backend!r} on "
                         f"{kind}")
    want = backend or {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    backend = str(dist.get_backend())
    if want is None or want not in backend:
        raise ValueError(f"a {kind} mesh runs on {want or 'no'} backend, the process "
                         f"group runs {backend}")
    resolve_device(kind)
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


# ---------------------------------------------------------------------------
# Ambient activation-sharding context
# ---------------------------------------------------------------------------

class RowSplit(NamedTuple):
    """The rank's share of a batch: rows ``rows`` of it, block ``index``
    of ``n`` over the data-parallel ``axes`` of size > 1 that
    ``batch_pspec`` kept (pod-major). Ranks along other axes hold the
    same rows; under a tensor-parallel view (:class:`TPView`) the ranks
    along ``"model"`` hold different shards of those rows' products."""

    axes: Tuple[str, ...]
    n: int
    index: int
    rows: slice


class TPView(NamedTuple):
    """The rank's place along the tensor-parallel mesh axis: the axis's
    process group, this rank's ``index`` along it and its ``size``; and,
    in a decode step, where ``"model"`` cuts the GQA caches (``kv``,
    :func:`kv_layout`): ``"seq"`` (each rank holds a block of every
    sequence's rows), ``"heads"`` (a block of the kv heads) or None
    (replicated)."""

    group: Any
    index: int
    size: int
    kv: Optional[str] = None


class ActContext(NamedTuple):
    mesh: Any
    dp: Tuple[str, ...]
    seq_axis: Optional[str]
    rules: ShardingRules
    split: Optional[RowSplit] = None
    tp: Optional[TPView] = None


_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_act_ctx", default=None)


def current_context() -> Optional[ActContext]:
    return _ACT_CTX.get()


@contextlib.contextmanager
def activation_sharding(mesh, *, seq_axis: Optional[str] = None,
                        dp_axes: Optional[Sequence[str]] = None,
                        rules: Optional[ShardingRules] = None):
    """Install the ambient mesh context for activation constraints.

    ``dp_axes``: mesh axes the batch dim shards over (default: whichever
    of ``("pod", "data")`` the mesh has). ``seq_axis``: optional mesh
    axis for sequence-parallel activations. ``rules``: the ShardingRules
    used to resolve parameter-style logical names in
    :func:`constrain_logical` (default DEFAULT_RULES)."""
    sizes = _axis_sizes(mesh)
    cand = ("pod", "data") if dp_axes is None else dp_axes
    dp = tuple(a for a in cand if a in sizes)
    token = _ACT_CTX.set(ActContext(mesh, dp, seq_axis,
                                    DEFAULT_RULES if rules is None else rules))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def row_split(mesh, batch: int, dp: Sequence[str]) -> RowSplit:
    """This rank's rows of a ``batch``-row batch: ``batch_pspec``'s entry
    at the rank's mesh coordinate. Where the batch does not divide, the
    relaxed axes hold the same rows and no sum runs over them."""
    sizes = _axis_sizes(mesh)
    spec = batch_pspec(mesh, batch, dp_axes=dp)
    axes = tuple(a for a in _entry_axes(spec[0] if spec else None) if sizes[a] > 1)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    n, index = 1, 0
    for a in axes:
        n, index = n * sizes[a], index * sizes[a] + coord[a]
    per = batch // n
    return RowSplit(axes, n, index, slice(index * per, (index + 1) * per))


@contextlib.contextmanager
def split_rows(split: RowSplit):
    """Run the enclosed forward on the rank's rows ``split`` (inside an
    :func:`activation_sharding` context)."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        raise RuntimeError("split_rows needs an activation_sharding context")
    token = _ACT_CTX.set(ctx._replace(split=split))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


#: The mesh axis that tensor-parallel compute splits products over.
TP_AXIS = "model"


def tp_view(mesh) -> Optional[TPView]:
    """The rank's :class:`TPView` on ``mesh``: None where the mesh has no
    ``"model"`` axis or it has size 1 (nothing to split)."""
    sizes = _axis_sizes(mesh)
    if sizes.get(TP_AXIS, 1) == 1:
        return None
    coord = dict(zip(sizes, mesh.get_coordinate()))
    return TPView(mesh.get_group(TP_AXIS), coord[TP_AXIS], sizes[TP_AXIS])


@contextlib.contextmanager
def tensor_parallel(view: Optional[TPView]):
    """Run the enclosed forward (and its backward) on the rank's blocks of
    the TP-only layout (inside an :func:`activation_sharding` context);
    ``None`` runs it whole."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        raise RuntimeError("tensor_parallel needs an activation_sharding context")
    token = _ACT_CTX.set(ctx._replace(tp=view))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def current_tp() -> Optional[TPView]:
    """The active tensor-parallel view, else None."""
    ctx = _ACT_CTX.get()
    return None if ctx is None else ctx.tp


def tp_rules(rules: ShardingRules) -> ShardingRules:
    """The TP-only gather layout of ``rules``: the FSDP axis (``embed``)
    replicated, every other rule kept (the reference's ZeRO-1
    ``rules.replace(embed=None)``)."""
    return rules.replace(embed=None)


def tp_placements(placements, mesh) -> Tuple:
    """``placements`` with every mesh dim but ``"model"`` replicated: a
    leaf's block in the TP-only layout when its own layout is the
    rules' (``tp_rules`` changes no ``"model"`` entry)."""
    return tuple(pl if name == TP_AXIS else Replicate()
                 for name, pl in zip(_axis_sizes(mesh), placements))


def tp_block(t: torch.Tensor, placements) -> torch.Tensor:
    """A parameter leaf's local block in the TP-only ``placements`` (every
    mesh dim but ``"model"`` replicated): a DTensor gathered over the
    other mesh dims of size > 1 that cut it (its local block where none
    does), a plain full tensor cut to the rank's ``"model"`` block."""
    if not isinstance(t, DTensor):
        ctx = _ACT_CTX.get()
        return t if ctx is None else local_block(t, ctx.mesh, placements)
    mesh, sizes = t.device_mesh, _axis_sizes(t.device_mesh)
    if any(name != TP_AXIS and not pl.is_replicate() for name, pl in zip(sizes, placements)):
        raise ValueError(f"a TP-only layout {tuple(placements)} cuts a mesh dim other than "
                         f"{TP_AXIS!r}: it gathers over every other axis")
    if all(size == 1 or pl == want
           for size, pl, want in zip(sizes.values(), t.placements, placements)):
        return t.to_local()
    return t.redistribute(mesh, placements).to_local()


def kv_layout(leaves: Sequence[torch.Tensor]) -> Optional[str]:
    """Where ``"model"`` cuts a decode step's GQA cache leaves (B, S, Hkv,
    D) as their placements lay them out: ``"seq"`` where it shards dim 1
    (``SP_DECODE_RULES``' ``act_kv_seq``; ``kv_heads`` then finds
    ``"model"`` taken and stays whole), ``"heads"`` where it shards dim 2
    (``DEFAULT_RULES`` where the kv heads divide it), None where it cuts
    neither (they do not divide it, or it has size 1). Every leaf must
    agree."""
    found = set()
    for t in leaves:
        dim = None
        if isinstance(t, DTensor):
            sizes = _axis_sizes(t.device_mesh)
            pl = t.placements[list(sizes).index(TP_AXIS)] if TP_AXIS in sizes else None
            if pl is not None and pl.is_shard() and sizes[TP_AXIS] > 1:
                dim = pl.dim % t.ndim
        if dim not in (None, 1, 2):
            raise ValueError(f"a cache leaf is cut over {TP_AXIS!r} along dim {dim}, "
                             "neither its rows nor its kv heads")
        found.add({None: None, 1: "seq", 2: "heads"}[dim])
    if len(found) > 1:
        raise ValueError(f"the cache leaves are laid out {sorted(map(str, found))} over "
                         f"{TP_AXIS!r}: one layout a step")
    return found.pop() if found else None


def current_split() -> Optional[RowSplit]:
    """The active row split when it spans more than one rank, else None."""
    ctx = _ACT_CTX.get()
    if ctx is None or ctx.split is None or not ctx.split.axes:
        return None
    return ctx.split


def split_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the active row split (a new tensor;
    ``t`` itself outside a split). Carries no gradient."""
    split = current_split()
    if split is None:
        return t
    out = t.detach().clone()
    mesh = _ACT_CTX.get().mesh
    for a in split.axes:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def split_gather(t: torch.Tensor) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` of the active row split, in
    split order; ``t[None]`` outside a split."""
    split = current_split()
    if split is None:
        return t[None]
    buf = torch.zeros((split.n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[split.index] = t.detach()
    return split_sum(buf)


def in_context(fn: Callable) -> Callable:
    """``fn`` bound to a copy of the current context: a rematerialised
    block recomputed in the backward (on another thread, on the card)
    sees the forward's row split."""
    return functools.partial(contextvars.copy_context().run, fn)


def _constrain(x, entries, mesh):
    while entries and entries[-1] is None:
        entries.pop()
    return x.redistribute(mesh, NamedSharding(mesh, P(*entries)).placements)


def constrain_batch(x):
    """Constrain an activation's dim 0 to the ambient data-parallel axes
    (and dim 1 to the ambient sequence axis, when set). A plain tensor is
    the rank's own block and comes back as it is; no-op outside an
    :func:`activation_sharding` context."""
    ctx = _ACT_CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    sizes = _axis_sizes(ctx.mesh)
    cand = _fit_axes(ctx.dp, x.shape[0], sizes, set())
    entries: list = [_entry(cand)]
    if x.ndim >= 2 and ctx.seq_axis is not None:
        seq = _fit_axes((ctx.seq_axis,), x.shape[1], sizes, set(cand))
        entries.append(_entry(seq))
    return _constrain(x, entries, ctx.mesh)


def constrain_logical(x, axes: Sequence[Optional[str]]):
    """Constrain an activation by logical axis names under the ambient
    context: ``act_batch`` resolves to the ambient dp axes, ``act_kv_seq``
    to the ambient sequence axis, parameter-style names through the
    context's rules. Plain tensors and calls outside a context pass
    through."""
    ctx = _ACT_CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    sizes = _axis_sizes(ctx.mesh)
    used: set = set()
    entries = []
    for name, dim in zip(axes, x.shape):
        if name == "act_batch":
            rule: AxisRule = ctx.dp
        elif name == "act_kv_seq":
            rule = ctx.seq_axis
        else:
            rule = ctx.rules.get(name) if name is not None else None
        cand = _fit_axes(_entry_axes(rule), dim, sizes, used) if rule else ()
        used.update(cand)
        entries.append(_entry(cand))
    return _constrain(x, entries, ctx.mesh)


# ---------------------------------------------------------------------------
# Reductions over a sharded leaf's dims
# ---------------------------------------------------------------------------

class LeafShards:
    """Where a DTensor's dims are cut across ranks: for each tensor dim
    the mesh dims (of size > 1) that shard it. ``of`` gives None for a
    leaf no such mesh dim shards, which then takes the single-device
    code unchanged."""

    def __init__(self, mesh, shape: Tuple[int, ...], dims: Dict[int, Tuple[int, ...]]):
        self.mesh, self.shape, self.dims = mesh, tuple(shape), dims

    @classmethod
    def of(cls, t) -> Optional["LeafShards"]:
        if not isinstance(t, DTensor):
            return None
        mesh, dims = t.device_mesh, {}
        for md, pl in enumerate(t.placements):
            if pl.is_shard() and mesh.size(md) > 1:
                d = pl.dim % t.ndim
                dims[d] = dims.get(d, ()) + (md,)
        return cls(mesh, tuple(t.shape), dims) if dims else None

    def _norm(self, dims) -> Tuple[int, ...]:
        n = len(self.shape)
        return tuple(range(n)) if dims is None else tuple(d % n for d in dims)

    def parts(self, dims=None) -> int:
        """How many blocks the leaf's ``dims`` (all by default) are cut into."""
        return math.prod(self.mesh.size(md) for d in self._norm(dims)
                         for md in self.dims.get(d, ()))

    def sum_(self, x: torch.Tensor, dims=None) -> torch.Tensor:
        """Sum ``x`` in place over the ranks that hold other blocks of
        ``dims`` (all by default); returns ``x``."""
        for md in sorted(md for d in self._norm(dims) for md in self.dims.get(d, ())):
            dist.all_reduce(x, group=self.mesh.get_group(md))
        return x

    def drop(self, dim: int) -> Optional["LeafShards"]:
        """The shards of one slice along ``dim`` (that dim removed)."""
        dim %= len(self.shape)
        dims = {d - (d > dim): mds for d, mds in self.dims.items() if d != dim}
        shape = self.shape[:dim] + self.shape[dim + 1:]
        return LeafShards(self.mesh, shape, dims) if dims else None


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A parameter leaf's full value: a DTensor gathered over the mesh
    dims that cut it (its local block where none of size > 1 does), a
    plain tensor itself."""
    if not isinstance(t, DTensor):
        return t
    return t.to_local() if LeafShards.of(t) is None else t.full_tensor()


def land(g: torch.Tensor, mesh, axes: Sequence[str], placements, held=None) -> DTensor:
    """A gradient ``g``, the rank's block under ``held`` placements (default
    replicated everywhere: a full-shape gradient), partial over the mesh
    ``axes``, summed there and cut to ``placements`` (a reduce-scatter
    where a summed axis shards the leaf). With nothing to sum or cut,
    ``g`` is the block."""
    sizes = _axis_sizes(mesh)
    held = tuple(held) if held is not None else (Replicate(),) * len(sizes)
    if not axes and all(size == 1 or pl == h
                        for pl, h, size in zip(placements, held, sizes.values())):
        return DTensor.from_local(g, mesh, placements, run_check=False)
    partial = [Partial() if name in axes else h for name, h in zip(sizes, held)]
    return DTensor.from_local(g, mesh, partial, run_check=False).redistribute(mesh, placements)
