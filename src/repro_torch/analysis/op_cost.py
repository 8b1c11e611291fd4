"""Per-device cost of one eager step, counted op by op: the port's
counterpart of ``repro.analysis.hlo`` and ``repro.analysis.hlo_cost``.

PyTorch has no compiled module to parse. Instead the step runs once (on
meta tensors for the dry run, or on the card) under :func:`counting`, a
``TorchDispatchMode`` that sees every aten op, every c10d collective and,
through ``repro_torch.kernels.work_hook``, every hand-written kernel:

  * flops            -- 2*M*N*K for each ``mm`` / ``bmm`` / ``addmm`` /
                        ``baddbmm`` (``linear`` and ``einsum`` reach these),
                        convolutions from the kernel shape (the formulas of
                        ``torch.utils.flop_counter``), plus each kernel's
                        reported FLOPs (its work formula);
  * hbm_bytes        -- operand plus output bytes of every aten op that is
                        not a view or metadata op (views, ``detach`` and
                        ``empty`` count 0; an in-place op its read and its
                        write), plus each kernel's reported bytes. Eager ops
                        are this program's materialisation boundaries, as
                        fusions are XLA's: this is the eager program's
                        traffic, NOT comparable to the reference's
                        ``hbm_bytes`` of a fused module;
  * collective bytes -- output bytes per device of each c10d op
                        (functional and in-place; send / recv count as
                        ``collective-permute``), under the reference's
                        ``COLLECTIVES`` names, with ``{kind}_count``; each
                        attributed to the innermost stack frame in
                        ``repro_torch`` (which stands in for HLO's
                        ``op_name`` metadata): the tensor-parallel step's
                        gather to the TP-only layout (``tp_block``), its
                        collectives over "model" by the model line that
                        issued them and the ``dist/tensor_parallel.py``
                        function and line that ran them (its own
                        ``backward`` lines for the backward's);
  * peak_bytes       -- the most live storage bytes: the arguments' storages
                        plus every storage an op creates, less each one when
                        its last tensor is freed (weak references);
  * unknown_trip_counts is always 0: Python loops really run.

Only this process's rank is counted; a fake process group moves nothing,
so collectives are counted, not timed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import weakref
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels as kernels

__all__ = ["COLLECTIVES", "OpCost", "counting", "collective_kind", "tensor_bytes"]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_PKG = Path(__file__).resolve().parents[1]
_SELF = Path(__file__).resolve()
_TP = _PKG / "dist" / "tensor_parallel.py"

#: aten ops that move no data although their schemas do not mark them views.
_NO_BYTES = {
    "detach", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "alias", "set_", "resize_", "_reshape_alias",
    "is_same_size", "_has_compatible_shallow_copy_type", "_wrap_tensor_autograd",
    "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset",
}

# c10d op name -> reference collective kind.
_KIND_RE = (
    (re.compile(r"all_?gather"), "all-gather"),
    (re.compile(r"reduce_?scatter"), "reduce-scatter"),
    (re.compile(r"all_?reduce"), "all-reduce"),
    (re.compile(r"all_?to_?all"), "all-to-all"),
    (re.compile(r"^(send|recv_|recv_any_source_)$"), "collective-permute"),
)


def collective_kind(func) -> str | None:
    """The reference's collective name of a c10d op, or None."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
        return None
    name = func._opname
    for pat, kind in _KIND_RE:
        if pat.search(name):
            return kind
    return None


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (elements times element size)."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class OpCost:
    """The reference's ``HloCost`` fields and methods, plus the peak live
    bytes, the kernels' reported work and the ops counted."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_by_source: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unknown_trip_counts: int = 0
    argument_bytes: int = 0
    peak_bytes: int = 0
    n_ops: int = 0
    kernel_work: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    #: aten op -> [calls, bytes, flops]: where two counts of one program part.
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    def top_collective_sources(self, n: int = 12):
        return sorted(self.collective_by_source.items(), key=lambda kv: -kv[1])[:n]

    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_total": self.total_collective_bytes(),
            "unknown_trip_counts": self.unknown_trip_counts,
            "argument_bytes": self.argument_bytes,
            "peak_bytes": self.peak_bytes,
            "n_ops": self.n_ops,
            "kernel_work": {k: dict(v) for k, v in self.kernel_work.items()},
        }

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One kernel launch's reported work (``kernels.work_hook``)."""
        self.flops += flops
        self.hbm_bytes += nbytes
        w = self.kernel_work.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        w["launches"] += 1
        w["flops"] += flops
        w["bytes"] += nbytes


def _source() -> str:
    """``file:line (function)`` of the innermost frame in the port's
    package outside this module; a collective that ``dist/tensor_parallel.py``
    issues in the forward is attributed to the line that called it,
    followed by ``via`` its own line there (so the two reduces of one
    call, the merge's, stay apart), one it issues in the backward to its
    own ``backward``."""
    f = sys._getframe(2)
    via = ""
    while f is not None:
        path = Path(f.f_code.co_filename)
        if path == _TP and f.f_code.co_name != "backward":
            via = f" via {f.f_code.co_name}:{f.f_lineno}"   # the outermost there
        if path != _SELF and _PKG in path.parents and (
                path != _TP or f.f_code.co_name == "backward"):
            return f"{path.relative_to(_PKG)}:{f.f_lineno} ({f.f_code.co_name}){via}"
        f = f.f_back
    return "(unattributed)"


def _storage_key(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


class _Live:
    """Live storage bytes: the arguments' storages (held throughout) plus
    every storage an op creates, until its last tracked tensor is freed."""

    def __init__(self, args) -> None:
        self.refs: Dict[int, int] = {}
        self.sizes: Dict[int, int] = {}
        self.fixed: set = set()
        self.base = 0
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)     # a DTensor's own block
                key, n = _storage_key(t)
                if key not in self.fixed:
                    self.fixed.add(key)
                    self.base += n
        self.now = self.base
        self.peak = self.base

    def track(self, t: torch.Tensor) -> None:
        key, n = _storage_key(t)
        if key in self.fixed:
            return
        if key not in self.refs:
            self.refs[key], self.sizes[key] = 0, n
            self.now += n
            self.peak = max(self.peak, self.now)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self.refs[key] -= 1
        if self.refs[key] == 0:
            del self.refs[key]
            self.now -= self.sizes.pop(key)


def _is_subclass(t: torch.Tensor) -> bool:
    return type(t) not in (torch.Tensor, torch.nn.Parameter)


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: OpCost, live: _Live) -> None:
        super().__init__()
        self.cost, self.live = cost, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        subs = [t for t in flat if isinstance(t, torch.Tensor) and _is_subclass(t)]
        if any(isinstance(t, DTensor) for t in subs):
            # A DTensor runs its local ops, which come back here.
            return NotImplemented
        if subs:
            # Another subclass (DTensor's sharding propagation runs ops on
            # fake tensors): metadata, not the step's work.
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        cost = self.cost
        cost.n_ops += 1
        rec = cost.by_op.setdefault(str(func), [0, 0.0, 0.0])
        rec[0] += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            cost.flops += flops
            rec[2] += flops
        kind = collective_kind(func)
        if kind is not None:
            # In-place c10d ops write their first argument; the functional
            # ones return their output.
            nbytes = tensor_bytes(args[0] if func.namespace == "c10d" else out)
            cost.collective_bytes[kind] += nbytes
            cost.collective_counts[f"{kind}_count"] += 1
            cost.collective_by_source[f"{kind}: {_source()}"] += nbytes
        if not (func.is_view or func._opname in _NO_BYTES):
            nbytes = tensor_bytes(flat) + tensor_bytes(out)
            cost.hbm_bytes += nbytes
            rec[1] += nbytes
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.live.track(t)
        cost.peak_bytes = self.live.peak
        return out


@contextlib.contextmanager
def counting(args=()) -> Iterator[OpCost]:
    """Count what runs inside the block into the yielded :class:`OpCost`.
    ``args``: the step's arguments (any tree of tensors), whose storages
    are live throughout and start the peak. Sets ``kernels.work_hook``
    for the block (one counter at a time)."""
    if kernels.work_hook is not None:
        raise RuntimeError("a kernel-work counter is already active")
    cost = OpCost()
    live = _Live(args)
    cost.argument_bytes = cost.peak_bytes = live.base
    kernels.work_hook = cost.add_kernel
    try:
        with _CostMode(cost, live):
            yield cost
    finally:
        kernels.work_hook = None
        cost.peak_bytes = live.peak


def count(fn, *args, **kwargs) -> Tuple[object, OpCost]:
    """(``fn(*args, **kwargs)``, its :class:`OpCost`), the arguments live
    throughout."""
    with counting((args, kwargs)) as cost:
        out = fn(*args, **kwargs)
    return out, cost
