"""RMSNorm: the hand-written CUDA kernels (``csrc/rmsnorm.cu``), forward
and backward, and their plain PyTorch versions.

Port of the Pallas TPU kernel ``rmsnorm_fwd``
(``src/repro/kernels/rmsnorm/kernel.py``), following the rounding order
of ``layers.rms_norm`` — the function the reference model runs: the
normalized row is rounded to the input dtype before the scale multiply.
The Pallas kernel keeps f32 through the scale multiply instead; the two
agree exactly in f32 and differ by one rounding in bf16. The reference
has no backward kernel (XLA differentiates ``layers.rms_norm``); here
the backward is a kernel too.

``rms_norm`` is an ``autograd.Function``: its forward is the forward
kernel and its backward ``rms_norm_bwd``, the backward kernel. Each takes its plain version for tensors on the CPU and launches
its kernel for CUDA tensors (or raises); ``rms_norm.launches`` and
``rms_norm_bwd.launches`` count kernel launches.

The kernels hold each row in registers, a group of threads (a warp or a
block) to a row, in a persistent grid; ``launch_plan`` chooses the
group's width, the 16-byte vectors (or elements) each thread holds and the
grid, from the table of instances the CUDA source builds (``INSTANCES``).

Meta tensors take a shape branch: the CUDA path's outputs (and the
backward's dscale scratch, planned for ``META_SMS`` SMs), no launch.
``rms_norm_work`` and ``rms_norm_bwd_work`` give one launch's (FLOPs,
bytes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

import repro_torch.kernels as _kernels
from . import _build
from .decode_attention import META_SMS, sm_count

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "launch_plan", "Plan", "rms_norm_work", "rms_norm_bwd_work"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Widest row the backward takes in 16-byte vectors (D a multiple of 8 in
#: bf16, of 4 in f32, and 16-byte aligned pointers), and in single
#: elements; the forward takes 16384 and 8192 (``INSTANCES``; wider rows
#: have no plan, and ``launch_plan`` raises).
MAX_BWD_DIM = 8192
MAX_BWD_DIM_ELEMENTS = 4096

#: Units (16-byte vectors, or single elements) a thread may hold.
J_CHOICES = (1, 2, 4, 8, 16)
#: The instances ``csrc/rmsnorm.cu`` builds (its ``kInstances``):
#: (backward, element bytes, 16-byte vectors, J) -> (the most threads a
#: block of it may have, whether it prefetches the next row).
INSTANCES = {
    (False, 2, True, 1): (1024, True), (False, 2, True, 2): (512, True),
    (False, 2, True, 4): (512, True), (False, 2, True, 8): (256, False),
    (False, 4, True, 1): (1024, True), (False, 4, True, 2): (512, True),
    (False, 4, True, 4): (512, True), (False, 4, True, 8): (512, False),
    (False, 2, False, 1): (1024, True), (False, 2, False, 2): (1024, True),
    (False, 2, False, 4): (1024, True), (False, 2, False, 8): (512, True),
    (False, 2, False, 16): (512, True),
    (False, 4, False, 1): (1024, True), (False, 4, False, 2): (1024, True),
    (False, 4, False, 4): (1024, True), (False, 4, False, 8): (512, True),
    (False, 4, False, 16): (512, True),
    (True, 2, True, 1): (512, True), (True, 2, True, 2): (512, True),
    (True, 2, True, 4): (256, False),
    (True, 4, True, 1): (1024, True), (True, 4, True, 4): (512, False),
    (True, 2, False, 1): (1024, True), (True, 2, False, 2): (1024, True),
    (True, 2, False, 4): (512, True), (True, 2, False, 8): (512, True),
    (True, 4, False, 1): (1024, True), (True, 4, False, 2): (1024, True),
    (True, 4, False, 4): (512, True), (True, 4, False, 8): (512, True),
}
#: Rows (warps) a block holds where a warp owns a row.
WARP_ROWS = 4

#: The plan's defaults (forward, backward), chosen with
#: ``tools/rmsnorm_tiles.py`` on the card: the units a thread holds where
#: the rows fill the card (at least ``FEW_ROWS`` a SM; fewer rows are a
#: matter of latency, and a thread then holds one unit), and the resident
#: threads asked per SM.
UNITS_PER_THREAD = {False: 4, True: 2}
THREADS_PER_SM = {False: 2048, True: 512}
FEW_ROWS = 4


def _units(dim: int, elem_bytes: int, vec: bool) -> int:
    return -(-dim // (16 // elem_bytes if vec else 1))


def max_threads(bwd: bool, elem_bytes: int, vec: bool, j: int) -> int:
    """Most threads a block of the (kernel, dtype, vec, J) instance may
    have; 0 where the source builds no such instance."""
    return INSTANCES.get((bwd, elem_bytes, vec, j), (0, False))[0]


class Plan(NamedTuple):
    """One launch: 16-byte vectors or single elements, threads per row
    (32: a warp owns a row and a block holds ``rows_per_block`` of them;
    else a block owns a row), units per thread and the grid. The rows are
    dealt to ``groups`` groups in turn (row r to group r % groups)."""

    vec: bool
    tpr: int
    j: int
    rows_per_block: int
    blocks: int

    @property
    def groups(self) -> int:
        return self.blocks * (self.rows_per_block if self.tpr == 32 else 1)

    @property
    def threads(self) -> int:
        return 32 * self.rows_per_block if self.tpr == 32 else self.tpr


def _fits(bwd: bool, elem_bytes: int, vec: bool, units: int, tpr: int) -> Optional[int]:
    """The fewest units per thread that cover a row at ``tpr`` threads with
    an instance that takes them, or None."""
    for j in J_CHOICES:
        if tpr * j >= units and 32 <= tpr <= max_threads(bwd, elem_bytes, vec, j):
            return j
    return None


@functools.lru_cache(maxsize=None)
def launch_plan(bwd: bool, rows: int, dim: int, elem_bytes: int, vec: bool, n_sms: int,
                threads_per_row: Optional[int] = None,
                threads_per_sm: Optional[int] = None) -> Plan:
    """The launch of the forward (``bwd`` False) or backward kernel over
    ``rows`` rows of ``dim`` elements of ``elem_bytes`` bytes, in 16-byte
    vectors (``vec``) or single elements, on ``n_sms`` SMs.

    Threads per row: ``threads_per_row``, or the least power of two (32 to
    1024) that gives each thread at most ``UNITS_PER_THREAD`` units (one
    below ``FEW_ROWS`` rows a SM) and that an instance takes (else the
    widest that one takes). Grid:
    ``threads_per_sm`` (``THREADS_PER_SM``) resident threads asked per SM,
    and never more blocks than rows.
    Raises ValueError where no instance covers the row."""
    if vec and dim % (16 // elem_bytes):
        raise ValueError(f"16-byte vectors need a row of a multiple of "
                         f"{16 // elem_bytes} elements, not {dim}")
    units = _units(dim, elem_bytes, vec)
    if threads_per_row is None:
        per_thread = UNITS_PER_THREAD[bwd] if rows >= FEW_ROWS * n_sms else 1
        want = -(-units // per_thread)
        fit = [t for t in (32, 64, 128, 256, 512, 1024)
               if _fits(bwd, elem_bytes, vec, units, t) is not None]
        tpr = next((t for t in fit if t >= want), fit[-1] if fit else 0)
    else:
        tpr = threads_per_row
    j = _fits(bwd, elem_bytes, vec, units, tpr) if tpr and tpr % 32 == 0 else None
    if j is None:
        raise ValueError(f"no rmsnorm {'backward' if bwd else 'forward'} instance covers a "
                         f"row of {dim} at {tpr} threads")
    rpb = WARP_ROWS if tpr == 32 else 1
    per_block = 32 * rpb if tpr == 32 else tpr
    per_sm = max(1, (threads_per_sm or THREADS_PER_SM[bwd]) // per_block)
    blocks = max(1, min(-(-rows // rpb), n_sms * per_sm))
    return Plan(vec, tpr, j, rpb, blocks)


def bwd_scratch(plan: Plan, dim: int, device: torch.device) -> torch.Tensor:
    """The backward's f32 dscale scratch: one row per group of ``plan``."""
    return torch.empty((plan.groups, dim), dtype=torch.float32, device=device)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mirror of ``layers.rms_norm``: mean of squares in f32, rsqrt, round
    to x's dtype, then multiply by ``scale``."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rms_norm_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx, dscale) of ``rms_norm_plain`` for the output
    gradient ``g``, as the backward kernel forms them. With
    r = rsqrt(mean(x²) + eps) and n = x·r in f32, x̂ = n rounded to x's
    dtype (the forward's rounding) and ĝ = g·scale rounded to x's dtype
    (the product's gradient in the input dtype, as JAX forms it):
    dx = r·(ĝ − n·mean(ĝ·n)) and dscale = Σ_rows g·x̂, summed in f32."""
    dt = x.dtype
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    gf = g.float().reshape(-1, D)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = xf * r
    gh = (gf * scale.float()).to(dt).float()
    mean = torch.mean(gh * n, dim=-1, keepdim=True)
    dx = (r * (gh - n * mean)).to(dt).reshape(x.shape)
    dscale = (gf * n.to(dt).float()).sum(dim=0).to(scale.dtype)
    return dx, dscale


def rms_norm_work(rows: int, D: int, elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K2 forward launch: ~4 f32 operations an
    element; x read and y written, the scale read."""
    return 4 * rows * D, (2 * rows * D + D) * elem_bytes


def rms_norm_bwd_work(rows: int, D: int, elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K2 backward launch (its two launches): ~10 f32
    operations an element; x and g read and dx written, the scale read
    and dscale written (the partial-dscale scratch is not counted)."""
    return 10 * rows * D, (3 * rows * D + 2 * D) * elem_bytes


def _check(x: torch.Tensor, scale: torch.Tensor, *more: torch.Tensor) -> int:
    D = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rms_norm takes f32 or bf16 x with a scale of the same "
                        f"dtype, not {x.dtype} / {scale.dtype}")
    if scale.shape != (D,) or scale.device != x.device:
        raise ValueError(f"scale must be ({D},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    for t in more:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"gradient {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"match x {tuple(x.shape)} {x.dtype} on {x.device}")
    if not all(t.is_contiguous() for t in (x, scale, *more)):
        raise ValueError("rms_norm needs contiguous inputs")
    return x.numel() // D if D else 0


def _plan(bwd: bool, rows: int, *ts: torch.Tensor) -> Plan:
    x = ts[0]
    D = x.shape[-1]
    es = x.element_size()
    vec = D % (16 // es) == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    return launch_plan(bwd, rows, D, es, vec, sm_count(x.device.index))


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type == "meta":
        rows = _check(x, scale)
        out = torch.empty_like(x)
        if rows:
            _kernels.report_work("rmsnorm", rms_norm_work(rows, x.shape[-1], x.element_size()))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    rows = _check(x, scale)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    p = _plan(False, rows, x, scale, out)
    lib = _build.load_library()
    rc = lib.repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, x.shape[-1], float(eps),
        _DTYPES[x.dtype], int(p.vec), p.tpr, p.j, p.rows_per_block, p.blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    rms_norm.launches += 1
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc}, plan {p})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("rmsnorm", *rms_norm_work(rows, x.shape[-1], x.element_size()))
    return out


def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 backward: (dx, dscale) for the output gradient ``g`` of
    ``rms_norm(x, scale)``; two launches (rows, then a per-column sum of
    the row groups' partial dscale, one scratch row per group of
    ``launch_plan``'s plan) counted as one."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(g, x, scale, eps)
    if x.device.type == "meta":
        rows = _check(x, scale, g)
        D, es = x.shape[-1], x.element_size()
        dx = torch.empty_like(x)
        if rows == 0:
            return dx, torch.zeros_like(scale)
        dscale = torch.empty_like(scale)
        p = launch_plan(True, rows, D, es, D % (16 // es) == 0, META_SMS)
        part = bwd_scratch(p, D, x.device)  # noqa: F841
        _kernels.report_work("rmsnorm_bwd", rms_norm_bwd_work(rows, D, es))
        return dx, dscale
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd runs on cpu or cuda, not {x.device}")
    rows = _check(x, scale, g)
    D = x.shape[-1]
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    p = _plan(True, rows, g, x, scale, dx)
    part = bwd_scratch(p, D, x.device)
    lib = _build.load_library()
    rc = lib.repro_rmsnorm_bwd(
        g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        part.data_ptr(), rows, D, float(eps), _DTYPES[x.dtype], int(p.vec), p.tpr, p.j,
        p.rows_per_block, p.blocks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    rms_norm_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed (code {rc}, plan {p})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("rmsnorm_bwd", *rms_norm_bwd_work(rows, D, x.element_size()))
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """K2 forward, with K2 backward as its gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(g.contiguous(), x, scale, ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (..., D) with ``scale`` (D,),
    differentiable in both."""
    return RMSNormFn.apply(x, scale, eps)


rms_norm.launches = 0
rms_norm_bwd.launches = 0
