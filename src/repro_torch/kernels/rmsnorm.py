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
kernel and its backward ``rms_norm_bwd``, the backward kernel. Each
takes its plain version for tensors on the CPU and launches its kernel
for CUDA tensors (or raises); ``rms_norm.launches`` and
``rms_norm_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Widest row the backward kernel takes (32 f32 dscale accumulators per
#: thread, at most 256 threads per row).
MAX_BWD_DIM = 32 * 256


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


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    rows = _check(x, scale)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library()
    rc = lib.repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, x.shape[-1], float(eps),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    rms_norm.launches += 1
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc})")
    return out


def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 backward: (dx, dscale) for the output gradient ``g`` of
    ``rms_norm(x, scale)``; two launches (rows, then a per-column sum of
    the row groups' partial dscale) counted as one."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(g, x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd runs on cpu or cuda, not {x.device}")
    rows = _check(x, scale, g)
    D = x.shape[-1]
    if D > MAX_BWD_DIM:
        raise ValueError(f"rms_norm_bwd takes rows of at most {MAX_BWD_DIM}, not {D}")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    lib = _build.load_library()
    part = torch.empty((lib.repro_rmsnorm_bwd_groups(rows, D), D), dtype=torch.float32,
                       device=x.device)
    rc = lib.repro_rmsnorm_bwd(
        g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        part.data_ptr(), rows, D, float(eps), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    rms_norm_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed (code {rc})")
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
