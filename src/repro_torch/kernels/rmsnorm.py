"""RMSNorm: the hand-written CUDA kernel (``csrc/rmsnorm.cu``) and its
plain PyTorch version.

Port of the Pallas TPU kernel ``rmsnorm_fwd``
(``src/repro/kernels/rmsnorm/kernel.py``), following the rounding order
of ``layers.rms_norm`` — the function the reference model runs: the
normalized row is rounded to the input dtype before the scale multiply.
The Pallas kernel keeps f32 through the scale multiply instead; the two
agree exactly in f32 and differ by one rounding in bf16.

``rms_norm`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises); ``rms_norm.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mirror of ``layers.rms_norm``: mean of squares in f32, rsqrt, round
    to x's dtype, then multiply by ``scale``."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (..., D) with ``scale`` (D,)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rms_norm takes f32 or bf16 x with a scale of the same "
                        f"dtype, not {x.dtype} / {scale.dtype}")
    if scale.shape != (D,) or scale.device != x.device:
        raise ValueError(f"scale must be ({D},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm needs contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _build.load_library()
    rc = lib.repro_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    rms_norm.launches += 1
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc})")
    return out


rms_norm.launches = 0
