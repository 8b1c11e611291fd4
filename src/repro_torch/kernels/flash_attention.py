"""Flash attention: the hand-written CUDA kernels
(``csrc/flash_attention.cu``), forward (K1) and backward, and their plain
PyTorch versions.

Port of the Pallas TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attention/kernel.py``): GQA attention, causal
(top-left aligned: query i sees keys j <= i) or bidirectional, over
q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) with out
(B, Sq, H, Dv) in q's dtype. The reference differentiates its jnp
attention with XLA; here the backward is a kernel too
(FlashAttention-2's recompute from the row log-sum-exp LSE).

``flash_attention`` is an ``autograd.Function``: its forward is the
forward kernel and its backward ``flash_attention_bwd``. Each takes its
plain version for tensors on the CPU and launches its kernel for CUDA
tensors (or raises); ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches (the backward's
two launches count as one).

In bf16 the kernels run on the tensor cores and round P and dS to bf16
before their second product; ``flash_attention_rounding_terms`` gives
what that may move each output by, for ``parity.flash_within``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

__all__ = [
    "HEAD_DIMS",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_plain",
    "flash_attention_bwd_plain",
    "flash_attention_rounding_terms",
]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (D, Dv) pairs the kernels are built for: D and Dv each in 32, 64, 128,
#: and hubert-xlarge's (80, 80) alone (not the whole cross product with 80).
HEAD_DIMS = tuple((d, dv) for d in (32, 64, 128) for dv in (32, 64, 128)) + ((80, 80),)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores (B, Hkv, G, Sq, Skv) of q scaled by 1/sqrt(D) after its
    f32 cast, masked to NEG_INF above the top-left causal diagonal."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if causal:
        keep = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, Dv) in q's dtype, LSE (B, H, Sq) f32): the kernel's
    function step by step.

    q is scaled AFTER its f32 cast, as the Pallas kernel does. The
    reference model's ``mea_attention`` scales in the input dtype first;
    for D = 64 (llama3.2-1b, smollm-135m) the scale is 1/8 and the two
    agree exactly, for D = 128 they differ by one bf16 rounding of q, and
    in f32 they agree."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l.clamp_min(1e-30), v.float())
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0].reshape(B, H, Sq)
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype).contiguous(), lse


def _p_ds(q, k, v, o, lse, do, causal: bool):
    """P = exp(S - LSE) (B, Hkv, G, Sq, Skv), dO in f32 (B, Sq, Hkv, G, Dv)
    and dS = P * (dO V^T - Delta), Delta = rowsum(dO * O), all f32."""
    B, Sq, H, _ = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))      # masked scores give 0
    dof = do.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (dof * o.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)        # (B, Sq, Hkv, G)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    return p, dof, p * (dp - delta.permute(0, 2, 3, 1)[..., None])


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool):
    """(dq, dk, dv) in the inputs' dtypes: the backward kernels' recompute
    step by step. P = exp(S - LSE), Delta = rowsum(dO * O),
    dS = P * (dO V^T - Delta); dq = dS K / sqrt(D), dk = dS^T q / sqrt(D),
    dv = P^T dO, all in f32."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    p, dof, ds = _p_ds(q, k, v, o, lse, do, causal)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    qf = q.float().reshape(B, Sq, Hkv, G, D) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_rounding_terms(q, k, v, o, lse, do, *, causal: bool):
    """(out, dq, dk, dv)-shaped f32 sums of |term| over each output's
    second product: P |V| for out (P normalized), P^T |dO| for dv,
    |dS| |K| / sqrt(D) for dq and |dS|^T |q| / sqrt(D) for dk.

    The bf16 kernels round P and dS to bf16 before those products, a
    rounding the plain version does not make; it moves each term by at
    most bf16's unit roundoff of its size, so each output by at most that
    unit times these sums (``parity.flash_within``)."""
    B, Sq, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    p, dof, ds = _p_ds(q, k, v, o, lse, do, causal)
    ds = ds.abs()
    t_out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float().abs()).reshape(B, Sq, H, Dv)
    t_dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof.abs())
    t_dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float().abs()).reshape(B, Sq, H, D) * scale
    t_dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().abs().reshape(B, Sq, Hkv, G, D))
    return t_out, t_dq, t_dk * scale, t_dv


def _check(q, k, v, *more) -> Tuple[int, ...]:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes f32 or bf16 q/k/v of one dtype, "
                        f"not {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q (B, Sq, H, D), k (B, Skv, Hkv, D), "
                         "v (B, Skv, Hkv, Dv)")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    Dv = v.shape[-1]
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or Hkv < 1 or H % Hkv or Sq < 1 or Skv < 1):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (need H % Hkv == 0, Sq, Skv >= 1)")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take (D, Dv) in {HEAD_DIMS}, "
                         f"not D={D}, Dv={Dv}")
    for t in (q, k, v, *more):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError("flash attention needs 16-byte aligned inputs (16-byte copies)")
    return B, Sq, Skv, H, Hkv, D, Dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 forward: (out, LSE (B, H, Sq) f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, Sq, Skv, H, Hkv, D, Dv = _check(q, k, v)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    rc = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Skv, H, Hkv, D, Dv, 1.0 / math.sqrt(D), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention.launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool):
    """K1 backward: (dq, dk, dv) in the inputs' dtypes, from the forward's
    out ``o`` and ``lse`` and the output gradient ``do``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not {q.device}")
    B, Sq, Skv, H, Hkv, D, Dv = _check(q, k, v, o, lse, do)
    if o.shape != (B, Sq, H, Dv) or do.shape != o.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype or lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}, v {tuple(v.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, Hkv, D, Dv, 1.0 / math.sqrt(D), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed (code {rc})")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward, with the K1 backward as its gradient. Saves q, k, v,
    out and LSE — under ``torch.utils.checkpoint`` the forward runs again
    in the backward pass and saves them anew."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """K1: attention out (B, Sq, H, Dv), differentiable in q, k and v."""
    return FlashAttentionFn.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
