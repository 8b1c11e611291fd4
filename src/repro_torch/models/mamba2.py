"""Mamba2 (SSD) block, training path (port of ``repro.models.mamba2``).

Shapes follow the reference: d_inner = expand * d_model, H = d_inner / P
heads of size P = head_dim, G groups sharing the B/C projections, state
size N = d_state.

  * ``ssd_chunked``   — training: the chunked scan through kernel K5
                        (forward and backward) for CUDA tensors, its plain
                        version on the CPU;
  * ``ssd_recurrent`` — the step-by-step recurrence, plain PyTorch (the
                        tests' oracle; finite at any decay);
  * ``mamba2_apply``  — one block's training forward; its gated RMSNorm
                        runs through K2.

The depthwise causal convolution stays plain PyTorch, as the reference
leaves it to XLA. The decode path (``mamba2_decode``,
``mamba2_state_spec``) waits for the hybrid serving slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ssd_scan as _ssd_kernel
from .layers import ParamSpec, norm_specs, rms_norm

__all__ = [
    "mamba2_specs",
    "mamba2_apply",
    "ssd_chunked",
    "ssd_recurrent",
]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    ssm: SSMConfig = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    H = d_inner // ssm.head_dim
    return d_inner, H, ssm.head_dim, ssm.n_groups, ssm.d_state


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    ssm: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, H, P, G, N = _dims(cfg)
    dt = cfg.dtype
    conv_dim = d_inner + 2 * G * N
    return {
        # order: [z, x, B, C, dt]
        "w_in": ParamSpec(
            (d, 2 * d_inner + 2 * G * N + H), ("embed", "ssm_inner"), "scaled", dt
        ),
        "conv_w": ParamSpec((ssm.d_conv, conv_dim), (None, "ssm_inner"), "scaled", dt),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros", dt),
        "a_log": ParamSpec((H,), ("ssm_heads",), "ones", "float32"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "zeros", "float32"),
        "d_skip": ParamSpec((H,), ("ssm_heads",), "ones", "float32"),
        "norm": norm_specs(d_inner, "rmsnorm", dt),
        "w_out": ParamSpec((d_inner, d), ("ssm_inner", "embed"), "scaled", dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, training form: x (B, S, D),
    w (W, D); left-pad W - 1 zeros, sum the W shifted windows, SiLU."""
    W, S = w.shape[0], x.shape[1]
    x_pad = F.pad(x, (0, 0, W - 1, 0))
    y = sum(x_pad[:, i:i + S] * w[i] for i in range(W)) + b
    return F.silu(y)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, H, P, G, N = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * G * N, H], dim=-1)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_inner, H, P, G, N = _dims(cfg)
    x, B, C = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    return (
        x.reshape(Bsz, S, H, P),
        B.reshape(Bsz, S, G, N),
        C.reshape(Bsz, S, G, N),
    )


def ssd_recurrent(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H) positive
    A: torch.Tensor,      # (H,) negative
    Bm: torch.Tensor,     # (B, S, G, N)
    Cm: torch.Tensor,     # (B, S, G, N)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Step-by-step SSM: s_t = exp(dt*A) s_{t-1} + dt * x_t B_t^T ;
    y_t = s_t C_t -> (y in x's dtype, final state (B, H, P, N) f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg = H // G
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * A)[..., None, None]
        bt = Bm[:, t].repeat_interleave(hg, dim=1).float()
        ct = Cm[:, t].repeat_interleave(hg, dim=1).float()
        upd = dtt[..., None, None] * x[:, t].float()[..., None] * bt[:, :, None, :]
        s = decay * s + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD (Mamba2's algorithm): quadratic within chunks, a scan
    across them -> (y in x's dtype, final state (B, H, P, N) f32), through
    K5 (differentiable in x, dt, A, B, C; the final state is not)."""
    return _ssd_kernel(x.contiguous(), dt.contiguous(), A.contiguous(), Bm.contiguous(),
                       Cm.contiguous(), chunk=chunk)


def mamba2_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training forward of one Mamba2 block (no state carried in)."""
    proj = x @ params["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xh, Bm, Cm = _split_xbc(cfg, xbc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
    y = y + params["d_skip"].to(y.dtype)[:, None] * xh
    Bsz, S = x.shape[0], x.shape[1]
    y = y.reshape(Bsz, S, -1)
    y = rms_norm(y * F.silu(z), params["norm"]["scale"])
    return y @ params["w_out"]
