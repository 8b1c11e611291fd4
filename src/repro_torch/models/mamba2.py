"""Mamba2 (SSD) block (port of ``repro.models.mamba2``).

Shapes follow the reference: d_inner = expand * d_model, H = d_inner / P
heads of size P = head_dim, G groups sharing the B/C projections, state
size N = d_state.

  * ``ssd_chunked``       — training: the chunked scan through kernel K5
                            (forward and backward) for CUDA tensors, its
                            plain version on the CPU;
  * ``ssd_recurrent``     — the step-by-step recurrence, plain PyTorch:
                            the serving step (as the reference serves
                            with it) and the tests' oracle;
  * ``mamba2_apply``      — one block's training forward;
  * ``mamba2_decode``     — one token against the carried conv and SSM
                            states, updated in place (lanes outside the
                            tick's mask keep theirs);
  * ``mamba2_state_spec`` — those states' spec for one layer.

Both gated RMSNorms run through K2. The depthwise causal convolution
stays plain PyTorch, as the reference leaves it to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ssd_scan as _ssd_kernel
from .layers import ParamSpec, norm_specs, rms_norm, slot_mask_select_

__all__ = [
    "mamba2_specs",
    "mamba2_apply",
    "mamba2_decode",
    "mamba2_state_spec",
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


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time: x (B, S, D), w (W, D); sum the W
    shifted windows, SiLU.

    Training form (no ``state``): left-pad W - 1 zeros -> y. Decode form:
    prepend the cached last W - 1 inputs ``state`` (B, W - 1, D), cast to
    x's dtype -> (y, the new last W - 1 inputs)."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        x_pad = F.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    y = F.silu(sum(x_pad[:, i:i + S] * w[i] for i in range(W)) + b)
    if state is None:
        return y
    return y, x_pad[:, x_pad.shape[1] - (W - 1):]


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


def mamba2_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Dict[str, torch.Tensor],
                  mask: Optional[torch.Tensor] = None):
    """One token x (B, 1, d_model) of one Mamba2 block against its carried
    ``state`` {"conv": (B, W - 1, conv_dim), "ssm": (B, H, P, N) f32} ->
    (out (B, 1, d_model), state). The states are updated in place; lanes
    where ``mask`` (B,) is False keep theirs (``slot_mask_select_``)."""
    proj = x @ params["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   state=state["conv"])
    xh, Bm, Cm = _split_xbc(cfg, xbc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    y, ssm_state = ssd_recurrent(xh, dt, A, Bm, Cm, state=state["ssm"])
    y = y + params["d_skip"].to(y.dtype)[:, None] * xh
    y = y.reshape(x.shape[0], 1, -1)
    y = rms_norm(y * F.silu(z), params["norm"]["scale"])
    slot_mask_select_(state["conv"], conv_state, mask)
    slot_mask_select_(state["ssm"], ssm_state, mask)
    return y @ params["w_out"], state


def mamba2_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    """One layer's decode state: the last d_conv - 1 conv inputs in the
    model's dtype and the SSM state in f32, batch on the "act_batch" axis."""
    ssm: SSMConfig = cfg.ssm
    d_inner, H, P, G, N = _dims(cfg)
    conv_dim = d_inner + 2 * G * N
    return {
        "conv": ParamSpec((batch, ssm.d_conv - 1, conv_dim),
                          ("act_batch", None, "ssm_inner"), "zeros", cfg.dtype),
        "ssm": ParamSpec((batch, H, P, N),
                         ("act_batch", "ssm_heads", None, None), "zeros", "float32"),
    }
