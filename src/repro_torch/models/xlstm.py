"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory)
and sLSTM (scalar memory).

  * ``mlstm_parallel``   — the stabilised parallel (quadratic) form, the
                           training forward;
  * ``mlstm_recurrent``  — the same recurrence step by step from a carried
                           (C, n, m) state: the serving step;
  * ``mlstm_apply`` / ``mlstm_decode`` — one mLSTM block's training
                           forward, and one token against its carried conv
                           and (C, n, m) states;
  * ``slstm_apply``      — one sLSTM block: a scan over time with
                           exponential gates stabilised by a running max
                           and per-head hidden-to-hidden weights; from a
                           fresh state (training) or a carried one (decode);
  * ``*_state_spec``     — one layer's decode state, batch on "act_batch".

Gate arithmetic (``log_f``, the stabiliser ``m``, the gate activations)
and the memories are f32, as in the reference. The sLSTM normaliser
state starts at ones (its spec's init, which the slot pool's reset
restores). Decode updates the states in place; lanes where the tick's
mask is False keep theirs (``layers.slot_mask_select_``). The block norms
(the mLSTM's at its inner width, the sLSTM's at d_model) run through K2;
the projections, the causal convolution and the recurrences are plain
PyTorch, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from .layers import ParamSpec, norm_specs, rms_norm, slot_mask_select_
from .mamba2 import _causal_conv

__all__ = [
    "mlstm_specs", "mlstm_apply", "mlstm_decode", "mlstm_state_spec",
    "slstm_specs", "slstm_apply", "slstm_state_spec",
    "mlstm_parallel", "mlstm_recurrent",
]

NEG_INF = -1e30


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    xc: XLSTMConfig = cfg.xlstm
    d_in = int(cfg.d_model * xc.mlstm_proj_factor)
    H = cfg.n_heads
    return d_in, H, d_in // H


# ---------------------------------------------------------------------------
# mLSTM core math
# ---------------------------------------------------------------------------

def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """Stabilised parallel form (xLSTM paper eq. 19-27): q/k/v (B, S, H, D),
    gate preactivations (B, S, H) -> h (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    log_f = F.logsigmoid(f_pre.float())                            # (B, S, H)
    cum = torch.cumsum(log_f, dim=1)
    # dmat[t, s] = F_t - F_s + i_s   (s <= t)
    dmat = cum[:, :, None, :] - cum[:, None, :, :] + i_pre.float()[:, None, :, :]
    idx = torch.arange(S, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    dmat = dmat.masked_fill(~causal[None, :, :, None], NEG_INF)
    m = dmat.amax(dim=2)                                           # (B, S, H) row max
    dexp = torch.exp(dmat - m[:, :, None, :])
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bthd,bshd->btsh", q.float() * scale, k.float())
    w = scores * dexp
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m))        # (B, S, H)
    h = torch.einsum("btsh,bshd->bthd", w, v.float()) / norm[..., None]
    return h.to(q.dtype)


def mlstm_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """The recurrence step by step over a (possibly length-1) sequence from
    ``state`` = (C (B, H, D, D), n (B, H, D), m (B, H)), all f32 ->
    (h (B, S, H, D) in q's dtype, the final state). The inputs' state
    tensors are not written."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    C, n, m = state
    hs = []
    for t in range(S):
        it = i_pre[:, t].float()
        log_f = F.logsigmoid(f_pre[:, t].float())                  # (B, H)
        m_new = torch.maximum(log_f + m, it)
        f_act = torch.exp(log_f + m - m_new)[..., None]
        i_act = torch.exp(it - m_new)[..., None]
        kf = k[:, t].float() * scale
        vf = v[:, t].float()
        C = f_act[..., None] * C + i_act[..., None] * (kf[..., :, None] * vf[..., None, :])
        n = f_act * n + i_act * kf
        qf = q[:, t].float()
        num = torch.einsum("bhd,bhde->bhe", qf, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    xc: XLSTMConfig = cfg.xlstm
    d = cfg.d_model
    d_in, H, Dh = _mlstm_dims(cfg)
    dt = cfg.dtype
    return {
        "w_up": ParamSpec((d, 2 * d_in), ("embed", "ffn"), "scaled", dt),
        "conv_w": ParamSpec((xc.conv1d_kernel, d_in), (None, "ffn"), "scaled", dt),
        "conv_b": ParamSpec((d_in,), ("ffn",), "zeros", dt),
        "wq": ParamSpec((d_in, d_in), ("ffn", "ffn_out"), "scaled", dt),
        "wk": ParamSpec((d_in, d_in), ("ffn", "ffn_out"), "scaled", dt),
        "wv": ParamSpec((d_in, d_in), ("ffn", "ffn_out"), "scaled", dt),
        "w_if": ParamSpec((d_in, 2 * H), ("ffn", None), "scaled", dt),
        "b_if": ParamSpec((2 * H,), (None,), "zeros", "float32"),
        "norm": norm_specs(d_in, "rmsnorm", dt),
        "w_down": ParamSpec((d_in, d), ("ffn", "embed"), "scaled", dt),
    }


def _mlstm_qkvif(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: Optional[torch.Tensor] = None):
    """x (B, S, d) -> q, k, v (B, S, H, Dh), gate preactivations i, f
    (B, S, H) f32, the output gate's input z (B, S, d_in), and the new
    conv state (None without ``conv_state``)."""
    d_in, H, Dh = _mlstm_dims(cfg)
    xm, z = (x @ params["w_up"]).chunk(2, dim=-1)
    if conv_state is None:
        xc, new_conv = _causal_conv(xm, params["conv_w"], params["conv_b"]), None
    else:
        xc, new_conv = _causal_conv(xm, params["conv_w"], params["conv_b"], state=conv_state)
    B, S = x.shape[0], x.shape[1]
    q = (xc @ params["wq"]).reshape(B, S, H, Dh)
    k = (xc @ params["wk"]).reshape(B, S, H, Dh)
    v = (xm @ params["wv"]).reshape(B, S, H, Dh)
    # A bf16 product plus the f32 bias widens to f32, as in the reference.
    i_pre, f_pre = ((xc @ params["w_if"]) + params["b_if"]).chunk(2, dim=-1)
    return q, k, v, i_pre, f_pre, z, new_conv


def _mlstm_out(params: Dict, h: torch.Tensor, z: torch.Tensor, d_in: int) -> torch.Tensor:
    """The block's output: its inner RMSNorm (K2) gated by SiLU(z), then
    the down projection."""
    B, S = h.shape[0], h.shape[1]
    h = rms_norm(h.reshape(B, S, d_in), params["norm"]["scale"]) * F.silu(z)
    return h @ params["w_down"]


def mlstm_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training forward of one mLSTM block (no state carried in)."""
    d_in, _, _ = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, z, _ = _mlstm_qkvif(params, x, cfg)
    return _mlstm_out(params, mlstm_parallel(q, k, v, i_pre, f_pre), z, d_in)


def mlstm_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict[str, torch.Tensor],
                 mask: Optional[torch.Tensor] = None):
    """One token x (B, 1, d_model) against the carried ``state`` {"conv",
    "C", "n", "m"} -> (out (B, 1, d_model), state), the states updated in
    place; lanes where ``mask`` (B,) is False keep theirs."""
    d_in, _, _ = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, z, conv = _mlstm_qkvif(params, x, cfg, conv_state=state["conv"])
    h, (C, n, m) = mlstm_recurrent(q, k, v, i_pre, f_pre, (state["C"], state["n"], state["m"]))
    out = _mlstm_out(params, h, z, d_in)
    for name, new in (("conv", conv), ("C", C), ("n", n), ("m", m)):
        slot_mask_select_(state[name], new, mask)
    return out, state


def mlstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    xc: XLSTMConfig = cfg.xlstm
    d_in, H, Dh = _mlstm_dims(cfg)
    return {
        "conv": ParamSpec(
            (batch, xc.conv1d_kernel - 1, d_in), ("act_batch", None, "ffn"),
            "zeros", cfg.dtype,
        ),
        "C": ParamSpec((batch, H, Dh, Dh), ("act_batch", "heads", None, None),
                       "zeros", "float32"),
        "n": ParamSpec((batch, H, Dh), ("act_batch", "heads", None),
                       "zeros", "float32"),
        "m": ParamSpec((batch, H), ("act_batch", "heads"), "zeros", "float32"),
    }


# ---------------------------------------------------------------------------
# sLSTM block (recurrent; block-diagonal per-head hidden-to-hidden)
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    xc: XLSTMConfig = cfg.xlstm
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    dt = cfg.dtype
    d_up = int(d * xc.slstm_proj_factor)
    return {
        # gates: z, i, f, o — input projections
        "w_x": ParamSpec((d, 4 * d), ("embed", "ffn"), "scaled", dt),
        # recurrent per-head block-diagonal weights (H, Dh, 4*Dh)
        "w_h": ParamSpec((H, Dh, 4 * Dh), ("heads", None, None), "scaled", dt),
        "bias": ParamSpec((4 * d,), ("ffn",), "zeros", "float32"),
        "norm": norm_specs(d, "rmsnorm", dt),
        # post-block gated MLP (proj factor 4/3)
        "up_w": ParamSpec((d, 2 * d_up), ("embed", "ffn"), "scaled", dt),
        "down_w": ParamSpec((d_up, d), ("ffn", "embed"), "scaled", dt),
    }


_SLSTM_STATE = ("h", "c", "n", "m")


def slstm_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """One sLSTM block over x (B, S, d_model) -> (out, final state). Without
    ``state`` the scan starts fresh (h, c, m zeros, n ones) and the final
    state is new; with one (decode) it starts from ``state``, which is
    updated in place, lanes where ``mask`` (B,) is False keeping theirs."""
    B, S, d = x.shape
    H = cfg.n_heads
    Dh = d // H
    x_gates = (x @ params["w_x"]).float() + params["bias"]
    if state is None:
        zeros = torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device)
        h, c, n, m = zeros, zeros, torch.ones_like(zeros), zeros
    else:
        h, c, n, m = (state[k] for k in _SLSTM_STATE)
    w_h = params["w_h"].float()                                    # (H, Dh, 4Dh)
    hs = []
    for t in range(S):
        g = x_gates[:, t].reshape(B, H, 4 * Dh) + torch.einsum("bhd,hdg->bhg", h, w_h)
        z_pre, i_pre, f_pre, o_pre = g.chunk(4, dim=-1)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_act = torch.exp(i_pre - m_new)
        f_act = torch.exp(log_f + m - m_new)
        c = f_act * c + i_act * z
        n = f_act * n + i_act
        h = o * c / torch.maximum(n, torch.full_like(n, 1e-6))
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    y = rms_norm(y, params["norm"]["scale"])
    u, g = (y @ params["up_w"]).chunk(2, dim=-1)
    y = (u * F.gelu(g, approximate="tanh")) @ params["down_w"]
    final = dict(zip(_SLSTM_STATE, (h, c, n, m)))
    if state is None:
        return y, final
    for k in _SLSTM_STATE:
        slot_mask_select_(state[k], final[k], mask)
    return y, state


def slstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    H = cfg.n_heads
    Dh = cfg.d_model // H
    ax = ("act_batch", "heads", None)
    return {
        "h": ParamSpec((batch, H, Dh), ax, "zeros", "float32"),
        "c": ParamSpec((batch, H, Dh), ax, "zeros", "float32"),
        "n": ParamSpec((batch, H, Dh), ax, "ones", "float32"),
        "m": ParamSpec((batch, H, Dh), ax, "zeros", "float32"),
    }
