"""Mixture-of-Experts FFN (port of ``repro.models.moe``): token-choice
top-k routing with softmax gates renormalized over the top k, the
Switch load-balance loss, optional always-on shared experts, and a
capacity-bounded sort-based dispatch.

The dispatch is the reference's ``_moe_apply_flat``: each (token, choice)
pair is ranked within its expert by a stable sort, pairs ranked past the
capacity are dropped (they pass through the residual stream only), the
kept ones are scattered into an (E, C, D) buffer, every expert runs its
gated FFN as one batched product over its C rows, and each token sums
its K weighted outputs in choice order, in x's dtype. With
``moe.dropless`` the capacity is the token count, so no token is ever
dropped and a token's output does not depend on the others in its chunk.

The reference's ``dispatch="grouped"`` forms one capacity buffer per
data-parallel group, and ``"model"`` reshards the dispatched rows; on one
device there is one group and nothing to reshard, and both are this
same computation. The expert products are batched matrix products that
the reference leaves to XLA outside any Pallas kernel; here they are
``torch.bmm``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from .layers import ParamSpec, activation, mlp_apply, mlp_specs

__all__ = ["moe_specs", "moe_apply", "moe_capacity", "route", "DISPATCH_MODES"]

#: The reference's dispatch formulations; on one device all are the flat one.
DISPATCH_MODES = ("data", "model", "grouped")


def moe_capacity(moe: MoEConfig, tokens: int) -> int:
    """Static per-expert capacity for ``tokens`` tokens. Dropless mode
    sizes the buffer for the worst case, every token on one expert."""
    if moe.dropless:
        return max(tokens, moe.top_k)
    cap = int(moe.capacity_factor * tokens * moe.top_k / moe.n_experts)
    return max(cap, moe.top_k)


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    moe = cfg.moe
    d, dt = cfg.d_model, cfg.dtype
    de = moe.d_expert
    specs: Dict[str, ParamSpec] = {
        "router": ParamSpec((d, moe.n_experts), ("embed", None), "scaled", dt),
        "w_in": ParamSpec(
            (moe.n_experts, d, de), ("expert", "embed", "expert_ffn"), "scaled", dt
        ),
        "w_gate": ParamSpec(
            (moe.n_experts, d, de), ("expert", "embed", "expert_ffn"), "scaled", dt
        ),
        "w_out": ParamSpec(
            (moe.n_experts, de, d), ("expert", "expert_ffn", "embed"), "scaled", dt
        ),
    }
    if moe.n_shared_experts > 0:
        d_sh = (moe.d_shared or moe.d_expert) * moe.n_shared_experts
        specs["shared"] = mlp_specs(d, d_sh, glu=True, dtype=dt)
    return specs


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of 0..n-1 in ``idx`` (int64). A scatter-add,
    not ``bincount``, which reads its input's maximum back to the host."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def route(x_flat: torch.Tensor, router: torch.Tensor, moe: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_route`` -> (weights (T, K) in x's dtype, experts
    (T, K) int64, aux loss f32). The router product is
    taken in x's dtype and then widened; softmax, top-k and the
    renormalization are f32. aux = E * sum_e f_e * P_e (Switch eq. 4),
    f_e the share of choices on expert e and P_e its mean probability."""
    logits = (x_flat @ router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, moe.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = moe.n_experts
    f = _counts(experts.reshape(-1), E).float()
    f = f / f.sum().clamp_min(1.0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return weights.to(x_flat.dtype), experts, aux


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss f32 scalar)."""
    moe = cfg.moe
    if moe.dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown MoE dispatch {moe.dispatch!r}")
    B, S, D = x.shape
    T = B * S
    K, E = moe.top_k, moe.n_experts
    C = moe_capacity(moe, T)
    x_flat = x.reshape(T, D)
    dev = x.device

    weights, experts, aux = route(x_flat, params["router"], moe)

    # Rank each (token, choice) pair within its expert: a stable sort keeps
    # token order inside an expert, so the earliest tokens are kept.
    flat_e = experts.reshape(-1)                                  # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * K, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = pos < C

    token_idx = torch.arange(T, device=dev).repeat_interleave(K)
    safe_e = torch.where(keep, flat_e, 0)
    safe_pos = torch.where(keep, pos, C - 1)

    # Kept pairs own distinct (expert, row) slots; a dropped pair adds a
    # zero row to slot (0, C - 1), which leaves it as it was.
    dispatched = torch.where(keep[:, None], x_flat[token_idx], 0).to(x.dtype)
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=dev)
    buf = buf.index_put((safe_e, safe_pos), dispatched, accumulate=True)

    h_in = torch.bmm(buf, params["w_in"])
    h_gate = torch.bmm(buf, params["w_gate"])
    h = activation(cfg.act)(h_gate) * h_in
    y_buf = torch.bmm(h, params["w_out"])

    gathered = torch.where(keep[:, None], y_buf[safe_e, safe_pos], 0)
    contrib = (gathered * weights.reshape(-1)[:, None].to(gathered.dtype)).reshape(T, K, D)
    # Each token's K outputs summed in choice order, as the reference's
    # scatter-add into zeros does.
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]

    if moe.n_shared_experts > 0:
        out = out + mlp_apply(params["shared"], x_flat, cfg.act, glu=True)

    return out.reshape(B, S, D), aux.float()
