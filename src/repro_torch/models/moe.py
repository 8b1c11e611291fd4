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

Under a data-parallel row split (``dist.sharding.split_rows``) a rank
holds some rows of the batch, and the dispatch keeps the reference's
global semantics. ``"data"`` and ``"model"`` (the flat dispatch; on a
mesh the reference only reshards its buffers) rank a choice within its
expert over the GLOBAL token order: the rank all-gathers the per-rank
(E,) choice counts and offsets its positions by the ranks before it,
keeps the choices ranked below the capacity of the global token count
and computes them locally (the expert FFN is row-wise). ``"grouped"``
forms one capacity buffer per data-parallel group (the product of the
ambient data axes when it divides the global token count), of capacity
the global one over the group count, over the whole groups the rank
holds. The router loss is the reference's product of two global means:
each rank adds E * sum_e f_e P_e with f from the all-reduced counts and
P_e its own probabilities' sum over the global token count, so the
ranks' terms sum to the global loss. The expert products are batched
matrix products that the reference leaves to XLA outside any Pallas
kernel; here they are ``torch.bmm`` over (E, groups x C, D) buffers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.dist.sharding import (
    _axis_sizes, constrain_logical, current_context, current_split, split_gather, split_sum,
)
from .layers import ParamSpec, activation, mlp_apply, mlp_specs

__all__ = ["moe_specs", "moe_apply", "moe_capacity", "route", "DISPATCH_MODES"]

#: The reference's dispatch formulations; at one group all are the flat one.
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
    f_e the share of choices on expert e and P_e its mean probability,
    both over the global tokens under a row split (this rank's term)."""
    logits = (x_flat @ router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, moe.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = moe.n_experts
    f = split_sum(_counts(experts.reshape(-1), E)).float()
    f = f / f.sum().clamp_min(1.0)
    split = current_split()
    if split is None:
        p = probs.mean(dim=0)
    else:
        p = probs.sum(dim=0) / (probs.shape[0] * split.n)
    aux = E * torch.sum(f * p)
    return weights.to(x_flat.dtype), experts, aux


def _dp_group_count(T: int) -> int:
    """Number of data-parallel groups for group-local dispatch (= product
    of the ambient data axes when it divides the global token count T,
    else 1)."""
    ctx = current_context()
    if ctx is None:
        return 1
    sizes = _axis_sizes(ctx.mesh)
    g = 1
    for a in ctx.dp:
        g *= sizes[a]
    return g if g > 1 and T % g == 0 else 1


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss f32 scalar)."""
    moe = cfg.moe
    if moe.dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown MoE dispatch {moe.dispatch!r}")
    B, S, D = x.shape
    T = B * S
    K, E = moe.top_k, moe.n_experts
    split = current_split()
    n_split = 1 if split is None else split.n
    T_all = T * n_split
    G = _dp_group_count(T_all) if moe.dispatch == "grouped" else 1
    if G > 1:
        # The rank's rows are whole groups: a split is a prefix of the
        # data axes, whose product G is.
        groups, C = G // n_split, max(moe_capacity(moe, T_all) // G, K)
    else:
        groups, C = 1, moe_capacity(moe, T_all)
    Tg = T // groups
    x_flat = x.reshape(T, D)
    dev = x.device

    weights, experts, aux = route(x_flat, params["router"], moe)

    # Rank each (token, choice) pair within its (group, expert): a stable
    # sort keeps token order inside an expert, so the earliest are kept.
    eg = experts.reshape(groups, Tg * K)
    order = torch.argsort(eg, dim=-1, stable=True)
    counts = torch.zeros((groups, E), dtype=torch.long, device=dev).scatter_add_(
        1, eg, torch.ones_like(eg))
    starts = torch.cumsum(counts, -1) - counts
    rank_sorted = (torch.arange(Tg * K, device=dev)[None, :]
                   - torch.gather(starts, 1, torch.gather(eg, 1, order)))
    pos = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = pos < C
    if G == 1 and split is not None:
        # One group across ranks: a choice's place in its expert counts
        # the choices of the ranks before this one.
        table = split_gather(counts[0])                       # (n_split, E)
        before = table[:split.index].sum(0)
        keep = pos + before[eg] < C

    tok = torch.arange(T, device=dev).repeat_interleave(K).reshape(groups, Tg * K)
    safe_e = torch.where(keep, eg, 0)
    # A group's rows of an expert's buffer follow the groups before it.
    safe_row = torch.where(keep, pos, C - 1) + C * torch.arange(groups, device=dev)[:, None]

    # Kept pairs own distinct (expert, row) slots; a dropped pair adds a
    # zero row to its group's slot (0, C - 1), which leaves it as it was.
    rows = ("act_batch", None) if groups > 1 else (
        None, "expert" if moe.dispatch == "model" else "act_batch")
    dispatched = torch.where(keep[..., None], x_flat[tok], 0).to(x.dtype)
    dispatched = constrain_logical(dispatched, rows + (None,))
    buf = torch.zeros((E, groups * C, D), dtype=x.dtype, device=dev)
    buf = buf.index_put((safe_e, safe_row), dispatched, accumulate=True)
    buf = constrain_logical(buf, ("expert", None, None))

    h_in = torch.bmm(buf, params["w_in"])
    h_gate = torch.bmm(buf, params["w_gate"])
    h = activation(cfg.act)(h_gate) * h_in
    y_buf = torch.bmm(h, params["w_out"])
    y_buf = constrain_logical(y_buf, ("expert", None, None))

    gathered = torch.where(keep[..., None], y_buf[safe_e, safe_row], 0)
    gathered = constrain_logical(gathered, rows + (None,))
    contrib = (gathered * weights.reshape(groups, Tg * K)[..., None].to(gathered.dtype)
               ).reshape(T, K, D)
    # Each token's K outputs summed in choice order, as the reference's
    # scatter-add into zeros does.
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]

    if moe.n_shared_experts > 0:
        out = out + mlp_apply(params["shared"], x_flat, cfg.act, glu=True)

    return out.reshape(B, S, D), aux.float()
