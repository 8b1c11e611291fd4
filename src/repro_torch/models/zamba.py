"""Zamba2-style hybrid (port of ``repro.models.zamba``): a Mamba2
backbone with ONE shared attention + MLP block.

  * ``n_layers`` Mamba2 blocks (pre-norm, residual) form the backbone;
  * the shared block (width 2 * d_model, fed concat([hidden, original
    embedding])) runs after every ``attn_every`` Mamba blocks, its weights
    shared across calls; each call adds its own LoRA adapters on the fused
    QKV and the MLP input projections, and the block's output is
    projected back to d_model and added to the residual stream.

Parameters: ``{"mamba": [one dict per layer], "shared": {...}}``. The
reference stacks the Mamba layers on a leading axis; the port keeps one
dict per layer (``bridge.params_from_numpy`` cuts the stack). The LoRA
adapters stay stacked over the calls, as in the reference, and
``_lora_slice`` indexes call ``i``.

The shared block's attention is the reference's ``mea_attention``
(causal, scanned over KV chunks in f32); here it is kernel K1 on the card
and K1's plain version on the CPU. The two compute the same function:
they agree in f32 (the CPU tests hold the port to ``mea_attention``);
in bf16 they differ by one rounding of q, which the reference scales in
the input dtype and K1 after its f32 cast (head_dim 128, so 1/sqrt(D) is
not a power of two).

Remat follows the reference exactly: every Mamba block and every shared
call is checkpointed when ``cfg.remat != "none"``, so ``"selective"``
means full checkpointing here.

Serving: ``zamba_decode`` takes one token through every Mamba2 step
(``mamba2.mamba2_decode``, its recurrent states updated in place) and
every shared call, which writes the call's K/V row and attends through
K3 (contiguous) or K4 (paged). ``zamba_cache_specs`` stacks the caches
as the reference does: ``{"mamba": {"conv", "ssm"}}`` on a leading
layer axis, contiguous per slot in both pool modes, and
``{"attn": {"k", "v"}}`` on a leading call axis, per-slot stripes or one
block arena per call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_batch
from repro_torch.kernels import flash_attention as _flash_kernel
from . import attention as attn
from . import mamba2
from .layers import ParamSpec, activation, apply_rope, norm_apply, norm_specs

__all__ = ["LORA_RANK", "n_shared_invocations", "zamba_specs", "zamba_apply",
           "zamba_decode", "zamba_cache_specs"]

LORA_RANK = 64


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _shared_width(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def zamba_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, dt = cfg.d_model, cfg.dtype
    dw = _shared_width(cfg)
    n_inv = n_shared_invocations(cfg)
    h, hd = cfg.n_heads, dw // cfg.n_heads
    mamba = [{"norm": norm_specs(d, cfg.norm, dt), "mixer": mamba2.mamba2_specs(cfg)}
             for _ in range(cfg.n_layers)]
    shared = {
        "norm": norm_specs(dw, cfg.norm, dt),
        "wqkv": ParamSpec(
            (dw, 3, h, hd), ("embed", None, "heads", "head_dim"), "scaled", dt
        ),
        "wo": ParamSpec((h, hd, dw), ("heads", "head_dim", "embed"), "scaled", dt),
        "mlp_norm": norm_specs(dw, cfg.norm, dt),
        "w_in": ParamSpec((dw, cfg.d_ff), ("embed", "ffn"), "scaled", dt),
        "w_gate": ParamSpec((dw, cfg.d_ff), ("embed", "ffn"), "scaled", dt),
        "w_out": ParamSpec((cfg.d_ff, dw), ("ffn", "embed"), "scaled", dt),
        "proj_down": ParamSpec((dw, d), ("embed", None), "scaled", dt),
        # Per-call LoRA adapters, stacked over the calls.
        "lora_qkv_a": ParamSpec((n_inv, dw, LORA_RANK), ("layers", "embed", None), "scaled", dt),
        "lora_qkv_b": ParamSpec((n_inv, LORA_RANK, 3 * h * hd), ("layers", None, None), "zeros", dt),
        "lora_mlp_a": ParamSpec((n_inv, dw, LORA_RANK), ("layers", "embed", None), "scaled", dt),
        "lora_mlp_b": ParamSpec((n_inv, LORA_RANK, cfg.d_ff), ("layers", None, None), "zeros", dt),
    }
    return {"mamba": mamba, "shared": shared}


def _lora_slice(shared: Dict, idx) -> Dict:
    return {
        "qkv_a": shared["lora_qkv_a"][idx],
        "qkv_b": shared["lora_qkv_b"][idx],
        "mlp_a": shared["lora_mlp_a"][idx],
        "mlp_b": shared["lora_mlp_b"][idx],
    }


def _shared_block(params: Dict, h: torch.Tensor, x0: torch.Tensor, cfg: ModelConfig,
                  lora: Dict, *, positions: torch.Tensor, cache: Optional[Dict] = None,
                  cache_index=None, block_table: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One call of the shared attention + MLP block -> its delta to the
    residual stream (B, S, d_model). ``lora`` holds this call's adapters.
    Without a cache (training) it attends over the sequence through K1;
    with one it decodes one token, writing the call's K/V row in place
    (``attn.cached_decode``: K3, or K4 with ``block_table``)."""
    dw = _shared_width(cfg)
    H, hd = cfg.n_heads, dw // cfg.n_heads
    Bsz, S = h.shape[0], h.shape[1]
    t = torch.cat([h, x0], dim=-1)
    tn = norm_apply(params["norm"], t, cfg.norm)

    qkv = tn @ params["wqkv"].reshape(dw, 3 * H * hd)
    qkv = qkv + (tn @ lora["qkv_a"]) @ lora["qkv_b"]
    qkv = qkv.reshape(Bsz, S, 3, H, hd)
    q = apply_rope(qkv[:, :, 0], positions, cfg.rope_theta)
    k = apply_rope(qkv[:, :, 1], positions, cfg.rope_theta)
    if cache is None:
        # RoPE hands back fresh tensors; v is a strided view, and K1 takes
        # only contiguous inputs.
        o = _flash_kernel(q.contiguous(), k.contiguous(), qkv[:, :, 2].contiguous(),
                          causal=True)
    else:
        o, _ = attn.cached_decode(q, k, qkv[:, :, 2], cache, cache_index,
                                  block_table=block_table)
    t = t + o.reshape(Bsz, S, H * hd) @ params["wo"].reshape(H * hd, dw)

    tn = norm_apply(params["mlp_norm"], t, cfg.norm)
    gate = tn @ params["w_gate"]
    up = tn @ params["w_in"] + (tn @ lora["mlp_a"]) @ lora["mlp_b"]
    t = t + (activation(cfg.act)(gate) * up) @ params["w_out"]
    return t @ params["proj_down"]


def zamba_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward -> (hidden (B, S, d_model), aux = 0): groups of
    ``attn_every`` Mamba blocks, each followed by one shared call, then
    the remaining Mamba blocks."""
    x0 = x
    h = x
    ae = cfg.attn_every or cfg.n_layers
    groups = n_shared_invocations(cfg)

    def mamba_block(layer, h):
        hn = norm_apply(layer["norm"], h, cfg.norm)
        return constrain_batch(h + mamba2.mamba2_apply(layer["mixer"], hn, cfg))

    def shared_block(shared, lora, h, x0):
        return constrain_batch(h + _shared_block(shared, h, x0, cfg, lora, positions=positions))

    if cfg.remat == "none":
        run_mamba, run_shared = mamba_block, shared_block
    else:
        def run_mamba(*args):
            return checkpoint(mamba_block, *args, use_reentrant=False)

        def run_shared(*args):
            return checkpoint(shared_block, *args, use_reentrant=False)

    layers = params["mamba"]
    for g in range(groups):
        for layer in layers[g * ae:(g + 1) * ae]:
            h = run_mamba(layer, h)
        h = run_shared(params["shared"], _lora_slice(params["shared"], g), h, x0)
    for layer in layers[groups * ae:]:
        h = run_mamba(layer, h)
    return h, torch.zeros((), dtype=torch.float32, device=x.device)


def zamba_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig, caches: Dict, *,
                 positions: torch.Tensor, cache_index,
                 block_tables: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """One token x (B, 1, d_model) per sequence -> (hidden (B, 1, d_model),
    caches): each Mamba2 layer's step, and after every ``attn_every``-th
    the next shared call with its own LoRA slice. ``caches`` (the
    ``zamba_cache_specs`` tree) are updated in place; lanes where ``mask``
    (B,) is False keep their recurrent states."""
    h = x
    n_inv = n_shared_invocations(cfg)
    mamba, kv = caches["mamba"], caches["attn"]
    inv = 0
    for i, layer in enumerate(params["mamba"]):
        state = {"conv": mamba["conv"][i], "ssm": mamba["ssm"][i]}
        delta, _ = mamba2.mamba2_decode(layer["mixer"], norm_apply(layer["norm"], h, cfg.norm),
                                        cfg, state, mask)
        h = h + delta
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0 and inv < n_inv:
            h = h + _shared_block(
                params["shared"], h, x, cfg, _lora_slice(params["shared"], inv),
                positions=positions, cache={"k": kv["k"][inv], "v": kv["v"][inv]},
                cache_index=cache_index, block_table=block_tables,
            )
            inv += 1
    return h, caches


def zamba_kv_rows(caches: Dict, block_tables: Optional[torch.Tensor] = None) -> int:
    """Rows one sequence's shared-call K/V holds: its contiguous stripe's,
    or its block table's (``zamba_cache_specs``'s layouts)."""
    rows = caches["attn"]["k"].shape[2]
    return rows if block_tables is None else rows * block_tables.shape[1]


def zamba_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                      page: Optional[Tuple[int, int]] = None) -> Dict:
    """The hybrid's cache: each Mamba2 layer's recurrent states, stacked on
    a leading layer axis and contiguous per slot in every mode (no
    sequence axis to page), and the shared calls' K/V, stacked on a
    leading call axis: per-slot (batch, max_len) stripes, or with
    ``page=(num_blocks, block_size)`` one arena (num_blocks + 1,
    block_size) per call, row 0 the NULL sink."""
    n_inv = n_shared_invocations(cfg)
    hd = _shared_width(cfg) // cfg.n_heads
    mamba = {
        name: ParamSpec((cfg.n_layers, *s.shape), ("layers", *s.axes), s.init, s.dtype)
        for name, s in mamba2.mamba2_state_spec(cfg, batch).items()
    }
    if page is not None:
        num_blocks, block_size = page
        front = (n_inv, num_blocks + 1, block_size)
        axes = ("layers", "kv_blocks", "kv_block", "heads", "head_dim")
    else:
        front = (n_inv, batch, max_len)
        axes = ("layers", "act_batch", "act_kv_seq", "heads", "head_dim")
    kv = ParamSpec((*front, cfg.n_heads, hd), axes, "zeros", cfg.dtype)
    return {"mamba": mamba, "attn": {"k": kv, "v": kv}}
