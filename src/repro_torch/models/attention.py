"""GQA attention and DeepSeek's multi-head latent attention (MLA) with KV
caches (port of ``repro.models.attention``).

Three execution paths share one set of GQA weights:
  * training (``gqa_apply`` without a cache): project, RoPE, and attend
    over the whole sequence through kernel K1 (flash attention, forward
    and backward), as the reference's ``gqa_apply`` reaches its Pallas
    kernel under ``use_pallas``;
  * prefill (``gqa_prefill``): project the whole chunk, write its K/V rows
    into the cache, and attend causally with the chunked online-softmax
    ``mea_attention`` (plain PyTorch, as the reference computes it in jnp);
  * decode (``gqa_apply`` with a cache): one query per sequence against
    its cache through kernel K3 (contiguous) or K4 (paged block arena);
    under a tensor-parallel view (``_tp_decode``) K3 runs at the rank's
    heads, or at the rank's block of the cache's rows (K3's partial form)
    with the ranks' partial softmaxes merged, as the cache is laid out.

MLA (``mla_apply``, ``mla_prefill``) caches the latent stream instead:
{"ckv": (B, S, kv_lora_rank), "k_rope": (B, S, qk_rope_head_dim)}, written
through the same row helpers and paged the same way. Its attention is
plain PyTorch in f32, as the reference computes it in jnp (no Pallas
kernel reaches it): ``mea_attention`` for training and prefill, and at
decode either the absorbed latent-space product (``absorb=True``, the
registry's choice) or the per-head expansion of the whole latent cache.

GQA caches are dicts {"k": ..., "v": ...}: contiguous (B, S, Hkv, D) stripes,
or paged arenas (num_blocks + 1, block_size, Hkv, D) addressed through a
per-sequence ``block_table`` (B, T). Arena row 0 is the NULL sink: never
allocated, it absorbs writes from dead lanes and pad rows and backs
unallocated table entries. Unlike the reference (pure functions), cache
writes here update the cache tensors IN PLACE and return them — the pool
holds one copy of every cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.dist.sharding import current_tp
from repro_torch.dist.tensor_parallel import (
    copy_to_tp, gather_from_tp, merge_partials_over_tp, reduce_from_tp,
)
from repro_torch.kernels import decode_attention as _decode_kernel
from repro_torch.kernels import decode_attention_partial as _decode_partial_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import paged_decode_attention as _paged_decode_kernel
from repro_torch.kernels.decode_attention import NEG_INF, paged_kv_view, scale_query
from .layers import ParamSpec, apply_rope, norm_apply, norm_specs

__all__ = [
    "NEG_INF", "KV_SEQ_ALIGN", "NULL_BLOCK", "round_kv_len", "paged_kv_view",
    "cache_row_update", "cache_block_row_update", "cache_rows_update", "decode_lengths",
    "cached_decode", "gqa_specs",
    "heads_split", "local_kv_heads", "gqa_tp_partial",
    "mea_attention", "decode_attention", "gqa_apply", "gqa_prefill",
    "gqa_cache_spec", "mla_specs", "mla_apply", "mla_prefill", "mla_cache_spec",
]

#: KV cache sequence axes are rounded up to this multiple at allocation
#: time, so paged block sizes divide the row count evenly.
KV_SEQ_ALIGN = 16

#: Arena row reserved as the write sink for masked/dead lanes and the
#: target of unallocated block-table entries. Never handed out by the
#: BlockManager; its contents are garbage and are never read unmasked.
NULL_BLOCK = 0


def round_kv_len(max_len: int, block: int = KV_SEQ_ALIGN) -> int:
    """Round a cache capacity up to the kernel/paging block multiple."""
    return -(-int(max_len) // block) * block


def _per_row(idx, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device).reshape(-1).expand(batch)


def cache_row_update(
    cache: torch.Tensor,
    new: torch.Tensor,
    idx,
    *,
    block_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Write the single decode row ``new`` (B, 1, ...) into ``cache`` at
    sequence offset ``idx`` — scalar (all rows share one position) or
    per-row (B,) — in place.

    Contiguous caches clamp the offset into [0, S-1], as the reference's
    ``dynamic_update_slice`` does (the engine clips positions to
    ``max_len - 1`` before the call).

    With ``block_table`` (B, T) the cache is a block arena and row b lands
    at ``arena[table[b, idx // bs], idx % bs]``; dead lanes carry NULL
    tables, so their writes land in the sink."""
    B = new.shape[0]
    new = new[:, 0].to(cache.dtype)
    idx = _per_row(idx, B, cache.device)
    if block_table is not None:
        bs = cache.shape[1]
        slot = (idx // bs).clamp(0, block_table.shape[1] - 1)
        bid = torch.gather(block_table.long(), 1, slot[:, None])[:, 0]
        cache[bid, idx % bs] = new
        return cache
    rows = torch.arange(B, device=cache.device)
    cache[rows, idx.clamp(0, cache.shape[1] - 1)] = new
    return cache


def cache_block_row_update(cache: torch.Tensor, new: torch.Tensor, idx, first: int,
                           total: int) -> torch.Tensor:
    """``cache_row_update`` on a block of a cache's rows, in place: ``cache``
    (B, S_block, ...) holds rows ``[first, first + S_block)`` of a
    ``total``-row cache. Each row's offset is clamped into [0, total - 1]
    as ``cache_row_update`` clamps it; a row whose offset falls in the
    block is written there, every other row keeps its contents (another
    rank's block holds it). No branch reads the offsets' values."""
    B, S = new.shape[0], cache.shape[1]
    at = _per_row(idx, B, cache.device).clamp(0, total - 1) - first
    inside = (at >= 0) & (at < S)
    at = at.clamp(0, S - 1)
    rows = torch.arange(B, device=cache.device)
    keep = inside.reshape(B, *(1,) * (new.dim() - 2))
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, at])
    return cache


def cache_rows_update(
    cache: torch.Tensor,
    new: torch.Tensor,
    start,
    *,
    block_table: Optional[torch.Tensor] = None,
    n_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bulk prefill write, in place: ``new`` (B, P, ...) rows land at
    sequence positions ``start + [0, P)``.

    Contiguous caches with a scalar start and no ``n_valid`` take one
    slice write, its start clamped into [0, S-P] as the reference's
    ``dynamic_update_slice`` clamps. Otherwise (per-row start (B,), or
    ``n_valid`` (B,) marking each row's real count) rows out of range or
    past ``n_valid`` are DROPPED, never clamped or wrapped. Paged arenas
    scatter every row through the block table; rows past ``n_valid`` go
    to the NULL sink, and pad rows whose table entry is still NULL fall
    into it as well."""
    new = new.to(cache.dtype)
    B, P = new.shape[:2]
    dev = cache.device
    scalar = not torch.is_tensor(start) or start.dim() == 0
    if block_table is None and scalar and n_valid is None:
        s0 = min(max(int(start), 0), cache.shape[1] - P)
        cache[:, s0:s0 + P] = new
        return cache
    start_t = torch.as_tensor(start, dtype=torch.long, device=dev)
    ar = torch.arange(P, device=dev)
    if block_table is None:
        S = cache.shape[1]
        pos = start_t.reshape(-1, 1).expand(B, 1) + ar            # (B, P)
        keep = (pos >= 0) & (pos < S)
        if n_valid is not None:
            keep &= ar[None, :] < n_valid.to(dev)[:, None]
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, P)
        cache[b_idx[keep], pos[keep]] = new[keep]
        return cache
    bs = cache.shape[1]
    table = block_table.long()
    pos = start_t.reshape(-1, 1).expand(B, 1) + ar                # (B, P)
    slot = (pos // bs).clamp(0, table.shape[1] - 1)
    bid = torch.gather(table, 1, slot)
    off = pos % bs
    if n_valid is not None:
        bid = torch.where(ar[None, :] < n_valid.to(dev)[:, None], bid,
                          torch.full_like(bid, NULL_BLOCK))
    cache[bid.reshape(-1), off.reshape(-1)] = new.reshape(B * P, *new.shape[2:])
    return cache


def decode_lengths(idx, batch: int, device=None) -> torch.Tensor:
    """Valid-prefix lengths (B,) int32 after writing one token at ``idx``."""
    return (_per_row(idx, batch, device) + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# GQA specs
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    out = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), "scaled", dt),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "scaled", dt),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), "scaled", dt),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), "scaled", dt),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros", dt)
        out["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), "zeros", dt)
        out["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), "zeros", dt)
    if cfg.qk_norm:
        out["q_norm"] = norm_specs(hd, "rmsnorm", dt)
        out["k_norm"] = norm_specs(hd, "rmsnorm", dt)
    return out


def heads_split(params: Dict, cfg: ModelConfig) -> bool:
    """Whether ``params`` holds the rank's block of the q heads (a
    tensor-parallel view's TP-only layout cut ``heads`` over ``"model"``)."""
    return params["wq"].shape[1] != cfg.n_heads


def local_kv_heads(cfg: ModelConfig, n_local: int, index: int):
    """The kv heads that q heads ``[index * n_local, (index + 1) *
    n_local)`` read, as a slice where they group evenly (each read by the
    same number of consecutive q heads), else one kv head for each q head
    (a local group of 1)."""
    G = cfg.n_heads // cfg.n_kv_heads
    reads = [h // G for h in range(index * n_local, (index + 1) * n_local)]
    first, n = reads[0], reads[-1] - reads[0] + 1
    if n_local % n == 0 and reads == [first + i // (n_local // n) for i in range(n_local)]:
        return slice(first, first + n)
    return torch.tensor(reads)


def _kv_leaves(params: Dict, cfg: ModelConfig):
    """The kv projection's leaves the rank computes with: its own block
    where ``kv_heads`` is cut like ``heads``; where it is replicated but
    the q heads are cut (it does not divide ``"model"``), the kv heads
    its q heads read (their gradients are partial over ``"model"``:
    ``gqa_tp_partial``)."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    leaves = {n: params[n] for n in names}
    if not heads_split(params, cfg) or params["wk"].shape[1] != cfg.n_kv_heads:
        return leaves
    tp = current_tp()
    heads = local_kv_heads(cfg, params["wq"].shape[1], 0 if tp is None else tp.index)
    dim = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}
    if isinstance(heads, slice):
        return {n: t.narrow(dim[n], heads.start, heads.stop - heads.start)
                for n, t in leaves.items()}
    return {n: t.index_select(dim[n], heads.to(t.device)) for n, t in leaves.items()}


def gqa_tp_partial(params: Dict, cfg: ModelConfig) -> set:
    """The attention leaves (by name) replicated over ``"model"`` but read
    by the rank's share of the heads, whose gradients are partial sums
    over ``"model"``: the qk-norm scales where the q heads are cut, and
    the kv projection where ``kv_heads`` is replicated but the q heads
    are cut."""
    if not heads_split(params, cfg):
        return set()
    out = {"q_norm", "k_norm"} & set(params)
    if params["wk"].shape[1] == cfg.n_kv_heads:
        out |= {"wk", "wv", "bk", "bv"} & set(params)
    return out


def _project_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, kv: Optional[Dict] = None):
    """x (B, S, d) -> q (B, S, H, D), k/v (B, S, Hkv, D), with bias,
    qk-norm and RoPE as the config asks. Under a tensor-parallel view
    whose layout cuts ``heads``, the rank's q heads and the kv heads they
    read (``_kv_leaves``; ``kv``, the kv projection's leaves, where the
    caller chooses them), column-parallel on ``x``."""
    if heads_split(params, cfg):
        x = copy_to_tp(x)
    kv = _kv_leaves(params, cfg) if kv is None else kv
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, kv["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, kv["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q.contiguous(), "rmsnorm")
        k = norm_apply(params["k_norm"], k.contiguous(), "rmsnorm")
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Memory-efficient chunked attention (plain PyTorch, prefill)
# ---------------------------------------------------------------------------

def mea_attention(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Skv, Hkv, D)
    v: torch.Tensor,          # (B, Skv, Hkv, Dv)
    *,
    causal: bool,
    chunk: int,
    q_offset=0,               # absolute position of q[0]: scalar, or (B,)
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, in f32 (the reference's
    jnp ``mea_attention``; masked scores are NEG_INF)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    dev = q.device
    qf = scale_query(q).float().reshape(B, Sq, Hkv, G, D)

    chunk = min(chunk, Skv)
    n_chunks = math.ceil(Skv / chunk)
    q_off = torch.as_tensor(q_offset, dtype=torch.long, device=dev)
    q_pos = q_off[..., None] + torch.arange(Sq, device=dev)     # (Sq,) or (B, Sq)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]

    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, Dv), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        c = kj.shape[1]
        s = torch.einsum("bqhgd,bchd->bqhgc", qf, kj)
        kv_pos = j * chunk + torch.arange(c, device=dev)
        if causal:
            valid = q_pos[..., :, None] >= kv_pos                    # (1|B, Sq, c)
            s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: torch.Tensor) -> torch.Tensor:
    """Single-token attention q (B, 1, H, D) against a contiguous cache
    (B, S, Hkv, D), masked past ``length`` (B,): kernel K3."""
    return _decode_kernel(q[:, 0].contiguous(), k, v, length)[:, None]


def gqa_apply(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_index=None,
    block_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The GQA block. Without a cache (training): attention over the whole
    sequence through K1, returning (out, None); under a tensor-parallel
    view whose layout cuts ``heads``, over the rank's heads (K1 at the
    local head counts), ``wo`` row-parallel. With one: one-token
    decode — write the token's K/V row at ``cache_index`` (scalar or
    (B,)) and attend against the cache, K4 over the arena with
    ``block_table``, else K3."""
    if cache is not None and block_table is None and current_tp() is not None:
        return _tp_decode(params, x, cfg, positions, cache, cache_index)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cache is None:
        # RoPE hands back fresh tensors; the projections may be strided
        # views, and K1 takes only contiguous inputs.
        out = _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=cfg.causal and not cfg.is_encoder)
        out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
        # Row-parallel on the rank's heads: made whole before the residual.
        return (reduce_from_tp(out) if heads_split(params, cfg) else out), None
    out, new_cache = cached_decode(q, k, v, cache, cache_index, block_table=block_table)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache


def _tp_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               cache: Dict, cache_index) -> Tuple[torch.Tensor, Dict]:
    """One decode token under a tensor-parallel view, as GSPMD partitions the
    reference's decode step over ``"model"`` (``current_tp().kv``: where
    ``"model"`` cuts the contiguous cache):

      * ``"seq"`` (``sp_decode``): the rank holds rows ``[first, first +
        S_block)`` of every kv head. Every q head attends over them, so
        the token's q heads (and its k/v heads where ``wk`` is cut) are
        gathered over ``"model"``; its K/V row is written by the rank
        whose block holds ``cache_index`` (per row); K3's partial form
        runs over the block at lengths ``clamp(length - first, 0,
        S_block)``, and the ranks' partials are merged
        (``merge_partials_over_tp``);
      * ``"heads"`` (``no_sp_decode``, kv heads dividing ``"model"``): K3
        at the rank's q heads over its kv heads; attention needs no
        collective;
      * None (the cache replicated over ``"model"``): where the q heads are
        cut, ``wk`` / ``wv`` are replicated, so every rank computes and
        writes every kv head (the replicas stay equal) and K3 reads the kv
        heads its q heads read (``local_kv_heads``); where they are not
        (heads dividing neither), the attention is whole.

    Where the q heads are cut, the rank keeps its heads of the output and
    ``wo`` is row-parallel, made whole by ``reduce_from_tp``."""
    tp = current_tp()
    split = heads_split(params, cfg)
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    kv_cut = params["wk"].shape[1] != cfg.n_kv_heads
    if (tp.kv == "heads") != kv_cut and tp.kv != "seq":
        raise ValueError(f"a cache laid out {tp.kv!r} over 'model' beside a kv projection "
                         f"of {params['wk'].shape[1]} of {cfg.n_kv_heads} heads")
    q, k, v = _project_qkv(params, x, cfg, positions, kv={n: params[n] for n in names})
    B = q.shape[0]
    if tp.kv == "seq":
        if split:
            q = gather_from_tp(q, 2)
        if kv_cut:
            k, v = gather_from_tp(k, 2), gather_from_tp(v, 2)
        rows = cache["k"].shape[1]
        first, total = tp.index * rows, tp.size * rows
        ck = cache_block_row_update(cache["k"], k, cache_index, first, total)
        cv = cache_block_row_update(cache["v"], v, cache_index, first, total)
        lengths = (decode_lengths(cache_index, B, q.device) - first).clamp(0, rows)
        part, lse = _decode_partial_kernel(q[:, 0].contiguous(), ck, cv, lengths)
        out = merge_partials_over_tp(part, lse, q.dtype)
        if split:
            n = cfg.n_heads // tp.size
            out = out[:, tp.index * n:(tp.index + 1) * n]
        out = out[:, None]
    else:
        ck = cache_row_update(cache["k"], k, cache_index)
        cv = cache_row_update(cache["v"], v, cache_index)
        rk, rv = ck, cv
        if split and not kv_cut:
            heads = local_kv_heads(cfg, q.shape[2], tp.index)
            if isinstance(heads, slice):
                rk, rv = ck[:, :, heads].contiguous(), cv[:, :, heads].contiguous()
            else:
                heads = heads.to(ck.device)
                rk, rv = ck.index_select(2, heads), cv.index_select(2, heads)
        out = decode_attention(q, rk, rv, length=decode_lengths(cache_index, B, q.device))
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return (reduce_from_tp(y) if split else y), {"k": ck, "v": cv}


def cached_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache: Dict,
    cache_index,
    *,
    block_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode token q (B, 1, H, D), k/v (B, 1, Hkv, D): write its K/V
    row at ``cache_index`` (scalar or (B,)), in place, and attend against
    the cache through K4 over the arena with ``block_table``, else K3 ->
    (out (B, 1, H, D), {"k", "v"})."""
    ck = cache_row_update(cache["k"], k, cache_index, block_table=block_table)
    cv = cache_row_update(cache["v"], v, cache_index, block_table=block_table)
    lengths = decode_lengths(cache_index, q.shape[0], q.device)
    if block_table is not None:
        out = _paged_decode_kernel(
            q[:, 0].contiguous(), ck, cv, block_table.to(torch.int32), lengths
        )[:, None]
    else:
        out = decode_attention(q, ck, cv, length=lengths)
    return out, {"k": ck, "v": cv}


def gqa_prefill(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Dict,
    start_index,
    block_table: Optional[torch.Tensor] = None,
    n_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Cache-writing batched prefill: project the whole (B, S) chunk once,
    write its K/V rows at ``start_index``, and attend causally against the
    cache (rows past the chunk are masked by causality, rows before it are
    an earlier chunk's prefix). Paged mode scatters the rows through the
    block table and attends against the gathered view. ``start_index``
    may be per row (B,), with ``n_valid`` (B,) marking each row's real
    token count (the speculative verify; see ``cache_rows_update``)."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    ck = cache_rows_update(cache["k"], k, start_index, block_table=block_table,
                           n_valid=n_valid)
    cv = cache_rows_update(cache["v"], v, start_index, block_table=block_table,
                           n_valid=n_valid)
    if block_table is not None:
        kv_k, kv_v = paged_kv_view(ck, block_table), paged_kv_view(cv, block_table)
    else:
        kv_k, kv_v = ck, cv
    out = mea_attention(q, kv_k, kv_v, causal=True, chunk=cfg.attn_chunk,
                        q_offset=start_index)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": ck, "v": cv}


def gqa_cache_spec(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    page: Optional[Tuple[int, int]] = None,
) -> Dict[str, ParamSpec]:
    """``page=(num_blocks, block_size)`` swaps the per-slot (batch, seq)
    stripe for a global arena (num_blocks + 1, block_size, ...) — one
    extra row for the NULL sink block."""
    if page is not None:
        num_blocks, block_size = page
        shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
        axes = ("kv_blocks", "kv_block", "kv_heads", "head_dim")
    else:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        axes = ("act_batch", "act_kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec(shape, axes, "zeros", cfg.dtype),
        "v": ParamSpec(shape, axes, "zeros", cfg.dtype),
    }


# ---------------------------------------------------------------------------
# DeepSeek MLA
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.dtype
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora"), "scaled", dt),
        "q_norm": norm_specs(m.q_lora_rank, "rmsnorm", dt),
        "wq_b": ParamSpec(
            (m.q_lora_rank, h, qk_dim), ("q_lora", "heads", "head_dim"), "scaled", dt
        ),
        "wkv_a": ParamSpec(
            (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora"), "scaled", dt
        ),
        "kv_norm": norm_specs(m.kv_lora_rank, "rmsnorm", dt),
        "wkv_b": ParamSpec(
            (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
            ("kv_lora", "heads", "head_dim"),
            "scaled",
            dt,
        ),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"), "scaled", dt),
    }


def _mla_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope) after
    RoPE, the normed latent ckv (B, S, kv_lora) and the shared rope key
    k_rope (B, S, 1, rope) after RoPE. Both norms run through K2."""
    m: MLAConfig = cfg.mla
    q_lat = norm_apply(params["q_norm"], x @ params["wq_a"], "rmsnorm")
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = (x @ params["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    # The split is a strided view; K2 takes contiguous rows.
    ckv = norm_apply(params["kv_norm"], ckv.contiguous(), "rmsnorm")
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def _mla_expand_kv(params: Dict, ckv: torch.Tensor, cfg: ModelConfig):
    """Latent rows (B, S, kv_lora) -> per-head k_nope (B, S, H, nope) and
    v (B, S, H, v_head_dim)."""
    m: MLAConfig = cfg.mla
    kv = torch.einsum("bsr,rhk->bshk", ckv, params["wkv_b"])
    return kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def _mla_full_qk(q_nope, q_rope, k_nope, k_rope_rows):
    """Per-head q (B, Sq, H, nope + rope) and k (B, S, H, nope + rope),
    the one rope key row broadcast over the heads."""
    B, S, H, _ = k_nope.shape
    k_rope_b = k_rope_rows[:, :, None, :].expand(B, S, H, k_rope_rows.shape[-1])
    return torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope_b], dim=-1)


def _mla_cache_write(cache: Dict, ckv, k_rope, write, block_table):
    """Write the latent rows with ``write`` (``cache_row_update`` or
    ``cache_rows_update``, bound to its position arguments), in place ->
    (new cache, per-sequence ckv view (B, S, kv_lora), k_rope view)."""
    new_cache = {"ckv": write(cache["ckv"], ckv), "k_rope": write(cache["k_rope"], k_rope[:, :, 0])}
    if block_table is None:
        return new_cache, new_cache["ckv"], new_cache["k_rope"]
    return (new_cache, paged_kv_view(new_cache["ckv"], block_table),
            paged_kv_view(new_cache["k_rope"], block_table))


def mla_apply(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_index=None,
    absorb: bool = False,
    block_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA attention. Without a cache (training): expand the latent rows
    per head and attend causally with ``mea_attention`` -> (out, None).
    With one: one-token decode. The token's latent row and rope key are
    written at ``cache_index`` (scalar or (B,)), and the query attends
    against the whole latent cache, masked past each row's length:
    ``absorb=True`` in latent space (W_UK folded into the query, W_UV
    applied after the softmax; f32 scores, as the reference), else by
    expanding every cached row to per-head K/V."""
    m: MLAConfig = cfg.mla
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, x, cfg, positions)
    B = x.shape[0]
    if cache is None:
        k_nope, v = _mla_expand_kv(params, ckv, cfg)
        q_full, k_full = _mla_full_qk(q_nope, q_rope, k_nope, k_rope[:, :, 0])
        out = mea_attention(q_full, k_full, v, causal=True, chunk=cfg.attn_chunk)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), None

    def write(c, new):
        return cache_row_update(c, new, cache_index, block_table=block_table)

    new_cache, c_ckv, c_rope = _mla_cache_write(cache, ckv, k_rope, write, block_table)
    S = c_ckv.shape[1]
    length = decode_lengths(cache_index, B, x.device)
    pos_mask = (torch.arange(S, device=x.device)[None, :] < length[:, None])[:, None, None, :]
    if absorb:
        w_uk, w_uv = params["wkv_b"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)          # (B, 1, H, r)
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        c_ckv_f = c_ckv.float()
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_ckv_f)
             + torch.einsum("bshk,btk->bhst", q_rope.float(), c_rope.float())) * scale
        p = torch.softmax(s.masked_fill(~pos_mask, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", p, c_ckv_f)
        out = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), w_uv)
    else:
        k_nope, v = _mla_expand_kv(params, c_ckv, cfg)
        q_full, k_full = _mla_full_qk(q_nope, q_rope, k_nope, c_rope)
        s = torch.einsum("bshk,bthk->bhst", scale_query(q_full).float(), k_full.float())
        p = torch.softmax(s.masked_fill(~pos_mask, NEG_INF), dim=-1)
        out = torch.einsum("bhst,bthk->bshk", p, v.float()).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache


def mla_prefill(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Dict,
    start_index,
    block_table: Optional[torch.Tensor] = None,
    n_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Cache-writing batched MLA prefill (and verify): write the chunk's
    latent rows at ``start_index`` (scalar or (B,), ``n_valid`` as in
    ``gqa_prefill``), expand the whole latent cache per head and attend
    causally with ``mea_attention``."""
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, x, cfg, positions)

    def write(c, new):
        return cache_rows_update(c, new, start_index, block_table=block_table,
                                 n_valid=n_valid)

    new_cache, c_ckv, c_rope = _mla_cache_write(cache, ckv, k_rope, write, block_table)
    k_nope, v = _mla_expand_kv(params, c_ckv, cfg)
    q_full, k_full = _mla_full_qk(q_nope, q_rope, k_nope, c_rope)
    out = mea_attention(q_full, k_full, v, causal=True, chunk=cfg.attn_chunk,
                        q_offset=start_index)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache


def mla_cache_spec(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    page: Optional[Tuple[int, int]] = None,
) -> Dict[str, ParamSpec]:
    """The latent cache: (batch, max_len) stripes, or with ``page`` one
    arena (num_blocks + 1, block_size) per leaf, as ``gqa_cache_spec``."""
    m: MLAConfig = cfg.mla
    if page is not None:
        num_blocks, block_size = page
        front, axes2 = (num_blocks + 1, block_size), ("kv_blocks", "kv_block")
    else:
        front, axes2 = (batch, max_len), ("act_batch", "act_kv_seq")
    return {
        "ckv": ParamSpec((*front, m.kv_lora_rank), (*axes2, None), "zeros", cfg.dtype),
        "k_rope": ParamSpec((*front, m.qk_rope_head_dim), (*axes2, None), "zeros", cfg.dtype),
    }
