"""Flash-decode: hand-written CUDA kernels (``csrc/decode_attention.cu``)
for one query per sequence against a contiguous KV cache (K3) or a paged
block arena (K4), and their plain PyTorch versions.

Ports of the Pallas TPU kernels ``decode_attention_fwd`` and
``paged_decode_attention_fwd``
(``src/repro/kernels/decode_attention/kernel.py``). Shapes follow those
kernels: q (B, H, D), caches (B, S, Hkv, D) or arenas
(num_blocks + 1, block_size, Hkv, D) with block tables (B, T), lengths
(B,). The G = H / Hkv grouped queries of a kv head share its K/V rows.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for CUDA tensors (or raises); ``<wrapper>.launches`` counts
kernel launches. The contiguous kernel's contract is ``lengths >= 1``
(decode always holds the current token); at length 0 it writes zeros, as
the paged kernel and its oracle do by convention.

The kernels split each (sequence, kv head)'s rows across ``n_splits``
blocks (split-KV) and merge the blocks' partial softmaxes in split order.
``split_plan`` picks ``n_splits`` from the shapes alone (never from
``lengths``, which stay on the card, nor from the batch size);
``split_rows`` is the row range each split takes, as the kernel
computes it.

Meta tensors take a shape branch: the CUDA path's output and split
scratch (planned for ``META_SMS`` SMs), no launch. ``decode_attention_work``
and ``paged_decode_attention_work`` give one launch's (FLOPs, bytes) for
its live rows: on the card the lengths' (read only while
``work_hook`` is set), on meta, where no value exists, every row of the
cache (a full cache, the dry run's decode cell).

``decode_attention_partial`` is K3's partial form, for a cache cut along
its rows across ranks (the sequence-parallel decode of
``models/attention.py``): the same split and merge kernels, instantiated
with an f32 output that is normalised but not rounded to q's dtype, and
each (sequence, head)'s log-sum-exp, so that the ranks' partial softmaxes
merge exactly (``dist.tensor_parallel.merge_partials_over_tp``). It
counts its launches on ``decode_attention.launches`` and reports its
work under K3's name: it launches K3's kernels.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

import repro_torch.kernels as _kernels
from . import _build

__all__ = [
    "NEG_INF",
    "decode_attention",
    "decode_attention_plain",
    "decode_attention_partial",
    "decode_attention_partial_plain",
    "decode_attention_partial_work",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_kv_view",
    "scale_query",
    "sm_count",
    "split_plan",
    "split_rows",
    "META_SMS",
    "decode_attention_work",
    "paged_decode_attention_work",
]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Split boundaries fall on multiples of this many rows (``kGranule`` in
#: ``csrc/decode_attention.cu``).
GRANULE = 16
#: ``split_plan`` aims at this many blocks per SM for one sequence, gives
#: no split fewer than ``MIN_SPLIT_ROWS`` of ``max_rows`` and at most
#: ``MAX_SPLITS`` splits.
BLOCKS_PER_SM = 2
MIN_SPLIT_ROWS = 128
MAX_SPLITS = 128


def split_plan(Hkv: int, max_rows: int, n_sms: int) -> int:
    """Splits of each (sequence, kv head)'s rows: enough blocks for one
    sequence (``n_splits * Hkv``) to fill ``n_sms`` SMs about
    ``BLOCKS_PER_SM`` times over, and no more than ``max_rows //
    MIN_SPLIT_ROWS``. A function of shapes only, and never of the batch:
    a sequence's rows are summed in one order whichever sequences share
    its launch (a served stream equals its offline decode, and a stream
    resumed in another batch goes on as it began). K3 at ``S`` and K4 at
    ``T * block_size == S`` get the same plan."""
    want = -(-BLOCKS_PER_SM * n_sms // Hkv)
    return max(1, min(want, max_rows // MIN_SPLIT_ROWS, MAX_SPLITS))


def split_rows(length: int, n_splits: int) -> List[Tuple[int, int]]:
    """[begin, end) of each split of ``[0, length)``: an even share of its
    ``ceil(length / GRANULE)`` granules, in split order (empty where
    there are fewer granules than splits), as the kernel computes it."""
    n_gran = -(-length // GRANULE)
    return [(min(length, n_gran * s // n_splits * GRANULE),
             min(length, n_gran * (s + 1) // n_splits * GRANULE)) for s in range(n_splits)]


#: SMs of the H100 SXM5: the plan a meta tensor's launch is given.
META_SMS = 132


def decode_attention_work(B: int, H: int, Hkv: int, D: int, elem_bytes: int,
                          live: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K3 launch over ``live`` K/V rows (the sum of
    the lengths): q . k, the softmax's ~5 operations and p v for each
    (row, head); q read and out written, the lengths read, each live K
    and V row read once."""
    flops = live * H * (4 * D + 5)
    nbytes = 2 * B * H * D * elem_bytes + B * 4 + 2 * live * Hkv * D * elem_bytes
    return flops, nbytes


def decode_attention_partial_work(B: int, H: int, Hkv: int, D: int, elem_bytes: int,
                                  live: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one launch of K3's partial form: K3's work, with
    its output written in f32 and each (row, head)'s log-sum-exp (f32)
    written as well."""
    flops, nbytes = decode_attention_work(B, H, Hkv, D, elem_bytes, live)
    return flops, nbytes + B * H * D * (4 - elem_bytes) + B * H * 4


def paged_decode_attention_work(B: int, H: int, Hkv: int, D: int, elem_bytes: int,
                                live: int, live_blocks: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K4 launch: K3's work over ``live`` rows and
    the ``live_blocks`` block-table entries (int32) those rows use."""
    flops, nbytes = decode_attention_work(B, H, Hkv, D, elem_bytes, live)
    return flops, nbytes + 4 * live_blocks


def _live(lengths: torch.Tensor, block: int = 0) -> Tuple[int, int]:
    """(rows, blocks of ``block`` rows) the lengths keep live, read from the
    card outside any dispatch mode (a counter counts the kernel's work,
    not this read)."""
    with _disable_current_modes():
        lens = lengths.tolist()
    return sum(lens), sum(-(-n // block) for n in lens) if block else 0


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the plan's ``n_sms``)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(q: torch.Tensor, n_splits: int):
    """The f32 scratch of the split partials (B * H * n_splits * (D + 2)
    values), or None where one split writes the output itself."""
    if n_splits == 1:
        return None
    B, H, D = q.shape
    return torch.empty(B * H * n_splits * (D + 2), dtype=torch.float32, device=q.device)


def paged_kv_view(arena: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Gather a contiguous per-sequence view (B, T*block_size, ...) out of
    a block arena (num_blocks+1, block_size, ...) via ``block_table``
    (B, T). Rows past each sequence's length are whatever the table points
    at; callers mask by length."""
    g = arena[block_table.long()]  # (B, T, block_size, ...)
    return g.reshape(block_table.shape[0], -1, *arena.shape[2:])


def scale_query(q: torch.Tensor) -> torch.Tensor:
    """``q * (1 / sqrt(head_dim))`` in q's dtype, rounded as the reference's
    jnp ``q * scale`` rounds: the scale to q's dtype first (a weakly typed
    Python float), then the f32 product. PyTorch's ``q * scale`` keeps the
    scale in f32 instead; the two differ in bf16 where the scale is no
    power of two (head_dim 128). The decode kernels scale the same way."""
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    return (q.float() * scale).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Mirror of ``attention.decode_attention`` in kernel shapes: q (B, H, D),
    k/v (B, S, Hkv, D). The query is scaled in its own dtype
    (``scale_query``) before the f32 cast, then masked softmax over all S
    rows in f32."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = scale_query(q).float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    valid = pos[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's partial form in plain PyTorch -> (out f32 (B, H, D), lse f32
    (B, H)): ``decode_attention_plain``'s softmax over the live rows, its
    output left in f32, and ``lse`` = log sum exp of the scaled scores
    over those rows. A row with no live row (length <= 0) gives out exact
    zeros and lse -inf: weight 0 in any merge whose largest lse is
    finite."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = scale_query(q).float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    valid = pos[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", torch.exp(s - lse[..., None]), v.float())
    live = (lengths.to(q.device) > 0)[:, None, None]
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    lse = torch.where(live, lse, torch.full_like(lse, -math.inf))
    return out.reshape(B, H, D), lse.reshape(B, H)


def paged_decode_attention_plain(q: torch.Tensor, k_arena: torch.Tensor,
                                 v_arena: torch.Tensor, block_tables: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Mirror of ``decode_attention/ref.py::paged_decode_ref``: gather the
    block-table views, run the contiguous plain decode, and return zeros
    for length-0 rows."""
    k = paged_kv_view(k_arena, block_tables)
    v = paged_kv_view(v_arena, block_tables)
    out = decode_attention_plain(q, k, v, lengths)
    live = (lengths.to(q.device) > 0)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out))


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """The decode kernels have no backward: raise rather than return a
    tensor that silently carries no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad() "
                           "or with inputs that do not require grad")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *ints: torch.Tensor) -> None:
    _check_shapes(q, k, v, *ints)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode attention needs 16-byte aligned inputs (16-byte loads)")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *ints: torch.Tensor) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention takes f32 or bf16 q/k/v of one dtype, "
                        f"not {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v, *ints):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("decode attention needs contiguous inputs")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"lengths / block tables must be int32, not {t.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != D or H % Hkv or H // Hkv > 8 or D > 256 or D % 8:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         "(need H % Hkv == 0, H / Hkv <= 8, head_dim <= 256 and a "
                         "multiple of 8)")


def _contiguous_decode(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, partial: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The launch K3 and its partial form share, on a meta or CUDA tensor
    -> (out, lse): out in q's dtype and lse None, or with ``partial`` out
    f32 and lse f32 (B, H). Both count on ``decode_attention.launches``
    and report their work under K3's name: they launch K3's kernels."""
    if q.device.type not in ("meta", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    odt = torch.float32 if partial else q.dtype
    work = decode_attention_partial_work if partial else decode_attention_work
    if q.device.type == "meta":
        _check_shapes(q, k, v, lengths)
        out = torch.empty((B, H, D), dtype=odt, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if partial else None
        ws = _workspace(q, split_plan(Hkv, S, META_SMS))  # noqa: F841
        _kernels.report_work("decode_attention", work(B, H, Hkv, D, q.element_size(), B * S))
        return out, lse
    _check(q, k, v, lengths)
    if k.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"batch mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    out = torch.empty((B, H, D), dtype=odt, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if partial else None
    n_splits = split_plan(Hkv, S, sm_count(q.device.index))
    ws = _workspace(q, n_splits)
    lib = _build.load_library()
    rc = lib.repro_decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if ws is None else ws.data_ptr(),
        B, H, Hkv, D, S, n_splits, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    decode_attention.launches += 1
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("decode_attention", *work(
            B, H, Hkv, D, q.element_size(), _live(lengths)[0]))
    return out, lse


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """K3: q (B, H, D) against a contiguous cache k/v (B, S, Hkv, D),
    masked past ``lengths`` (B,). Has no backward: raises under grad."""
    _refuse_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    return _contiguous_decode("decode_attention", q, k, v, lengths, False)[0]


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's partial form: q (B, H, D) against a contiguous cache (or a
    rank's block of its rows) k/v (B, S, Hkv, D), masked past ``lengths``
    (B,), which may be 0 -> (out f32 (B, H, D), lse f32 (B, H)). ``out``
    is the softmax-weighted mean of the live V rows in f32, not rounded
    to q's dtype; ``lse`` the log-sum-exp of the live rows' scaled scores
    (natural log). Contract at a row with no live row (length <= 0): out
    exact zeros and lse -inf, so a cross-rank merge gives it weight 0.
    The split plan is the block's own (``split_plan`` of its S). Has no
    backward: raises under grad."""
    _refuse_grad("decode_attention_partial", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, k, v, lengths)
    return _contiguous_decode("decode_attention_partial", q, k, v, lengths, True)


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """K4: q (B, H, D) against block arenas (num_blocks + 1, block_size,
    Hkv, D) read through ``block_tables`` (B, T); only the
    ``ceil(length / block_size)`` live blocks of each row are read, and a
    length-0 row gives zeros. Has no backward: raises under grad."""
    _refuse_grad("paged_decode_attention", q, k_arena, v_arena)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_arena, v_arena, block_tables, lengths)
    if q.device.type == "meta":
        _check_shapes(q, k_arena, v_arena, block_tables, lengths)
        B, H, D = q.shape
        bs, Hkv = k_arena.shape[1], k_arena.shape[2]
        T = block_tables.shape[1]
        out = torch.empty_like(q)
        ws = _workspace(q, split_plan(Hkv, T * bs, META_SMS))  # noqa: F841
        _kernels.report_work("paged_decode_attention", paged_decode_attention_work(
            B, H, Hkv, D, q.element_size(), B * T * bs, B * T))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_arena, v_arena, block_tables, lengths)
    B, H, D = q.shape
    bs, Hkv = k_arena.shape[1], k_arena.shape[2]
    T = block_tables.shape[1]
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"batch mismatch: q {tuple(q.shape)}, tables "
                         f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    n_splits = split_plan(Hkv, T * bs, sm_count(q.device.index))
    ws = _workspace(q, n_splits)
    lib = _build.load_library()
    rc = lib.repro_paged_decode_attention_fwd(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), B, H, Hkv,
        D, bs, T, n_splits, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_decode_attention.launches += 1
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed (code {rc})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("paged_decode_attention", *paged_decode_attention_work(
            B, H, Hkv, D, q.element_size(), *_live(lengths, bs)))
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
