"""Split-KV flash decode (K3, K4) on the CPU: the split plan, and the
kernels' split-and-merge arithmetic emulated in PyTorch.

The CUDA kernels (``csrc/decode_attention.cu``) split each (sequence,
kv head)'s rows ``[0, length)`` into ``n_splits`` ranges of whole
granules (``split_rows``), form each range's softmax state (running max
m, sum l, unnormalized f32 accumulator), and merge the states in split
order. They run only on the card; here ``_split_merge`` repeats that
arithmetic, and is held to the plain versions (``decode_attention_plain``,
``paged_decode_attention_plain``) and to the reference's jnp oracles
(``decode_ref``, ``paged_decode_ref``). Inputs come from one seeded numpy
generator. Tolerance: 2e-5 in f32, 2e-2 in bf16 (both round once to bf16
at the end, from f32 sums taken in other orders).

K3's partial form (``decode_attention_partial``: the f32 output and each
row's log-sum-exp, for a rank's block of a cache cut along its rows) is
held here too: its plain version against an f64 softmax, two blocks of a
cache merged by the cross-rank merge's formula against the whole, a
block with no live row included, and the emulation's (m, l) turned into
the kernels' lse.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_ref, paged_decode_ref
from repro_torch.kernels import (
    decode_attention_partial, decode_attention_partial_plain, decode_attention_plain,
    paged_decode_attention_plain,
)
from repro_torch.kernels.decode_attention import (
    GRANULE,
    MAX_SPLITS,
    MIN_SPLIT_ROWS,
    NEG_INF,
    paged_kv_view,
    scale_query,
    split_plan,
    split_rows,
)

RNG = np.random.default_rng(15)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132
LOG2E = 1.4426950408889634


def _np(shape):
    return RNG.normal(size=shape).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _merge(states):
    """(m, l, acc) of the rows of all ``states``, folded in split order as
    the merge kernel does; m and l (G,), acc (G, D), f32; m in log2 units
    (the scores carry a factor log2(e), so exp2 stands for exp)."""
    mx = torch.full_like(states[0][0], NEG_INF)
    for m, _, _ in states:
        mx = torch.maximum(mx, m)
    l_sum = torch.zeros_like(states[0][1])
    acc_sum = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp2(m - mx)
        l_sum = l_sum + l * w
        acc_sum = acc_sum + acc * w[:, None]
    return mx, l_sum, acc_sum


def _split_state(qg, k, v, r0, r1):
    """Softmax state of rows [r0, r1) for the G queries ``qg`` (G, D) f32,
    scaled by log2(e), against k, v (rows, D); an empty range is
    (kNegInf, 0, 0)."""
    G, D = qg.shape
    if r1 <= r0:
        return (torch.full((G,), NEG_INF), torch.zeros(G), torch.zeros(G, D))
    s = qg @ k[r0:r1].float().T                      # (G, rows)
    m = s.max(dim=-1).values
    p = torch.exp2(s - m[:, None])
    return m, p.sum(dim=-1), p @ v[r0:r1].float()


def _split_merge(q, k, v, lengths, n_splits, partial=False):
    """What the split and merge kernels compute: q (B, H, D), contiguous
    k/v (B, S, Hkv, D), lengths (B,) -> (B, H, D) in q's dtype; a
    length-0 row gives zeros. With ``partial`` (K3's partial form): (out
    f32, lse (B, H)), lse = (m + log2 l) ln 2 from the merged state, -inf
    where l is 0 (``row_lse`` in the source)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = scale_query(q).float().reshape(B, Hkv, G, D) * LOG2E
    out = torch.empty(B, Hkv, G, D)
    lse = torch.empty(B, Hkv, G)
    for b in range(B):
        length = max(0, min(int(lengths[b]), S))
        for h in range(Hkv):
            states = [_split_state(qf[b, h], k[b, :, h], v[b, :, h], r0, r1)
                      for r0, r1 in split_rows(length, n_splits)]
            m, l, acc = _merge(states)
            out[b, h] = acc / torch.clamp(l, min=1e-30)[:, None]
            lse[b, h] = torch.where(l > 0, (m + torch.log2(l)) * math.log(2.0),
                                    torch.full_like(l, -math.inf))
    if partial:
        return out.reshape(B, H, D), lse.reshape(B, H)
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [
    # B, Hkv, max_rows (B: the batch beside it, which the plan does not read)
    (4, 8, 1024),        # llama3.2-1b serving: 4 slots, max_len 1024
    (4, 8, 8192),
    (1, 8, 32768),
    (1, 1, 64), (1, 1, 65), (3, 3, 100), (2, 2, 4096),
    (32, 8, 2048),
    (64, 8, 512), (8, 32, 1024), (1, 1, 1 << 20),
    (4, 32, 512),        # zamba2-1.2b serving: 4 slots, max_len 512, MHA
]


@pytest.mark.parametrize("B,Hkv,max_rows", PLAN_SHAPES)
def test_split_plan_covers_max_rows_in_whole_granules(B, Hkv, max_rows):
    n = split_plan(Hkv, max_rows, H100_SMS)
    assert 1 <= n <= MAX_SPLITS
    if max_rows >= MIN_SPLIT_ROWS:
        assert n <= max_rows // MIN_SPLIT_ROWS
    ranges = split_rows(max_rows, n)
    assert len(ranges) == n
    assert ranges[0][0] == 0 and ranges[-1][1] == max_rows
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0, "splits must be contiguous, in order"
    for r0, r1 in ranges:
        assert r0 % GRANULE == 0
        assert r1 % GRANULE == 0 or r1 == max_rows
        # No split of a full row is shorter than a granule.
        assert r1 - r0 >= min(GRANULE, max_rows)
    # Enough blocks for one sequence to fill the card about twice, unless
    # capped: whatever the batch B beside it.
    if n < min(max_rows // MIN_SPLIT_ROWS, MAX_SPLITS):
        assert n * Hkv >= 2 * H100_SMS


@pytest.mark.parametrize("Hkv,max_rows", [(8, 1024), (8, 512), (1, 4096), (33, 256),
                                          (3, 256), (2, 2048)])
def test_split_plan_is_the_same_for_every_batch_size(Hkv, max_rows):
    """The plan reads no batch size, so every row of a batch of B is split
    (and its partial softmaxes merged) exactly as that row alone: for B in
    {1, 4, 33, 64}, the split-and-merge arithmetic at the plan the wrapper
    takes for the batch gives, row by row and bit for bit, what it gives
    for each row alone at the plan the wrapper takes for that row. The
    engine's B 4 tick and offline decode's B 1 sum a sequence in one
    order."""
    assert "B" not in inspect.signature(split_plan).parameters
    G, D = 2, 16
    rng = np.random.default_rng(Hkv + max_rows)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # thousands of tiny products: threads only contend
    try:
        _each_row_as_alone(Hkv, max_rows, G, D, rng)
    finally:
        torch.set_num_threads(threads)


def _each_row_as_alone(Hkv, max_rows, G, D, rng):
    """Each row of ``_split_merge`` over batches of 1, 4, 33 and 64 rows
    equals, bit for bit, that row's ``_split_merge`` alone."""
    for B in (1, 4, 33, 64):
        q = torch.from_numpy(rng.normal(size=(B, Hkv * G, D)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(B, max_rows, Hkv, D)).astype(np.float32))
                for _ in range(2))
        lengths = rng.integers(0, max_rows + 1, size=B)
        lengths[0] = max_rows
        # As decode_attention takes it: from the cache's shape, never from B.
        n_batch = split_plan(k.shape[2], k.shape[1], H100_SMS)
        batch = _split_merge(q, k, v, lengths, n_batch)
        for b in range(B):
            n_alone = split_plan(k[b:b + 1].shape[2], k[b:b + 1].shape[1], H100_SMS)
            alone = _split_merge(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1],
                                 n_alone)
            assert torch.equal(batch[b], alone[0]), f"B {B}, row {b}"


@pytest.mark.parametrize("bs", [1, 16, 32, 256])
@pytest.mark.parametrize("B,Hkv,S", [(4, 8, 1024), (4, 8, 8192), (1, 8, 32768), (6, 2, 256)])
def test_split_plan_is_the_same_for_k3_and_k4(B, Hkv, S, bs):
    """K3 plans from S, K4 from T * block_size: equal rows, equal plans
    and equal row ranges; the plan reads no lengths."""
    T = S // bs
    assert split_plan(Hkv, S, H100_SMS) == split_plan(Hkv, T * bs, H100_SMS)
    n = split_plan(Hkv, S, H100_SMS)
    for length in (0, 1, 17, S // 3, S):
        assert split_rows(length, n) == split_rows(length, split_plan(Hkv, T * bs, H100_SMS))


@pytest.mark.parametrize("length", [0, 1, GRANULE - 1, GRANULE, GRANULE + 1, 543, 4097])
@pytest.mark.parametrize("n_splits", [1, 2, 9, 33, 128])
def test_split_rows_share_a_length_in_whole_granules(length, n_splits):
    ranges = split_rows(length, n_splits)
    covered = [r for r0, r1 in ranges for r in range(r0, r1)]
    assert covered == list(range(length)), "every row once, in order"
    assert all(r0 % GRANULE == 0 for r0, _ in ranges)
    # Even: the splits' granule counts differ by at most one.
    grans = [-(-(r1 - r0) // GRANULE) for r0, r1 in ranges]
    assert max(grans) - min(grans) <= 1
    assert sum(g > 0 for g in grans) == min(n_splits, -(-length // GRANULE))


# ---------------------------------------------------------------------------
# The split-and-merge arithmetic against the plain versions and the oracles
# ---------------------------------------------------------------------------

S, HKV, BS = 256, 2, 16
#: Lengths 0, 1, granule - 1, granule, granule + 1, max_rows and a
#: ragged mix.
LENGTHS = [0, 1, GRANULE - 1, GRANULE, GRANULE + 1, S, 100, 203]
#: One split (the split kernel writes the output), a few, the plan's
#: choice for these shapes on 132 SMs, and more splits than a short
#: row has granules (empty splits merge in).
N_SPLITS = [1, 2, 5, split_plan(HKV, S, H100_SMS), 40]


def _scatter_to_arena(k, v, lengths, block_size, rng):
    """Contiguous (B, S, ...) numpy caches scattered into a shuffled block
    arena with noise wherever no live block is (block 0 and every
    unreferenced row); returns (k_arena, v_arena, tables)."""
    B, S_ = k.shape[:2]
    T = S_ // block_size
    ids = rng.permutation(B * T) + 1
    k_ar = rng.normal(size=(B * T + 1, block_size, *k.shape[2:])).astype(np.float32)
    v_ar = rng.normal(size=(B * T + 1, block_size, *v.shape[2:])).astype(np.float32)
    tables = np.zeros((B, T), np.int32)
    nxt = 0
    for b in range(B):
        for t in range(-(-int(lengths[b]) // block_size)):
            tables[b, t] = ids[nxt]
            k_ar[ids[nxt]] = k[b, t * block_size:(t + 1) * block_size]
            v_ar[ids[nxt]] = v[b, t * block_size:(t + 1) * block_size]
            nxt += 1
    return k_ar, v_ar, tables


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_plain_and_reference(dtype, G, D):
    H, B = G * HKV, len(LENGTHS)
    q, k, v = _np((B, H, D)), _np((B, S, HKV, D)), _np((B, S, HKV, D))
    lengths = np.array(LENGTHS, np.int32)
    k_ar, v_ar, tables = _scatter_to_arena(k, v, lengths, BS, np.random.default_rng(G + D))
    tdt, jdt, tol = TDT[dtype], getattr(jnp, dtype), TOL[dtype]
    qt, kt, vt, k_art, v_art = (torch.from_numpy(a).to(tdt) for a in (q, k, v, k_ar, v_ar))
    qj, kj, vj, k_arj, v_arj = (jnp.asarray(a, jdt) for a in (q, k, v, k_ar, v_ar))
    lt, tt = torch.from_numpy(lengths), torch.from_numpy(tables)

    live = lengths > 0     # K3's contract is length >= 1
    plain = _f32(decode_attention_plain(qt, kt, vt, lt))[live]
    ref = _f32(decode_ref(qj, kj, vj, jnp.asarray(lengths)))[live]
    paged_plain = _f32(paged_decode_attention_plain(qt, k_art, v_art, tt, lt))
    paged_ref = _f32(paged_decode_ref(qj, k_arj, v_arj, jnp.asarray(tables),
                                      jnp.asarray(lengths)))
    k_view, v_view = paged_kv_view(k_art, tt), paged_kv_view(v_art, tt)
    for n in N_SPLITS:
        out = _split_merge(qt, kt, vt, lt, n)
        paged = _split_merge(qt, k_view, v_view, lt, n)
        assert out.dtype == qt.dtype and out.shape == qt.shape
        np.testing.assert_allclose(_f32(out)[live], plain, atol=tol, err_msg=f"{n} splits")
        np.testing.assert_allclose(_f32(out)[live], ref, atol=tol, err_msg=f"{n} splits")
        np.testing.assert_allclose(_f32(paged), paged_plain, atol=tol, err_msg=f"{n} splits")
        np.testing.assert_allclose(_f32(paged), paged_ref, atol=tol, err_msg=f"{n} splits")
        assert torch.isfinite(paged.float()).all()
        assert (paged[~torch.from_numpy(live)] == 0).all(), "a length-0 row must be zeros"
        # The same rows through the arena: the same arithmetic, the same bits.
        assert torch.equal(paged[torch.from_numpy(live)], out[torch.from_numpy(live)])


def test_merge_of_empty_splits_is_zero_without_nan():
    """Splits with no rows carry (kNegInf, 0, 0); merged alone they give
    exact zeros, since exp2(kNegInf - kNegInf) = 1 multiplies zeros (a
    running max of -inf would give exp2(-inf - -inf) = NaN)."""
    G, D = 4, 64
    empty = (torch.full((G,), NEG_INF), torch.zeros(G), torch.zeros(G, D))
    m, l, acc = _merge([empty] * 7)
    out = acc / torch.clamp(l, min=1e-30)[:, None]
    assert torch.isfinite(out).all() and (out == 0).all()
    # An empty split beside a live one changes nothing.
    qg, k, v = (torch.from_numpy(_np(s)) for s in ((G, D), (40, D), (40, D)))
    live = _split_state(qg, k, v, 0, 40)
    for got, want in zip(_merge([empty, live, empty]), live):
        assert torch.equal(got, want)


def test_split_merge_is_one_softmax_for_any_split_count():
    """Merging the splits' states equals one softmax over all the rows, to
    f32 rounding, for every split count from 1 to more than the
    granules."""
    B, H, D, S_ = 2, 8, 64, 300
    q, k, v = (torch.from_numpy(_np(s)) for s in ((B, H, D), (B, S_, 2, D), (B, S_, 2, D)))
    lengths = torch.tensor([300, 77], dtype=torch.int32)
    want = decode_attention_plain(q, k, v, lengths)
    for n in (1, 2, 3, 7, 19, 25, 64):
        torch.testing.assert_close(_split_merge(q, k, v, lengths, n), want, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# K3's partial form: a rank's block of a cache's rows, merged across ranks
# ---------------------------------------------------------------------------

def _f64_softmax(q, k, v, lengths):
    """(out, lse) in f64 numpy: q scaled in its own dtype as the kernels do,
    a softmax over each row's live rows; a row with none gives zeros and
    -inf."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qs = scale_query(q).double().numpy().reshape(B, Hkv, H // Hkv, D)
    kd, vd = k.double().numpy(), v.double().numpy()
    out, lse = np.zeros((B, Hkv, H // Hkv, D)), np.full((B, Hkv, H // Hkv), -np.inf)
    for b in range(B):
        n = int(lengths[b])
        if n <= 0:
            continue
        s_ = np.einsum("hgd,shd->hgs", qs[b], kd[b, :n])
        top = s_.max(-1, keepdims=True)
        e = np.exp(s_ - top)
        lse[b] = (top[..., 0] + np.log(e.sum(-1)))
        out[b] = np.einsum("hgs,shd->hgd", e / e.sum(-1, keepdims=True), vd[b, :n])
    return out.reshape(B, H, D), lse.reshape(B, H)


def _merge_partials(parts):
    """The cross-rank merge's formula (``merge_partials_over_tp``) over a
    list of (out f32, lse) partials, in f32: the largest lse floored at
    the least finite f32, weights exp(lse - max), the weighted outputs summed and
    divided by the summed weights (floored at 1e-30)."""
    top = torch.stack([lse for _, lse in parts]).amax(0).clamp(
        min=torch.finfo(torch.float32).min)
    num = sum(out * torch.exp(lse - top)[..., None] for out, lse in parts)
    den = sum(torch.exp(lse - top) for _, lse in parts)
    return num / den.clamp(min=1e-30)[..., None]


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_plain_matches_an_f64_softmax(dtype, G):
    """``decode_attention_partial_plain`` (the CPU path of the wrapper)
    against an f64 softmax: out within 2e-6 and lse within 2e-6 relative
    in f32 terms on live rows (f32 sums against f64), whatever q's dtype
    (the output is not rounded to it); a length-0 row gives exact zeros
    and lse -inf."""
    B, D = len(LENGTHS), 64
    H = G * HKV
    q, k, v = (torch.from_numpy(_np(s_)).to(TDT[dtype])
               for s_ in ((B, H, D), (B, S, HKV, D), (B, S, HKV, D)))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    out, lse = decode_attention_partial(q, k, v, lengths)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.equal(out, decode_attention_partial_plain(q, k, v, lengths)[0])
    want_out, want_lse = _f64_softmax(q, k, v, lengths)
    live = lengths > 0
    np.testing.assert_allclose(out[live].numpy(), want_out[live.numpy()], atol=2e-6)
    np.testing.assert_allclose(lse[live].numpy(), want_lse[live.numpy()], rtol=2e-6,
                               atol=2e-6)
    assert (out[~live] == 0).all() and torch.isneginf(lse[~live]).all()
    # The output is the plain K3's before its rounding to q's dtype.
    np.testing.assert_allclose(_f32(out[live].to(q.dtype)),
                               _f32(decode_attention_plain(q, k, v, lengths)[live]),
                               atol=TOL[dtype])


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_blocks_of_a_cache_merged_equal_the_whole(G, parts):
    """A cache cut along its rows into ``parts`` equal blocks, as
    ``sp_decode`` cuts it over "model": each block's partial form at the
    local lengths clamp(length - first, 0, rows) (rows 0 for every lane
    shorter than the block's first row: blocks with no live row), merged
    by the cross-rank formula, equals the partial form over the whole
    cache within 1e-6 relative (f32), and its lse the whole's."""
    B, D = len(LENGTHS), 64
    H = G * HKV
    q, k, v = (torch.from_numpy(_np(s_)) for s_ in ((B, H, D), (B, S, HKV, D), (B, S, HKV, D)))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    rows = S // parts
    blocks = []
    for i in range(parts):
        local = (lengths - i * rows).clamp(0, rows)
        blocks.append(decode_attention_partial(q, k[:, i * rows:(i + 1) * rows].contiguous(),
                                               v[:, i * rows:(i + 1) * rows].contiguous(),
                                               local))
    assert any(bool((b[1] == -math.inf).any()) for b in blocks), "no block without live rows"
    whole, whole_lse = decode_attention_partial(q, k, v, lengths)
    merged = _merge_partials(blocks)
    live = lengths > 0
    scale = whole[live].abs().max()
    np.testing.assert_allclose(merged[live].numpy(), whole[live].numpy(), rtol=0,
                               atol=1e-6 * float(scale))
    assert (merged[~live] == 0).all() and torch.isfinite(merged).all()
    lse = torch.logsumexp(torch.stack([b[1] for b in blocks]), 0)
    np.testing.assert_allclose(lse[live].numpy(), whole_lse[live].numpy(), rtol=1e-6)


@pytest.mark.parametrize("n_splits", [1, 2, 5, 40])
def test_split_merge_emulation_gives_the_partial_form(n_splits):
    """The kernels' arithmetic with an f32 output and the lse written from
    the merged (m, l) (``_split_merge(..., partial=True)``, one split
    writing it from the split kernel) equals the plain partial form: out
    within 2e-6, lse within 2e-6 relative; a length-0 row zeros and
    -inf (the lse within 2e-6 absolute near 0)."""
    B, H, D = len(LENGTHS), 8, 64
    q, k, v = (torch.from_numpy(_np(s_)).to(torch.bfloat16)
               for s_ in ((B, H, D), (B, S, HKV, D), (B, S, HKV, D)))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    out, lse = _split_merge(q, k, v, lengths, n_splits, partial=True)
    want, want_lse = decode_attention_partial_plain(q, k, v, lengths)
    live = lengths > 0
    np.testing.assert_allclose(out[live].numpy(), want[live].numpy(), atol=2e-6)
    np.testing.assert_allclose(lse[live].numpy(), want_lse[live].numpy(), rtol=2e-6,
                               atol=2e-6)
    assert (out[~live] == 0).all() and torch.isneginf(lse[~live]).all()
    assert torch.equal(out.to(q.dtype), _split_merge(q, k, v, lengths, n_splits))


def test_partial_form_on_meta_reports_the_blocks_rows():
    """The dry run's meta branch of K3's partial form: f32 (B, H, D) and
    (B, H) outputs, no launch, and one report under K3's name of
    ``decode_attention_partial_work`` over every row of the rank's block
    (a full cache), which adds the f32 output and the lse to K3's bytes."""
    import repro_torch.kernels as K

    B, H, Hkv, D, S = 4, 32, 8, 64, 512
    q = torch.empty((B, H, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, S, Hkv, D), dtype=torch.bfloat16, device="meta")
    lengths = torch.empty((B,), dtype=torch.int32, device="meta")
    seen, launches = [], K.decode_attention.launches
    K.work_hook = lambda name, flops, nbytes: seen.append((name, flops, nbytes))
    try:
        out, lse = decode_attention_partial(q, k, k, lengths)
    finally:
        K.work_hook = None
    assert out.shape == (B, H, D) and lse.shape == (B, H)
    assert out.dtype == lse.dtype == torch.float32 and out.device.type == "meta"
    assert K.decode_attention.launches == launches
    flops, nbytes = K.decode_attention_partial_work(B, H, Hkv, D, 2, B * S)
    assert seen == [("decode_attention", flops, nbytes)]
    k3 = K.decode_attention_work(B, H, Hkv, D, 2, B * S)
    assert (flops, nbytes - k3[1]) == (k3[0], B * H * D * 2 + B * H * 4)
