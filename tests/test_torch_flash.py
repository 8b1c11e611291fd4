"""The training kernels' plain versions against the reference, on the CPU:
flash attention forward (K1) against the Pallas kernel in interpret mode
and its jnp oracle, K1 backward against ``jax.vjp`` of the oracle and of
the model's ``mea_attention``, and the RMSNorm backward (K2) against
``jax.vjp`` of ``layers.rms_norm``.

On the CPU the wrappers take these plain versions, so these tests hold
the functions the CUDA kernels are checked against on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 7). Inputs come from one
seeded numpy generator and go to both frameworks.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention as pallas_flash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    rms_norm,
    rms_norm_bwd_plain,
)
from repro_torch.kernels.flash_attention import _p_ds, flash_attention_rounding_terms
from repro_torch.kernels.parity import FLASH_SHAPES, dscale_bf16_slack, flash_within, within

RNG = np.random.default_rng(11)

#: A copy of tests/test_kernels.py's FLASH_CASES.
FLASH_CASES = [
    # B, Sq, Skv, H, Hkv, D, Dv, causal
    (2, 128, 128, 4, 2, 64, 64, True),
    (1, 256, 256, 8, 8, 64, 64, True),     # MHA
    (1, 200, 200, 4, 1, 64, 64, True),     # MQA, ragged seq (padding path)
    (2, 128, 128, 4, 2, 128, 128, False),  # bidirectional
    (1, 64, 64, 2, 2, 32, 32, True),       # small blocks
    (1, 384, 384, 6, 3, 64, 64, True),     # 3 q blocks
]
#: Backward cases: the kernel cases, G = 3 with D != Dv, and Sq != Skv.
BWD_CASES = FLASH_CASES + [
    (2, 40, 40, 6, 2, 32, 64, True),
    (1, 24, 56, 4, 2, 64, 32, False),
]
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype):
    B, Sq, Skv, H, Hkv, D, Dv, _ = case
    arrs = [RNG.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(case, dtype):
    """Tolerance: the reference's own (tests/test_kernels.py) — 2e-5 in
    f32, 6e-2 in bf16 (one rounding of outputs of magnitude ~4)."""
    causal = case[-1]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype)
    out, lse = flash_attention_plain(qt, kt, vt, causal=causal)
    tol = 6e-2 if dtype == "bfloat16" else 2e-5
    pallas = pallas_flash(qj, kj, vj, causal=causal, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(attention_ref(qj, kj, vj, causal=causal)),
                               atol=tol)
    assert out.dtype == qt.dtype and lse.dtype == torch.float32
    assert lse.shape == (case[0], case[3], case[1])


def test_flash_attention_block_size_invariance():
    """The Pallas kernel at two block sizes and the port's plain version
    (which has no blocks) agree: the online softmax does not depend on
    the tiling."""
    case = (1, 256, 256, 4, 2, 64, 64, True)
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, "float32")
    a = pallas_flash(qj, kj, vj, causal=True, block_q=64, block_kv=64, interpret=True)
    b = pallas_flash(qj, kj, vj, causal=True, block_q=128, block_kv=256, interpret=True)
    out, _ = flash_attention_plain(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5)
    np.testing.assert_allclose(_f32(out), _f32(a), atol=1e-5)


def _mea(q, k, v, causal):
    return jattn.mea_attention(q, k, v, causal=causal, chunk=64)


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("oracle", ["attention_ref", "mea_attention"])
def test_flash_attention_bwd_matches_jax_vjp(case, oracle):
    """dq, dk, dv of one shared random cotangent, in f32, from the plain
    backward and from the CPU ``autograd.Function``, against ``jax.vjp``.
    Tolerance 1e-4 of the largest gradient magnitude: both sum up to 384
    f32 products per entry, in other orders."""
    causal = case[-1]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, "float32")
    do = RNG.normal(size=(case[0], case[1], case[3], case[6])).astype(np.float32)
    fn = functools.partial(attention_ref, causal=causal) if oracle == "attention_ref" \
        else functools.partial(_mea, causal=causal)
    ref = jax.jit(lambda q, k, v, d: jax.vjp(fn, q, k, v)[1](d))(qj, kj, vj, jnp.asarray(do))

    out, lse = flash_attention_plain(qt, kt, vt, causal=causal)
    plain = flash_attention_bwd_plain(qt, kt, vt, out, lse, torch.from_numpy(do),
                                      causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    flash_attention(*leaves, causal=causal).backward(torch.from_numpy(do))
    for r, p, leaf in zip(ref, plain, leaves):
        atol = 1e-4 * max(1.0, float(np.abs(_f32(r)).max()))
        np.testing.assert_allclose(_f32(p), _f32(r), atol=atol)
        np.testing.assert_allclose(_f32(leaf.grad), _f32(r), atol=atol)


@pytest.mark.parametrize("shape", [(4, 16, 128), (2, 7, 576), (3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_bwd_matches_jax_vjp(shape, dtype):
    """dx and dscale against ``jax.vjp(layers.rms_norm)``.

    f32: within 1e-5 of the largest magnitude (sums over up to 576
    columns and 112 rows in another order).
    bf16: dx against the bf16 vjp within one bf16 step (2e-2 + |ref|/64;
    both form it in f32 from the same bf16 products and round once).
    dscale against the f32 vjp of the same bf16-valued inputs: XLA's CPU
    reduction sums the bf16 vjp's rows in bf16 itself, so that dscale
    strays by several rounding steps (~0.1 at |dscale| ~ 5), while the
    port sums in f32, as its kernel does. The port multiplies g by the
    normalized row rounded to bf16 (the forward's x^), so each term may
    differ from the f32 vjp's by 2^-8 of |g * x^|: the tolerance of a
    column is 2^-8 * sum over rows of |g * x^| plus one bf16 step of the
    result (|ref| / 64)."""
    x = RNG.normal(size=shape).astype(np.float32)
    g = RNG.normal(size=shape).astype(np.float32)
    s = (1 + 0.1 * RNG.normal(size=shape[-1:])).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj, gj, sj = (jnp.asarray(a, jdt) for a in (x, g, s))
    _, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b), xj, sj)
    rdx, rds = vjp(gj)
    if dtype == "bfloat16":
        f32 = [jnp.asarray(a, jnp.float32) for a in (xj, sj, gj)]
        _, vjp32 = jax.vjp(lambda a, b: jlayers.rms_norm(a, b), f32[0], f32[1])
        rds = vjp32(f32[2])[1]
    tx, tg, ts = (torch.tensor(np.asarray(a, np.float32)).to(_TDT[dtype])
                  for a in (xj, gj, sj))
    plain = rms_norm_bwd_plain(tg, tx, ts)
    xl, sl = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    rms_norm(xl, sl).backward(tg)
    for i, (r, p, got) in enumerate(zip((rdx, rds), plain, (xl.grad, sl.grad))):
        assert got.dtype == _TDT[dtype]
        if dtype == "float32":
            atol, rtol = 1e-5 * max(1.0, float(np.abs(_f32(r)).max())), 0.0
        elif i == 0:
            atol, rtol = 2e-2, 1 / 64
        else:
            atol, rtol = dscale_bf16_slack(tg, tx)[0].numpy(), 1 / 64
        for val in (p, got):
            err = np.abs(_f32(val) - _f32(r))
            assert np.all(err <= atol + rtol * np.abs(_f32(r))), (i, err.max())


# --- The bf16 kernels' rounding of P and dS, emulated on the CPU ----------

#: FLASH_SHAPES small enough for the CPU (the two B = 32 training shapes
#: run on the card only).
SMALL_FLASH_SHAPES = [s for s in FLASH_SHAPES if s[0] < 32]
#: Shapes with at least two KV and q tiles of 64, for the dropped-tile rule.
TILED_FLASH_SHAPES = [s for s in SMALL_FLASH_SHAPES if min(s[1], s[2]) > 128]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16_case(shape, seed, mul=1.0):
    g = torch.Generator().manual_seed(seed)
    B, Sq, Skv, H, Hkv, D, Dv = shape
    q = (torch.randn((B, Sq, H, D), generator=g) * mul).to(torch.bfloat16)
    k = (torch.randn((B, Skv, Hkv, D), generator=g) * mul).to(torch.bfloat16)
    v = torch.randn((B, Skv, Hkv, Dv), generator=g).to(torch.bfloat16)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(torch.bfloat16)
    return q, k, v, do


def _emulated(q, k, v, o, lse, do, causal, drop_keys=None, drop_queries=None):
    """(out, dq, dk, dv): the plain versions with P rounded to bf16 before
    PV and P^T dO, and dS before dS K and dS^T q, where the bf16 kernels
    round them. The backward takes the plain forward's ``o`` and ``lse``,
    as the card's checks do. ``drop_keys`` (a slice) leaves those keys'
    share out of out and dq, ``drop_queries`` those queries' share out of
    dk and dv: one tile a kernel would have skipped."""
    B, Sq, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    p, dof, ds = _p_ds(q, k, v, o, lse, do, causal)
    p, ds = _bf16(p), _bf16(ds)
    pk, dsk, pq, dsq = p.clone(), ds.clone(), p.clone(), ds.clone()
    if drop_keys is not None:
        pk[..., drop_keys] = 0
        dsk[..., drop_keys] = 0
    if drop_queries is not None:
        pq[..., drop_queries, :] = 0
        dsq[..., drop_queries, :] = 0
    out = torch.einsum("bhgqk,bkhd->bqhgd", pk, v.float()).reshape(B, Sq, H, Dv)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsk, k.float()).reshape(B, Sq, H, D) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dsq, q.float().reshape(B, Sq, Hkv, G, D)) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pq, dof)
    return tuple(t.to(torch.bfloat16) for t in (out, dq, dk, dv))


def _plain_all(q, k, v, do, causal):
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    return o, lse, (o,) + flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SMALL_FLASH_SHAPES)
def test_bf16_rounding_of_p_and_ds_passes_the_bf16_rule(shape, causal):
    """Rounding P and dS to bf16 before their second product, as the bf16
    kernels do, keeps out, dq, dk and dv within ``parity.within``'s bf16
    rule of the plain versions at unit-variance inputs."""
    q, k, v, do = _bf16_case(shape, 21)
    o, lse, refs = _plain_all(q, k, v, do, causal)
    for name, got, ref in zip(("out", "dq", "dk", "dv"),
                              _emulated(q, k, v, o, lse, do, causal), refs):
        err, ok = within(got, ref, torch.bfloat16)
        assert ok, (name, err)


@pytest.mark.parametrize("shape", [(2, 128, 128, 4, 2, 64, 64), (4, 512, 512, 32, 8, 64, 64)])
def test_bf16_rounding_at_large_scores_needs_the_stated_rule(shape):
    """With q and k scaled by 4 (scores near 100, as on the card's harder
    case) dS reaches tens: its rounding moves dq and dk past ``within``'s
    bf16 rule, but not past ``flash_within``, which adds bf16's unit
    roundoff of the terms' sizes (``flash_attention_rounding_terms``)."""
    q, k, v, do = _bf16_case(shape, 22, mul=4.0)
    o, lse, refs = _plain_all(q, k, v, do, True)
    terms = flash_attention_rounding_terms(q, k, v, o, lse, do, causal=True)
    got = _emulated(q, k, v, o, lse, do, True)
    assert not all(within(a, b, torch.bfloat16)[1] for a, b in zip(got, refs))
    for name, a, b, t in zip(("out", "dq", "dk", "dv"), got, refs, terms):
        err, ok = flash_within(a, b, torch.bfloat16, t)
        assert ok, (name, err)


@pytest.mark.parametrize("mul", [1.0, 4.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", TILED_FLASH_SHAPES)
def test_flash_rule_rejects_a_dropped_tile(shape, causal, mul):
    """The stated rule has teeth: out and dq less one KV tile's share
    (keys 64-127), and dk and dv less one q tile's share (queries
    64-127), each fail ``flash_within``, at unit and at large scores."""
    q, k, v, do = _bf16_case(shape, 23, mul=mul)
    o, lse, refs = _plain_all(q, k, v, do, causal)
    terms = flash_attention_rounding_terms(q, k, v, o, lse, do, causal=causal)
    tile = slice(64, 128)
    got = _emulated(q, k, v, o, lse, do, causal, drop_keys=tile, drop_queries=tile)
    for name, a, b, t in zip(("out", "dq", "dk", "dv"), got, refs, terms):
        assert not flash_within(a, b, torch.bfloat16, t)[1], name
    # The f32 rule rejects the same tile dropped in f32.
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o32, lse32, refs32 = _plain_all(qf, kf, vf, dof, causal)
    p, _, _ = _p_ds(qf, kf, vf, o32, lse32, dof, causal)
    p[..., tile] = 0
    out32 = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).reshape(o32.shape)
    assert not flash_within(out32, refs32[0], torch.float32, None)[1]


# --- The f32 kernels' 3xTF32 products, emulated on the CPU ----------------


def _tf32(x):
    """f32 ``x`` rounded to nearest at 10 mantissa bits, ties away from
    zero: ``cvt.rna.tf32.f32`` (the low 13 bits of the pattern cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    """``einsum(eq, a, b)`` as the f32 kernels form it: each f32 operand
    split into big = tf32(x) and small = tf32(x - big), and small . big +
    big . small summed before big . big, in f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    cross = torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
    return cross + torch.einsum(eq, a_big, b_big)


def _mm_tf32(eq, a, b):
    """One TF32 product: each operand rounded to TF32 once."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _recompute(q, k, v, do, causal, mm, o=None, lse=None):
    """(out, dq, dk, dv) of the kernels' recompute in the inputs' dtype,
    every one of its seven products through ``mm``: S = (q / sqrt(D)) K^T
    (q scaled before it is split), O = P V / l, then from ``o`` and
    ``lse`` (the plain forward's, as the card's checks pass them; else
    this forward's) P = exp(S - LSE), dP = dO V^T, dS = P o (dP - Delta)
    formed and then split, dV = P^T dO, dQ = dS K / sqrt(D),
    dK = dS^T (q / sqrt(D))."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    qs = q.reshape(B, Sq, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = mm("bqhgd,bkhd->bhgqk", qs, k)
    if causal:
        keep = torch.arange(Sq)[:, None] >= torch.arange(Skv)
        s = s.masked_fill(~keep, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm("bhgqk,bkhd->bqhgd", p, v) / l.permute(0, 3, 1, 2, 4)
    if o is None:
        o, lse = out.reshape(B, Sq, H, Dv), (m + torch.log(l)).reshape(B, H, Sq)
    p = torch.exp(s - lse.to(q.dtype).reshape(B, Hkv, G, Sq, 1))
    dof = do.reshape(B, Sq, Hkv, G, Dv)
    delta = (dof * o.to(q.dtype).reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    ds = p * (mm("bqhgd,bkhd->bhgqk", dof, v) - delta.permute(0, 2, 3, 1)[..., None])
    dv = mm("bhgqk,bqhgd->bkhd", p, dof)
    dq = mm("bhgqk,bkhd->bqhgd", ds, k) * (1.0 / math.sqrt(D))
    dk = mm("bhgqk,bqhgd->bkhd", ds, qs)
    return out.reshape(B, Sq, H, Dv), dq.reshape(B, Sq, H, D), dk, dv


def _f32_case(shape, mul, seed=31):
    """q, k, v, dO from a seeded numpy generator, q and k scaled by ``mul``."""
    rng = np.random.default_rng(seed)
    B, Sq, Skv, H, Hkv, D, Dv = shape
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv), (B, Sq, H, Dv))]
    arrs[0] *= mul
    arrs[1] *= mul
    return [torch.from_numpy(a) for a in arrs]


def _f64_refs(q, k, v, do, causal):
    """The plain version's recompute in float64 (exact products), and a
    check that it is the plain version's function: the f32 plain forward
    and backward lie within the f32 rule of it."""
    refs = _recompute(*(t.double() for t in (q, k, v, do)), causal, torch.einsum)
    o, lse, plain = _plain_all(q, k, v, do, causal)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), plain[:1] + plain[1:], refs):
        assert within(got, ref, torch.float32)[1], ("plain", name)
    return o, lse, refs


#: Reduced cases of the f32 paths: smollm-135m's G 3 at D 64, the failover's
#: D 32, D 128 with D != Dv, hubert's D 80 (bidirectional, Sq != Skv), and
#: scores near 100 (q and k scaled by 4) at G 2 and G 3.
TF32X3_CASES = [
    ((2, 128, 128, 9, 3, 64, 64), True, 1.0),
    ((2, 64, 64, 4, 2, 32, 32), True, 1.0),
    ((2, 77, 100, 6, 2, 128, 64), False, 1.0),
    ((2, 77, 100, 4, 4, 80, 80), False, 1.0),
    ((2, 128, 128, 4, 2, 64, 64), True, 4.0),
    ((2, 128, 128, 9, 3, 64, 64), True, 4.0),
]


@pytest.mark.parametrize("shape,causal,mul", TF32X3_CASES)
def test_3xtf32_products_pass_the_f32_rule(shape, causal, mul):
    """Every product of the forward and backward in 3xTF32 (P and dS split
    too) keeps out, dq, dk and dv within ``parity.within``'s f32 rule of
    the f64 recompute, at unit and at large scores."""
    q, k, v, do = _f32_case(shape, mul)
    o, lse, refs = _f64_refs(q, k, v, do, causal)
    got = _recompute(q, k, v, do, causal, _mm_3xtf32, o, lse)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, refs):
        err, ok = within(a, b, torch.float32)
        assert ok, (name, err)


@pytest.mark.parametrize("shape,causal,mul", [TF32X3_CASES[1], TF32X3_CASES[5]])
def test_one_tf32_product_fails_the_f32_rule(shape, causal, mul):
    """The rule has teeth: the same recompute with one TF32 product each
    (operands rounded to 10 mantissa bits once) leaves every output
    outside the f32 rule."""
    q, k, v, do = _f32_case(shape, mul)
    o, lse, refs = _f64_refs(q, k, v, do, causal)
    got = _recompute(q, k, v, do, causal, _mm_tf32, o, lse)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, refs):
        assert not within(a, b, torch.float32)[1], name


def test_tf32_split_rounds_to_nearest():
    """``_tf32`` is ``cvt.rna``: ties away from zero, 10 mantissa bits; big
    + small holds x to 2^-21 of |x|, where big alone is off by up to
    2^-11."""
    one = torch.tensor([1.0, -1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    assert torch.equal(_tf32(one * (1 + ulp / 2)), one * (1 + ulp))      # a tie: away
    assert torch.equal(_tf32(one * (1 + ulp / 2 - 2 ** -23)), one)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32))
    big = _tf32(x)
    small = _tf32(x - big)
    assert torch.equal(big.view(torch.int32) & 0x1FFF, torch.zeros(4096, dtype=torch.int32))
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0 ** -21
    assert ((big.double() - x.double()).abs() / x.double().abs()).max() > 2.0 ** -12
