"""The RMSNorm kernels' arithmetic (K2, ``csrc/rmsnorm.cu``) emulated on
the CPU, and their launch plan.

The CUDA kernels hold each row in registers, a group of ``tpr`` threads
(a warp or a block) to a row: thread ``lane`` holds units ``lane``,
``lane + tpr``, ... of the row (16-byte vectors of N elements, or single
elements) and sums its own elements in order with fused multiply-adds;
the group adds the threads' sums by xor shuffles within each warp and the
warps' sums in warp order. The backward reduces the pair (sum x^2,
sum g^ x) so, with r = rsqrt(sum x^2 / D + eps), mean(g^ n) = r * (sum g^ x
/ D), and dx = r * fma(-n, mean, g^). Row r goes to group r % groups; each
group sums its rows' g * x^ per column in row order into one row of an f32
scratch, and a second launch sums the scratch per column: slice s of 64
(16 without 16-byte vectors) adds groups s, s + 64, ... in order, then a
halving tree over the slices.

``_fwd`` and ``_bwd`` repeat that arithmetic (a fused multiply-add as one
rounding of the f64 sum of the exact f64 product; PyTorch's rsqrt, where
the card's ``rsqrtf`` lies within 2 ulps) and are held to three
references on inputs from one seeded numpy generator: the plain versions
(``parity.within``, with ``dscale_bf16_slack(near_ulps=NEAR_ULPS)`` on bf16
dscale), the Pallas ``rmsnorm_fwd`` in interpret mode and ``rmsnorm_ref``
(forward), and ``jax.vjp`` of ``layers.rms_norm`` (backward).
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_ref
from repro.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro.models import layers as jlayers
from repro_torch.kernels import rms_norm_bwd_plain, rms_norm_plain
from repro_torch.kernels import rmsnorm as R
from repro_torch.kernels.parity import RMS_TRAIN_SHAPES, NEAR_ULPS, dscale_bf16_slack, within

RNG = np.random.default_rng(17)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132
EPS = 1e-6
#: (rows, D): zamba2's gated norm and shared block widths (4096), llama's
#: d_model (2048), smollm's (576), and rows that are no multiple of 8
#: (33: single elements) or narrower than a warp's vectors (64).
SHAPES = [(6, 576), (5, 2048), (3, 4096), (5, 33), (7, 64)]
#: 132 SMs give every row its own group at these few rows; 2 SMs make
#: groups walk several rows each (the grid-stride loop and its dscale sums).
SMS = [H100_SMS, 2]


def _fma(a, b, c):
    """f32 fused multiply-add: the f64 product of two f32 values is exact,
    so this rounds once, but for a rare double rounding at an f64 tie."""
    return (a.double() * b.double() + c.double()).float()


def _layout(dim, plan):
    """(tpr, J * N) column of each thread's elements in the order it sums
    them; ``dim`` (a zero column) past the row."""
    n = 16 // plan.elem_bytes if plan.vec else 1
    units = dim // n
    u = torch.arange(plan.tpr)[:, None] + plan.tpr * torch.arange(plan.j)[None, :]
    col = (u[:, :, None] * n + torch.arange(n)[None, None, :])
    col = torch.where((u < units)[:, :, None], col, dim)
    return col.reshape(plan.tpr, plan.j * n)


def _group_sum(v):
    """(rows, tpr) thread sums -> (rows,) the group's sum: xor shuffles
    within each warp, then the warps' sums in warp order. Every lane of a
    warp ends with the same bits."""
    rows, tpr = v.shape
    w = v.reshape(rows, tpr // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, :, lane ^ o]
    assert torch.equal(w, w[:, :, :1].expand_as(w))
    t = w[:, 0, 0]
    for i in range(1, tpr // 32):
        t = t + w[:, i, 0]
    return t


def _gather(a, col):
    """a (rows, D) f32 -> (rows, tpr, J * N), zero past the row."""
    return torch.cat([a, torch.zeros(a.shape[0], 1)], 1)[:, col]


class _P:
    """A launch plan with its element size, as the emulation reads it."""

    def __init__(self, plan, elem_bytes):
        self.__dict__.update(plan._asdict(), groups=plan.groups, elem_bytes=elem_bytes)


def _fwd(x, scale, plan):
    dt = x.dtype
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    col = _layout(D, plan)
    xt = _gather(xf, col)
    ss = torch.zeros(xt.shape[:2])
    for k in range(xt.shape[2]):
        ss = _fma(xt[:, :, k], xt[:, :, k], ss)
    r = torch.rsqrt(_group_sum(ss) / D + EPS)[:, None]
    return ((xf * r).to(dt).float() * scale.float()).to(dt).reshape(x.shape)


def _bwd(g, x, scale, plan):
    dt = x.dtype
    D = x.shape[-1]
    xf, gf = x.float().reshape(-1, D), g.float().reshape(-1, D)
    gh = (gf * scale.float()).to(dt).float()
    col = _layout(D, plan)
    xt, ght = _gather(xf, col), _gather(gh, col)
    v0 = v1 = torch.zeros(xt.shape[:2])
    for k in range(xt.shape[2]):
        v0 = _fma(xt[:, :, k], xt[:, :, k], v0)
        v1 = _fma(ght[:, :, k], xt[:, :, k], v1)
    v0, v1 = _group_sum(v0), _group_sum(v1)
    r = torch.rsqrt(v0 / D + EPS)[:, None]
    mean = r * (v1 / D)[:, None]
    n = xf * r
    dx = (r * _fma(-n, mean.expand_as(n), gh)).to(dt).reshape(x.shape)
    # Group i takes rows i, i + G, ...: its scratch row sums them in order.
    G = plan.groups
    steps = -(-xf.shape[0] // G)
    pad = steps * G - xf.shape[0]
    gp = torch.cat([gf, torch.zeros(pad, D)]).reshape(steps, G, D)
    xh = torch.cat([n.to(dt).float(), torch.zeros(pad, D)]).reshape(steps, G, D)
    part = torch.zeros(G, D)
    for s in range(steps):
        part = _fma(gp[s], xh[s], part)
    # The second launch: S slices, each summing groups s, s + S, ... in
    # order, then a halving tree over the slices.
    S = 64 if D % 4 == 0 else 16
    sm = torch.zeros(S, D)
    for i in range(G):
        sm[i % S] = sm[i % S] + part[i]
    h = S // 2
    while h:
        sm[:h] = sm[:h] + sm[h:2 * h]
        h //= 2
    return dx, sm[0].to(scale.dtype)


def _plan(bwd, rows, D, dtype, n_sms, tpr=None):
    es = torch.tensor([], dtype=TDT[dtype]).element_size()
    vec = D % (16 // es) == 0
    return _P(R.launch_plan(bwd, rows, D, es, vec, n_sms, tpr), es)


def _inputs(shape, dtype):
    x = RNG.normal(size=shape).astype(np.float32)
    g = RNG.normal(size=shape).astype(np.float32)
    s = (1 + 0.1 * RNG.normal(size=shape[-1:])).astype(np.float32)
    return [torch.from_numpy(a).to(TDT[dtype]) for a in (x, g, s)]


def _np32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# The emulation against the plain versions and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_emulation_matches_plain_and_pallas(shape, dtype, n_sms):
    """The forward's arithmetic against ``rms_norm_plain`` (``within``),
    ``rmsnorm_ref`` (f32 2e-5; bf16 one bf16 step, 2e-2 + |ref| / 128: the
    same rounding order) and the Pallas kernel in interpret mode (f32
    2e-5; bf16 0.1: it multiplies by the scale before its single cast)."""
    x, _, s = _inputs(shape, dtype)
    out = _fwd(x, s, _plan(False, shape[0], shape[-1], dtype, n_sms))
    dt = TDT[dtype]
    assert out.dtype == dt and out.shape == x.shape
    err, ok = within(out, rms_norm_plain(x, s), dt)
    assert ok, err
    jdt = getattr(jnp, dtype)
    xj, sj = jnp.asarray(_np32(x), jdt), jnp.asarray(_np32(s), jdt)
    ref = _np32(rmsnorm_ref(xj, sj))
    pallas = _np32(rmsnorm_fwd(xj, sj, interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(_np32(out), ref, atol=2e-5)
        np.testing.assert_allclose(_np32(out), pallas, atol=2e-5)
    else:
        np.testing.assert_allclose(_np32(out), ref, atol=2e-2, rtol=1 / 128)
        np.testing.assert_allclose(_np32(out), pallas, atol=1e-1)


@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_emulation_matches_plain(shape, dtype, n_sms):
    """dx and dscale against ``rms_norm_bwd_plain`` by ``parity.within``;
    bf16 dscale with the slack of x^'s rounding near a bf16 midpoint (the
    emulation's r is formed in another order, from a factored mean)."""
    x, g, s = _inputs(shape, dtype)
    dx, ds = _bwd(g, x, s, _plan(True, shape[0], shape[-1], dtype, n_sms))
    rx, rs = rms_norm_bwd_plain(g, x, s)
    dt = TDT[dtype]
    assert dx.dtype == dt and ds.dtype == dt
    err, ok = within(dx, rx, dt)
    assert ok, ("dx", err)
    slack = dscale_bf16_slack(g, x, near_ulps=NEAR_ULPS)[0] if dtype == "bfloat16" else 0.0
    err, ok = within(ds, rs, dt, slack)
    assert ok, ("dscale", err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_emulation_matches_jax_vjp(shape, dtype):
    """dx and dscale against ``jax.vjp(layers.rms_norm)`` at 2 SMs (groups
    of several rows). f32: within 1e-5 of the largest magnitude. bf16: dx
    against the bf16 vjp within 2e-2 + |ref| / 64; dscale against the f32
    vjp of the same bf16 values within 2^-8 sum |g x^| + |ref| / 64 (XLA's
    CPU vjp sums bf16 dscale in bf16, the kernel in f32;
    tests/test_torch_flash.py states the same rule for the plain version)."""
    x, g, s = _inputs(shape, dtype)
    dx, ds = _bwd(g, x, s, _plan(True, shape[0], shape[-1], dtype, 2))
    jdt = getattr(jnp, dtype)
    xj, gj, sj = (jnp.asarray(_np32(t), jdt) for t in (x, g, s))
    _, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b), xj, sj)
    rdx, rds = vjp(gj)
    if dtype == "bfloat16":
        f32 = [jnp.asarray(a, jnp.float32) for a in (xj, sj, gj)]
        _, vjp32 = jax.vjp(lambda a, b: jlayers.rms_norm(a, b), f32[0], f32[1])
        rds = vjp32(f32[2])[1]
    for i, (got, ref) in enumerate(((dx, rdx), (ds, rds))):
        ref = _np32(ref)
        if dtype == "float32":
            atol, rtol = 1e-5 * max(1.0, float(np.abs(ref).max())), 0.0
        elif i == 0:
            atol, rtol = 2e-2, 1 / 64
        else:
            atol, rtol = dscale_bf16_slack(g, x)[0].numpy(), 1 / 64
        err = np.abs(_np32(got) - ref)
        assert np.all(err <= atol + rtol * np.abs(ref)), (i, err.max())


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("tpr", [32, 64, 128, 256])
def test_every_width_of_row_group_gives_the_same_function(bwd, tpr):
    """Each width of row group an instance takes at llama's bf16 row (D
    2048) computes the same function: its emulation passes ``within``
    against the plain version."""
    shape, dtype = (9, 2048), "bfloat16"
    x, g, s = _inputs(shape, dtype)
    es = 2
    try:
        plan = _P(R.launch_plan(bwd, shape[0], shape[1], es, True, 3, tpr), es)
    except ValueError:
        assert bwd and R.max_threads(True, es, True, 256 // tpr) == 0
        return
    if bwd:
        dx, ds = _bwd(g, x, s, plan)
        rx, rs = rms_norm_bwd_plain(g, x, s)
        assert within(dx, rx, torch.bfloat16)[1]
        assert within(ds, rs, torch.bfloat16,
                      dscale_bf16_slack(g, x, near_ulps=NEAR_ULPS)[0])[1]
    else:
        assert within(_fwd(x, s, plan), rms_norm_plain(x, s), torch.bfloat16)[1]


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

PLAN_CASES = [(rows, D, es, bwd) for rows in (1, 4, 7, 256, 16384)
              for D in (33, 576, 2048, 4096, 8192) for es in (4, 2) for bwd in (False, True)]
# The MLA and xLSTM loops' training rows (``parity.RMS_TRAIN_SHAPES``).
PLAN_CASES += [(rows, D, es, bwd) for rows, D in RMS_TRAIN_SHAPES for es in (4, 2)
               for bwd in (False, True)]


@pytest.mark.parametrize("rows,D,es,bwd", PLAN_CASES)
def test_plan_covers_every_row_once_and_sizes_the_scratch(rows, D, es, bwd):
    """Each row goes to exactly one group (row r to group r % groups, a
    group walking its rows by the grid stride), no block is idle where
    there are rows for it, the groups' threads cover the row, the block is
    one the instance takes, and the dscale scratch has one row per
    group."""
    vec = D % (16 // es) == 0
    p = R.launch_plan(bwd, rows, D, es, vec, H100_SMS)
    assert 1 <= p.blocks <= -(-rows // p.rows_per_block)
    covered = np.zeros(rows, int)
    for grp in range(p.groups):
        covered[np.arange(grp, rows, p.groups)] += 1
    assert np.all(covered == 1)
    n = 16 // es if vec else 1
    assert p.tpr * p.j * n >= D and p.j in R.J_CHOICES
    assert p.threads <= R.max_threads(bwd, es, vec, p.j) and p.threads % 32 == 0
    assert p.blocks <= H100_SMS * max(1, R.THREADS_PER_SM[bwd] // p.threads)
    if bwd:
        assert R.bwd_scratch(p, D, torch.device("cpu")).shape == (p.groups, D)


def test_plan_refuses_rows_no_instance_covers():
    with pytest.raises(ValueError, match="no rmsnorm"):
        R.launch_plan(True, 8, 2048, 2, True, H100_SMS, 48)
    with pytest.raises(ValueError, match="no rmsnorm"):
        R.launch_plan(True, 8, R.MAX_BWD_DIM + 8, 2, True, H100_SMS)
    with pytest.raises(ValueError, match="multiple of 8"):
        R.launch_plan(False, 8, 100, 2, True, H100_SMS)
    with pytest.raises(ValueError, match="no rmsnorm"):
        R.launch_plan(False, 8, 16384 + 8, 2, True, H100_SMS)
    with pytest.raises(ValueError, match="no rmsnorm"):
        R.launch_plan(False, 8, 8192 + 1, 2, False, H100_SMS)


def test_every_row_width_up_to_the_limit_has_a_plan():
    """Every D up to ``MAX_BWD_DIM`` has a forward and a backward plan in
    16-byte vectors, and in single elements a forward plan up to
    ``MAX_BWD_DIM`` and a backward plan up to ``MAX_BWD_DIM_ELEMENTS``, in
    both dtypes, at few rows and at rows that fill the card; the forward
    also takes 16-byte rows up to 16384."""
    for D in list(range(1, 130)) + [576, 1000, 2048, 4095, 4096, 6000, 8191, 8192]:
        for es in (4, 2):
            for vec in (False, True):
                if vec and D % (16 // es):
                    continue
                for bwd in (False, True):
                    for rows in (3, 16384):
                        if bwd and not vec and D > R.MAX_BWD_DIM_ELEMENTS:
                            with pytest.raises(ValueError, match="no rmsnorm"):
                                R.launch_plan(bwd, rows, D, es, vec, H100_SMS)
                        else:
                            R.launch_plan(bwd, rows, D, es, vec, H100_SMS)
    for es in (4, 2):
        for rows in (3, 16384):
            R.launch_plan(False, rows, 16384, es, True, H100_SMS)


def test_plan_reads_the_cuda_sources_instances():
    """``INSTANCES`` is ``kInstances`` of ``csrc/rmsnorm.cu``, the entry
    points dispatch every J of ``J_CHOICES``, and the instances the main
    paths take (bf16 vectors, J 1 and 2) prefetch the next row."""
    src = (Path(R.__file__).parents[1] / "csrc" / "rmsnorm.cu").read_text()
    table = src[src.index("kInstances[] = {"):src.index("};", src.index("kInstances[] = {"))]
    rows = re.findall(r"\{(\d), (\d), (\d), (\d+), (\d+), (\d)\}", table)
    got = {(b == "1", int(e), v == "1", int(j)): (int(t), p == "1") for b, e, v, j, t, p in rows}
    assert got == R.INSTANCES
    for kind in ("fwd", "bwd"):
        cases = re.findall(rf"case (\d+): return {kind}_j", src)
        assert tuple(int(c) for c in cases) == R.J_CHOICES
    assert "kReduceCols = 16" in src and "S = kReduceThreads / CT" in src
    for bwd in (False, True):
        for j in (1, 2):
            threads, pf = R.INSTANCES[(bwd, 2, True, j)]
            assert pf and threads >= 512
