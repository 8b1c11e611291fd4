"""The bf16 SSD scan kernels' arithmetic (K5 on the tensor cores), learned
on the CPU before the card runs it.

``csrc/ssd_scan.cu``'s bf16 kernels feed the tensor cores bf16 operands
and sum in f32. x, B, C and dy are bf16 inputs, exact as operands. Every
operand that is f32 by nature is split into hi = bf16(v) and lo =
bf16(v - hi) and fed as two products, so it enters as hi + lo, within
2^-16 of v:
  forward:  M = (C B^T) * L * dt (against x), the state S_in (against C),
            w * x with w_j = exp(a_tot - a_cum_j) dt_j (against B);
  backward: S_in (against dy), G (against x and B), P1 = L dt (dy x^T)
            (against B and C), P2 = (C B^T) * L (against dy), e * dy with
            e_i = exp(a_cum_i) (against C);
and r_i = dy_i . y_i is formed as e_i C_i . (dy_i S_in) + sum_j S_ij P1_ij,
never from a re-formed y. A block takes one head; the backward writes
each head's share of dB and dC, and the reduction adds the heads of a
group in head order. ``_fwd`` and ``_bwd`` below repeat that arithmetic in PyTorch
(f32 products of the same operands) and are held, by the rule the card
holds the kernels to (``parity.ssd_within``, unchanged from the f32
kernels), to the plain versions and to the reference: ``ssd_chunked``,
``jax.vjp`` of it, and of ``ssd_recurrent`` where that gradient is NaN
(zamba2-1.2b's decay). Inputs are seeded numpy, rounded to bf16.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked, ssd_recurrent
from repro_torch.kernels import ssd_scan_bwd_plain
from repro_torch.kernels.parity import SSD_SHAPES, ssd_within
from repro_torch.kernels.ssd_scan import (
    MMA_DIMS, _check_mma, _decay, _per_head_chunks, _states_plain, _unlay, ssd_bwd_term_sums,
)

SMALL = [s for s in SSD_SHAPES if s[0] * s[1] <= 512]
BF = torch.bfloat16
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _hl(v, lo=True):
    """The operand the kernel's hi and lo products carry: bf16(v) plus
    bf16(v - bf16(v)); ``lo=False``: the hi part alone (one rounding)."""
    hi = v.to(BF).float()
    return hi + (v - hi).to(BF).float() if lo else hi


def _inputs(shape, seed, zamba):
    """bf16 x, B, C, dy and f32 dt, A, as the card's tests make them
    (``zamba``: A = -e, dt = softplus(N(0, 1)))."""
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32)).to(BF)
    if zamba:
        dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0).astype(np.float32)
        A = np.full((H,), -np.e, np.float32)
    else:
        dt = rng.uniform(0.01, 0.3, size=(B, S, H)).astype(np.float32)
        A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm, Cm, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(BF)
                  for s in ((B, S, G, N), (B, S, G, N), (B, S, H, P)))
    return x, torch.from_numpy(dt), torch.from_numpy(A), Bm, Cm, dy


def _fwd(x, dt, A, Bm, Cm, chunk, lo=True):
    """The bf16 forward kernel's arithmetic: (y (B, S, H, P) bf16, states
    (B, H, nc + 1, P, N) f32)."""
    xh, dth, Bh, Ch, a_cum = _per_head_chunks(x, dt, A, Bm, Cm, chunk)
    a_tot = a_cum[..., -1:]
    e = torch.exp(a_cum)[..., None]
    w = torch.exp(a_tot - a_cum) * dth
    M = _hl((Ch @ Bh.transpose(-1, -2)) * _decay(a_cum) * dth[..., None, :], lo)
    y_intra = M @ xh
    contrib = _hl(w[..., None] * xh, lo).transpose(-1, -2) @ Bh    # (B, nc, H, P, N)
    s = torch.zeros_like(contrib[:, 0])
    ys, states = [], [s]
    for c in range(xh.shape[1]):
        ys.append(e[:, c] * (Ch[:, c] @ _hl(s, lo).transpose(-1, -2)) + y_intra[:, c])
        s = torch.exp(a_tot[:, c])[..., None] * s + contrib[:, c]
        states.append(s)
    y = torch.stack(ys, dim=1)
    return _unlay(y, x.shape[1]).to(BF), torch.stack(states, dim=2)


def _bwd(x, dt, A, Bm, Cm, states, dy, chunk):
    """The bf16 backward kernels' arithmetic: (dx bf16, ddt f32, dA f32,
    dB bf16, dC bf16)."""
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xh, dth, Bh, Ch, a_cum, dyh = _per_head_chunks(x, dt, A, Bm, Cm, chunk, dy)
    nc = xh.shape[1]
    a_tot = a_cum[..., -1]
    e = torch.exp(a_cum)
    f = torch.exp(a_tot[..., None] - a_cum)
    L = _decay(a_cum)
    s_in = states[:, :, :-1].transpose(1, 2)
    s_out = states[:, :, 1:].transpose(1, 2)
    K = _hl(e[..., None] * dyh).transpose(-1, -2) @ Ch
    g = torch.zeros_like(K[:, 0])
    Gs = [None] * nc
    for c in range(nc - 1, -1, -1):
        Gs[c] = g
        g = torch.exp(a_tot[:, c])[..., None, None] * g + K[:, c]
    Gs = torch.stack(Gs, dim=1)
    Sm = Ch @ Bh.transpose(-1, -2)                                   # C_i . B_j
    P1 = L * dth[..., None, :] * (dyh @ xh.transpose(-1, -2))
    t = dyh @ _hl(s_in)
    r = e * (Ch * t).sum(-1) + (Sm * P1).sum(-1)
    dC = e[..., None] * t + _hl(P1) @ Bh
    dB = (f * dth)[..., None] * (xh @ _hl(Gs)) + _hl(P1).transpose(-1, -2) @ Ch
    du = f[..., None] * (Bh @ _hl(Gs).transpose(-1, -2)) + _hl(Sm * L).transpose(-1, -2) @ dyh
    dd = (xh * du).sum(-1)
    datot = (Gs * s_out).sum((-1, -2))
    dacum = r - dth * dd
    dacum[..., -1] += datot
    da = dacum.flip(-1).cumsum(-1).flip(-1)
    ddt = dd + A.float()[:, None] * da

    def grouped(t):
        """Per-head shares (B, S, H, N) summed over the heads of each group
        in head order."""
        heads = _unlay(t, S).reshape(Bsz, S, G, H // G, N)
        out = heads[:, :, :, 0]
        for k in range(1, heads.shape[3]):
            out = out + heads[:, :, :, k]
        return out.to(BF)

    return (_unlay(dth[..., None] * du, S).to(BF), _unlay(ddt, S),
            _unlay(da * dth, S).sum((0, 1)), grouped(dB), grouped(dC))


def _j(*ts):
    return [jnp.asarray(t.float().numpy()) for t in ts]


@pytest.mark.parametrize("zamba", [False, True])
@pytest.mark.parametrize("shape", SMALL)
def test_tc_forward_arithmetic_matches_plain_and_reference(shape, zamba):
    """y (bf16) and every chunk's state (f32) of the emulated kernel against
    the plain version and ``ssd_chunked`` on the same bf16-valued inputs,
    by ``ssd_within``."""
    chunk = shape[-1]
    x, dt, A, Bm, Cm, _ = _inputs(shape, 10 + zamba, zamba)
    y, states = _fwd(x, dt, A, Bm, Cm, chunk)
    ref_y, ref_states = _states_plain(x, dt, A, Bm, Cm, chunk)
    assert ssd_within(y, _unlay(ref_y, x.shape[1]).to(BF), BF)[1]
    assert ssd_within(states, ref_states, torch.float32)[1]
    jy, jstate = ssd_chunked(*_j(x, dt, A, Bm, Cm), chunk=chunk)
    assert ssd_within(y, torch.from_numpy(np.array(jy)), BF)[1]
    assert ssd_within(states[:, :, -1], torch.from_numpy(np.array(jstate)), torch.float32)[1]


@pytest.mark.parametrize("zamba", [False, True])
@pytest.mark.parametrize("shape", SMALL)
def test_tc_backward_arithmetic_matches_plain_and_reference(shape, zamba):
    """dx, ddt, dA, dB and dC of the emulated kernels against the plain
    backward and against
    ``jax.vjp`` of ``ssd_chunked`` (of ``ssd_recurrent`` at zamba2's decay,
    where the chunked gradient is NaN), by ``ssd_within`` with the plain
    version's term sums."""
    chunk = shape[-1]
    x, dt, A, Bm, Cm, dy = _inputs(shape, 20 + zamba, zamba)
    _, states = _states_plain(x, dt, A, Bm, Cm, chunk)
    refs = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    terms = (None,) + ssd_bwd_term_sums(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    fn = (lambda *a: ssd_recurrent(*a)[0]) if zamba else (
        lambda *a: ssd_chunked(*a, chunk=chunk)[0])
    _, vjp = jax.vjp(fn, *_j(x, dt, A, Bm, Cm))
    oracle = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dy.float().numpy()))]
    got = _bwd(x, dt, A, Bm, Cm, states, dy, chunk)
    for name, a, b, o, t in zip(NAMES, got, refs, oracle, terms):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        err, ok = ssd_within(a, b, a.dtype, t)
        assert ok, f"{name} vs plain: max |err| {err:.3e}"
        err, ok = ssd_within(a, o, a.dtype, t)
        assert ok, f"{name} vs reference: max |err| {err:.3e}"


@pytest.mark.parametrize("zamba", [False, True])
def test_one_rounding_of_the_f32_operands_fails_the_rule(zamba):
    """The lo parts are needed, and ``ssd_within`` sees their absence: with
    each f32 operand of the forward rounded once to bf16 (hi alone), the
    chunk states leave the f32 rule at the training-like chunk of 128,
    while the hi + lo form holds it."""
    shape = (2, 256, 4, 64, 2, 64, 128)
    x, dt, A, Bm, Cm, _ = _inputs(shape, 30 + zamba, zamba)
    _, ref_states = _states_plain(x, dt, A, Bm, Cm, 128)
    assert ssd_within(_fwd(x, dt, A, Bm, Cm, 128)[1], ref_states, torch.float32)[1]
    assert not ssd_within(_fwd(x, dt, A, Bm, Cm, 128, lo=False)[1], ref_states,
                          torch.float32)[1]


def test_heads_per_block_and_mma_shapes():
    """A block takes one head, so at zamba2-1.2b's one group of 64 heads
    the backward writes 64 shares of dB and dC a row, which the reduction
    adds in head order: that sum holds ``ssd_within`` against the plain
    backward. The bf16 kernels take P, N in ``MMA_DIMS`` and 16-byte
    aligned tiles."""
    shape = (1, 128, 64, 16, 1, 16, 64)
    chunk = shape[-1]
    x, dt, A, Bm, Cm, dy = _inputs(shape, 40, True)
    _, states = _states_plain(x, dt, A, Bm, Cm, chunk)
    refs = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    terms = ssd_bwd_term_sums(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    got = _bwd(x, dt, A, Bm, Cm, states, dy, chunk)
    for name, a, b, t in zip(NAMES[3:], got[3:], refs[3:], terms[2:]):
        err, ok = ssd_within(a, b, a.dtype, t)
        assert ok, f"{name} vs plain: max |err| {err:.3e}"
    t = torch.zeros(64, dtype=BF)
    for P in MMA_DIMS:
        for N in MMA_DIMS:
            _check_mma(P, N, t)
    with pytest.raises(ValueError, match="P and N"):
        _check_mma(128, 64, t)
    with pytest.raises(ValueError, match="P and N"):
        _check_mma(64, 8, t)
    with pytest.raises(ValueError, match="aligned"):
        _check_mma(64, 64, t[1:])
