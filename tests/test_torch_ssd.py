"""The port's SSD scan (K5) against the reference, on the CPU: the plain
forward against the Pallas kernel in interpret mode and ``ssd_chunked``,
the plain backward against ``jax.vjp`` of ``ssd_chunked`` where that is
finite and of ``ssd_recurrent`` where it is not, and the autograd wiring.

Inputs are seeded numpy, handed to both frameworks; everything is f32.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models.mamba2 import ssd_chunked, ssd_recurrent
from repro_torch.kernels import (
    ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_fwd, ssd_scan_plain,
)
from repro_torch.kernels.parity import SSD_SHAPES, ssd_within
from repro_torch.kernels.ssd_scan import MAX_CHUNK, _bwd_parts, _check, ssd_bwd_term_sums

#: Every shape of ``SSD_SHAPES`` but the 32-row training shape (the CPU's
#: share of the card's cases).
SMALL = [s for s in SSD_SHAPES if s[0] * s[1] <= 512]
NAMES = ("x", "dt", "A", "B", "C")


def _inputs(shape, seed, zamba=False):
    """x, dt, A, B, C, dy as f32 numpy. ``zamba``: zamba2-1.2b's initial
    decay, A = -e (a_log = 1) and dt = softplus(N(0, 1)); otherwise the
    reference kernel test's dt ~ U(0.01, 0.3), A ~ -U(0.5, 2)."""
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    if zamba:
        dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0).astype(np.float32)
        A = np.full((H,), -np.e, np.float32)
    else:
        dt = rng.uniform(0.01, 0.3, size=(B, S, H)).astype(np.float32)
        A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, dy


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", SMALL)
def test_plain_forward_matches_pallas_kernel_and_ssd_chunked(shape):
    """y against the Pallas kernel (interpret mode) and ``ssd_chunked``,
    the final state against ``ssd_chunked``'s, at the reference kernel
    test's atol 5e-4 (f32 sums in other orders)."""
    chunk = shape[-1]
    x, dt, A, Bm, Cm, _ = _inputs(shape, 0)
    y, state = ssd_scan_plain(*_t((x, dt, A, Bm, Cm)), chunk=chunk)
    ref_y, ref_state = ssd_chunked(*_j((x, dt, A, Bm, Cm)), chunk=chunk)
    pallas_y = pallas_ssd_scan(*_j((x, dt, A, Bm, Cm)), chunk=chunk, interpret=True)
    assert y.shape == x.shape and state.shape == (shape[0], shape[2], shape[3], shape[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas_y), atol=5e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=5e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), atol=5e-4)


def test_chunk_invariance():
    """The chunking is an evaluation order, not a model: chunks of 16, 32,
    64 and 96 (ragged) give the same y and final state."""
    x, dt, A, Bm, Cm, _ = _inputs((2, 192, 4, 32, 2, 16, 0), 1)
    outs = [ssd_scan_plain(*_t((x, dt, A, Bm, Cm)), chunk=c) for c in (16, 32, 64, 96)]
    for y, s in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(), atol=5e-4)
        np.testing.assert_allclose(s.numpy(), outs[0][1].numpy(), atol=5e-4)


@pytest.mark.parametrize("shape", SMALL)
def test_plain_backward_matches_vjp_of_ssd_chunked(shape):
    """dx, ddt, dA, dB, dC against ``jax.vjp`` of ``ssd_chunked`` (finite
    at these decays) at 2e-5 of each gradient's largest value (f32, sums
    in other orders; dA sums over every position). The cases cover G < H
    (dB and dC summed over the heads of a group) and G = H."""
    chunk = shape[-1]
    x, dt, A, Bm, Cm, dy = _inputs(shape, 2)
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk)[0], *_j((x, dt, A, Bm, Cm)))
    ref = vjp(jnp.asarray(dy))
    t = _t((x, dt, A, Bm, Cm))
    _, states = ssd_scan_fwd(*t, chunk=chunk)
    got = ssd_scan_bwd_plain(*t, states, torch.from_numpy(dy), chunk=chunk)
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [32, 128])
def test_backward_at_zamba2_decay_is_finite_where_the_reference_is_not(chunk):
    """At zamba2-1.2b's initial decay the reference's ``ssd_chunked``
    gradient is non-finite (its exp above the diagonal overflows before
    the mask), while the port's is finite and equals ``jax.vjp`` of the
    step-by-step ``ssd_recurrent`` (decay <= 1: finite everywhere), at
    1e-4 of each gradient's largest value: the chunked form takes each
    decay exp(a_cum_i - a_cum_j) as the difference of two running sums
    that reach a_total ~ -300 over a 128-chunk here, whose f32 rounding
    (~300 * 2^-24 = 2e-5 absolute) is a relative error of the decay; the
    recurrence forms each step's decay directly (dA, a sum over 256
    positions of such terms, differs by up to 7e-5 of its largest)."""
    shape = (1, 256, 4, 32, 1, 16, chunk)
    x, dt, A, Bm, Cm, dy = _inputs(shape, 3, zamba=True)
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk)[0], *_j((x, dt, A, Bm, Cm)))
    chunked = vjp(jnp.asarray(dy))
    assert not all(np.isfinite(np.asarray(g)).all() for g in chunked)
    _, vjp = jax.vjp(lambda *a: ssd_recurrent(*a)[0], *_j((x, dt, A, Bm, Cm)))
    oracle = vjp(jnp.asarray(dy))
    t = _t((x, dt, A, Bm, Cm))
    y, states = ssd_scan_fwd(*t, chunk=chunk)
    ref_y, _ = ssd_recurrent(*_j((x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=5e-4)
    got = ssd_scan_bwd_plain(*t, states, torch.from_numpy(dy), chunk=chunk)
    for name, a, b in zip(NAMES, got, oracle):
        b = np.asarray(b)
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def test_autograd_function_runs_the_plain_backward_on_the_cpu():
    """``ssd_scan``'s gradient is ``ssd_scan_bwd`` (its plain version for
    CPU tensors, which launches nothing); the final state carries no
    gradient and equals the plain version's."""
    shape = (2, 64, 4, 32, 2, 16, 16)
    x, dt, A, Bm, Cm, dy = _inputs(shape, 4)
    leaves = [t.requires_grad_(True) for t in _t((x, dt, A, Bm, Cm))]
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, state = ssd_scan(*leaves, chunk=16)
    assert not state.requires_grad
    y.backward(torch.from_numpy(dy))
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == before
    t = _t((x, dt, A, Bm, Cm))
    ref_y, ref_state = ssd_scan_plain(*t, chunk=16)
    assert torch.equal(y.detach(), ref_y) and torch.equal(state, ref_state)
    _, states = ssd_scan_fwd(*t, chunk=16)
    for leaf, g in zip(leaves, ssd_scan_bwd_plain(*t, states, torch.from_numpy(dy), chunk=16)):
        assert torch.equal(leaf.grad, g)


def test_sum_tolerance_rejects_a_dropped_head():
    """``ssd_within``'s allowance for dB and dC (a fraction of the sum of
    their heads' |shares|) has teeth: dB less one head's share fails it, in f32 and
    bf16, while dB itself passes."""
    shape = (2, 64, 4, 32, 1, 16, 16)
    x, dt, A, Bm, Cm, dy = _inputs(shape, 5)
    t = _t((x, dt, A, Bm, Cm))
    _, states = ssd_scan_fwd(*t, chunk=16)
    dyt = torch.from_numpy(dy)
    _, _, _, dB, _ = ssd_scan_bwd_plain(*t, states, dyt, chunk=16)
    _, _, dB_terms, _ = ssd_bwd_term_sums(*t, states, dyt, chunk=16)
    head0 = _bwd_parts(*t, states, dyt, 16)[3][:, :, :1]          # (B, S, 1, N)
    for dtype in (torch.float32, torch.bfloat16):
        assert ssd_within(dB.to(dtype), dB, dtype, dB_terms)[1]
        assert not ssd_within((dB - head0).to(dtype), dB, dtype, dB_terms)[1]


def test_wrappers_check_their_inputs():
    x, dt, A, Bm, Cm, _ = _t(_inputs((1, 300, 2, 16, 1, 16, 0), 6))
    with pytest.raises(ValueError, match="at most"):
        _check(x, dt, A, Bm, Cm, MAX_CHUNK + 1)
    with pytest.raises(TypeError, match="f32 dt"):
        _check(x, dt.double(), A, Bm, Cm, 64)
    with pytest.raises(ValueError, match="contiguous"):
        _check(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, 64)
    assert _check(x, dt, A, Bm, Cm, 64) == (1, 300, 2, 16, 1, 16, 64)
