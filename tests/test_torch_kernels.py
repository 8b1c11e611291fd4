"""The port's kernel modules against the reference's Pallas kernels and
their jnp oracles, on the CPU.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions (the functions the CUDA kernels are checked
against on the card, in tests/test_torch_gpu.py and chip_smoke.py) to
the Pallas kernels run in interpret mode and to their ``ref.py``
oracles. Inputs come from one seeded numpy generator and go to both
frameworks. Tolerance: 2e-5 in f32 (the two frameworks sum in different
orders); bf16 RMSNorm is held to one bf16 rounding step.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_ref,
    flash_decode,
    paged_decode_ref,
    paged_flash_decode,
)
from repro.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    rms_norm,
    rms_norm_plain,
)

RNG = np.random.default_rng(7)


def _np(shape):
    return RNG.normal(size=shape).astype(np.float32)


def _both(a, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K2: rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64, 128), (2, 100, 576), (1, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_ref_and_pallas(shape, dtype):
    xj, xt = _both(_np(shape), dtype)
    sj, st = _both(_np(shape[-1:]), dtype)
    out = rms_norm_plain(xt, st)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    ref = _f32(rmsnorm_ref(xj, sj))
    pallas = _f32(rmsnorm(xj, sj, interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), ref, atol=2e-5)
        np.testing.assert_allclose(_f32(out), pallas, atol=2e-5)
    else:
        # Same rounding order as the oracle: at most one bf16 step apart.
        np.testing.assert_allclose(_f32(out), ref, atol=2e-2, rtol=1 / 128)
        # The Pallas kernel scales before its single cast (the tolerance
        # tests/test_kernels.py allows for that ordering).
        np.testing.assert_allclose(_f32(out), pallas, atol=1e-1)
    # On the CPU the wrapper is the plain version.
    assert torch.equal(rms_norm(xt, st), out)


# ---------------------------------------------------------------------------
# K3: contiguous flash decode
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, S, H, Hkv, D, block_kv
    (2, 256, 8, 2, 64, 64),
    (1, 320, 4, 4, 128, 64),    # non-power-of-two block count
    (3, 1024, 8, 1, 64, 512),   # MQA
    (2, 96, 9, 3, 64, 32),      # G = 3 (smollm's grouping)
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_ref_and_pallas(case):
    B, S, H, Hkv, D, block = case
    qj, qt = _both(_np((B, H, D)), "float32")
    kj, kt = _both(_np((B, S, Hkv, D)), "float32")
    vj, vt = _both(_np((B, S, Hkv, D)), "float32")
    lengths = RNG.integers(1, S + 1, size=(B,)).astype(np.int32)
    out = decode_attention_plain(qt, kt, vt, torch.from_numpy(lengths))
    ref = decode_ref(qj, kj, vj, jnp.asarray(lengths))
    pallas = flash_decode(qj, kj, vj, jnp.asarray(lengths), block_kv=block,
                          interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=2e-5)
    assert torch.equal(decode_attention(qt, kt, vt, torch.from_numpy(lengths)), out)


def test_decode_attention_plain_bf16_scales_in_q_dtype():
    """``q * scale`` rounds in q's dtype before the f32 cast, as the
    reference model's decode does (head_dim 128: the scale is inexact)."""
    B, S, H, Hkv, D = 2, 64, 4, 2, 128
    qj, qt = _both(_np((B, H, D)), "bfloat16")
    kj, kt = _both(_np((B, S, Hkv, D)), "bfloat16")
    vj, vt = _both(_np((B, S, Hkv, D)), "bfloat16")
    lengths = np.array([5, 64], np.int32)
    out = decode_attention_plain(qt, kt, vt, torch.from_numpy(lengths))
    ref = decode_ref(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2)


def test_decode_attention_length_masking_exact():
    """Entries beyond `lengths` must have zero influence."""
    B, S, H, Hkv, D = 1, 128, 4, 2, 32
    q, k, v = (torch.from_numpy(_np(s)) for s in
               ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    L = torch.tensor([50], dtype=torch.int32)
    out1 = decode_attention_plain(q, k, v, L)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] = 99.0
    v2[:, 50:] = -99.0
    out2 = decode_attention_plain(q, k2, v2, L)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K4: paged flash decode
# ---------------------------------------------------------------------------

def _scatter_to_arena(k, v, lengths, block_size, seed=0):
    """Scatter contiguous (B, S, ...) numpy caches into a shuffled block
    arena with garbage everywhere a live block is not (the NULL sink block
    0 and all unreferenced rows), returning (k_arena, v_arena, tables)."""
    rng = np.random.default_rng(seed)
    B, S = k.shape[:2]
    T = S // block_size
    ids = rng.permutation(B * T) + 1          # blocks shuffled, 0 = sink
    k_arena = rng.normal(size=(B * T + 1, block_size, *k.shape[2:])).astype(np.float32)
    v_arena = rng.normal(size=(B * T + 1, block_size, *v.shape[2:])).astype(np.float32)
    tables = np.zeros((B, T), np.int32)
    nxt = 0
    for b in range(B):
        n_live = -(-int(lengths[b]) // block_size)
        for t in range(n_live):
            bid = int(ids[nxt])
            nxt += 1
            tables[b, t] = bid
            k_arena[bid] = k[b, t * block_size:(t + 1) * block_size]
            v_arena[bid] = v[b, t * block_size:(t + 1) * block_size]
    return k_arena, v_arena, tables


PAGED_CASES = [
    # S, H, Hkv, D, block_size
    (64, 8, 2, 64, 16),    # GQA, small blocks
    (128, 8, 1, 64, 32),   # MQA
    (64, 8, 8, 32, 64),    # MHA, one block per sequence
    (64, 6, 2, 32, 16),    # G = 3
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_attention_plain_matches_oracles(case):
    """Plain paged decode vs the jnp paged oracle vs the Pallas kernel
    across the boundary lengths {0, 1, bs-1, bs, bs+1, max} in one ragged
    batch, over an arena that is garbage wherever no live block is."""
    S, H, Hkv, D, bs = case
    B = 6
    lengths = np.array([0, 1, bs - 1, bs, min(bs + 1, S), S], np.int32)
    q, k, v = _np((B, H, D)), _np((B, S, Hkv, D)), _np((B, S, Hkv, D))
    k_ar, v_ar, tables = _scatter_to_arena(k, v, lengths, bs)
    args_j = [jnp.asarray(a) for a in (q, k_ar, v_ar, tables, lengths)]
    args_t = [torch.from_numpy(a) for a in (q, k_ar, v_ar, tables, lengths)]
    out = paged_decode_attention_plain(*args_t)
    ref = paged_decode_ref(*args_j)
    pallas = paged_flash_decode(*args_j, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=2e-5)
    assert (out[0] == 0).all(), "a length-0 row must be exact zeros"
    assert torch.equal(paged_decode_attention(*args_t), out)
    # The paged view equals the contiguous decode on live rows, bit for bit.
    contig = decode_attention_plain(args_t[0], torch.from_numpy(k),
                                    torch.from_numpy(v), args_t[4])
    assert torch.equal(out[1:], contig[1:])


def test_paged_decode_attention_ragged_gqa_sweep():
    """Random ragged lengths x GQA group sizes (G in {1, 4, 8})."""
    S, D, bs, B = 96, 32, 16, 4
    for Hkv in (8, 2, 1):
        H = 8
        lengths = RNG.integers(1, S + 1, size=(B,)).astype(np.int32)
        q, k, v = _np((B, H, D)), _np((B, S, Hkv, D)), _np((B, S, Hkv, D))
        k_ar, v_ar, tables = _scatter_to_arena(k, v, lengths, bs, seed=Hkv)
        out = paged_decode_attention_plain(
            *(torch.from_numpy(a) for a in (q, k_ar, v_ar, tables, lengths)))
        ref = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lengths))
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5,
                                   err_msg=f"Hkv={Hkv}")


# ---------------------------------------------------------------------------
# Dispatch: no silent fallback off the CPU
# ---------------------------------------------------------------------------

class _OtherDevice:
    """Stands in for a tensor on a device the wrappers do not take (a
    CPU-only PyTorch can place no real tensor there)."""

    device = torch.device("xpu")
    requires_grad = False


def test_wrappers_refuse_devices_other_than_cpu_and_cuda(monkeypatch):
    """Only a CPU tensor reaches a plain version; a CUDA tensor launches the
    kernel, a meta tensor takes the shape branch (the dry run's: outputs,
    no launch, no plain version), and any other device raises."""
    import importlib

    # The package's ``decode_attention`` attribute is the wrapper, not the module.
    kd = importlib.import_module("repro_torch.kernels.decode_attention")
    kr = importlib.import_module("repro_torch.kernels.rmsnorm")

    def never(*a, **k):
        raise AssertionError("a meta tensor reached a plain version")

    for mod, name in ((kr, "rms_norm_plain"), (kd, "decode_attention_plain"),
                      (kd, "paged_decode_attention_plain")):
        monkeypatch.setattr(mod, name, never)
    x = torch.empty((2, 8), device="meta")
    assert rms_norm(x, torch.empty(8, device="meta")).shape == (2, 8)
    q = torch.empty((1, 4, 8), device="meta")
    kv = torch.empty((1, 16, 2, 8), device="meta")
    lengths = torch.empty(1, dtype=torch.int32, device="meta")
    assert decode_attention(q, kv, kv, lengths).shape == (1, 4, 8)
    assert paged_decode_attention(q, kv, kv, torch.empty((1, 1), dtype=torch.int32,
                                                          device="meta"), lengths).device == q.device
    assert rms_norm.launches == decode_attention.launches == paged_decode_attention.launches == 0
    other = _OtherDevice()
    with pytest.raises(ValueError, match="cpu or cuda"):
        rms_norm(other, other)
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_attention(other, other, other, other)
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attention(other, other, other, other, other)
