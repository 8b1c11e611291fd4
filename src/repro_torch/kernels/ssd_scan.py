"""The Mamba2 SSD chunked scan: the hand-written CUDA kernels
(``csrc/ssd_scan.cu``), forward (K5) and backward, and their plain
PyTorch versions.

Port of the Pallas TPU kernel ``ssd_scan_fwd``
(``src/repro/kernels/ssd_scan/kernel.py``), the TPU twin of the reference
model's ``mamba2.ssd_chunked``. Inputs are pre-activated, as there:
x (B, S, H, P), dt (B, S, H) f32 (softplus'd, > 0), A (H,) f32 (< 0),
Bm and Cm (B, S, G, N) in x's dtype, head h reading group h // (H / G).
Per chunk of Q = min(chunk, S) positions, in f32, with
a_cum = cumsum(dt * A) and L_ij = exp(a_cum_i - a_cum_j) for i >= j:

    y_i = exp(a_cum_i) C_i S + sum_{j <= i} (C_i . B_j) L_ij dt_j x_j
    S  <- exp(a_total) S + sum_j exp(a_total - a_cum_j) dt_j x_j B_j^T

with the (P, N) state S carried across chunks from zero; y is in x's
dtype. S is padded to a multiple of Q with dt = 0, which is inert.

Every exponential is formed only where its argument is <= 0: ``L`` is
masked BEFORE the ``exp``. The reference's ``ssd_chunked`` takes
``where(causal, exp(seg), 0)``, whose gradient is 0 * inf = NaN once
``seg`` above the diagonal passes f32's exp limit (zamba2-1.2b's initial
decay does within one 128-chunk); the forward values agree.

``ssd_scan`` is an ``autograd.Function``: its forward is K5 (which also
writes each chunk's entry state, for the backward) and its backward
``ssd_scan_bwd``. The final state it returns carries no gradient. Each
wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors (or raises); ``ssd_scan.launches`` and
``ssd_scan_bwd.launches`` count kernel launches (the backward's two
launches count as one).

In bf16 the kernels run the in-chunk products on the tensor cores and
take P and N in ``MMA_DIMS`` (they raise on others). Each f32 operand of
those products is split into two bf16 parts (hi = bf16(v), lo =
bf16(v - hi)), so every term keeps 16 bits; ``parity.ssd_within`` holds
them as it holds the f32 kernels.

Meta tensors take a shape branch: the CUDA path's outputs (the forward's
per-chunk states, the backward's partial-sum scratch), no launch.
``ssd_scan_work`` and ``ssd_scan_bwd_work`` give one launch's (FLOPs,
bytes).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

import repro_torch.kernels as _kernels
from . import _build

__all__ = [
    "MAX_CHUNK",
    "MMA_DIMS",
    "ssd_scan",
    "ssd_scan_fwd",
    "ssd_scan_bwd",
    "ssd_scan_plain",
    "ssd_scan_bwd_plain",
    "ssd_bwd_term_sums",
    "ssd_scan_work",
    "ssd_scan_bwd_work",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Longest chunk the kernels take: a chunk's (Q, Q) decay matrix and its
#: x, B, C (and dy) tiles share one block's shared memory.
MAX_CHUNK = 128
#: P (head dim) and N (state dim) the bf16 tensor-core kernels take.
MMA_DIMS = (16, 32, 64)


def ssd_scan_work(Bsz: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
                  elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K5 forward launch: the four in-chunk products
    over each chunk's causal pairs (positions past S are not work), two
    flops a multiply-add; x, dt, A, B, C read and y written once (the
    states the kernel keeps for its backward are its own choice and not
    counted)."""
    Q = min(chunk, S)
    flops = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        pairs = q * (q + 1) // 2
        flops += 2 * (pairs * N + pairs * P + 2 * q * P * N)
    xb, dtb, bcb = Bsz * S * H * P * elem_bytes, Bsz * S * H * 4, 2 * Bsz * S * G * N * elem_bytes
    return flops * Bsz * H, 2 * xb + dtb + H * 4 + bcb


def ssd_scan_bwd_work(Bsz: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
                      elem_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K5 backward launch: twice the forward's
    products (each product's gradient is two of its size); the forward's
    inputs and dy read, dx, ddt, dA, dB, dC written."""
    flops, _ = ssd_scan_work(Bsz, S, H, P, G, N, chunk, elem_bytes)
    xb, dtb, bcb = Bsz * S * H * P * elem_bytes, Bsz * S * H * 4, 2 * Bsz * S * G * N * elem_bytes
    return 2 * flops, 3 * xb + 2 * dtb + 2 * H * 4 + 2 * bcb


def _per_head_chunks(x, dt, A, Bm, Cm, chunk, *more):
    """f32 per-chunk, per-head views, padded to whole chunks:
    x (B, nc, H, Q, P), dt (B, nc, H, Q), B/C (B, nc, H, Q, N) with each
    head's group repeated, a_cum (B, nc, H, Q), and ``more`` (each
    (B, S, H, P)) laid out like x."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    Q = min(chunk, S)
    nc = math.ceil(S / Q)
    pad = nc * Q - S

    def lay(t):                         # (B, S, H, ...) -> (B, nc, H, Q, ...)
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(Bsz, nc, Q, *t.shape[2:])
        return t.transpose(2, 3)

    xh, dth = lay(x), lay(dt)
    Bh = lay(Bm.repeat_interleave(H // G, dim=2))
    Ch = lay(Cm.repeat_interleave(H // G, dim=2))
    a_cum = torch.cumsum(dth * A.float()[:, None], dim=-1)
    return (xh, dth, Bh, Ch, a_cum, *(lay(t) for t in more))


def _decay(a_cum):
    """L (B, nc, H, Q, Q): exp(a_cum_i - a_cum_j) on i >= j, exactly 0
    above the diagonal (masked before the exp, so never inf)."""
    Q = a_cum.shape[-1]
    seg = a_cum[..., :, None] - a_cum[..., None, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=a_cum.device).tril()
    return torch.exp(seg.masked_fill(~causal, float("-inf")))


def _unlay(t, S):
    """(B, nc, H, Q, ...) -> (B, S, H, ...)."""
    t = t.transpose(2, 3)
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :S]


def _states_plain(x, dt, A, Bm, Cm, chunk):
    """(y f32 (B, nc, H, Q, P), states (B, H, nc + 1, P, N) f32): states[:, :, c]
    enters chunk c; states[:, :, nc] is the final state."""
    xh, dth, Bh, Ch, a_cum = _per_head_chunks(x, dt, A, Bm, Cm, chunk)
    a_tot = a_cum[..., -1]                                       # (B, nc, H)
    P2 = (Ch @ Bh.transpose(-1, -2)) * _decay(a_cum)             # (C_i . B_j) L_ij
    y = P2 @ (dth[..., None] * xh)
    w = torch.exp(a_tot[..., None] - a_cum) * dth                # (B, nc, H, Q)
    contrib = (w[..., None] * xh).transpose(-1, -2) @ Bh         # (B, nc, H, P, N)
    s = torch.zeros_like(contrib[:, 0])
    states = [s]
    for c in range(contrib.shape[1]):
        s = torch.exp(a_tot[:, c])[..., None, None] * s + contrib[:, c]
        states.append(s)
    states = torch.stack(states, dim=2)                          # (B, H, nc+1, P, N)
    s_in = states[:, :, :-1].transpose(1, 2)                     # (B, nc, H, P, N)
    y = y + torch.exp(a_cum)[..., None] * (Ch @ s_in.transpose(-1, -2))
    return y, states


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32): the
    reference's ``ssd_chunked`` with the decay masked before its exp."""
    y, states = _states_plain(x, dt, A, Bm, Cm, chunk)
    return _unlay(y, x.shape[1]).to(x.dtype), states[:, :, -1]


def _bwd_parts(x, dt, A, Bm, Cm, states, dy, chunk):
    """Per-position f32 gradient parts: dx, ddt (B, S, H, P) / (B, S, H),
    dA's terms da * dt (B, S, H), each head's share of dB and dC
    (B, S, H, N), before the sums over positions and heads, and the sizes
    of what ddt and dA's terms were formed from (B, S, H) each
    (``ssd_bwd_term_sums``).

    With u_j = dt_j x_j, P2_ij = (C_i . B_j) L_ij and G the gradient of
    the state leaving the chunk (scanned back from zero at the end):
      du_j  = sum_{i>=j} P2_ij dy_i + exp(a_tot - a_cum_j) G B_j,
      dC_i  = sum_{j<=i} P1_ij B_j + exp(a_cum_i) S_in^T dy_i,
      dB_j  = sum_{i>=j} P1_ij C_i + exp(a_tot - a_cum_j) dt_j G^T x_j,
    where P1_ij = L_ij dt_j (dy_i . x_j); and d a_cum_i collects
    dy_i . y_i (its row terms) - u_i . du_i (its column terms), plus
    <G, S_out> at the chunk's last row (a_total). Its reverse cumsum in
    the chunk is da; ddt = x . du + A da and dA = sum da dt."""
    S = x.shape[1]
    xh, dth, Bh, Ch, a_cum, dyh = _per_head_chunks(x, dt, A, Bm, Cm, chunk, dy)
    nc = xh.shape[1]
    a_tot = a_cum[..., -1]
    e = torch.exp(a_cum)
    f = torch.exp(a_tot[..., None] - a_cum)
    L = _decay(a_cum)
    s_in = states[:, :, :-1].transpose(1, 2)                     # (B, nc, H, P, N)
    s_out = states[:, :, 1:].transpose(1, 2)
    # Gradient of the state leaving each chunk, scanned back from the end.
    K = (e[..., None] * dyh).transpose(-1, -2) @ Ch              # (B, nc, H, P, N)
    g = torch.zeros_like(K[:, 0])
    Gs = [None] * nc
    for c in range(nc - 1, -1, -1):
        Gs[c] = g
        g = torch.exp(a_tot[:, c])[..., None, None] * g + K[:, c]
    Gs = torch.stack(Gs, dim=1)

    P2 = (Ch @ Bh.transpose(-1, -2)) * L
    u = dth[..., None] * xh
    y = P2 @ u + e[..., None] * (Ch @ s_in.transpose(-1, -2))
    du = P2.transpose(-1, -2) @ dyh + f[..., None] * (Bh @ Gs.transpose(-1, -2))
    ddt_direct = (xh * du).sum(-1)
    P1 = L * dth[..., None, :] * (dyh @ xh.transpose(-1, -2))
    dC = P1 @ Bh + e[..., None] * (dyh @ s_in)
    dB = P1.transpose(-1, -2) @ Ch + (f * dth)[..., None] * (xh @ Gs)
    r = (dyh * y).sum(-1)
    datot = (Gs * s_out).sum((-1, -2))
    dacum = r - dth * ddt_direct
    dacum[..., -1] += datot
    da = dacum.flip(-1).cumsum(-1).flip(-1)
    ddt = ddt_direct + A.float()[:, None] * da
    size = r.abs() + (dth * ddt_direct).abs()
    size[..., -1] += datot.abs()
    da_size = size.flip(-1).cumsum(-1).flip(-1)
    ddt_size = ddt_direct.abs() + A.float().abs()[:, None] * da_size
    return (_unlay(dth[..., None] * du, S), _unlay(ddt, S), _unlay(da * dth, S),
            _unlay(dB, S), _unlay(dC, S), _unlay(ddt_size, S), _unlay(da_size * dth, S))


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """(dx, ddt, dA, dB, dC) in the inputs' dtypes, for the output gradient
    ``dy`` of ``ssd_scan_plain`` (the final state's gradient taken as
    zero), from the forward's ``states`` (B, H, nc + 1, P, N): the
    backward kernel's arithmetic step by step, in f32. dA sums its terms
    over every (b, s), dB and dC over the H / G heads of each group."""
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dx, ddt, dA_terms, dB, dC, _, _ = _bwd_parts(x, dt, A, Bm, Cm, states, dy, chunk)
    group = lambda t: t.reshape(Bsz, S, G, H // G, N).sum(3).to(Bm.dtype)  # noqa: E731
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA_terms.sum((0, 1)).to(A.dtype),
            group(dB), group(dC))


def ssd_bwd_term_sums(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """(size of ddt (B, S, H), of dA (H,), of dB and of dC (B, S, G, N)):
    the magnitudes the backward's long sums are formed from, which bound
    their f32 rounding (``parity.ssd_within``). dB and dC: the sum of
    |each head's share|. ddt_j = x_j . du_j + A da_j and dA = sum_j da_j
    dt_j: da_j = sum_{i>=j} d a_cum_i, whose addends nearly cancel (a
    uniform shift of a chunk's a_cum moves only exp(a_cum_i) and
    exp(a_total)), so da_j may lie far below them; its size is the sum of
    theirs."""
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _, _, _, dB, dC, ddt_size, dA_size = _bwd_parts(x, dt, A, Bm, Cm, states, dy, chunk)
    group = lambda t: t.abs().reshape(Bsz, S, G, H // G, N).sum(3)  # noqa: E731
    return ddt_size, dA_size.sum((0, 1)), group(dB), group(dC)


def _check(x, dt, A, Bm, Cm, chunk, *more) -> Tuple[int, ...]:
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one dtype, not "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes f32 dt and A, not {dt.dtype}/{A.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan takes x (B, S, H, P), dt (B, S, H), A (H,), "
                         "B/C (B, S, G, N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape[:2] != (Bsz, S)
            or Cm.shape != Bm.shape or G < 1 or H % G or S < 1 or chunk < 1):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
                         f"chunk {chunk}")
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise ValueError(f"the ssd_scan kernels take chunks of at most {MAX_CHUNK}, not {Q}")
    for t in (dt, A, Bm, Cm, *more):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")
    for t in (x, dt, A, Bm, Cm, *more):
        if not t.is_contiguous():
            raise ValueError("ssd_scan needs contiguous inputs")
    return Bsz, S, H, P, G, N, Q


def _check_mma(P: int, N: int, *ts: torch.Tensor) -> None:
    """The bf16 kernels' extra terms: P and N in ``MMA_DIMS``, and 16-byte
    aligned tiles (16-byte cp.async)."""
    if P not in MMA_DIMS or N not in MMA_DIMS:
        raise ValueError(f"the bf16 ssd_scan kernels take P and N in {MMA_DIMS}, "
                         f"not P {P}, N {N}")
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the bf16 ssd_scan kernels need 16-byte aligned inputs")


def ssd_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 forward: (y (B, S, H, P) in x's dtype, states (B, H, nc + 1, P, N)
    f32, the state entering each chunk and, last, the final state)."""
    if x.device.type == "cpu":
        y, states = _states_plain(x, dt, A, Bm, Cm, chunk)
        return _unlay(y, x.shape[1]).to(x.dtype), states
    if x.device.type == "meta":
        Bsz, S, H, P, G, N, Q = _check(x, dt, A, Bm, Cm, chunk)
        if x.dtype == torch.bfloat16:
            _check_mma(P, N)
        y = torch.empty_like(x)
        states = torch.empty((Bsz, H, math.ceil(S / Q) + 1, P, N), dtype=torch.float32,
                             device=x.device)
        _kernels.report_work("ssd_scan", ssd_scan_work(Bsz, S, H, P, G, N, chunk, x.element_size()))
        return y, states
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    Bsz, S, H, P, G, N, Q = _check(x, dt, A, Bm, Cm, chunk)
    if x.dtype == torch.bfloat16:
        _check_mma(P, N, x, Bm, Cm)
    nc = math.ceil(S / Q)
    y = torch.empty_like(x)
    states = torch.empty((Bsz, H, nc + 1, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    rc = lib.repro_ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), states.data_ptr(), Bsz, S, H, P, G, N, Q, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    ssd_scan.launches += 1
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("ssd_scan", *ssd_scan_work(Bsz, S, H, P, G, N, chunk,
                                                      x.element_size()))
    return y, states


def ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, *, chunk: int):
    """K5 backward: (dx, ddt, dA, dB, dC) in the inputs' dtypes, from the
    forward's ``states`` and the output gradient ``dy``."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy, chunk=chunk)
    if x.device.type == "meta":
        Bsz, S, H, P, G, N, Q = _check(x, dt, A, Bm, Cm, chunk, states, dy)
        if x.dtype == torch.bfloat16:
            _check_mma(P, N)
        dx, ddt = torch.empty_like(x), torch.empty_like(dt)
        dB, dC, dA = torch.empty_like(Bm), torch.empty_like(Cm), torch.empty_like(A)
        # The CUDA path's scratch: dB's and dC's per-head shares, dA's.
        scratch = [torch.empty((Bsz, S, H, N), dtype=torch.float32, device=x.device),  # noqa: F841
                   torch.empty((Bsz, S, H, N), dtype=torch.float32, device=x.device),
                   torch.empty((Bsz, H), dtype=torch.float32, device=x.device)]
        _kernels.report_work("ssd_scan_bwd", ssd_scan_bwd_work(
            Bsz, S, H, P, G, N, chunk, x.element_size()))
        return dx, ddt, dA, dB, dC
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cpu or cuda, not {x.device}")
    Bsz, S, H, P, G, N, Q = _check(x, dt, A, Bm, Cm, chunk, states, dy)
    nc = math.ceil(S / Q)
    if (states.shape != (Bsz, H, nc + 1, P, N) or states.dtype != torch.float32
            or dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"states {tuple(states.shape)} {states.dtype}, dy {tuple(dy.shape)} "
                         f"{dy.dtype} do not match x {tuple(x.shape)} {x.dtype}")
    if x.dtype == torch.bfloat16:
        _check_mma(P, N, x, Bm, Cm, states, dy)
    dev = x.device
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC, dA = torch.empty_like(Bm), torch.empty_like(Cm), torch.empty_like(A)
    # Each head's share of dB and dC and each (b, h)'s share of dA, summed
    # in a fixed order by the second launch: no atomics.
    dB_part = torch.empty((Bsz, S, H, N), dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((Bsz, H), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    rc = lib.repro_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        states.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        Bsz, S, H, P, G, N, Q, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    ssd_scan_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed (code {rc})")
    if _kernels.work_hook is not None:
        _kernels.work_hook("ssd_scan_bwd", *ssd_scan_bwd_work(Bsz, S, H, P, G, N, chunk,
                                                              x.element_size()))
    return dx, ddt, dA, dB, dC


class SSDScanFn(torch.autograd.Function):
    """K5 forward, with the K5 backward as its gradient. Saves the inputs
    and the per-chunk states (B, H, nc + 1, P, N) f32; under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass and saves them anew."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, states = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        final = states[:, :, -1]
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, _dfinal):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (y (B, S, H, P), final state (B, H, P, N) f32), y differentiable
    in x, dt, A, B and C."""
    return SSDScanFn.apply(x, dt, A, Bm, Cm, chunk)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
