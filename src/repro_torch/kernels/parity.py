"""How a kernel is held to its plain version on the card: the shapes and
tolerances that ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` share,
so the two cannot drift apart.

Each tolerance states why it is what it is. The kernels compute in f32
and sum in another order than their plain versions; in bf16 both round
once at the end, so an order difference may flip that rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["DECODE_BLOCK", "DECODE_SHAPES", "SHARED_DECODE_SHAPES", "shared_block_arena",
           "RMS_DECODE_SHAPES", "RMS_VERIFY_SHAPES", "RMS_CHUNK_SHAPES",
           "RMS_TRAIN_SHAPES", "FLASH_SHAPES", "SSD_SHAPES",
           "NEAR_ULPS", "BF16_UNIT", "within", "flash_within", "ssd_within", "dscale_bf16_slack",
           "k2_per_call"]

#: Flash decode (K3, K4) cases: H, Hkv, D, S, lengths (B = len(lengths)),
#: block; the paged form reads the same rows through a shuffled arena of
#: ``block``-row blocks (``DECODE_BLOCK`` but where a case says otherwise).
#: llama3.2-1b's serving geometry (32/8
#: heads, D 64, S 1024) and G = 3 (smollm) at lengths around a block
#: and near S; the old small cases (S 256, G 1 to 8, D 32 to 128); lengths
#: that land on the boundaries of 9 and of 16 splits (9 x k and 16 x k
#: granules of 16 rows, and one row either side; the plan gives 8 at Hkv 8,
#: S 1024 on 132 SMs); one row long enough for many splits (S 4096: 32); G = 8
#: at D 128; G = 3 at D 256, the widest head the kernels take; and
#: zamba2-1.2b's shared block (32 heads over 32 kv heads, G = 1, at D 128,
#: S 512, where the plan gives 4 splits): lengths of about one granule, of
#: fewer granules than splits and of as many, and either side of each
#: split boundary of a full row (128, 256, 384); and G = 8, the widest
#: group the kernels take, at D 128 at the serving shapes of qwen2.5-3b
#: (16 heads over 2, S 1024), of command-r-35b and chameleon-34b (64 over
#: 8, S 512) and of qwen3-moe-30b-a3b (32 over 4, S 512); and the reduced
#: configs that ``examples/serve_lm_torch.py`` and
#: ``examples/elastic_serving_torch.py`` serve in f32: smollm's 4 heads
#: over 2 at D 32 in a 48-row cache (4 slots, blocks of 16), zamba2's
#: shared block (4 over 4, D 64, 48 rows), and smollm's at 64 rows in
#: blocks of 8 (2 slots a replica; the offline oracle's B 1 is each row
#: alone); and a rank's shapes in llama3.2-1b's tensor-parallel decode on
#: two ranks (``chip_smoke.py`` phase 27 (e), lanes at [101, 510, 701,
#: 1001]): under ``sp_decode`` every q head over a rank's 512 of the 1,024
#: rows, rank 0's lengths and rank 1's (clamp(length - 512, 0, 512): two
#: lanes with no live row there), under ``no_sp_decode`` 16 q heads over 4
#: kv heads of the whole cache. A length of 0 is K4's empty row (zeros)
#: and K3's partial form's (zeros, lse -inf); K3's contract is length >=
#: 1, so it is held to plain on live rows only.
DECODE_BLOCK = 16
DECODE_SHAPES = [(*case, DECODE_BLOCK) for case in [
    (32, 8, 64, 1024, [1, 15, 16, 17]), (32, 8, 64, 1024, [1000, 1024, 500, 33]),
    (32, 8, 64, 1024, [0, 1, 15, 1000]), (9, 3, 64, 1024, [1, 15, 16, 17]),
    (9, 3, 64, 1024, [1000, 1024, 500, 33]), (9, 3, 64, 1024, [0, 1, 15, 1000]),
    (32, 8, 64, 256, [1, 15, 16, 17, 200, 256]), (9, 3, 64, 256, [1, 15, 16, 17, 200, 256]),
    (8, 1, 128, 256, [1, 15, 16, 17, 200, 256]), (4, 4, 32, 256, [1, 15, 16, 17, 200, 256]),
    (32, 8, 64, 1024, [144, 143, 145, 1008]), (32, 8, 64, 1024, [288, 1007, 1009, 9]),
    (32, 8, 64, 1024, [256, 255, 257, 1023]),
    (32, 8, 64, 4096, [4096]), (32, 8, 64, 4096, [4001]),
    (8, 1, 128, 1024, [0, 1, 513, 1024]), (6, 2, 256, 512, [0, 1, 300, 512]),
    (32, 32, 128, 512, [1, 15, 16, 17, 512]), (32, 32, 128, 512, [47, 48, 49, 64, 65, 0]),
    (32, 32, 128, 512, [127, 128, 129, 255, 256, 257, 383, 384, 385]),
    (16, 2, 128, 1024, [1, 15, 16, 17]), (16, 2, 128, 1024, [1000, 1024, 500, 33]),
    (64, 8, 128, 512, [0, 1, 47, 512]), (64, 8, 128, 512, [300, 129, 511, 256]),
    (32, 4, 128, 512, [1, 16, 200, 512]),
    (4, 2, 32, 48, [1, 16, 17, 41]), (4, 2, 32, 48, [0, 8, 33, 40]),
    (4, 4, 64, 48, [1, 16, 17, 41]),
    (32, 8, 64, 512, [101, 510, 512, 512]), (32, 8, 64, 512, [0, 0, 189, 489]),
    (16, 4, 64, 1024, [101, 510, 701, 1001]),
]] + [(4, 2, 32, 64, [9, 28], 8), (4, 2, 32, 64, [0, 8, 17, 63], 8)]

#: Paged flash decode (K4) over SHARED block tables, as prefix sharing
#: leaves them: H, Hkv, D, S, lengths, shared blocks. Rows 0 and 1 name
#: the same first ``shared`` blocks; row 2 names the first ``shared - 1``
#: and, in place of the last, a fork of it (a copy whose last row was
#: rewritten: the full-match re-feed); row 3 owns all of its blocks.
#: llama3.2-1b's serving geometry with a 512-token common prefix (32
#: blocks), and zamba2-1.2b's shared block with a 128-token one.
SHARED_DECODE_SHAPES = [
    (32, 8, 64, 1024, [576, 552, 530, 240], 32),
    (32, 32, 128, 512, [160, 140, 150, 77], 8),
]


def shared_block_arena(Hkv: int, D: int, S: int, lens, shared: int, gen: torch.Generator,
                       dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """K and V arenas of ``DECODE_BLOCK``-row blocks (random everywhere,
    the NULL block 0 included) and the (4, S / DECODE_BLOCK) int32 block
    tables of a ``SHARED_DECODE_SHAPES`` case, from ``gen`` (on the CPU)."""
    bs, T = DECODE_BLOCK, S // DECODE_BLOCK
    need = [-(-n // bs) for n in lens]
    tables = torch.zeros((len(lens), T), dtype=torch.int32)
    nxt = 1

    def own(row, first):
        nonlocal nxt
        for t in range(first, need[row]):
            tables[row, t] = nxt
            nxt += 1
    own(0, 0)
    tables[1, :shared] = tables[0, :shared]
    own(1, shared)
    tables[2, :shared - 1] = tables[0, :shared - 1]
    own(2, shared - 1)
    own(3, 0)
    k = torch.randn((nxt, bs, Hkv, D), generator=gen)
    v = torch.randn((nxt, bs, Hkv, D), generator=gen)
    src, fork = int(tables[0, shared - 1]), int(tables[2, shared - 1])
    for arena in (k, v):
        arena[fork, :bs - 1] = arena[src, :bs - 1]
    return k.to(device, dtype), v.to(device, dtype), tables.to(device)


#: RMSNorm (K2) forward at the rows of a decode step: one (the scanned
#: prefill of the recurrent stacks, an offline step) or four (a tick of
#: four lanes), at d_model 2048, at zamba2-1.2b's 4096-wide norms (its
#: gated Mamba2 norm and the shared block's two) and at chameleon-34b's
#: 8192; the qk-norm's rows of D 128, one a head (B, 1, heads, 128):
#: chameleon-34b's 64 query and 8 key heads, qwen3-moe-30b-a3b's 32 and
#: 4; deepseek-v3's d_model 7168 and its MLA q_norm (1536) and kv_norm
#: (512); and xlstm-125m's d_model 768 (the block norms and the sLSTM's)
#: and its mLSTM's inner norm (2 x 768 = 1536); and the reduced configs
#: that ``examples/serve_lm_torch.py`` and ``elastic_serving_torch.py``
#: serve (f32, d_model 128; zamba2's and xLSTM's inner norms of 256): a
#: tick of 1, 2 or 4 lanes, a 16-token prefill and a verify of 4 tokens.
RMS_DECODE_SHAPES = [(1, 1, 2048), (4, 1, 2048), (1, 1, 4096), (4, 1, 4096),
                     (1, 1, 8192), (4, 1, 8192),
                     (4, 1, 64, 128), (4, 1, 8, 128), (4, 1, 32, 128), (4, 1, 4, 128),
                     (1, 1, 7168), (4, 1, 7168), (1, 1, 1536), (4, 1, 1536),
                     (1, 1, 512), (4, 1, 512), (1, 1, 768), (4, 1, 768),
                     (1, 1, 128), (2, 1, 128), (4, 1, 128), (1, 16, 128), (4, 4, 128),
                     (1, 1, 256), (4, 1, 256)]

#: RMSNorm (K2) forward at a llama3.2-1b speculative verify's rows: 4
#: lanes of a window of 1 + gamma tokens, gamma 1 to 6 (8 to 28 rows of
#: D 2048).
RMS_VERIFY_SHAPES = [(4, 1 + gamma, 2048) for gamma in range(1, 7)]

#: RMSNorm (K2) forward at a 128-token prefill chunk of the wide models:
#: chameleon-34b's norms (D 8192) and its qk-norm (64 and 8 heads of 128),
#: qwen3-moe-30b-a3b's qk-norm (32 and 4 heads), and deepseek-v3's norms
#: (D 7168) and its MLA q_norm and kv_norm (1536, 512). xLSTM has no
#: chunk: it prefills one token a step.
RMS_CHUNK_SHAPES = [(1, 128, 8192), (1, 128, 64, 128), (1, 128, 8, 128),
                    (1, 128, 32, 128), (1, 128, 4, 128),
                    (1, 128, 7168), (1, 128, 1536), (1, 128, 512)]

#: RMSNorm (K2) forward and backward at the training rows of the MLA and
#: xLSTM loops (rows, D): deepseek-v3's 8 x 512 tokens, and 7 x 512 while
#: a worker of 8 is down, at d_model 7168, q_norm 1536 and kv_norm 512;
#: xlstm-125m's 32 x 512, and 21 x 512 of a beta stage, at d_model 768
#: and the mLSTM's inner 1536; and smollm-135m's 32 x 128 tokens at beta
#: 1 at d_model 576 (4.5 x 128: ``examples/train_lm_torch.py --preset
#: smollm``, f32); and ``examples/elastic_failover_torch.py``'s 32 x 64
#: tokens at d_model 64, and 28 x 64, the batch its loop runs most (f32).
RMS_TRAIN_SHAPES = [(4096, 7168), (3584, 7168), (4096, 1536), (3584, 1536), (4096, 512),
                    (3584, 512), (16384, 768), (10752, 768), (16384, 1536), (10752, 1536),
                    (4096, 576), (2048, 64), (1792, 64)]

#: Flash attention (K1) shapes: B, Sq, Skv, H, Hkv, D, Dv. The reference's
#: kernel-test shapes (tests/test_kernels.py), G = 3 (smollm), ragged and
#: Sq != Skv cases, D != Dv both ways, and llama3.2-1b's training shape at
#: 4 and at 32 rows (the training loop's largest batch, beta = 1),
#: zamba2-1.2b's shared attention block (MHA, D = 128) at 32 rows,
#: qwen2.5-3b's (16 heads over 2, G = 8, D 128) at 8 rows of 512, and
#: hubert-xlarge's D = Dv = 80: a reduced ragged case (Sq != Skv, neither
#: a multiple of a tile) and its training shape (MHA, 16 heads, 32 x 512
#: frames; the encoder runs it non-causal), and smollm-135m's training
#: shape (9 heads over 3, G = 3, D 64) at 32 rows of 128 tokens
#: (``examples/train_lm_torch.py --preset smollm``, f32), and
#: ``examples/elastic_failover_torch.py``'s (4 heads over 2, D 32, 64
#: tokens) at its largest batch, 32 rows; and llama3.2-1b's local shape
#: on a rank of a (1, 2) ("data", "model") mesh (16 of its 32 q heads
#: over 4 of its 8 kv heads, D 64) at the tensor-parallel step's 8 rows
#: of 512 (bf16) and at its f32 2-layer cut's 8 rows of 128.
FLASH_SHAPES = [
    (2, 128, 128, 4, 2, 64, 64), (1, 256, 256, 8, 8, 64, 64), (1, 200, 200, 4, 1, 64, 64),
    (2, 128, 128, 4, 2, 128, 128), (1, 64, 64, 2, 2, 32, 32), (1, 384, 384, 6, 3, 64, 64),
    (1, 384, 384, 9, 3, 64, 64), (2, 77, 100, 6, 2, 128, 64), (2, 130, 64, 4, 4, 32, 128),
    (4, 512, 512, 32, 8, 64, 64), (32, 512, 512, 32, 8, 64, 64),
    (32, 512, 512, 32, 32, 128, 128), (8, 512, 512, 16, 2, 128, 128),
    (2, 77, 100, 4, 4, 80, 80), (32, 512, 512, 16, 16, 80, 80),
    (32, 128, 128, 9, 3, 64, 64), (32, 64, 64, 4, 2, 32, 32),
    (8, 512, 512, 16, 4, 64, 64), (8, 128, 128, 16, 4, 64, 64),
]

#: SSD scan (K5) shapes: B, S, H, P, G, N, chunk. The reference's kernel-
#: test cases (tests/test_kernels.py: a ragged S 100, one group per head),
#: the reduced zamba2 the CPU tests run (B 4 x S 64, chunk 32), and
#: zamba2-1.2b's training shape at 32 rows (the loop's largest batch).
SSD_SHAPES = [
    (2, 64, 4, 32, 2, 16, 16), (1, 100, 2, 64, 1, 32, 32), (2, 256, 4, 64, 2, 64, 128),
    (1, 128, 8, 64, 8, 64, 64), (4, 64, 8, 32, 1, 16, 32), (32, 512, 64, 64, 1, 64, 128),
]

#: bf16 tolerance: 2e-2, plus one bf16 step of the reference value
#: (|ref| / 128), the size of one flipped final rounding.
BF16_ATOL, BF16_RTOL = 2e-2, 1.0 / 128


def within(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
           slack=0.0) -> Tuple[float, bool]:
    """(max |err|, ok) of a kernel's output against its plain version.

    f32: |err| <= 1e-4 * max(1, max |ref|) — the two sum the same f32
    products in other orders, over up to 512 terms.
    bf16: |err| <= 2e-2 + |ref| / 128 — both compute in f32 and round once
    to bf16, so an order difference can flip one rounding (one bf16 step
    of the value). ``slack`` (a tensor that broadcasts against ``ref``)
    adds what a stated earlier rounding may move the value by."""
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 * max(1.0, ref.float().abs().max().item())).all())
    else:
        ok = bool((err <= BF16_ATOL + ref.float().abs() * BF16_RTOL + slack).all())
    return err.max().item(), ok


#: bf16's unit roundoff: rounding a value to bf16 (8 significant bits)
#: moves it by at most 2^-8 of itself.
BF16_UNIT = 2.0 ** -8


def flash_within(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
                 terms: torch.Tensor) -> Tuple[float, bool]:
    """K1's rule: ``within``, and in bf16 a slack of ``BF16_UNIT * terms``.

    The bf16 kernels round P (forward, dV) and dS (dQ, dK) to bf16 before
    their second product, as FlashAttention does and the plain version
    does not; every term of that product moves by at most ``BF16_UNIT``
    of its size, so the output by at most ``BF16_UNIT`` times the sum of
    the terms' sizes (``terms``: ``flash_attention_rounding_terms``).
    Where scores are large, dS reaches tens and that bound exceeds
    ``within``'s bf16 rule. The f32 kernels form every product in 3xTF32,
    P and dS split as every other operand, so each product carries about
    2^-21 of its size: ``within``'s f32 rule alone."""
    if dtype == torch.float32:
        return within(out, ref, dtype)
    return within(out, ref, dtype, BF16_UNIT * terms.float())


#: Relative f32 rounding allowed on an output that sums terms across
#: positions or heads (the SSD backward's ddt and dA through a reverse
#: cumsum within each chunk, dA over every (b, s), dB and dC over the
#: H / G heads of a group), against the size of what the sum
#: was formed from (``ssd_scan.ssd_bwd_term_sums``): the kernel and the
#: plain version add the same f32 values in other orders, each carrying
#: a few ulps (2^-24 = 6e-8) of its own addends; 1e-6 is ~16 ulps. The
#: sum itself may be far smaller than its addends, so its largest value
#: bounds nothing.
SUM_RTOL = 1e-6


def ssd_within(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
               terms=None) -> Tuple[float, bool]:
    """``within``, plus ``SUM_RTOL`` of ``terms`` (the size each element
    was formed from, ``ssd_scan.ssd_bwd_term_sums``) for outputs summed across
    positions or heads. An SSD output that is no such sum (y, dx) passes
    ``terms=None`` and is held to ``within`` alone."""
    if terms is None:
        return within(out, ref, dtype)
    err = (out.float() - ref.float()).abs()
    extra = SUM_RTOL * terms.float()
    if dtype == torch.float32:
        tol = 1e-4 * max(1.0, ref.float().abs().max().item()) + extra
    else:
        tol = BF16_ATOL + ref.float().abs() * BF16_RTOL + extra
    return err.max().item(), bool((err <= tol).all())


#: The RMSNorm backward kernel's rsqrt lies a few f32 ulps from PyTorch's
#: (rsqrtf is within 2 ulps, and its f32 sum of squares runs in another
#: order): a normalized value within this many f32 ulps of a bf16 rounding
#: midpoint may round the other way in the kernel.
NEAR_ULPS = 32


def dscale_bf16_slack(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
                      near_ulps=None) -> Tuple[torch.Tensor, int]:
    """(per-column bound, elements counted): how far the RMSNorm backward's
    dscale = sum over rows of g * x^ can move through the bf16 rounding of
    the normalized row x^ = round(n), n = x * rsqrt(mean(x^2) + eps) in f32.

    ``near_ulps=None``: against a reference that does not round n (an f32
    gradient of the same bf16 inputs): every element moves by up to half a
    bf16 step, at most 2^-8 |g n|.

    ``near_ulps=m``: against a reference that rounds n too, from an rsqrt
    a few f32 ulps away (the kernel's own reduction order and rsqrtf): an
    element can round the other way only if its f32 n lies within m f32
    ulps of a bf16 rounding midpoint, and then moves by one bf16 step, at
    most 2^-7 |g n|. Only those elements are counted."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    gn = (g.float().reshape(-1, D) * n).abs()
    if near_ulps is None:
        return gn.sum(0) * 2.0 ** -8, n.numel()
    # bf16 keeps the high 16 bits of the f32 pattern; the rounding
    # midpoint of a binade step sits where the low 16 bits are 0x8000.
    low = n.view(torch.int32) & 0xFFFF
    near = (low - 0x8000).abs() <= near_ulps
    return (gn * near).sum(0) * 2.0 ** -7, int(near.sum().item())


def k2_per_call(cfg) -> int:
    """K2 launches of one serving call over a segment stack (a prefill
    chunk, a tick, a verify; a step of xLSTM's scanned prefill): each
    RMSNorm, and the final norm. A GQA block has one (parallel) or two and
    the qk-norm's two; an MLA block two and its q_norm and kv_norm; an
    xLSTM block its pre-norm and its mixer's inner norm. LayerNorm is plain
    PyTorch."""
    rms = cfg.norm == "rmsnorm"
    if cfg.family == "xlstm":
        per_layer = rms + 1
    elif cfg.mla is not None:
        per_layer = 2 * rms + 2
    else:
        per_layer = rms * (1 if cfg.parallel_block else 2) + 2 * cfg.qk_norm
    return cfg.n_layers * per_layer + rms
