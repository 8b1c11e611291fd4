#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 or another sm_90a part) and ``nvcc``. It
runs, in order, and exits non-zero at the first phase that fails:

1. prints the card (name, power limit), the torch and CUDA versions, and
   turns TF32 off for float32 matrix products and convolutions;
2. builds the port's CUDA kernels from ``src/repro_torch/csrc``, prints
   ptxas's registers and spills, and shows that K1's bf16 kernels on the
   main paths (forward, dQ and dK/dV at D 64, D 128 and D 80) and every
   instance of K5's bf16 kernels (the SSD scan's forward and backward)
   hold tensor-core instructions (HMMA in ``cuobjdump -sass``) and spill
   nothing, and that no instance of K3's and K4's split and merge kernels
   and of K2's forward, backward and dscale-sum kernels spills;
3. holds every kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in f32 and bf16: K2 at a decode step's 1
   and 4 rows at D 2048, 4096 and 8192 and at the qk-norm's rows of D 128
   (``parity.RMS_DECODE_SHAPES``), a llama verify's 8 to 28 rows
   (``parity.RMS_VERIFY_SHAPES``), a 128-token chunk of the wide models
   (``parity.RMS_CHUNK_SHAPES``; all three printing each one's launch
   plan) and a prefill chunk's 256, each a second launch
   bit for bit; K3 and K4 (split-KV flash
   decode) at ``parity.DECODE_SHAPES`` (zamba2's G = 1, D 128 and the
   wide models' G = 8, D 128 among them),
   each bit for bit equal to the
   other on identical rows, to a second launch of itself, and, row by row,
   to a launch of that row alone (the split plan reads no batch size);
   and K4 over the block tables prefix sharing leaves
   (``parity.SHARED_DECODE_SHAPES``: two rows naming the same first
   blocks, a third naming a fork of one of them), held the same way;
4. serves llama3.2-1b at full width in bf16 (random weights from a seed)
   through ``ServeEngine`` — 8 requests, 4 slots, chunked prefill — once
   over the contiguous pool and once over the paged pool, checks every
   position of every stream against ``generate_offline`` fed the same
   stream, and checks from the kernels' launch counters that the whole
   path ran through them;
5. times each kernel (CUDA events, cold L2, median of 60 launches)
   beside its plain version, one library call and its bound (K2 at the
   decode tick's and a prefill chunk's rows), K3 and K4 also at two
   long-context shapes (``LONG_DECODE``), the launch floor (``t.add_(0)``
   on a one-element tensor under the same timer), and reports decode
   tokens/s of each pool;
6. profiles decode ticks and prefill chunks with ``torch.profiler`` —
   host wall time, device time, the device's idle share, launches, and
   device time by kernel class;
7. holds the training kernels against their plain versions on the card:
   flash attention forward and backward (K1) over the reference's
   kernel-test shapes and the training shapes (``parity.FLASH_SHAPES``:
   llama3.2-1b's, zamba2's shared block's, qwen2.5-3b's, hubert-xlarge's
   at D 80 and a reduced ragged D 80 case), causal and not, in f32
   and bf16, plus the training shape with q and k scaled by 4 (scores
   near 100), and the RMSNorm forward and backward (K2) at the training
   rows of both models' widths (D 2048 and 4096), each a second launch
   bit for bit;
8. takes one train step of llama3.2-1b at full width, cut to 2 layers,
   in f32, through the kernels on the card, and the same step on the
   CPU through the plain versions, and holds loss, gradient norm and
   every updated parameter of the one to the other, for an SGD step and
   for the loop's AdamW step;
9. trains llama3.2-1b at full width (16 layers, bf16, full remat)
   through the adaptive-(k, beta) loop with 8 workers, a worker failure
   and its rejoin, and checks the losses, the stage walk, the fleet
   path, the kernels' launch counts per step and the peak memory; then
   holds the training kernels against their plain versions at every
   batch shape the loop ran;
10. times the training kernels at the training shape (K1; K2 forward and
   backward at D 2048) beside their plain versions, one library call and
   their bounds, and profiles one full-width train step at beta = 1;
11. holds the SSD scan (K5) forward and backward against their plain
   versions over the reference's kernel-test shapes, the reduced zamba2
   shape and zamba2-1.2b's training shape, at two decays, in f32 and bf16
   (bf16: the tensor-core kernels), each a second launch bit for bit;
12. takes one train step of zamba2-1.2b at full width, cut to 2 Mamba2
   layers and one shared call, in f32, through the kernels on the card
   and through the plain versions on the CPU, held as in phase 8;
13. trains zamba2-1.2b at full width (38 Mamba2 layers, 6 shared calls,
   bf16, full remat) through the adaptive-(k, beta) loop as phase 9 does
   llama3.2-1b, at 8 x 512 tokens a step (``ZAMBA_TRAIN_B``), with the
   same checks, then holds K5, K1 and K2 against
   their plain versions at every batch shape the loop ran;
14. times K5 forward and backward at the training shape beside their
   plain versions and bounds, K1 forward and backward at the shared
   block's shape (MHA, D 128) beside theirs and SDPA, and K2 forward and
   backward at zamba2's 4096-wide norms beside theirs and ``F.rms_norm``,
   and profiles one full-width zamba2 train step;
15. serves zamba2-1.2b: first, cut to 2 Mamba2 layers and one shared call
   at full width in f32, one right-padded prefill chunk and 4 decode ticks
   with a lane masked off through the kernels on the card against the
   plain versions on the CPU, over each pool (logits, recurrent states,
   K/V rows); then at full width cut to 12 Mamba2 layers and 2 shared
   calls (``Z_SERVE_LAYERS``; phases 16 and 17 serve the same cut), bf16,
   5 requests (prompts 16-96) through ``ServeEngine`` over each pool (4
   slots of 512 rows, 64-token chunks), every stream position held to teacher-forced
   ``generate_offline`` and each decode step's launches counted (K2 29
   times, K3 or K4 twice, nothing else); times K3 and K4 at the tick's
   shape and K2 at its 4 rows of 4096, and profiles a decode tick of each
   pool and the scanned prefill per prompt token;
16. serves speculatively (a draft model's masked ticks, one target verify
   over the pool, exact-argmax acceptance and a rollback, gamma adapted to
   the acceptance rate): first the 2-layer f32 cuts of both models run
   ``verify_with_cache`` (per-row starts, n_input 0, 1 and 4, a rejected
   tail) and the replay on the card against plain on the CPU over both
   pools; then llama3.2-1b at full width serves the first 5 of phase 4's
   8 requests with
   gamma <= 6 over both pools with a draft of the target plus noise 3e-4
   and with the target itself (whose every rejection must sit at a
   near-tie of offline decode), and over the contiguous pool with a poor
   draft (noise 2e-2) that drives the controller to gamma = 0 rounds; zamba2-1.2b serves 2
   requests with gamma <= 3 over both pools, and every round that
   speculates on its contiguous pool is held to ``decode_step`` run token
   by token over the committed tokens. Every call's launches are counted (a llama
   draft tick K2 33 and K3 16 times, a verify K2 33 times and nothing
   else; a zamba2 scan step K2 29 and K3/K4 twice), and so is each
   round's sequence of calls; every stream is held to teacher-forced
   offline decode; K2 is timed at a verify's 8 and 28 rows, and one
   steady llama round is profiled;
17. serves with copy-on-write prefix sharing, preempt-and-requeue and
   migration: llama3.2-1b (paged, block 16) serves 8 requests sharing a
   512-token prefix and two identical block-aligned prompts (a full
   match that re-feeds its last token through a forked block) with and
   without sharing — at least 6 admissions adopt, and the prefill tokens
   fall by exactly the rows shared (the streams compared with the
   unshared run's); phase 4's traffic on a 64-block sharing arena,
   which must preempt and replay (compared with phase 4's paged
   streams); and 2 of phase 4's
   requests exported after 8 tokens to a second engine, contiguous to
   contiguous and paged to paged (sharing), compared with the same
   requests served unmigrated token for token, and a ticket with one
   byte flipped refused with the destination unchanged; zamba2-1.2b
   serves 3 requests on a 4-block sharing arena (preempted, never
   sharing) and migrates one (its recurrent state moves).
   Every call's launches are counted as in phase 16 (a llama tick K2 33
   and K3 or K4 16 times, a prefill chunk K2 33; a zamba2 step K2 29 and
   K3/K4 twice), every arena drains clean, every stream is held to
   teacher-forced offline decode, and ``snapshot_slot`` and
   ``restore_slot`` of a llama slot are timed against their byte bound;
18. observability and the multi-replica fleet: (a) phase 4's traffic on
   both pools again with ``Observability()``, whose streams, stats and
   every call's launches must equal phase 4's, whose trace must validate
   with no span left open, and whose engine counters must equal the
   ``EngineStats``; (b) phase 4's 8 requests through a ``Frontend`` over
   3 paged replicas (block 16, 4 slots of 1024, 256-token chunks) sharing
   one params dict, hedged at 0.001 a copy, with replica 1 failing while
   it decodes and rejoining, replica 2 draining while it decodes, and a
   transport plan of a drop, a duplicate and a corruption of the drain's
   first ticket: every request completes, at least one ticket lands and
   one is refused, every stream holds by the near-tie rule, every pool,
   arena and router count drains, the trace validates, every call of
   every replica launches what phase 4's do, and each ticket's seal and
   verify are timed;
19. the registry's other GQA decoders at full width, each loaded alone
   (random bf16 weights from a seed, their bias and norm leaves made
   noisy; the memory held before each load and the peak after it
   printed) and served cut in depth (qwen2.5-3b to 12 layers, the wide
   models to 8: ``QWEN_SERVE_LAYERS``, ``W_LAYERS``): (a) qwen2.5-3b
   (q/k/v bias) serves the first 6 of phase 4's requests over both
   pools; (b) command-r-35b (LayerNorm, the parallel attention + FFN block, logit scale 0.0625), chameleon-34b
   (qk-norm, untied head) and qwen3-moe-30b-a3b (128 experts top 8,
   dropless) each serve 5 requests (prompts 32-256, 8-32 new) over the
   paged pool, 4 slots of 512, 128-token chunks. Every call's launches
   are counted (K2 once an RMSNorm, none for LayerNorm; K3 or K4 once a
   layer a tick) and every stream position is held to teacher-forced
   offline decode by two rules: the logits' top-2 gap read before
   ``logit_scale`` is a near-tie, or, for the MoE, the served router
   picked another expert set than offline's in some layer at that
   position (both runs' sets are recorded; the share of positions where
   a set differs and the largest offline router gap at a differing set
   are printed); each rule's excused positions are printed, and either
   excusing more than a quarter of them fails. (c) Before each wide model, its 2-layer f32
   cut runs a right-padded prefill chunk and 2 ticks on the card against
   plain on the CPU over both pools. (d) qwen2.5-3b trains at full width
   (36 layers, bf16, remat selective, 8 x 512 tokens a step) through
   the adaptive-(k, beta) loop with a fail and a rejoin; then one step
   under selective and one under full remat on one batch (losses equal
   bit for bit, gradient norms within 1e-3; peak memory and wall of
   each), and K1 and K2 held at every batch shape the loop ran. (e) K2,
   K3 and K4 are timed at each model's tick shape (G 8 at D 128; K2 at D
   8192 and at the qk-norm's D 128) and K1 at qwen2.5-3b's training
   shape, and 6 steady ticks of each model (qwen2.5-3b's on the paged
   pool) are profiled beside their
   byte bound (the weights plus the live K/V rows at 3.35 TB/s; for the
   MoE every expert, as its dropless dispatch reads them, and beside it
   only the experts the profiled ticks routed to);
20. MLA and xLSTM serving, each model loaded alone (random bf16 weights
   from a seed, norm scales and biases made noisy): (a) deepseek-v3 at
   full width (d_model 7168, 128 heads, q_lora 1536, kv_lora 512, 256
   experts top 8 plus one shared, dense d_ff 18432, vocab 129280, the MTP
   head held) cut to 5 layers (3 MLA dense, 2 MLA MoE), dropless: 4
   requests over both pools with the registry's absorbed latent decode,
   again over the contiguous pool through the expand path, and 4 requests
   sharing a 128-token prefix on the paged pool with sharing (which must
   adopt it); (b) xlstm-125m at full width cut to 6 layers (5 mLSTM and
   1 sLSTM block; ``XL_LAYERS``) serves 6 requests over both pools,
   again with a draft of the target plus noise 3e-4 (gamma <= 3) over
   both pools, and 3 requests on a 4-block sharing arena that must preempt. (c) Every
   stream is held to teacher-forced offline decode by phase 19's rules
   (near-ties; for deepseek the router rule), and every call's launches
   are counted: K2 ``k2_per_call`` times a call (xLSTM: a scanned step),
   nothing else (MLA attends and xLSTM recurs in plain PyTorch). (d)
   Peak memory of each run; 6 steady ticks of each pool profiled beside
   their byte bound (the weights without the MTP head, the latent rows,
   xLSTM's states read and written; deepseek also with only the routed
   experts); K2 timed at the new widths (7168, 1536, 512; 768, 1536);
21. training MLA and xLSTM through the adaptive-(k, beta) loop: (c)
   first one f32 train step of each family through the kernels on the
   card vs plain on the CPU, held as in phase 8 (xlstm-125m at full width
   cut to an mLSTM and an sLSTM block; deepseek-v3 at the CPU tests'
   widths, 2 layers with 8 experts of top 2, the MTP head on); then (a)
   deepseek-v3 at full width cut to 2 layers (1 MLA dense, 1 MLA MoE of 256 experts top
   8 plus a shared one, capacity-dropped; the MTP head on; 14.63 B
   parameters), bf16, remat full, Adafactor, 8 workers, 8 x 512 tokens,
   12 steps, and (b) xlstm-125m at full width cut to 6 layers (phase
   20's cut), bf16, remat full, momentum 0.9, 32 x 512 tokens, 12 steps,
   each with a worker
   failing at step 5 and rejoining at 10 (``train_full_width``: the
   stage walk, the fleet path, finite losses, the peak memory, and (e)
   K2's launches equal to ``per_step_launches`` a step, nothing else
   launched); each first takes two steps on one batch from its loaded
   weights, whose loss must fall (deepseek at lr 1e-5: a fresh
   Adafactor's first step moves every weight by about lr), and after its
   loop holds (d) K2 forward and backward against plain at every batch
   shape its loop ran and every norm width (7168, 1536, 512; 768, 1536),
   times K2 there, profiles one train step and times its optimizer's
   in-place step beside its byte bound; the load and training peaks are
   printed;
22. (a) hubert-xlarge (frames in: a projection and a depthwise positional
   conv; 48 bidirectional encoder layers of 16 heads of 80, LayerNorm,
   GELU; 946,272,000 parameters): first one f32 train step at full
   width cut to 2 layers through the kernels on the card vs plain on the
   CPU, held as in phase 8; then at full width and depth, bf16, remat
   full, AdamW, one batch of 32 x 512 frames of ``make_frame_stream`` over
   8 workers: 3 masked fastest-k steps with 6 of 8 contributing, whose
   own-batch loss must fall, and one with all 8, each launching K1 96
   times forward and 48 backward, non-causal, and nothing else (the load
   and training peaks printed); K1 held against plain at the step's
   shape, timed there beside SDPA and its bound, and one step profiled
   once (b)'s worker processes have ended.
   (b) the simulation engines: ``simulate_batch`` at
   ``benchmarks/perf_sim.py``'s Fig. 4 points (n 20, 24 seeds, cut to
   5,000 iterations, adaptive-(k, beta) and adaptive-k) with its lanes in
   float64 on the card, held to the same call on the CPU (stage logs
   exactly, trajectories within 1e-9) and lanes 0 and 23 to the scalar
   ``simulate`` at those seeds, the wall seconds of each printed (the
   CPU's runs in worker processes while (a) runs; the card's after they
   have ended), and a window of 256 iterations of each point profiled
   on the card (launches, device time and idle share an iteration); and
   ``evaluate_schedule``'s runtime ratio and computation and
   communication change against adaptive-k at the reference's
   calibration (host arithmetic);
23. (a) the chaos search's twin (``tools/chaos_search_torch.py``) over
   llama3.2-1b at full width (bf16, seeded weights): 3 paged replicas
   of 2 slots, 64 rows, block 8, one params dict, 4 requests. The
   ``CHAOS_SCHEDULES`` sampled schedules pass all eight oracles; the
   reference test's leak schedule with the engine's seeded cancel-path
   bug armed trips ``block_conservation``, ``shrink`` reduces it to its
   one fail atom, two replays give its signature, and unarmed it passes
   every oracle. ``byte_identity`` is exact unless every departure from
   the offline references sits at a near-tie of teacher-forced offline
   decode (``check_streams``); every call of every replica launches
   what phase 4's do. Each run prints its signature, plane ticks, host
   seconds, ``summary()`` and launches. K2 and K4 are held against plain
   at every shape the runs launched them at (K4 at block 8, a shape no
   other phase runs) and timed there. (b) the int8 error-feedback codec
   over a seeded bf16 gradient tree of llama3.2-1b's parameter shapes
   (1,235,814,400 elements) and a float32 residual: three leaves encoded
   and compressed on the card equal the CPU bit for bit, every leaf's
   round trip stays within scale/2 plus one float32 epsilon of |v|, and
   one ``ef_compress_tree`` over the tree is timed (CUDA events, cold L2)
   beside its byte bound, its device events counted;

and prints the ``kernels`` JSON line (eight kernels, each with its
launches on the zamba2 serving path under ``zamba_serve_launches``, in
phase 17 under ``phase17_launches`` and in phase 18 under
``phase18_launches``, in phase 19 under ``phase19_launches`` and in
phase 20 under ``phase20_launches``, in phase 21 under
``phase21_launches``, in phase 22 under ``phase22_launches`` and in
phase 23 under ``phase23_launches``; then K4 again at block 8, the chaos
fleet's geometry, with its times there and its launches in phase 23, and
K1's forward and backward at D 80, hubert's main path, with their
times at its shape and their launches in phase 22; the profiles under
``profile``, ``train_profile`` and ``zamba_train_profile``, K3's and K4's
long-context times under ``decode_long_context``, K1's times at
zamba2's shape under ``zamba_flash_times``, K2's at D 4096 under
``zamba_rmsnorm_times`` and at llama's training rows under
``rmsnorm_train_forward``, phase 15's results under ``zamba_serve``,
``zamba_serve_streams``, ``zamba_decode_parity``, ``zamba_decode_times``
and ``zamba_serve_profile``, phase 16's under ``spec_parity``,
``spec_serve``, ``spec_serve_streams``, ``spec_state_check``,
``spec_rmsnorm_times``, ``spec_snapshot`` and ``spec_profile`` (each
kernel's launches there under ``spec_serve_launches``), phase 17's under
``prefix_serve``, ``preempt_serve``, ``migration`` and ``zamba_preempt``, phase 18's
under ``observed_serve`` and ``fleet``, phase 19's under ``gqa_configs``,
phase 20's under ``mla_xlstm``, phase 21's under ``mla_xlstm_train``,
phase 22's under ``hubert_train`` and ``sim_engines``, phase 23's under
``chaos_search`` and ``compression``,
the launch floor, phase 2's tensor-core
reports under ``k1_tensor_cores`` and ``k5_tensor_cores`` and its
decode-kernel and K2 reports under ``decode_kernel_resources`` and
``k2_resources``), the card line
and, last, the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 RMSNorm outputs reach |y| of 4-5, where one bf16 rounding step is
#: 2^-5 = 3.1e-2: a one-rounding flip between the kernel's and PyTorch's
#: sum order exceeds 2e-2 alone, so bf16 RMSNorm is held to
#: 2e-2 + |ref| / 128 (one bf16 ulp of the reference value on top).
RMS_RTOL_BF16 = 1.0 / 128
#: Greedy streams may part from offline decode only where the offline
#: logits' top-2 gap is below this: 4 bf16 ulps at the top logit's
#: magnitude (4-8 for these random weights, where one ulp is 2^-5).
TIE_TOL = 0.125

ARCH = "llama3.2-1b"
N_SLOTS, MAX_LEN, PREFILL_CHUNK, BLOCK_SIZE, SEED = 4, 1024, 256, 16, 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: the build, and the tensor cores in K1's bf16 kernels
# ---------------------------------------------------------------------------

#: K1's bf16 kernels the main paths launch: llama3.2-1b's D 64,
#: zamba2-1.2b's shared block's D 128 and hubert-xlarge's D 80 (D = Dv).
K1_TC_KERNELS = ("fa_fwd_mma", "fa_bwd_dq_mma", "fa_bwd_dkdv_mma")
K1_TC_DIMS = (64, 128, 80)


def k1_instance(mangled: str):
    """(kernel, D, Dv) of a mangled K1 bf16 kernel name, else None."""
    m = re.search(r"(fa_(?:fwd|bwd_dq|bwd_dkdv)_mma)ILi(\d+)ELi(\d+)E", mangled)
    return (m.group(1), int(m.group(2)), int(m.group(3))) if m else None


def ptxas_resources(log: str) -> dict:
    """{mangled entry: (registers, spill bytes stored + loaded)} from
    ptxas's ``-v`` report in the build log."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
    return out


#: A SASS line that holds an HMMA instruction.
HMMA_LINE = re.compile(r"^[^\n]*\bHMMA\b", re.M)


def sass_hmma_counts(sass: str) -> dict:
    """{function: lines holding HMMA} of ``cuobjdump -sass`` output, each
    function's lines running from its ``Function : name`` line to the
    next one's."""
    counts = {}
    for part in re.split(r"^[^\n]*Function : ", sass, flags=re.M)[1:]:
        head, _, body = part.partition("\n")
        counts[head.split()[0]] = len(HMMA_LINE.findall(body))
    return counts


@functools.lru_cache(maxsize=None)
def hmma_counts(library: Path) -> dict:
    """{mangled function: count of HMMA instructions} in the library's
    SASS (``cuobjdump -sass``, from the toolkit that built it), read once
    for K1's and K5's checks."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    return sass_hmma_counts(sass)


def check_tensor_cores(library: Path, log: str) -> dict:
    """Each K1 bf16 kernel of the main paths issues HMMA and spills
    nothing; {"kernel D/Dv": {"hmma", "registers", "spill_bytes"}}."""
    res = {k1_instance(name): r for name, r in ptxas_resources(log).items() if k1_instance(name)}
    hmma = {k1_instance(name): n for name, n in hmma_counts(library).items()
            if k1_instance(name)}
    out = {}
    for kern in K1_TC_KERNELS:
        for d in K1_TC_DIMS:
            key = (kern, d, d)
            check(key in res and key in hmma, f"{kern}<{d}, {d}> is missing from the build")
            regs, spill = res[key]
            out[f"{kern} D{d}/Dv{d}"] = dict(hmma=hmma[key], registers=regs, spill_bytes=spill)
            print(f"    {kern}<D {d}, Dv {d}>: {hmma[key]} HMMA, {regs} registers, "
                  f"{spill} bytes spilled")
            check(hmma[key] > 0, f"{kern}<{d}, {d}> issues no HMMA: no tensor cores")
            check(spill == 0, f"{kern}<{d}, {d}> spills {spill} bytes")
    return out


#: A K5 bf16 kernel's instance in a mangled name: forward or backward, P
#: and N.
K5_ENTRY = re.compile(r"(ssd_(?:fwd|bwd)_mma)ILi(\d+)ELi(\d+)E")
#: Its instances: P and N in {16, 32, 64}, forward and backward.
K5_TC_INSTANCES = 2 * 9


def check_ssd_tensor_cores(library: Path, log: str) -> dict:
    """Every K5 bf16 kernel instance has HMMA and spills nothing, and the
    main path's (P = N = 64) are built;
    {"kernel P/N": {"hmma", "registers", "spill_bytes"}}."""

    def key(name):
        m = K5_ENTRY.search(name)
        return (m.group(1), *map(int, m.groups()[1:])) if m else None

    res = {key(n): r for n, r in ptxas_resources(log).items() if key(n)}
    hmma = {key(n): c for n, c in hmma_counts(library).items() if key(n)}
    check(len(res) == K5_TC_INSTANCES and set(res) == set(hmma),
          f"{len(res)} K5 bf16 kernel instances in the build, not {K5_TC_INSTANCES}")
    for main in (("ssd_fwd_mma", 64, 64), ("ssd_bwd_mma", 64, 64)):
        check(main in res, f"{main} (the main path's) is missing from the build")
    out = {}
    for k in sorted(res):
        regs, spill = res[k]
        out[f"{k[0]} P{k[1]}/N{k[2]}"] = dict(hmma=hmma[k], registers=regs, spill_bytes=spill)
        print(f"    {k[0]}<P {k[1]}, N {k[2]}>: {hmma[k]} HMMA, {regs} registers, "
              f"{spill} bytes spilled")
        check(hmma[k] > 0, f"{k} has no HMMA: no tensor cores")
        check(spill == 0, f"{k} spills {spill} bytes")
    return out


#: A decode kernel's instance in a mangled name: split or merge, dtype,
#: row functor and, for the split kernel, lanes per row, 16-byte pieces per
#: lane and the query group it is built for.
DECODE_ENTRY = re.compile(r"decode_(split|merge)_kernelI(f|13__nv_bfloat16)NS_\d+"
                          r"(Contiguous|Paged)RowsE(?:Li(\d+)ELi(\d+)ELi(\d+)E)?")


def check_decode_resources(log: str) -> dict:
    """K3's and K4's kernels (split-KV split and merge) spill nothing;
    {"split bf16 Paged LPR 8 NC 1 G<=4": {"registers", "spill_bytes"}, ...}."""
    out = {}
    for name, (regs, spill) in ptxas_resources(log).items():
        m = DECODE_ENTRY.search(name)
        if not m:
            continue
        kind, dt, rows, lpr, nc, gm = m.groups()
        key = f"{kind} {'f32' if dt == 'f' else 'bf16'} {rows}"
        if kind == "split":
            key += f" LPR {lpr} NC {nc} G<={gm}"
        out[key] = dict(registers=regs, spill_bytes=spill)
    check(len(out) == 40, f"{len(out)} decode kernel instances in the build, not 40")
    for key, r in sorted(out.items()):
        print(f"    {key}: {r['registers']} registers, {r['spill_bytes']} bytes spilled")
        check(r["spill_bytes"] == 0, f"decode kernel {key} spills {r['spill_bytes']} bytes")
    return out


#: A K2 kernel's instance in a mangled name: forward rows, backward rows or
#: the backward's dscale sum; dtype; 16-byte vectors; for the row kernels,
#: units per thread, prefetch and the most threads a block.
K2_ENTRY = re.compile(r"(rmsnorm_(?:fwd_rows|bwd_rows|bwd_reduce))I(f|13__nv_bfloat16)"
                      r"Lb([01])E(?:Li(\d+)ELb([01])ELi(\d+)E)?")
#: Its instances (``kInstances`` in ``csrc/rmsnorm.cu``): 18 forward, 13
#: backward, 4 dscale sums.
K2_INSTANCES = 35


def check_rmsnorm_resources(log: str, fail: bool = True) -> dict:
    """Every K2 instance is built and (``fail``) spills nothing;
    {"kernel dtype vec J threads": {"registers", "spill_bytes"}}."""
    out = {}
    for name, (regs, spill) in ptxas_resources(log).items():
        m = K2_ENTRY.search(name)
        if not m:
            continue
        kern, dt, vec, j, pf, threads = m.groups()
        key = f"{kern} {'f32' if dt == 'f' else 'bf16'} {'vectors' if vec == '1' else 'elements'}"
        if j:
            key += f" J {j}, {threads} threads{', prefetch' if pf == '1' else ''}"
        out[key] = dict(registers=regs, spill_bytes=spill)
    for key, r in sorted(out.items()):
        print(f"    {key}: {r['registers']} registers, {r['spill_bytes']} bytes spilled")
    check(len(out) == K2_INSTANCES, f"{len(out)} K2 instances in the build, not {K2_INSTANCES}")
    spills = [k for k, r in out.items() if r["spill_bytes"]]
    check(not (fail and spills), f"K2 instances spill: {spills}")
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scatter_to_arena(k, v, lengths, block_size, gen):
    """Scatter contiguous (B, S, ...) caches into a shuffled block arena
    holding random values everywhere a live block is not (the NULL block
    0 and every unreferenced row)."""
    B, S = k.shape[:2]
    T = S // block_size
    dev = k.device
    ids = torch.randperm(B * T, generator=gen, device="cpu") + 1
    k_arena = torch.randn((B * T + 1, block_size, *k.shape[2:]), generator=gen).to(dev, k.dtype)
    v_arena = torch.randn((B * T + 1, block_size, *v.shape[2:]), generator=gen).to(dev, v.dtype)
    tables = torch.zeros((B, T), dtype=torch.int32)
    nxt = 0
    for b in range(B):
        for t in range(-(-int(lengths[b]) // block_size)):
            bid = int(ids[nxt])
            nxt += 1
            tables[b, t] = bid
            k_arena[bid] = k[b, t * block_size:(t + 1) * block_size]
            v_arena[bid] = v[b, t * block_size:(t + 1) * block_size]
    return k_arena, v_arena, tables.to(dev)


def hold_rms_norm(shape, dtype, gen) -> float:
    """K2 forward vs its plain version on random (shape) x; max |err|."""
    from repro_torch.kernels import rms_norm, rms_norm_plain

    x = torch.randn(shape, generator=gen).to("cuda", dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=gen)).to("cuda", dtype)
    out, ref = rms_norm(x, scale), rms_norm_plain(x, scale)
    same = torch.equal(rms_norm(x, scale), out)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    rtol = RMS_RTOL_BF16 if dtype == torch.bfloat16 else 0.0
    ok = bool((err <= TOL[dtype] + rtol * ref.float().abs()).all())
    name = str(dtype).replace("torch.", "")
    print(f"  K2 rmsnorm {name} x {tuple(shape)}: max|err|={err.max().item():.3e}; repeat "
          f"launch bitwise: {same} ({'ok' if ok else 'FAIL'})")
    check(ok, f"rmsnorm {name} {tuple(shape)} disagrees with its plain version")
    check(same, f"a second launch of rmsnorm {name} {tuple(shape)} gave other bits")
    return err.max().item()


def check_kernels() -> dict:
    """Every kernel vs its plain version; returns {kernel: max |err| in bf16}.
    K3 and K4 at ``parity.DECODE_SHAPES``: K3 on live rows (its contract
    is length >= 1), K4 on all; K3 == K4 bit for bit, a second launch of
    each gives the same bits, each row equals a launch of that row alone
    bit for bit (K3 on live rows), and a length-0 row is exact zeros; K4
    also over the shared block tables of ``parity.SHARED_DECODE_SHAPES``
    (``hold_shared_tables``)."""
    from repro_torch.kernels import (
        decode_attention, decode_attention_plain, paged_decode_attention,
        paged_decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention import sm_count
    from repro_torch.kernels.parity import (
        DECODE_BLOCK, DECODE_SHAPES, RMS_CHUNK_SHAPES, RMS_DECODE_SHAPES, RMS_VERIFY_SHAPES,
        SHARED_DECODE_SHAPES,
    )
    from repro_torch.kernels.rmsnorm import launch_plan

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    worst = {"rmsnorm": 0.0, "decode_attention": 0.0, "paged_decode_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for shape in (RMS_DECODE_SHAPES + RMS_VERIFY_SHAPES + RMS_CHUNK_SHAPES
                      + [(PREFILL_CHUNK, 1, 2048), (512, 2048)]):
            err = hold_rms_norm(shape, dtype, gen)
            if shape in RMS_DECODE_SHAPES + RMS_VERIFY_SHAPES + RMS_CHUNK_SHAPES:
                es = torch.tensor([], dtype=dtype).element_size()
                plan = launch_plan(False, int(np.prod(shape[:-1])), shape[-1], es, True,
                                   sm_count(0))
                print(f"    launch plan: {plan} (phase 2: no K2 instance spills)")
            if dtype == torch.bfloat16:
                worst["rmsnorm"] = max(worst["rmsnorm"], err)
        for H, Hkv, D, S, lens in DECODE_SHAPES:
            B = len(lens)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            live = lengths > 0
            q = torch.randn((B, H, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dtype)
            k_ar, v_ar, tables = scatter_to_arena(k, v, lens, DECODE_BLOCK, gen)
            paged = paged_decode_attention(q, k_ar, v_ar, tables, lengths)
            paged_ref = paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)
            out = decode_attention(q, k, v, lengths)
            ref = decode_attention_plain(q, k, v, lengths)
            same = (torch.equal(decode_attention(q, k, v, lengths), out)
                    and torch.equal(paged_decode_attention(q, k_ar, v_ar, tables, lengths), paged))
            alone = all(
                torch.equal(paged_decode_attention(q[b:b + 1], k_ar, v_ar, tables[b:b + 1],
                                                   lengths[b:b + 1])[0], paged[b])
                and (lens[b] == 0 or torch.equal(
                    decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1])[0],
                    out[b]))
                for b in range(B))
            torch.cuda.synchronize()
            perr = (paged.float() - paged_ref.float()).abs().max().item()
            err = (out[live].float() - ref[live].float()).abs().max().item()
            print(f"  K3/K4 decode {name} H={H} Hkv={Hkv} D={D} S={S} lengths={lens}: "
                  f"K3 max|err|={err:.3e}, K4 max|err|={perr:.3e}; K3 == K4 bitwise: "
                  f"{bool(torch.equal(out, paged))}; repeat launches bitwise: {same}; each row "
                  f"== that row alone (B 1) bitwise: {alone}")
            check(perr <= TOL[dtype], f"paged decode {name} {lens} disagrees")
            check(err <= TOL[dtype], f"decode {name} {lens} disagrees")
            check(bool((paged[~live] == 0).all()), "length-0 row is not exact zeros")
            check(torch.equal(out, paged), "K3 and K4 differ on identical rows")
            check(same, "a second launch of K3 or K4 gave other bits")
            check(alone, "a row of K3 or K4 differs from a launch of that row alone")
            if dtype == torch.bfloat16:
                worst["decode_attention"] = max(worst["decode_attention"], err)
                worst["paged_decode_attention"] = max(worst["paged_decode_attention"], perr)
        for H, Hkv, D, S, lens, shared in SHARED_DECODE_SHAPES:
            perr = hold_shared_tables(H, Hkv, D, S, lens, shared, dtype, gen)
            if dtype == torch.bfloat16:
                worst["paged_decode_attention"] = max(worst["paged_decode_attention"], perr)
    return worst


def hold_shared_tables(H, Hkv, D, S, lens, shared, dtype, gen) -> float:
    """K4 over block tables that prefix sharing leaves
    (``parity.shared_block_arena``: rows 0 and 1 name the same first
    ``shared`` blocks, row 2 a fork of the last of them), held by
    ``hold_paged_tables``."""
    from repro_torch.kernels.parity import shared_block_arena

    dev = torch.device("cuda")
    k_ar, v_ar, tables = shared_block_arena(Hkv, D, S, lens, shared, gen, dtype, dev)
    q = torch.randn((len(lens), H, D), generator=gen).to(dev, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    name = str(dtype).replace("torch.", "")
    return hold_paged_tables(q, k_ar, v_ar, tables, lengths,
                             f"K4 over shared tables {name} H={H} Hkv={Hkv} D={D} S={S} "
                             f"lengths={lens}, {shared} shared blocks and a fork")


def hold_paged_tables(q, k_ar, v_ar, tables, lengths, label: str) -> float:
    """K4 on these inputs: plain's value, a second launch bit for bit, each
    row bit for bit equal to a launch of that row alone, and K3 on the
    gathered rows bit for bit; returns max |err|."""
    from repro_torch.kernels import (
        decode_attention, paged_decode_attention, paged_decode_attention_plain,
    )
    from repro_torch.models.attention import paged_kv_view

    out = paged_decode_attention(q, k_ar, v_ar, tables, lengths)
    ref = paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)
    same = torch.equal(paged_decode_attention(q, k_ar, v_ar, tables, lengths), out)
    alone = all(torch.equal(paged_decode_attention(q[b:b + 1], k_ar, v_ar, tables[b:b + 1],
                                                   lengths[b:b + 1])[0], out[b])
                for b in range(q.shape[0]))
    k3 = torch.equal(decode_attention(q, paged_kv_view(k_ar, tables),
                                      paged_kv_view(v_ar, tables), lengths), out)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  {label}: max|err|={err:.3e}; repeat launch bitwise: {same}; each row == that "
          f"row alone bitwise: {alone}; == K3 on the gathered rows bitwise: {k3}")
    check(err <= TOL[q.dtype], f"{label}: K4 disagrees with its plain version")
    check(same, f"{label}: a second launch of K4 gave other bits")
    check(alone, f"{label}: a row of K4 differs from a launch of that row alone")
    check(k3, f"{label}: K4 differs from K3 on the gathered rows")
    return err


# ---------------------------------------------------------------------------
# Phase 4: serve llama3.2-1b through both pools
# ---------------------------------------------------------------------------

def workload(vocab: int):
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(8):
        p = int(rng.integers(64, 601))
        m = int(rng.integers(16, 65))
        reqs.append((rng.integers(0, vocab, size=p).astype(np.int32), m, i * 0.02))
    return reqs


def serve(model, params, reqs, pools=(("contiguous", None), ("paged", BLOCK_SIZE)), *,
          n_slots: int = N_SLOTS, max_len: int = MAX_LEN, chunk: int = PREFILL_CHUNK) -> dict:
    """``reqs`` through ``ServeEngine`` over each of ``pools`` ((name, block
    size or None)), each run's launch counters reset just before it and
    read just after: K2 ``k2_per_call`` times a prefill call (xLSTM: a
    prefilled token, which it scans) and a tick, K3 or K4 once a GQA layer
    a tick (none for MLA and xLSTM), nothing else. The caller holds the
    streams to offline decode (``check_streams``); for an MoE, each run
    also records the experts its router chose at every (request index,
    position) (``record_served_experts``)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.parity import k2_per_call
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    L = cfg.n_layers if cfg.mla is None and not model.recurrent else 0
    norms = k2_per_call(cfg)
    runs = {}
    for pool, block_size in pools:
        eng = ServeEngine(
            model, params, n_slots=n_slots, max_len=max_len, block_size=block_size,
            scheduler=Scheduler(n_slots, prefill_chunk=chunk),
        )
        rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
        finish = record_served_experts(eng) if cfg.moe is not None else None
        torch.cuda.synchronize()
        reset_launch_counts()
        with RouterRecord() if finish else contextlib.nullcontext() as rec:
            results = eng.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        st = eng.stats
        print(f"  {pool}: {st.prefill_calls} prefill calls, {st.decode_ticks} decode "
              f"ticks, {st.generated_tokens} tokens in {st.wall_seconds:.2f} s; "
              f"decode {st.decode_tokens_per_wsec:.1f} tokens/s; KV high-water "
              f"{eng.pool.kv_bytes_high_water() / 2**20:.1f} MiB of "
              f"{eng.pool.kv_bytes_contiguous() / 2**20:.1f} MiB contiguous; "
              f"launches {counts}")
        steps = st.decode_ticks + (st.prefill_tokens if model.recurrent else st.prefill_calls)
        check(counts["rmsnorm"] == norms * steps,
              f"{pool}: rmsnorm launched {counts['rmsnorm']} times, expected "
              f"{norms} x {steps}")
        attn = "paged_decode_attention" if block_size else "decode_attention"
        check(counts[attn] == L * st.decode_ticks and st.decode_ticks > 0,
              f"{pool}: {attn} launched {counts[attn]} times, expected {L} x "
              f"{st.decode_ticks}")
        others = {k: v for k, v in counts.items() if k not in ("rmsnorm", attn) and v}
        check(not others, f"{pool}: kernels off the serving path launched: {others}")
        for rid, (p, m, _) in zip(rids, reqs):
            toks = results[rid].tokens
            check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{pool}: request {rid} produced a malformed stream")
        runs[pool] = {"tokens": [results[r].tokens for r in rids], "stats": st,
                      "launches": counts}
        if finish:
            index = {rid: i for i, rid in enumerate(rids)}
            runs[pool]["experts"] = {(index[rid], q): ex
                                     for (rid, q), ex in finish(rec).items()}
    return runs


#: Teacher-forced offline decodes, (model name, request index, stream) ->
#: (offline's choices, their top-2 gaps): a stream served again (by
#: another pool, or speculatively) is not decoded twice.
OFFLINE = {}
#: MoE models: (model name, request index, stream) -> the offline decode's
#: router record: (positions, MoE layers, top_k) sorted experts and the
#: (positions, MoE layers) router-logit gaps (``RouterRecord``).
ROUTER_OFFLINE = {}


class RouterRecord:
    """While active, records what every call of the MoE router
    (``repro_torch.models.moe.route``) returns as each row's experts (a
    (T, K) device tensor a call, kept as the router made it), and, with
    ``gaps``, each row's router-logit gap between its k-th and (k+1)-th
    largest expert (log p_k - log p_(k+1), as ``route`` forms the logits).
    A model call routes once a MoE layer, in layer order."""

    def __init__(self, gaps: bool = False):
        self.want_gaps, self.experts, self.gaps = gaps, [], []

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.route = moe, moe.route

        def route(x_flat, router, cfg_moe):
            res = self.route(x_flat, router, cfg_moe)
            self.experts.append(res[1])
            if self.want_gaps:
                top = torch.topk((x_flat @ router).float(), cfg_moe.top_k + 1, dim=-1).values
                self.gaps.append(top[:, -2] - top[:, -1])
            return res
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.module.route = self.route

    def calls(self, n_layers: int) -> list:
        """One ((n_layers, T, K) sorted experts, (n_layers, T) gaps or None)
        pair a model call, as numpy arrays."""
        out = []
        for i in range(0, len(self.experts), n_layers):
            ex = torch.stack(self.experts[i:i + n_layers]).sort(dim=-1).values.cpu().numpy()
            g = (torch.stack(self.gaps[i:i + n_layers]).cpu().numpy()
                 if self.want_gaps else None)
            out.append((ex, g))
        return out


def moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.moe.first_k_dense if cfg.moe is not None else 0


def record_served_experts(eng):
    """Wraps ``eng``'s prefill and decode calls so that, with a
    ``RouterRecord`` active, each call's rows can be mapped to (request id,
    position). Returns ``finish(rec)``, which after the run gives {(rid,
    position): (MoE layers, top_k) sorted experts} for every real row (a
    prefill chunk's padding and idle lanes are left out)."""
    rows, cur = [], {}
    do_prefill, prefill, decode = eng._do_prefill, eng._prefill, eng._decode

    def do_prefill_w(req):
        cur["rid"] = req.rid
        return do_prefill(req)

    def prefill_w(params, chunk, caches, length, start, tables):
        rows.append(("prefill", cur["rid"], int(start), length))
        return prefill(params, chunk, caches, length, start, tables)

    def decode_w(params, tokens, caches, positions, tables, lanes):
        owners = [eng.pool.owner[s] if eng._decoding[s] else None
                  for s in range(len(eng._decoding))]
        rows.append(("tick", owners, eng.pool.positions.copy()))
        return decode(params, tokens, caches, positions, tables, lanes)

    eng._do_prefill, eng._prefill, eng._decode = do_prefill_w, prefill_w, decode_w

    def finish(rec: RouterRecord) -> dict:
        calls = rec.calls(moe_layers(eng.model.cfg))
        check(len(calls) == len(rows), f"{len(calls)} router calls for {len(rows)} model calls")
        out = {}
        for row, (ex, _) in zip(rows, calls):
            if row[0] == "prefill":
                _, rid, start, length = row
                for r in range(int(length[0])):
                    out[(rid, start + r)] = ex[:, r]
            else:
                for s, rid in enumerate(row[1]):
                    if rid is not None:
                        out[(rid, int(row[2][s]))] = ex[:, s]
        return out
    return finish


def check_streams(model, params, reqs, runs: dict, max_len: int) -> dict:
    """Offline decode is fed each served stream (teacher forcing), so every
    position is checked: the engine's token equals offline's choice on
    the same prefix, or a near-tie rule excuses it. Where paged and
    contiguous part on a shared prefix, offline's one choice differs from
    one of them, so the check also covers that split.

    The logit rule: offline's top-2 gap there, read before the config's
    ``logit_scale`` (gap / logit_scale), is below ``TIE_TOL``. The router
    rule (MoE models): at the position whose logits chose the token, the
    served run's router picked another expert set than offline decode's in
    some layer (``serve`` records the served sets). The batch-4 tick and
    the batch-1 offline step, or a 128-row chunk and the whole prompt,
    round apart in bf16, and a flipped set moves the logits by more than a
    rounding. That is a fact of the two runs, not a tolerance: a set flips
    only where the served router logits moved across offline's gap between
    its k-th and (k+1)-th expert, so the largest such gap is the run's own
    bound, and it is printed with the rule's reach (the positions where
    some layer's set differs). Each rule's excused positions are counted;
    a departure that neither excuses fails the run."""
    from repro_torch.serve import generate_offline

    cfg = model.cfg
    n_moe = moe_layers(cfg)
    compared = near_ties = router_flips = identical = 0
    flipped = flipped_prompt = prompt_rows = 0
    flip_gap_max = 0.0
    for i, (p, m, _) in enumerate(reqs):
        P = len(p)
        for pool in runs:
            got = runs[pool]["tokens"][i]
            key = (cfg.name, i, tuple(got))
            if key not in OFFLINE:
                with RouterRecord(gaps=True) if n_moe else contextlib.nullcontext() as rec:
                    OFFLINE[key] = generate_offline(model, params, p, m, max_len, forced=got)
                if n_moe:
                    # (positions, layers, K) and (positions, layers): the
                    # prefill's P rows, then one row a decode step.
                    calls = rec.calls(n_moe)
                    ROUTER_OFFLINE[key] = (
                        np.concatenate([ex.transpose(1, 0, 2) for ex, _ in calls]),
                        np.concatenate([g.T for _, g in calls]))
            choice, margins = OFFLINE[key]
            diff = None
            if n_moe:
                # diff[q, l]: layer l's expert set at position q differs.
                # Position P - 1 + j's logits chose token j.
                # An adopted prefix's rows were computed by another request:
                # only the rows a request computed itself are recorded. Those
                # from its last prompt token on always are.
                off_ex, off_gap = ROUTER_OFFLINE[key]
                served = runs[pool]["experts"]
                n_pos = P + m - 1
                check(off_ex.shape[0] == n_pos
                      and all((i, q) in served for q in range(P - 1, n_pos)),
                      f"{pool}: request {i}: router records do not cover its positions "
                      f"{P - 1}..{n_pos - 1}")
                diff = np.stack([(served[(i, q)] != off_ex[q]).any(-1) if (i, q) in served
                                 else np.zeros(n_moe, bool) for q in range(n_pos)])
                flipped_prompt += int(diff[:P - 1].any(-1).sum())
                prompt_rows += sum((i, q) in served for q in range(P - 1))
                flipped += int(diff[P - 1:].any(-1).sum())
                if diff.any():
                    flip_gap_max = max(flip_gap_max, float(off_gap[:n_pos][diff].max()))
            for j in (j for j in range(m) if got[j] != choice[j]):
                gap = margins[j] / cfg.logit_scale
                if gap < TIE_TOL:
                    near_ties += 1
                    print(f"  {pool}: request {i} token {j}/{m} differs from offline "
                          f"(offline top-2 gap {gap:.4f} < {TIE_TOL}: near-tie)")
                    continue
                layers = np.nonzero(diff[P - 1 + j])[0] if n_moe else []
                check(len(layers) > 0,
                      f"{pool}: request {i} token {j} is {got[j]}, offline decode on the "
                      f"same prefix picks {choice[j]} at a top-2 gap {gap:.4f} >= {TIE_TOL}"
                      + (" and the served router picked offline's experts in every layer "
                         "there" if n_moe else ""))
                router_flips += 1
                print(f"  {pool}: request {i} token {j}/{m} differs from offline (top-2 "
                      f"gap {gap:.4f}; the served router picked other experts there in "
                      f"layers {layers.tolist()}, offline router gaps "
                      f"{[round(float(off_gap[P - 1 + j, l]), 4) for l in layers]}: router flip)")
            compared += m
            identical += got == choice
    out = {"positions_compared": compared, "near_ties": near_ties,
           "router_flips": router_flips, "unexcused": 0,
           "identical_streams": identical, "streams": len(runs) * len(reqs)}
    line = (f"  streams vs teacher-forced offline: {compared} positions compared, "
            f"{identical} of {len(runs) * len(reqs)} streams identical, {near_ties} near-ties "
            f"accepted (top-2 gap / logit_scale < {TIE_TOL})")
    if n_moe:
        out.update(router_flip_positions=flipped, router_flip_share=flipped / compared,
                   router_flip_prompt_rows=flipped_prompt, prompt_rows=prompt_rows,
                   router_flip_gap_max=flip_gap_max)
        line += (f", {router_flips} router flips accepted; the rule's reach: some layer's "
                 f"served expert set differs from offline's at {flipped} of {compared} "
                 f"positions ({flipped / compared:.1%}) and at {flipped_prompt} of "
                 f"{prompt_rows} earlier prompt rows; the largest offline router gap where a "
                 f"set differs: {flip_gap_max:.4f}")
    if "contiguous" in runs and "paged" in runs:
        out["paged_equals_contiguous"] = sum(
            a == b for a, b in zip(runs["contiguous"]["tokens"], runs["paged"]["tokens"]))
        line += f"; paged == contiguous for {out['paged_equals_contiguous']} of {len(reqs)}"
    print(line)
    return out


# ---------------------------------------------------------------------------
# Phase 5: timing
# ---------------------------------------------------------------------------

def time_ms(fn, n: int = 60, warmup: int = 5, flush_by_read: bool = False) -> float:
    """Median device time of ``fn`` over ``n`` launches, each bracketed by
    CUDA events after an L2 flush (a 128 MiB write, which leaves L2 full
    of dirty lines that the timed work's reads must write back; with
    ``flush_by_read``, a 128 MiB sum, which leaves it clean); a GPU-side
    sleep before the batch lets the host enqueue ahead, so host launch
    overhead is not timed."""
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    flush_f32 = flush.view(torch.float32)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        if flush_by_read:
            flush_f32.sum()
        else:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """The least time (ms) for the work: bytes over the memory rate or
    operations over ``peak``, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: Long-context decode shapes for llama3.2-1b's heads (32/8, D 64), timed
#: beside the serving shape: (B, S, lengths).
LONG_DECODE = {"a": (4, 8192, [8192, 6001, 2048, 4097]), "b": (1, 32768, [32768])}


def decode_inputs(B: int, S: int, H: int, Hkv: int, hd: int, lens, gen,
                  block: int = BLOCK_SIZE):
    """bf16 q (B, H, hd) and caches (B, S, Hkv, hd) at ``lens``, and the
    same rows in a shuffled arena of ``block``-row blocks."""
    dev, dt = torch.device("cuda"), torch.bfloat16
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, hd), generator=gen).to(dev, dt)
    k = torch.randn((B, S, Hkv, hd), generator=gen).to(dev, dt)
    v = torch.randn((B, S, Hkv, hd), generator=gen).to(dev, dt)
    k_ar, v_ar, tables = scatter_to_arena(k, v, lens, block, gen)
    return q, k, v, lengths, k_ar, v_ar, tables


def time_decode(B: int, S: int, H: int, Hkv: int, hd: int, lens, gen,
                block: int = BLOCK_SIZE) -> dict:
    """K3 and K4 (bf16, ``block``-row blocks) at ``lens``: kernel, plain
    version, one SDPA call (GQA, length mask; on the gathered view for
    K4) and the bound: every live K/V row read once, q read and out
    written once (and K4's live table entries)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        decode_attention, decode_attention_plain, paged_decode_attention,
        paged_decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention import sm_count, paged_kv_view, split_plan

    q, k, v, lengths, k_ar, v_ar, tables = decode_inputs(B, S, H, Hkv, hd, lens, gen, block)
    live = sum(lens)
    io = 2 * (B * H * hd * 2) + B * 4
    kv = live * Hkv * hd * 2 * 2
    flops = live * H * (4 * hd + 5)
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    kp = paged_kv_view(k_ar, tables).transpose(1, 2)
    vp = paged_kv_view(v_ar, tables).transpose(1, 2)

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask, enable_gqa=True)

    splits = split_plan(Hkv, S, sm_count(q.device.index))
    out = {}
    b, kind = bound(io + kv, flops)
    out["decode_attention"] = dict(
        shape=f"q ({B}, {H}, {hd}), cache ({B}, {S}, {Hkv}, {hd}) bf16, lengths {lens}",
        n_splits=splits,
        ms=time_ms(lambda: decode_attention(q, k, v, lengths)),
        plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, lengths)),
        library_ms=time_ms(lambda: sdpa(ks, vs)), bound_ms=b, bound_by=kind,
    )
    n_blocks = sum(-(-n // block) for n in lens)
    b, kind = bound(io + kv + n_blocks * 4, flops)
    out["paged_decode_attention"] = dict(
        shape=f"q ({B}, {H}, {hd}), arenas {tuple(k_ar.shape)} bf16, block {block}, "
              f"lengths {lens}",
        n_splits=splits,
        ms=time_ms(lambda: paged_decode_attention(q, k_ar, v_ar, tables, lengths)),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)),
        library_ms=time_ms(lambda: sdpa(kp, vp)), bound_ms=b, bound_by=kind,
    )
    return out


def print_kernel_times(out: dict) -> None:
    for name, r in out.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f", {r['n_splits']} splits" if "n_splits" in r else ""))


def time_rmsnorm_rows(rows: int, D: int, gen) -> dict:
    """K2 forward at x (rows, 1, D) bf16 beside its plain version,
    ``F.rms_norm`` and its bound (x read and y written, the scale read; ~4
    f32 operations an element)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rms_norm, rms_norm_plain

    dev, dt = torch.device("cuda"), torch.bfloat16
    x = torch.randn((rows, 1, D), generator=gen).to(dev, dt)
    scale = torch.ones(D, dtype=dt, device=dev)
    b, kind = bound(2 * rows * D * 2 + D * 2, 4 * rows * D)
    return dict(
        shape=f"x ({rows}, 1, {D}) bf16",
        ms=time_ms(lambda: rms_norm(x, scale)),
        plain_ms=time_ms(lambda: rms_norm_plain(x, scale)),
        library_ms=time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6)),
        bound_ms=b, bound_by=kind,
    )


def time_kernels(cfg, reqs) -> tuple:
    """(serving-shape times of K2, K3 and K4; K3 and K4 at LONG_DECODE)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    for rows, label in ((N_SLOTS, "decode"), (PREFILL_CHUNK, "prefill")):
        out[f"rmsnorm_{label}"] = time_rmsnorm_rows(rows, cfg.d_model, gen)
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(0))
    print(f"  launch floor (t.add_(0) on a one-element tensor, the same timer): "
          f"{floor:.5f} ms")
    # Decode attention at the serving run's geometry: 4 lanes mid-flight,
    # each at its prompt length plus half its new tokens.
    lens = [len(p) + m // 2 for p, m, _ in reqs[:N_SLOTS]]
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    out.update(time_decode(N_SLOTS, MAX_LEN, *heads, lens, gen))
    print_kernel_times(out)
    out["launch_floor_ms"] = floor
    long = {}
    for label, (B, S, lens) in LONG_DECODE.items():
        long[label] = time_decode(B, S, *heads, lens, gen)
        print(f"  long-context shape ({label}):")
        print_kernel_times(long[label])
    return out, long


# ---------------------------------------------------------------------------
# Phase 6: where serving time goes
# ---------------------------------------------------------------------------

def kernel_class(name: str) -> str:
    if "rmsnorm_bwd" in name:
        return "K2 rmsnorm bwd"
    if "rmsnorm" in name:
        return "K2 rmsnorm"
    if "fa_bwd" in name:
        return "K1 flash attention bwd"
    if "fa_fwd" in name:
        return "K1 flash attention fwd"
    if "ssd_bwd" in name:
        return "K5 ssd scan bwd"
    if "ssd_fwd" in name:
        return "K5 ssd scan fwd"
    if "decode_split_kernel" in name or "decode_merge_kernel" in name:
        return "K4 paged decode" if "PagedRows" in name else "K3 decode"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "gemv", "nvjet", "cublas")):
        return "GEMM (cuBLAS)"
    return "other PyTorch kernels"


def cuda_events(prof):
    """(name, device ms) of each device event (kernel, copy, set) a
    finished ``torch.profiler.profile`` recorded, read from its raw
    results, as ``prof.events()`` gives them (demangled; an async event's
    time 0): ``events()`` first builds the whole event tree, which on a
    busy host took longer than most windows took to run (~0.2 ms an
    event; a deepseek train step is ~45,000)."""
    for evt in prof.profiler.kineto_results.events():
        if (evt.device_type() != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_hidden_event", lambda: False)()):
            continue
        name = evt.name()
        name = torch._C._demangle(name) if len(name) > 1 else name
        asynchronous = evt.is_async() or evt.start_thread_id() != evt.end_thread_id()
        yield name, 0.0 if asynchronous else (evt.end_ns() - evt.start_ns()) / 1e6


def device_events(fn) -> int:
    """Device events (kernels, copies, sets) the profiler records over
    ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for _ in cuda_events(prof))


def window(label: str, timed, profiled, n_units: int, unit: str) -> dict:
    """Host wall time of ``timed()`` without the profiler, and device
    kernel time of ``profiled()`` (the same amount of the same work) under
    it; both end in a device sync."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled()
        torch.cuda.synchronize()
    by_class, by_name, launches = defaultdict(float), defaultdict(float), 0
    for name, ms in cuda_events(prof):
        by_class[kernel_class(name)] += ms
        by_name[name[:90]] += ms
        launches += 1
    device = sum(by_class.values())
    out = {
        "window": label, "units": n_units, "unit": unit,
        "wall_ms_per_unit": wall_ms / n_units,
        "device_ms_per_unit": device / n_units,
        "idle_share": 1 - device / wall_ms,
        "kernel_launches_per_unit": launches / n_units,
        "device_ms_per_unit_by_class": {k: v / n_units for k, v in
                                         sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_unit": {k: v / n_units for k, v in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }
    print(f"  {label}: {out['wall_ms_per_unit']:.3f} ms wall / {unit}, "
          f"{out['device_ms_per_unit']:.3f} ms device / {unit}, idle share "
          f"{out['idle_share']:.3f}, {out['kernel_launches_per_unit']:.1f} launches / {unit}")
    for k, v in out["device_ms_per_unit_by_class"].items():
        print(f"      {k}: {v:.4f} ms / {unit} ({v / max(out['device_ms_per_unit'], 1e-12):.1%})")
    for k, v in out["top_kernels_ms_per_unit"].items():
        print(f"        {v:.4f} ms  {k}")
    return out


def profile_serving(model, params) -> list:
    """Three steady windows, each after a warm-up of the same work: 20
    decode ticks of 4 lanes (prompts of 400-600 tokens) over the
    contiguous pool, the same over the paged pool (``profile_ticks``), and
    the 3 prefill chunks of one 600-token prompt. For each: host wall
    time, device kernel time, the device's idle share (1 - device / wall),
    kernel launches, and device time by kernel class."""
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    results = profile_ticks(model, params, (("contiguous", None), ("paged", BLOCK_SIZE)),
                            n_slots=N_SLOTS, max_len=MAX_LEN, chunk=PREFILL_CHUNK,
                            prompt=(400, 600), seed=SEED)
    rng = np.random.default_rng(SEED)

    def prefill_fresh():
        eng = ServeEngine(model, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                          scheduler=Scheduler(N_SLOTS, prefill_chunk=PREFILL_CHUNK))
        eng.submit(rng.integers(0, cfg.vocab_size, size=600), 2)
        return eng

    def prefill_all(eng):
        while eng.sched.running or eng.sched.waiting:
            eng.step()

    prefill_all(prefill_fresh())              # warm-up
    a, b = prefill_fresh(), prefill_fresh()
    results.append(window("prefill, 600-token prompt in 256-token chunks",
                          lambda: prefill_all(a), lambda: prefill_all(b), 3, "chunk"))
    return results


#: Decode ticks in each profiled tick window, and in the warm-up before
#: the windows (the engine's kernels are built and ran before); cut from
#: 10 after 4 to fit the script's time limit.
PROFILE_TICKS, PROFILE_WARMUP = 6, 2


def tick_bytes(model, params, live_rows: int, experts_read: float = None,
               lanes: int = 0) -> int:
    """Bytes a decode tick must move: every weight it reads (an untied
    embedding table only for its lanes' rows, which are left out, and no
    MTP head, which serving never runs) and ``live_rows`` cached rows over
    all layers (GQA: K and V; MLA: the latent row and its rope key). For
    an MoE, ``experts_read`` (the distinct experts the tick routes to,
    summed over its MoE layers) counts only those experts' weights;
    without it every expert is read, as the dropless dispatch's (E, C, D)
    products do. A recurrent stack reads and writes its ``lanes`` lanes'
    states once."""
    from repro_torch.models.layers import tree_leaves

    cfg = model.cfg

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree, is_leaf=torch.is_tensor))

    weights = nbytes(params) - nbytes(params.get("mtp", {}))
    if not cfg.tie_embeddings:
        weights -= params["embed"].numel() * params["embed"].element_size()
    if experts_read is not None:
        ffn = params["stack"][-1][0]["ffn"]
        per_expert = sum(ffn[k][0].numel() * ffn[k].element_size()
                         for k in ("w_in", "w_gate", "w_out"))
        weights -= round((moe_layers(cfg) * cfg.moe.n_experts - experts_read) * per_expert)
    elem = params["embed"].element_size()
    if cfg.mla is not None:
        kv_row = cfg.n_layers * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * elem
    elif model.recurrent:
        kv_row = 0
    else:
        kv_row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * elem
    state = 0
    if model.recurrent:
        from repro_torch.models.layers import DTYPES
        from repro_torch.serve.kv_pool import is_state_spec

        state = sum(s.size * DTYPES[s.dtype].itemsize
                    for s in tree_leaves(model.cache_specs(lanes, 16)) if is_state_spec(s))
    return weights + live_rows * kv_row + 2 * state


def profile_ticks(model, params, pools, *, n_slots: int, max_len: int, chunk: int,
                  prompt, seed: int) -> list:
    """``PROFILE_TICKS`` steady decode ticks of ``n_slots`` lanes (prompts
    drawn from ``prompt``, budgets to the end of the slot, so no lane
    finishes in the window) over each of ``pools``, after a warm-up of
    ``PROFILE_WARMUP``: the ``window`` of each, with its byte bound per tick
    (``tick_bytes`` at the window's mean live rows over
    ``HBM_BYTES_PER_S``). For an MoE, the profiled ticks also record the
    router's choices, a second bound reads only the experts they routed
    to (the mean distinct experts a tick over its MoE layers), and as
    many ticks again are profiled without the record for their launches."""
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    n = PROFILE_TICKS
    n_moe = moe_layers(cfg)
    out = []
    for pool, bsz in pools:
        eng = ServeEngine(model, params, n_slots=n_slots, max_len=max_len, block_size=bsz,
                          scheduler=Scheduler(n_slots, prefill_chunk=chunk))
        for _ in range(n_slots):
            eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(*prompt))),
                       max_len - prompt[1])
        while not eng._decoding.all():        # admit and prefill all lanes
            eng.step()

        def ticks(eng=eng, n=n):
            for _ in range(n):
                eng.step()

        rec = RouterRecord()

        def recorded(ticks=ticks, rec=rec):
            with rec:
                ticks()

        ticks(n=PROFILE_WARMUP)
        live = int(eng.pool.positions.sum()) + n_slots * (n + 1) // 2
        nbytes = tick_bytes(model, params, live, lanes=n_slots)
        res = window(f"{cfg.name} decode tick, {pool} pool, {n_slots} lanes", ticks,
                     recorded if n_moe else ticks, n, "tick")
        res.update(bound_bytes_per_tick=nbytes,
                   bound_ms_per_tick=nbytes / HBM_BYTES_PER_S * 1e3, live_kv_rows=live)
        print(f"    byte bound: {nbytes / 2**30:.2f} GiB a tick ({live} live K/V rows) = "
              f"{res['bound_ms_per_tick']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        if n_moe:
            calls = rec.calls(n_moe)
            check(len(calls) == n, f"{len(calls)} routed ticks recorded, expected {n}")
            routed = float(np.mean([sum(len(np.unique(ex[l])) for l in range(n_moe))
                                    for ex, _ in calls]))
            nbytes = tick_bytes(model, params, live, experts_read=routed, lanes=n_slots)
            res.update(routed_experts_per_tick=routed,
                       routed_bound_bytes_per_tick=nbytes,
                       routed_bound_ms_per_tick=nbytes / HBM_BYTES_PER_S * 1e3)
            print(f"    byte bound of the routed experts only ({routed / n_moe:.2f} distinct "
                  f"of {cfg.moe.n_experts} a layer a tick, mean over the profiled ticks): "
                  f"{nbytes / 2**30:.2f} GiB a tick = "
                  f"{res['routed_bound_ms_per_tick']:.3f} ms")
            # As many ticks again, profiled without the record, which must
            # add no launch of its own.
            res["launches_per_tick_unrecorded"] = device_events(ticks) / n
            print(f"    launches a tick profiled without the router record: "
                  f"{res['launches_per_tick_unrecorded']:.1f}")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# Phase 7: training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 32, 512, 16
#: RMSNorm (K2) rows: half the training batch, the training run's largest
#: (32 x 512 tokens at beta = 1) at llama's width and at zamba2's 4096-wide
#: norms, and a decode-sized one.
RMS_BWD_SHAPES = ((8192, 2048), (TRAIN_B * TRAIN_S, 2048), (TRAIN_B * TRAIN_S, 4096),
                  (4, 1, 2048))
#: q and k of K1's harder case are scaled by this: scores |S| reach ~100.
SCORE_MUL = 4.0


def hold_flash(shape, causal: bool, dtype, gen, mul: float = 1.0) -> tuple:
    """K1 forward and backward vs their plain versions on random inputs
    of ``shape`` (B, Sq, Skv, H, Hkv, D, Dv), q and k scaled by ``mul``;
    (out err, max dq/dk/dv err). Held by ``parity.flash_within`` (in bf16
    the kernels round P and dS to bf16 before their second product) and,
    at ``mul`` 1, by ``parity.within`` alone as well."""
    from repro_torch.kernels import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention import flash_attention_rounding_terms
    from repro_torch.kernels.parity import flash_within, within

    B, Sq, Skv, H, Hkv, D, Dv = shape
    dev = torch.device("cuda")
    q = (torch.randn((B, Sq, H, D), generator=gen) * mul).to(dev, dtype)
    k = (torch.randn((B, Skv, Hkv, D), generator=gen) * mul).to(dev, dtype)
    v = torch.randn((B, Skv, Hkv, Dv), generator=gen).to(dev, dtype)
    do = torch.randn((B, Sq, H, Dv), generator=gen).to(dev, dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    grads = flash_attention_bwd(q, k, v, ref, ref_lse, do, causal=causal)
    refs = flash_attention_bwd_plain(q, k, v, ref, ref_lse, do, causal=causal)
    terms = flash_attention_rounding_terms(q, k, v, ref, ref_lse, do, causal=causal)
    torch.cuda.synchronize()
    e_o, ok_o = flash_within(out, ref, dtype, terms[0])
    e_l, ok_l = within(lse, ref_lse, torch.float32)
    bwd = [flash_within(g, r, dtype, t) for g, r, t in zip(grads, refs, terms[1:])]
    # At unit-variance inputs the bf16 rule alone (no slack for the
    # rounding of P and dS) holds too, and is held; scores near 100 need
    # the slack.
    bare = all(within(a, b, dtype)[1] for a, b in zip((out,) + grads, (ref,) + refs))
    ok = ok_o and ok_l and all(o for _, o in bwd) and (bare or mul != 1)
    name = str(dtype).replace("torch.", "")
    scaled = (f", q and k x {mul:g} (row LSE up to {ref_lse.max().item():.0f})" if mul != 1
              else "")
    print(f"  K1 {name} B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} D={D} Dv={Dv} "
          f"causal={causal}{scaled}: out {e_o:.2e}, lse {e_l:.2e}, dq/dk/dv "
          f"{' / '.join(f'{e:.2e}' for e, _ in bwd)} ({'ok' if ok else 'FAIL'}"
          f"{'' if bare else '; within() alone is exceeded'})")
    check(ok, f"flash attention {name} {shape} causal={causal} disagrees with its plain "
              "version")
    return e_o, max(e for e, _ in bwd)


def hold_rms_norm_bwd(shape, dtype, gen) -> float:
    """K2 backward vs its plain version on random inputs of ``shape``;
    max |err| of dx and dscale.

    bf16 dscale sums g * x^ over rows, x^ the normalized row rounded to
    bf16. The kernel's rsqrt may differ from PyTorch's in its last bits,
    so x^ may round the other way where n lies near a bf16 midpoint: a
    column's tolerance adds one bf16 step of |g * n| for each of those
    elements (``dscale_bf16_slack``), beside the usual bf16 rule."""
    from repro_torch.kernels import rms_norm_bwd, rms_norm_bwd_plain
    from repro_torch.kernels.parity import NEAR_ULPS, dscale_bf16_slack, within

    dev = torch.device("cuda")
    x = torch.randn(shape, generator=gen).to(dev, dtype)
    g = torch.randn(shape, generator=gen).to(dev, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=gen)).to(dev, dtype)
    (dx, ds), (rx, rs) = rms_norm_bwd(g, x, scale), rms_norm_bwd_plain(g, x, scale)
    dx2, ds2 = rms_norm_bwd(g, x, scale)
    same = torch.equal(dx, dx2) and torch.equal(ds, ds2)
    torch.cuda.synchronize()
    slack, near = (dscale_bf16_slack(g, x, near_ulps=NEAR_ULPS) if dtype == torch.bfloat16
                   else (0.0, 0))
    (e_x, ok_x), (e_s, ok_s) = within(dx, rx, dtype), within(ds, rs, dtype, slack)
    name = str(dtype).replace("torch.", "")
    extra = ""
    if dtype == torch.bfloat16:
        extra = (f"; {near} of {x.numel()} elements within {NEAR_ULPS} f32 ulps of a "
                 f"bf16 midpoint, slack <= {float(torch.as_tensor(slack).max()):.3e}")
    print(f"  K2 bwd {name} x {tuple(shape)}: dx {e_x:.2e}, dscale {e_s:.2e} "
          f"(|dscale| <= {rs.float().abs().max().item():.1f}{extra}); repeat launch bitwise: "
          f"{same} ({'ok' if ok_x and ok_s else 'FAIL'})")
    check(ok_x and ok_s, f"rmsnorm backward {name} {tuple(shape)} disagrees")
    check(same, f"a second launch of the rmsnorm backward {name} {tuple(shape)} gave other bits")
    if dtype == torch.bfloat16 and x.numel() >= 4096 * shape[-1]:
        # The tolerance has teeth: the kernel's dscale less one row's share
        # (a dropped row) must fail it.
        xl = x.float().reshape(-1, shape[-1])[-1]
        xh = (xl * torch.rsqrt(xl.square().mean() + 1e-6)).to(dtype).float()
        dropped = (ds.float() - g.float().reshape(-1, shape[-1])[-1] * xh).to(dtype)
        _, passes = within(dropped, rs, dtype, slack)
        _, all_rows = within(dropped, rs, dtype, dscale_bf16_slack(g, x)[0])
        print(f"    dscale with one of {x.numel() // shape[-1]} rows dropped: "
              f"{'passes (FAIL)' if passes else 'rejected (ok)'}; a slack of 2^-8 |g n| "
              f"summed over every row would {'pass' if all_rows else 'reject'} it")
        check(not passes, "the bf16 dscale tolerance does not catch a dropped row")
    return max(e_x, e_s)


def check_training_kernels() -> dict:
    """K1 forward and backward over ``FLASH_SHAPES``, causal and not, and
    K2 forward and backward at the training rows, in f32 and bf16, vs
    their plain versions; returns {kernel: max |err| in bf16}."""
    from repro_torch.kernels.parity import FLASH_SHAPES

    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "rmsnorm": 0.0,
             "rmsnorm_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = [(shape, causal, 1.0) for shape in FLASH_SHAPES for causal in (True, False)]
        if bf16:
            # The training shape with scores reaching ~100: the online
            # rescale and exponentials that underflow.
            cases.append(((TRAIN_B, TRAIN_S, TRAIN_S, 32, 8, 64, 64), True, SCORE_MUL))
        for shape, causal, mul in cases:
            e_o, e_b = hold_flash(shape, causal, dtype, gen, mul)
            if bf16:
                worst["flash_attention"] = max(worst["flash_attention"], e_o)
                worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], e_b)
        for shape in RMS_BWD_SHAPES:
            e_f, e_b = hold_rms_norm(shape, dtype, gen), hold_rms_norm_bwd(shape, dtype, gen)
            if bf16:
                worst["rmsnorm"] = max(worst["rmsnorm"], e_f)
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], e_b)
    return worst


def check_loop_shapes(cfg, shapes, worst: dict) -> None:
    """K1 (causal) and K2, forward and backward, vs their plain versions in
    the model's dtype at every batch shape (B, S) the training loop ran:
    attention at (B, S, S, H, Hkv, D, D), the norms at B * S rows. Raises
    ``worst`` to the largest error seen."""
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(SEED + 4)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for B, S in shapes:
        e_o, e_b = hold_flash((B, S, S, H, Hkv, D, D), True, dtype, gen)
        rows = (B * S, cfg.d_model)
        e_f, e_r = hold_rms_norm(rows, dtype, gen), hold_rms_norm_bwd(rows, dtype, gen)
        for key, e in (("flash_attention", e_o), ("flash_attention_bwd", e_b),
                       ("rmsnorm", e_f), ("rmsnorm_bwd", e_r)):
            worst[key] = max(worst[key], e)


# ---------------------------------------------------------------------------
# Phase 8: one train step through the kernels against the plain path
# ---------------------------------------------------------------------------

def token_batch(vocab: int, n_workers: int, per_worker: int, seq: int, mask) -> dict:
    from repro_torch.data import StagedBatcher, TokenStream

    b = StagedBatcher(TokenStream(vocab, seed=SEED), n_workers=n_workers,
                      global_batch=n_workers * per_worker, seq_len=seq)
    arr = b.batch_for_stage(1.0)
    return {"inputs": torch.from_numpy(arr["inputs"]), "labels": torch.from_numpy(arr["labels"]),
            "worker_mask": torch.tensor(mask, dtype=torch.float32), "lr": 1e-3}


def step_batch(cfg, n_workers: int, per_worker: int, seq: int, mask) -> dict:
    """A worker-major train batch for ``cfg`` on the CPU: ``token_batch``'s,
    or for a frames model (hubert) ``make_frame_stream``'s frames (B, S,
    d_model) and labels from the same seed."""
    if cfg.input_kind == "tokens":
        return token_batch(cfg.vocab_size, n_workers, per_worker, seq, mask)
    from repro_torch.data import make_frame_stream

    x, labels = make_frame_stream(cfg.d_model, seed=SEED)(n_workers * per_worker, seq,
                                                            cfg.vocab_size)
    return {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels),
            "worker_mask": torch.tensor(mask, dtype=torch.float32), "lr": 1e-3}


def step_vs_plain(small, expect: dict) -> dict:
    """A model at full width cut to a few layers (``small``, f32), B 4 x
    S 64 with worker mask [1, 0, 1, 1]: one clipped SGD step through the
    kernels on the card (whose launches must equal ``expect``) and
    through the plain versions on the CPU, from the same parameters and
    batch.

    SGD first: its update is the clipped gradient, the thing the kernels
    compute. Then the loop's AdamW step from the same parameters, with
    each side's clipped gradient and update recorded. AdamW's first step
    maps a gradient g to lr * g / (|g| + eps), whose slope
    eps / (|g| + eps)^2 turns the f32 noise of two GEMM libraries into up
    to lr itself where |g| is near eps = 1e-8 (the tied head gives the
    embedding rows of absent tokens such gradients). So the AdamW updates
    are held to each other where both |g| >= 100 eps, within what the
    gradient tolerance implies through that slope, and the elements below
    it are counted and their largest difference printed."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import Optimizer, adamw, sgd
    from repro_torch.optim.optimizers import tree_step
    from repro_torch.runtime import make_train_step

    def copy(tree):
        # The step updates its parameters in place.
        return tree_map(torch.clone, tree, is_leaf=torch.is_tensor)

    model = Model(small)
    # Drawn on the card and copied: the host's f32 draw of a full-width
    # embedding took seconds.
    gpu_params = model.init(SEED, device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), gpu_params, is_leaf=torch.is_tensor)
    batch = step_batch(small, 4, 1, 64, [1.0, 0.0, 1.0, 1.0])
    batch["lr"] = 0.1
    gpu_batch = {k: v.to("cuda") if torch.is_tensor(v) else v for k, v in batch.items()}
    opt = sgd()
    step = make_train_step(model, opt)
    reset_launch_counts()
    new_gpu, _, m_gpu = step(copy(gpu_params), opt.init(gpu_params), gpu_batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    t0 = time.perf_counter()
    new_cpu, _, m_cpu = step(copy(cpu_params), opt.init(cpu_params), batch)
    cpu_s = time.perf_counter() - t0
    print(f"  launches in the kernel step: {counts} (expected {expect}; remat "
          f"{small.remat!r} runs each block's forward twice)")
    check(counts == expect, "the kernel train step did not run through every kernel")
    loss_g, loss_c = float(m_gpu["loss"]), float(m_cpu["loss"])
    gn_g, gn_c = float(m_gpu["grad_norm"]), float(m_cpu["grad_norm"])
    # f32 on both sides, sums in other orders: loss and grad norm to 1e-5
    # relative; each parameter leaf's update (old - new, the clipped
    # gradient times lr) to 1e-4 of the leaf's largest update, plus one
    # f32 rounding of the weight it is added to (|p| * 2^-23 < 2e-7 * |p|).
    worst, ok = 0.0, True
    for p0, a, b in zip(tree_leaves(cpu_params, is_leaf=torch.is_tensor),
                        tree_leaves(new_gpu, is_leaf=torch.is_tensor),
                        tree_leaves(new_cpu, is_leaf=torch.is_tensor)):
        ua, ub = p0 - a.cpu(), p0 - b
        err = (ua - ub).abs()
        worst = max(worst, err.max().item())
        ok &= bool((err <= 1e-4 * ub.abs().max() + 2e-7 * p0.abs().clamp_min(1.0)).all())
    print(f"  loss {loss_g:.7f} (card) vs {loss_c:.7f} (CPU plain, {cpu_s:.1f} s); "
          f"grad norm {gn_g:.7f} vs {gn_c:.7f}; max |update diff| {worst:.3e} "
          f"(lr {batch['lr']}) ({'ok' if ok else 'FAIL'})")
    check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), "train step loss: card vs plain")
    check(abs(gn_g - gn_c) <= 1e-5 * abs(gn_c), "train step grad norm: card vs plain")
    check(ok, "updated parameters: card vs plain")
    del new_gpu, new_cpu

    def recorded(opt):
        seen = {}

        def update(grads, state, params, lr):
            updates, state = opt.update(grads, state, params, lr)
            seen["grads"] = tree_leaves(grads, is_leaf=torch.is_tensor)
            seen["updates"] = tree_leaves(updates, is_leaf=torch.is_tensor)
            return updates, state

        return Optimizer(opt.init, update, tree_step(update)), seen

    eps, lr = 1e-8, batch["lr"]
    seen = []
    for params, b in ((gpu_params, gpu_batch), (cpu_params, batch)):
        opt, rec = recorded(adamw(eps=eps))
        make_train_step(model, opt)(copy(params), opt.init(params), b)
        seen.append(rec)
    # Gradients: 1e-4 of the leaf's largest, as the SGD check above. AdamW
    # updates where both |g| >= 100 eps: |du| / lr <= eps * dg_tol /
    # ((|g_card| + eps) (|g_cpu| + eps)), the first step's slope over the
    # gradient tolerance, plus 1e-6 for the roundings of m^ / sqrt(v^).
    g_ok = a_ok = True
    worst_g = worst_in = worst_below = 0.0
    n_in = n_below = 0
    below = []
    for ga, gb, ua, ub in zip(seen[0]["grads"], seen[1]["grads"], seen[0]["updates"],
                              seen[1]["updates"]):
        ga, ua, gb, ub = ga.cpu().float(), ua.cpu().float(), gb.float(), ub.float()
        dg_tol = 1e-4 * gb.abs().max().item()
        dg = (ga - gb).abs()
        worst_g = max(worst_g, dg.max().item())
        g_ok &= bool((dg <= dg_tol).all())
        du = (ua - ub).abs() / lr
        big = torch.minimum(ga.abs(), gb.abs()) >= 100 * eps
        bound = eps * dg_tol / ((ga.abs() + eps) * (gb.abs() + eps)) + 1e-6
        a_ok &= bool((du[big] <= bound[big]).all())
        n_in += int(big.sum())
        if big.any():
            worst_in = max(worst_in, du[big].max().item())
        if not big.all():
            k = int((~big).sum())
            n_below += k
            worst_below = max(worst_below, du[~big].max().item())
            below.append((tuple(ga.shape), k, du[~big].max().item()))
    print(f"  AdamW step (eps {eps}): max |grad diff| {worst_g:.3e} "
          f"({'ok' if g_ok else 'FAIL'}); {n_in} elements with |g| >= {100 * eps:g}: max "
          f"|update diff| {worst_in:.3e} lr ({'ok' if a_ok else 'FAIL'}); {n_below} below: "
          f"max |update diff| {worst_below:.3e} lr")
    for shape, k, d in sorted(below, key=lambda r: -r[1])[:4]:
        print(f"      leaf {shape}: {k} elements with |g| < {100 * eps:g}, max |update "
              f"diff| {d:.3e} lr")
    check(g_ok, "AdamW step gradients: card vs plain")
    check(a_ok, "AdamW step updates where |g| >= 100 eps: card vs plain")
    return {"loss": [loss_g, loss_c], "grad_norm": [gn_g, gn_c], "max_update_diff": worst,
            "adamw": {"max_grad_diff": worst_g, "elements_at_or_above_100eps": n_in,
                      "max_update_diff_over_lr": worst_in, "elements_below_100eps": n_below,
                      "max_update_diff_over_lr_below": worst_below}}


# ---------------------------------------------------------------------------
# Phase 9: the training loop at full width
# ---------------------------------------------------------------------------

def per_step_launches(cfg) -> dict:
    """Kernel launches of one train step, from the model's structure. Under
    remat every checkpointed block runs its forward twice (once more in
    the backward pass) and its backward once.

    Dense: each block runs K1 and its K2 norms (``k2_per_call``); an MLA
    block and an xLSTM block run only their K2 norms (MLA attends in plain
    PyTorch). Hybrid: each Mamba2 layer runs K5 and two K2 norms (its
    pre-norm and its gated norm), each shared call K1 and two K2 norms.
    Plus the final norm, and DeepSeek's MTP block and norm, which run
    once (the reference does not rematerialise them). Selective remat
    recomputes K1 and K2 like full remat: neither is a saved product."""
    from repro_torch.kernels.parity import k2_per_call

    r = 1 if cfg.remat == "none" else 2
    L = cfg.n_layers
    counts = dict.fromkeys(("decode_attention", "paged_decode_attention", "ssd_scan",
                            "ssd_scan_bwd"), 0)
    final = int(cfg.norm == "rmsnorm")
    once = final
    if cfg.family in ("ssm", "hybrid"):
        calls = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        norms = 2 * L + 2 * calls
        counts.update(flash_attention=r * calls, flash_attention_bwd=calls,
                      ssd_scan=r * L, ssd_scan_bwd=L)
    else:
        norms = k2_per_call(cfg) - final
        flash = 0 if cfg.mla is not None or cfg.family == "xlstm" else L
        counts.update(flash_attention=r * flash, flash_attention_bwd=flash)
        if cfg.mtp:
            # One block's norms and the MTP norm: a one-layer stack's count.
            once += k2_per_call(dataclasses.replace(cfg, n_layers=1))
    counts.update(rmsnorm=r * norms + once, rmsnorm_bwd=norms + once)
    return counts


def train_full_width(model, steps: int, global_batch: int = TRAIN_B,
                     loss_falls: bool = True, optimizer=None, lr: float = 3e-4,
                     params=None) -> dict:
    """The adaptive-(k, beta) loop at full width: 8 workers, ``global_batch``
    rows of ``TRAIN_S`` tokens at beta 1, a fail at step 5 and a rejoin at
    10, ``optimizer`` (default AdamW) at ``lr``, from ``params`` (default
    the loop's own init; the loop updates them in place). Checks the
    launches per step, finite losses, the stage walk, the fleet path, the
    peak memory and, with ``loss_falls``, that the last loss is below the
    first."""
    from repro_torch.core import DiagnosticConfig, SimplifiedDelayModel, StrategyConfig
    from repro_torch.data import StagedBatcher, TokenStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw
    from repro_torch.runtime import FaultEvent, TrainLoopConfig, train

    cfg = model.cfg
    n = 8
    # A loose loss diagnostic (any plateau test passes after 4 steps of a
    # stage) so that 16 steps walk beta up the whole grid to 1.
    strategy = StrategyConfig(
        "adaptive_kbeta", n=n, s=4, k0=1, k_max=4, beta_grid=(0.25, 0.5, 0.75, 1.0),
        diagnostic=DiagnosticConfig(kind="loss", rel_tol=0.5, min_iters=4, consecutive=1),
    )
    batcher = StagedBatcher(TokenStream(cfg.vocab_size, seed=SEED), n_workers=n,
                            global_batch=global_batch, seq_len=TRAIN_S)
    events = [FaultEvent(5, "fail", 3), FaultEvent(10, "rejoin", 3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train(model, optimizer or adamw(), strategy, SimplifiedDelayModel(lambda_y=1.0, x=0.05),
                batcher, TrainLoopConfig(total_steps=steps, lr=lr, log_every=4, seed=SEED,
                                         events=events), params=params, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    per_step = per_step_launches(cfg)
    steps = len(hist)
    print(f"  {steps} steps in {wall:.1f} s; batch shapes {out['compiled_shapes']}; peak "
          f"memory {peak / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    print(f"  per step, from the model (remat {cfg.remat!r}: each checkpointed block's "
          f"forward twice, its backward once): {per_step}")
    print(f"  launches over the run: {counts}")
    for h in hist:
        print(f"    step {h['step']:2d} k={h['k']} beta={h['beta']:.2f} n={h['n_workers']} "
              f"loss {h['loss']:.4f} grad_norm {h['grad_norm']:.4f} sim_time {h['sim_time']:.3f}")
    check(counts == {k: v * steps for k, v in per_step.items()},
          f"launch counts {counts} are not {steps} x {per_step}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), "a training loss is not finite")
    if loss_falls:
        check(losses[-1] < losses[0],
              f"the last loss {losses[-1]} is not below the first {losses[0]}")
    stages = []
    for h in hist:
        if not stages or stages[-1] != (h["k"], h["beta"]):
            stages.append((h["k"], h["beta"]))
    check(len(stages) >= 2, f"only one stage visited: {stages}")
    fleet = [h["n_workers"] for h in hist]
    walk = [fleet[0]] + [b for a, b in zip(fleet, fleet[1:]) if b != a]
    check(walk == [8, 7, 8], f"fleet path {walk}, expected 8 -> 7 -> 8")
    check(peak < 0.9 * torch.cuda.get_device_properties(0).total_memory,
          f"peak memory {peak / 2**30:.1f} GiB is within 10% of the card")
    print(f"  stages {stages}; fleet {walk}")
    return {"steps": steps, "wall_s": wall, "stages": stages, "fleet": walk,
            "shapes": [tuple(s) for s in out["compiled_shapes"]],
            "launches": counts, "per_step": per_step, "peak_bytes": peak,
            "losses": losses, "params": out["params"]}


# ---------------------------------------------------------------------------
# Phase 10: training kernels' times and one profiled train step
# ---------------------------------------------------------------------------

def time_flash(B: int, S: int, H: int, Hkv: int, D: int, gen, causal: bool = True) -> dict:
    """K1 forward and backward at q (B, S, H, D), k/v (B, S, Hkv, D), bf16,
    causal or not, beside their plain versions, SDPA and their bounds
    (CUDA events, cold L2, median of 30)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain,
    )

    dev, dt = torch.device("cuda"), torch.bfloat16
    q = torch.randn((B, S, H, D), generator=gen).to(dev, dt)
    k = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dt)
    v = torch.randn((B, S, Hkv, D), generator=gen).to(dev, dt)
    do = torch.randn((B, S, H, D), generator=gen).to(dev, dt)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    pairs = S * (S + 1) // 2 if causal else S * S   # (query, key) pairs per head
    fwd_flops = 4 * B * H * pairs * D            # QK^T and PV, 2 flops per MAC
    qkv = (q.numel() + k.numel() + v.numel()) * 2
    out = {}
    b, kind = bound(qkv + o.numel() * 2 + lse.numel() * 4, fwd_flops, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = Hkv != H

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=gqa)

    shape = (f"q ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {Hkv}, {D}) bf16, "
             f"{'causal' if causal else 'non-causal'}")
    out["flash_attention"] = dict(
        shape=shape,
        ms=time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal), n=30),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, causal=causal), n=30),
        library_ms=time_ms(sdpa, n=30), bound_ms=b, bound_by=kind,
        flops=fwd_flops,
    )
    # Backward: S, dP, dV, dK, dQ are five products against the forward's two.
    bwd_flops = fwd_flops * 5 // 2
    b, kind = bound(qkv + 2 * o.numel() * 2 + lse.numel() * 4 + qkv, bwd_flops, BF16_FLOPS)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (qt, kt, vt))

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, enable_gqa=gqa)
        y.backward(do.transpose(1, 2))

    lib_fb = time_ms(sdpa_fwd_bwd, n=30)
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                                           enable_gqa=gqa), n=30)
    out["flash_attention_bwd"] = dict(
        shape=shape + ", with dO",
        ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal), n=30),
        plain_ms=time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                           causal=causal), n=30),
        library_ms=lib_fb - lib_f, bound_ms=b, bound_by=kind, flops=bwd_flops,
    )
    return out


def print_times(out: dict) -> None:
    for name, r in out.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s" if "flops" in r else ""))


def time_rmsnorm(rows: int, D: int, gen) -> dict:
    """K2 forward and backward at x, g (rows, D) bf16 beside their plain
    versions, ``F.rms_norm`` (forward; forward and backward less forward)
    and their bounds (CUDA events, cold L2, median of 30)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rms_norm, rms_norm_bwd, rms_norm_bwd_plain, rms_norm_plain

    dev, dt = torch.device("cuda"), torch.bfloat16
    x = torch.randn((rows, D), generator=gen).to(dev, dt)
    g = torch.randn((rows, D), generator=gen).to(dev, dt)
    scale = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    xr, sr = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)

    def lib_rms_fb():
        F.rms_norm(xr, (D,), sr, 1e-6).backward(g)

    lib_fb = time_ms(lib_rms_fb, n=30)
    lib_f = time_ms(lambda: F.rms_norm(xr, (D,), sr, 1e-6), n=30)
    out = {}
    # x read and y written (bf16), scale read; ~4 f32 operations per element.
    b, kind = bound(2 * rows * D * 2 + D * 2, 4 * rows * D)
    out["rmsnorm"] = dict(
        shape=f"x ({rows}, {D}) bf16",
        ms=time_ms(lambda: rms_norm(x, scale), n=30),
        plain_ms=time_ms(lambda: rms_norm_plain(x, scale), n=30),
        library_ms=lib_f, bound_ms=b, bound_by=kind,
    )
    # x and g read, dx written (bf16), scale read and dscale written; ~10
    # f32 operations per element.
    b, kind = bound(3 * rows * D * 2 + 2 * D * 2, 10 * rows * D)
    out["rmsnorm_bwd"] = dict(
        shape=f"x, g ({rows}, {D}) bf16",
        ms=time_ms(lambda: rms_norm_bwd(g, x, scale), n=30),
        plain_ms=time_ms(lambda: rms_norm_bwd_plain(g, x, scale), n=30),
        library_ms=lib_fb - lib_f, bound_ms=b, bound_by=kind,
    )
    return out


def time_training_kernels(cfg) -> dict:
    """K1 and K2 at llama3.2-1b's training shape (32 x 512 tokens)."""
    gen = torch.Generator().manual_seed(SEED + 3)
    B, S = TRAIN_B, TRAIN_S
    out = time_flash(B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, gen)
    out.update(time_rmsnorm(B * S, cfg.d_model, gen))
    print_times(out)
    return out


def profile_train_step(model, params, opt=None, global_batch: int = TRAIN_B) -> dict:
    """One full-width train step at beta = 1 (8 workers x ``global_batch``
    / 8 rows x 512 tokens, worker mask of k = 4; ``opt`` default AdamW),
    timed without the profiler and then profiled over an equal step, after
    one warm-up step."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import make_train_step

    cfg = model.cfg
    opt = opt or adamw()
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = step_batch(cfg, 8, global_batch // 8, TRAIN_S,
                       [1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0])
    batch = {k: v.to("cuda") if torch.is_tensor(v) else v for k, v in batch.items()}

    def one():
        step(params, state, batch)

    one()                                     # warm-up
    res = window(f"train step, {cfg.name} full width, {global_batch} x {TRAIN_S} tokens, "
                 f"beta 1", one, one, 1, "step")
    res["tokens_per_s"] = global_batch * TRAIN_S / (res["wall_ms_per_unit"] / 1e3)
    print(f"  training throughput: {res['tokens_per_s']:.0f} tokens/s (host clock, "
          f"one step)")
    return res


# ---------------------------------------------------------------------------
# Phase 11: the SSD scan (K5) against its plain version
# ---------------------------------------------------------------------------

#: zamba2-1.2b's loop takes ``ZAMBA_STEPS`` steps of ``ZAMBA_TRAIN_B`` x 512
#: tokens at beta 1 (from 32 x 512, to fit the script's 1,200 s limit: K5,
#: K1 and K2 are held at every batch shape the loop runs, 2 now, 6 then).
ZAMBA_ARCH, ZAMBA_STEPS, ZAMBA_TRAIN_B = "zamba2-1.2b", 16, 8


def ssd_inputs(shape, dtype, gen, zamba: bool):
    """x, dt, A, B, C, dy on the card for ``shape`` (B, S, H, P, G, N,
    chunk). ``zamba``: zamba2-1.2b's initial decay, A = -e (a_log = 1) and
    dt = softplus(N(0, 1)); otherwise the reference kernel test's
    dt ~ U(0.01, 0.3), A ~ -U(0.5, 2)."""
    import torch.nn.functional as F

    B, S, H, P, G, N, _ = shape
    dev = torch.device("cuda")
    x = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    if zamba:
        dt = F.softplus(torch.randn((B, S, H), generator=gen)).to(dev)
        A = torch.full((H,), -float(np.e), device=dev)
    else:
        dt = (0.01 + 0.29 * torch.rand((B, S, H), generator=gen)).to(dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen)).to(dev)
    Bm = torch.randn((B, S, G, N), generator=gen).to(dev, dtype)
    Cm = torch.randn((B, S, G, N), generator=gen).to(dev, dtype)
    dy = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    return x, dt, A, Bm, Cm, dy


def hold_ssd(shape, dtype, gen, zamba: bool) -> tuple:
    """K5 forward (y and every chunk's state) and backward vs their plain
    versions (``parity.ssd_within``: ddt, dA, dB and dC, long sums whose
    addends may cancel, get 1e-6 of the size they were formed from), and
    a second launch of each bit for bit; (y err, max gradient err)."""
    from repro_torch.kernels import ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_fwd
    from repro_torch.kernels.parity import ssd_within
    from repro_torch.kernels.ssd_scan import _states_plain, _unlay, ssd_bwd_term_sums

    chunk = shape[-1]
    x, dt, A, Bm, Cm, dy = ssd_inputs(shape, dtype, gen, zamba)
    y, states = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    ref_y, ref_states = _states_plain(x, dt, A, Bm, Cm, chunk)
    ref_y = _unlay(ref_y, x.shape[1]).to(dtype)
    grads = ssd_scan_bwd(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    y2, states2 = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    grads2 = ssd_scan_bwd(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    same = (torch.equal(y, y2) and torch.equal(states, states2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    refs = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    terms = (None,) + ssd_bwd_term_sums(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    torch.cuda.synchronize()
    e_y, ok_y = ssd_within(y, ref_y, dtype)
    e_s, ok_s = ssd_within(states, ref_states, torch.float32)
    bwd = [ssd_within(a, b, a.dtype, t) for a, b, t in zip(grads, refs, terms)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    ok = ok_y and ok_s and finite and all(o for _, o in bwd)
    name = str(dtype).replace("torch.", "")
    print(f"  K5 {name} B,S,H,P,G,N,chunk={shape}{' zamba decay' if zamba else ''}: y "
          f"{e_y:.2e}, states {e_s:.2e}, dx/ddt/dA/dB/dC "
          f"{' / '.join(f'{e:.2e}' for e, _ in bwd)}; repeat launches bitwise: {same} "
          f"({'ok' if ok else 'FAIL'})")
    check(ok, f"ssd scan {name} {shape} disagrees with its plain version")
    check(same, f"a second launch of the ssd scan {name} {shape} gave other bits")
    return e_y, max(e for e, _ in bwd)


def check_ssd_kernels() -> dict:
    """K5 forward and backward over ``SSD_SHAPES``, at the reference test's
    decay and at zamba2's, in f32 and bf16; {kernel: max |err| in bf16}."""
    from repro_torch.kernels.parity import SSD_SHAPES

    gen = torch.Generator().manual_seed(SEED + 5)
    worst = {"ssd_scan": 0.0, "ssd_scan_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_SHAPES:
            for zamba in (False, True):
                e_f, e_b = hold_ssd(shape, dtype, gen, zamba)
                if dtype == torch.bfloat16:
                    worst["ssd_scan"] = max(worst["ssd_scan"], e_f)
                    worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e_b)
    return worst


def check_zamba_loop_shapes(cfg, shapes, worst: dict) -> None:
    """K5, K1 (the shared block's causal MHA at D 128) and K2 (at the
    Mamba and shared widths), forward and backward, vs their plain
    versions in the model's dtype at every batch shape (B, S) the zamba2
    loop ran. Raises ``worst`` to the largest error seen."""
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(SEED + 6)
    ssm = cfg.ssm
    H = ssm.expand * cfg.d_model // ssm.head_dim
    dw = 2 * cfg.d_model
    for B, S in shapes:
        e_f, e_b = hold_ssd((B, S, H, ssm.head_dim, ssm.n_groups, ssm.d_state, ssm.chunk),
                            dtype, gen, zamba=True)
        e_o, e_a = hold_flash((B, S, S, cfg.n_heads, cfg.n_heads, dw // cfg.n_heads,
                               dw // cfg.n_heads), True, dtype, gen)
        errs = [("ssd_scan", e_f), ("ssd_scan_bwd", e_b), ("flash_attention", e_o),
                ("flash_attention_bwd", e_a)]
        for width in (cfg.d_model, dw, ssm.expand * cfg.d_model):
            errs += [("rmsnorm", hold_rms_norm((B * S, width), dtype, gen)),
                     ("rmsnorm_bwd", hold_rms_norm_bwd((B * S, width), dtype, gen))]
        for key, e in errs:
            worst[key] = max(worst[key], e)


# ---------------------------------------------------------------------------
# Phase 14: the SSD scan's times
# ---------------------------------------------------------------------------

def ssd_work(shape, dtype) -> tuple:
    """(forward bytes, forward flops, backward bytes, backward flops) the
    SSD scan needs at ``shape``: each input read once and each output
    written once (x, dt, A, B, C in; y out; the backward adds dy in and
    dx, ddt, dA, dB, dC out; the states the kernel keeps for its backward
    are its own choice and not counted), and the forward's four in-chunk
    products over the causal pairs of each chunk (positions past S are not
    work), two flops per multiply-add. The backward is counted as twice
    the forward: each product's gradient is two products of its size."""
    B, S, H, P, G, N, chunk = shape
    es = torch.tensor([], dtype=dtype).element_size()
    Q = min(chunk, S)
    flops = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        pairs = q * (q + 1) // 2
        flops += 2 * (pairs * N + pairs * P + 2 * q * P * N)
    flops *= B * H
    xb, dtb, bcb = B * S * H * P * es, B * S * H * 4, 2 * B * S * G * N * es
    fwd_bytes = 2 * xb + dtb + H * 4 + bcb
    bwd_bytes = 3 * xb + 2 * dtb + 2 * H * 4 + 2 * bcb
    return fwd_bytes, flops, bwd_bytes, 2 * flops


def ssd_mma_issued(shape) -> tuple:
    """(forward, backward) flops of the m16n8k16 products the bf16 kernels
    issue at ``shape`` (4096 flops each, two per multiply-add), counted from
    their loops in ``csrc/ssd_scan.cu``: per (b, h, chunk) with NB 16-row
    tiles and NB (NB + 1) / 2 causal 16 x 16 tiles, a product with an f32
    operand (hi and lo) counting twice and whole diagonal tiles counted.
    The work ``ssd_work`` counts is the part of this the scan needs."""
    B, S, H, P, G, N, chunk = shape
    NB = (min(chunk, 128) + 15) // 16
    tiles, slab = NB * (NB + 1) // 2, (P // 16) * (N // 8) * NB * 2
    state = NB * (P // 16) * (N // 8) * 2           # 16 rows against an f32 state
    fwd = state + tiles * (N // 16 * 2 + P // 16 * 4) + slab
    bwd = (3 * state + tiles * (N // 16 * 2 + P // 16 * 2 + N // 16 * 4)
           + tiles * (N // 16 * 2 + P // 16 * 4) + tiles * (P // 16 * 2 + N // 16 * 4) + slab)
    n = B * H * -(-S // chunk) * 4096
    return fwd * n, bwd * n


def time_ssd_kernels(cfg) -> dict:
    """K5 forward and backward at zamba2-1.2b's training shape (32 x 512
    tokens, bf16) beside their plain versions and bounds. No PyTorch call
    computes the SSD scan, so there is no library time."""
    from repro_torch.kernels import ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_fwd
    from repro_torch.kernels.ssd_scan import _states_plain

    ssm = cfg.ssm
    H = ssm.expand * cfg.d_model // ssm.head_dim
    shape = (TRAIN_B, TRAIN_S, H, ssm.head_dim, ssm.n_groups, ssm.d_state, ssm.chunk)
    dt_ = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 7)
    x, dt, A, Bm, Cm, dy = ssd_inputs(shape, dt_, gen, zamba=True)
    chunk = ssm.chunk
    _, states = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    fb, ff, bb, bf = ssd_work(shape, dt_)
    issued = ssd_mma_issued(shape)
    desc = (f"x ({TRAIN_B}, {TRAIN_S}, {H}, {ssm.head_dim}), B/C ({TRAIN_B}, {TRAIN_S}, "
            f"{ssm.n_groups}, {ssm.d_state}) bf16, chunk {chunk}")
    out = {}
    b, kind = bound(fb, ff, BF16_FLOPS)
    out["ssd_scan"] = dict(
        shape=desc, ms=time_ms(lambda: ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk), n=30),
        plain_ms=time_ms(lambda: _states_plain(x, dt, A, Bm, Cm, chunk), n=30),
        library_ms=None, bound_ms=b, bound_by=kind, flops=ff, bytes=fb, issued_flops=issued[0],
    )
    b, kind = bound(bb, bf, BF16_FLOPS)
    out["ssd_scan_bwd"] = dict(
        shape=desc + ", with dy",
        ms=time_ms(lambda: ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, chunk=chunk), n=30),
        plain_ms=time_ms(lambda: ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, dy,
                                                    chunk=chunk), n=30),
        library_ms=None, bound_ms=b, bound_by=kind, flops=bf, bytes=bb, issued_flops=issued[1],
    )
    for name, r in out.items():
        print(f"  {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library none (no PyTorch call computes the SSD scan), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, "
              f"{r['flops'] / 1e9:.1f} GFLOP); {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s; "
              f"issued mma {r['issued_flops'] / 1e9:.1f} GFLOP, "
              f"{r['issued_flops'] / r['ms'] / 1e9:.1f} TFLOP/s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: serve zamba2-1.2b through both pools
# ---------------------------------------------------------------------------

#: zamba2-1.2b serving: 4 slots of 512 rows, 64-token prefill chunks (a
#: prompt over 64 tokens continues a prefilled state), 5 requests of
#: 16-96 prompt and 8-32 new tokens (the fifth re-uses a freed slot); the
#: scanned prefill costs one decode step a prompt token, so the traffic
#: is smaller than llama's (cut from 6 requests of 16-128 to fit the
#: script's time limit).
Z_SLOTS, Z_MAX_LEN, Z_CHUNK, Z_REQUESTS = 4, 512, 64, 5
#: Phases 15-17 serve zamba2-1.2b at full width cut to ``Z_SERVE_LAYERS``
#: Mamba2 layers and so 2 shared calls (from 38 and 6): a decode step is
#: host-bound, its time goes with its launches, and the script at full
#: depth ran past its 1,200 s limit on an H100.
Z_SERVE_LAYERS = 12


def zamba_workload(vocab: int, n: int = Z_REQUESTS, prompt=(16, 97), new=(8, 33),
                   seed: int = SEED + 10, gap: float = 0.02):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = int(rng.integers(*prompt))
        m = int(rng.integers(*new))
        reqs.append((rng.integers(0, vocab, size=p).astype(np.int32), m, i * gap))
    return reqs


def hybrid_step_launches(cfg, steps: int, paged: bool) -> dict:
    """Kernel launches of ``steps`` hybrid decode steps (ticks, or prompt
    tokens of the scanned prefill): per step K2 once per norm (a pre-norm
    and a gated norm per Mamba2 layer, two per shared call, the final
    norm) and K3 (contiguous) or K4 (paged) once per shared call; no
    other kernel."""
    from repro_torch.kernels import KERNELS

    calls = cfg.n_layers // cfg.attn_every
    counts = dict.fromkeys(KERNELS, 0)
    counts["rmsnorm"] = (2 * cfg.n_layers + 2 * calls + 1) * steps
    counts["paged_decode_attention" if paged else "decode_attention"] = calls * steps
    return counts


def zamba_decode_vs_plain(zcfg) -> dict:
    """zamba2-1.2b at full width cut to 2 Mamba2 layers and one shared
    call, f32, over each pool: one right-padded prefill chunk into blank
    caches (4 rows of 16, 9, 12 and 5 tokens), then 4 decode ticks with
    lane 2 masked off (its position stays), through the kernels on the
    card (whose launches must be ``hybrid_step_launches``) and through the
    plain versions on the CPU, from the same parameters (the LoRA
    up-projections drawn at random, not zeros) and tokens. The chunk's and
    every tick's logits, every recurrent state and each shared-call K/V
    row below its row's length are held by ``parity.within`` (f32)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.parity import within
    from repro_torch.models import Model
    from repro_torch.models.attention import paged_kv_view
    from repro_torch.models.layers import tree_map

    small = dataclasses.replace(zcfg, n_layers=2, attn_every=2, dtype="float32")
    model = Model(small)
    cpu_params = model.init(SEED, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 12)
    shared = cpu_params["stack"]["shared"]
    for name in ("lora_qkv_b", "lora_mlp_b"):
        shared[name] = 0.05 * torch.randn(shared[name].shape, generator=gen)
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params, is_leaf=torch.is_tensor)
    B, P, rows, bs, n_ticks = 4, 16, 64, 16, 4
    lens = torch.tensor([16, 9, 12, 5])
    lanes = torch.tensor([True, True, False, True])
    V = small.vocab_size
    chunk = torch.randint(0, V, (B, P), generator=gen)
    chunk[torch.arange(P)[None, :] >= lens[:, None]] = 0          # the bucket's padding
    ticks = torch.randint(0, V, (n_ticks, B, 1), generator=gen)
    tables = (torch.randperm(B * rows // bs, generator=gen) + 1).reshape(B, -1).int()
    steps = int(lens.max()) + n_ticks
    out, ok = {}, True
    for pool, paged in (("contiguous", False), ("paged", True)):
        kw = dict(block_size=bs, num_blocks=B * rows // bs) if paged else {}
        res = {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            caches = model.blank_caches(B, rows, device=dev, **kw)
            tt = tables.to(dev) if paged else None
            reset_launch_counts()
            t0 = time.perf_counter()
            lg, caches = model.prefill_with_cache(params, chunk.to(dev), caches,
                                                  length=lens.to(dev), start_index=0,
                                                  block_tables=tt)
            logits, pos = [lg], lens.clone()
            for t in range(n_ticks):
                lg, caches = model.decode_step(params, ticks[t].to(dev), caches, pos.to(dev),
                                               block_tables=tt, mask=lanes.to(dev))
                logits.append(lg)
                pos = pos + lanes.long()
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = launch_counts()
            res[dev] = (logits, caches, time.perf_counter() - t0)
        expect = hybrid_step_launches(small, steps, paged)
        check(counts == expect, f"{pool}: launches {counts}, expected {expect}")
        (lg_g, c_g, s_g), (lg_c, c_c, s_c) = res["cuda"], res["cpu"]
        errs = {"logits": max(within(a.cpu(), b, torch.float32)[0] for a, b in zip(lg_g, lg_c))}
        ok &= all(within(a.cpu(), b, torch.float32)[1] for a, b in zip(lg_g, lg_c))
        for name in ("conv", "ssm"):
            e, o = within(c_g["mamba"][name].cpu(), c_c["mamba"][name], torch.float32)
            errs[name] = e
            ok &= o
        for name in ("k", "v"):
            e_max = 0.0
            for call in range(c_c["attn"][name].shape[0]):
                g, c = c_g["attn"][name][call].cpu(), c_c["attn"][name][call]
                if paged:
                    g, c = paged_kv_view(g, tables), paged_kv_view(c, tables)
                for b in range(B):
                    e, o = within(g[b, :pos[b]], c[b, :pos[b]], torch.float32)
                    e_max = max(e_max, e)
                    ok &= o
            errs[name] = e_max
        print(f"  {pool}: {steps} decode steps ({int(lens.max())} of the scanned chunk, "
              f"{n_ticks} ticks with lane 2 masked), card {s_g:.2f} s vs CPU plain {s_c:.2f} s; "
              f"max |err|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; launches {dict((k, v) for k, v in counts.items() if v)} "
              f"({'ok' if ok else 'FAIL'})")
        out[pool] = {"max_abs_err": errs, "launches": counts, "steps": steps}
    check(ok, "the cut-down zamba2 decode: card vs plain on the CPU")
    return out


def serve_zamba(model, params) -> tuple:
    """zamba2-1.2b through ``ServeEngine`` over each pool: the launches of
    every decode step, well-formed streams, every stream position held to
    teacher-forced offline decode (``check_streams``), and the pool's
    recurrent-state and KV bytes."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    reqs = zamba_workload(cfg.vocab_size)
    runs = {}
    for pool, block_size in (("contiguous", None), ("paged", BLOCK_SIZE)):
        eng = ServeEngine(model, params, n_slots=Z_SLOTS, max_len=Z_MAX_LEN,
                          block_size=block_size,
                          scheduler=Scheduler(Z_SLOTS, prefill_chunk=Z_CHUNK))
        rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
        torch.cuda.synchronize()
        reset_launch_counts()
        results = eng.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        st = eng.stats
        steps = st.decode_ticks + st.prefill_tokens
        expect = hybrid_step_launches(cfg, steps, block_size is not None)
        mem = {"state_bytes_per_slot": eng.pool.state_bytes_per_slot(),
               "kv_bytes_high_water": eng.pool.kv_bytes_high_water(),
               "kv_bytes_contiguous": eng.pool.kv_bytes_contiguous()}
        print(f"  {pool}: {st.prefill_calls} prefill calls ({st.prefill_tokens} prompt tokens, "
              f"one decode step each), {st.decode_ticks} decode ticks, {st.generated_tokens} "
              f"tokens in {st.wall_seconds:.2f} s; decode {st.decode_tokens_per_wsec:.1f} "
              f"tokens/s; recurrent state {mem['state_bytes_per_slot'] / 2**20:.2f} MiB a slot; "
              f"KV high-water {mem['kv_bytes_high_water'] / 2**20:.2f} MiB of "
              f"{mem['kv_bytes_contiguous'] / 2**20:.2f} MiB contiguous; launches "
              f"{dict((k, v) for k, v in counts.items() if v)} over {steps} steps")
        check(counts == expect, f"{pool}: launches {counts}, expected {expect}")
        for rid, (p, m, _) in zip(rids, reqs):
            toks = results[rid].tokens
            check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{pool}: request {rid} produced a malformed stream")
        runs[pool] = {"tokens": [results[r].tokens for r in rids], "stats": st,
                      "launches": counts, "steps": steps, **mem}
    streams = check_streams(model, params, reqs, runs, Z_MAX_LEN)
    return runs, streams


#: The profiled zamba2 windows: ticks (after a warm-up of half as many)
#: and the prompt of the scanned prefill. Kept short: a zamba2 step is
#: ~2100 launches, and reading a window's profiler events takes longer
#: than running it.
Z_PROFILE_TICKS, Z_PROFILE_PROMPT = 6, 16


def profile_zamba_serving(model, params) -> list:
    """A steady window of ``Z_PROFILE_TICKS`` decode ticks of 4 lanes
    (prompts of 16-32 tokens) over each pool, and the scanned prefill of
    a ``Z_PROFILE_PROMPT``-token prompt, per token, after a warm-up
    prompt: host wall time, device time, idle share, launches, and device
    time by kernel class."""
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 13)
    results = []

    def engine(block_size):
        return ServeEngine(model, params, n_slots=Z_SLOTS, max_len=Z_MAX_LEN,
                           block_size=block_size,
                           scheduler=Scheduler(Z_SLOTS, prefill_chunk=Z_CHUNK))

    for pool, bsz in (("contiguous", None), ("paged", BLOCK_SIZE)):
        eng = engine(bsz)
        for _ in range(Z_SLOTS):
            eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(16, 33))), 100)
        while not eng._decoding.all():        # admit and prefill all lanes
            eng.step()

        def ticks(n, eng=eng):
            for _ in range(n):
                eng.step()

        n = Z_PROFILE_TICKS
        ticks(n // 2)                         # warm-up
        results.append(window(f"zamba2 decode tick, {pool} pool, 4 lanes",
                              lambda: ticks(n), lambda: ticks(n), n, "tick"))

    def prefill_fresh():
        eng = engine(None)
        eng.submit(rng.integers(0, cfg.vocab_size, size=Z_PROFILE_PROMPT), 2)
        return eng

    def prefill_all(eng):
        while eng.sched.running or eng.sched.waiting:
            eng.step()

    prefill_all(prefill_fresh())              # warm-up
    a, b = prefill_fresh(), prefill_fresh()
    results.append(window(f"zamba2 scanned prefill, {Z_PROFILE_PROMPT}-token prompt, per "
                          "prompt token", lambda: prefill_all(a), lambda: prefill_all(b),
                          Z_PROFILE_PROMPT, "token"))
    return results


def time_zamba_kernels(cfg, reqs) -> dict:
    """K3 and K4 at the zamba2 tick's shape (4 lanes of 512 rows, 32 heads
    over 32 kv heads, D 128; each lane at its prompt length plus half its
    new tokens) and K2 at the tick's 4 rows of 4096, beside their plain
    versions, a library call and their bounds."""
    gen = torch.Generator().manual_seed(SEED + 14)
    lens = [len(p) + m // 2 for p, m, _ in reqs[:Z_SLOTS]]
    hd = 2 * cfg.d_model // cfg.n_heads
    out = time_decode(Z_SLOTS, Z_MAX_LEN, cfg.n_heads, cfg.n_heads, hd, lens, gen)
    out["rmsnorm"] = time_rmsnorm_rows(Z_SLOTS, 2 * cfg.d_model, gen)
    print_kernel_times(out)
    return out


# ---------------------------------------------------------------------------
# Phase 16: speculative serving (draft, then verify)
# ---------------------------------------------------------------------------

#: llama3.2-1b speculation: phase 4's traffic, draft length up to 6, and a
#: draft made of the target's weights plus noise of 3e-4 (f32 draws from a
#: seeded generator on the card, cast back to bf16); and, on the
#: contiguous pool, a poor draft (noise 2e-2, about the weights' own
#: scale) whose rejections make the controller fall back to gamma = 0
#: rounds (a target tick and a draft tick), probing gamma = 1 every 16
#: rounds. zamba2-1.2b: 3
#: requests of 16-32 prompt and 8-16 new tokens, 4 slots of 512 rows,
#: 64-token chunks, draft length up to 3 (its verify and replay scan the
#: decode step, so a round costs 2 (1 + gamma) + gamma decode steps), all
#: arriving at once so that rounds speculate on several lanes.
SPEC_GAMMA, SPEC_NOISE, SPEC_POOR = 6, 3e-4, 2e-2
#: Both speculative workloads are cut to fit the script's time limit:
#: llama3.2-1b serves the first 5 of phase 4's 8 requests (one still
#: waits for a freed slot; the noisy and the perfect draft over both
#: pools, the poor draft over the contiguous one; from 8, then 6),
#: zamba2-1.2b 2 requests (from 3).
SPEC_REQUESTS = 5
Z_SPEC_GAMMA, Z_SPEC_REQUESTS = 3, 2


def noisy_params(params, noise: float, seed: int, only=None):
    """The parameters plus ``noise`` times standard normals drawn in f32 from
    a seeded generator on their device, each leaf cast back to its dtype.
    ``only``: the names (dict keys) of the leaves to perturb; the others
    are passed through as they are."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        if only is not None and key not in only:
            return t
        return (t.float() + noise * torch.randn(t.shape, generator=gen,
                                                device=t.device)).to(t.dtype)

    return walk(params, None)


def cut_for_parity(cfg):
    """The 2-layer f32 cut of a full-width config (the hybrid: 2 Mamba2
    layers and one shared call)."""
    if cfg.family in ("ssm", "hybrid"):
        return dataclasses.replace(cfg, n_layers=2, attn_every=2, dtype="float32")
    return dataclasses.replace(cfg, n_layers=2, dtype="float32")


def step_launches(cfg, paged: bool, steps: int = 1) -> dict:
    """Kernel launches of one call over an attention stack (a prefill
    chunk, a tick, a verify: K2 once a norm; a GQA tick also K3 or K4 once
    a layer; MLA attends in plain PyTorch), of ``steps`` hybrid decode
    steps (``hybrid_step_launches``) or of ``steps`` xLSTM decode steps (K2
    once a norm a step, nothing else). Returns the tick's; callers drop
    the attention for a prefill or verify."""
    if cfg.family in ("ssm", "hybrid"):
        return hybrid_step_launches(cfg, steps, paged)
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.parity import k2_per_call

    counts = dict.fromkeys(KERNELS, 0)
    if cfg.family == "xlstm":
        counts["rmsnorm"] = k2_per_call(cfg) * steps
        return counts
    counts["rmsnorm"] = k2_per_call(cfg)
    if cfg.mla is None:
        counts["paged_decode_attention" if paged else "decode_attention"] = cfg.n_layers
    return counts


def verify_vs_plain(cfg, device: str = "cuda") -> dict:
    """``verify_with_cache`` and the replay step of the 2-layer f32 cut of
    ``cfg`` through the kernels on the card against the plain versions on
    the CPU, from the same parameters (the hybrid's LoRA up-projections
    drawn at random), over each pool (paged: every block allocated, in a
    shuffled order): 4 lanes prefilled with 16, 9, 12 and 5 tokens, then
    one window of S = 4 at per-row starts with n_input 0, 1, 4 and 4, lane
    2 accepting two draft tokens then rejecting, lane 3 rejecting at once.
    Held by ``parity.within`` (f32): the logits at every position, the
    recurrent states and each lane's K/V rows below its committed
    position, after the verify and after the replay of the committed
    tokens. The verify's launches: dense, K2 once a norm and no K3/K4;
    the hybrid, ``hybrid_step_launches`` for S steps."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.parity import within
    from repro_torch.models import Model
    from repro_torch.models.attention import paged_kv_view
    from repro_torch.models.layers import tree_map

    small = cut_for_parity(cfg)
    hybrid = small.family in ("ssm", "hybrid")
    model = Model(small)
    cpu_params = model.init(SEED, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 21)
    if hybrid:
        shared = cpu_params["stack"]["shared"]
        for name in ("lora_qkv_b", "lora_mlp_b"):
            shared[name] = 0.05 * torch.randn(shared[name].shape, generator=gen)
    gpu_params = tree_map(lambda t: t.to(device), cpu_params, is_leaf=torch.is_tensor)
    B, P, S, rows, bs = 4, 16, 4, 64, 16
    lens = torch.tensor([16, 9, 12, 5])
    n_input = torch.tensor([0, 1, 4, 4])
    V = small.vocab_size
    chunk = torch.randint(0, V, (B, P), generator=gen)
    chunk[torch.arange(P)[None, :] >= lens[:, None]] = 0
    inputs = torch.randint(0, V, (B, S), generator=gen)
    tables = (torch.randperm(B * rows // bs, generator=gen) + 1).reshape(B, -1).int()

    def prefilled(dev, params, paged):
        kw = dict(block_size=bs, num_blocks=B * rows // bs) if paged else {}
        caches = model.blank_caches(B, rows, device=dev, **kw)
        tt = tables.to(dev) if paged else None
        _, caches = model.prefill_with_cache(params, chunk.to(dev), caches,
                                             length=lens.to(dev), start_index=0,
                                             block_tables=tt)
        return caches, tt

    # Lane 2 takes the CPU's own greedy tokens as its first two drafts.
    for t in range(2):
        caches, _ = prefilled("cpu", cpu_params, False)
        logits, _ = model.verify_with_cache(cpu_params, inputs, caches, n_input, lens)
        inputs[2, t + 1] = int(torch.argmax(logits[2, t]))
    out, ok = {}, True
    for pool, paged in (("contiguous", False), ("paged", True)):
        res = {}
        for dev, params in ((device, gpu_params), ("cpu", cpu_params)):
            caches, tt = prefilled(dev, params, paged)
            reset_launch_counts()
            logits, caches = model.verify_with_cache(params, inputs.to(dev), caches,
                                                     n_input.to(dev), lens.to(dev), tt)
            counts = launch_counts() if params is gpu_params else None
            greedy = torch.argmax(logits, -1).cpu()
            acc = []
            for b in range(B):
                a = 0
                while a < int(n_input[b]) - 1 and int(greedy[b, a]) == int(inputs[b, a + 1]):
                    a += 1
                acc.append(a)
            commit = torch.where(n_input > 0, torch.tensor(acc) + 1, 0) if hybrid else n_input
            replayed, _ = prefilled(dev, params, paged)
            replayed = model.verify_with_cache(params, inputs.to(dev), replayed,
                                               commit.to(dev), lens.to(dev), tt,
                                               greedy_commit=False)[1]
            res[params is gpu_params] = (logits, caches, replayed, acc, commit, counts)
        (lg_g, c_g, r_g, acc_g, commit, counts), (lg_c, c_c, r_c, acc_c, _, _) = \
            res[True], res[False]
        expect = step_launches(small, paged, S)
        if not hybrid:
            expect["paged_decode_attention" if paged else "decode_attention"] = 0
        check(counts == expect, f"{small.family} {pool} verify: launches {counts}, "
                                f"expected {expect}")
        check(acc_g == acc_c == [0, 0, 2, 0],
              f"{pool}: accepted drafts {acc_g} (card) / {acc_c} (CPU), expected [0, 0, 2, 0]")
        errs = {"logits": within(lg_g.cpu(), lg_c, torch.float32)[0]}
        ok &= within(lg_g.cpu(), lg_c, torch.float32)[1]
        for label, got, want in (("verify", c_g, c_c), ("replay", r_g, r_c)):
            if hybrid:
                for name in ("conv", "ssm"):
                    e, o = within(got["mamba"][name].cpu(), want["mamba"][name], torch.float32)
                    errs[f"{label} {name}"] = e
                    ok &= o
                pairs = [(got["attn"][n][c].cpu(), want["attn"][n][c])
                         for n in ("k", "v") for c in range(want["attn"][n].shape[0])]
            else:
                pairs = [(g[n].cpu(), w[n]) for sg, sw in zip(got, want)
                         for g, w in zip(sg, sw) for n in ("k", "v")]
            e_max = 0.0
            for g, w in pairs:
                if paged:
                    g, w = paged_kv_view(g, tables), paged_kv_view(w, tables)
                for b in range(B):
                    upto = int(lens[b] + commit[b])
                    e, o = within(g[b, :upto], w[b, :upto], torch.float32)
                    e_max = max(e_max, e)
                    ok &= o
            errs[f"{label} K/V"] = e_max
        print(f"  {small.family}, {pool}: S {S}, n_input {n_input.tolist()}, accepted "
              f"{acc_g}; max |err|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; verify launches {dict((k, v) for k, v in counts.items() if v)} "
              f"({'ok' if ok else 'FAIL'})")
        out[pool] = {"max_abs_err": errs, "launches": counts, "accepted": acc_g}
    check(ok, f"the cut-down {small.family} verify: card vs plain on the CPU")
    return out


class CallProbe:
    """Wraps the step functions of each engine (and of its draft, if it has
    one) to record each call's kind, its decode steps (a window's S, a
    hybrid prefill's tokens; else 1) and the kernels it launched; each
    speculative round is marked. Reading the host-side counters adds no
    device work."""

    KINDS = {"_prefill": "prefill", "_decode": "tick", "_verify": "verify"}
    DRAFT_KINDS = {"_prefill": "draft prefill", "_decode": "draft", "_replay": "replay"}

    def __init__(self, *engines):
        self.calls = []
        for eng in engines:
            for attr, kind in self.KINDS.items():
                self._wrap(eng, attr, kind)
            if eng.draft is None:
                continue
            for attr, kind in self.DRAFT_KINDS.items():
                self._wrap(eng.draft, attr, kind)
            self._mark_rounds(eng)

    def _mark_rounds(self, eng):
        do_round = eng._do_spec_round

        def marked():
            self.calls.append(("round", 0, {}))
            do_round()
            self.calls.append(("end", 0, {}))
        eng._do_spec_round = marked

    def _wrap(self, obj, attr, kind):
        from repro_torch.kernels import launch_counts

        fn = getattr(obj, attr)

        def probed(*args, **kw):
            before = launch_counts()
            out = fn(*args, **kw)
            after = launch_counts()
            if kind in ("prefill", "draft prefill"):
                steps = int(args[3][0])
            elif kind in ("verify", "replay"):
                steps = args[1].shape[1]
            else:
                steps = 1
            self.calls.append((kind, steps, {k: after[k] - before[k] for k in after
                                             if after[k] != before[k]}))
            return out
        setattr(obj, attr, probed)

    def rounds(self):
        """The calls of each round, in order."""
        out, inside = [], False
        for kind, steps, launched in self.calls:
            if kind in ("round", "end"):
                inside = kind == "round"
                if inside:
                    out.append([])
            elif inside:
                out[-1].append((kind, steps, launched))
        return out


def check_spec_launches(cfg, probe: CallProbe, counts: dict, paged: bool, label: str) -> dict:
    """Every probed call launched what its kind should (a dense prefill K2
    once a norm; a dense tick that and K3 or K4 once a layer; a hybrid
    call ``hybrid_step_launches`` for its steps), and nothing ran outside
    them; a gamma = 0 round is one target tick and at most one
    draft tick; a speculating round is draft ticks, one verify and (the
    recurrent stacks: the hybrid, xLSTM) one replay or (attention stacks)
    at most one more draft tick. Returns
    {kind: {"calls": n, "launches": {kernel: n}}}."""
    hybrid = cfg.family in ("ssm", "hybrid", "xlstm")
    total = defaultdict(int)
    per_kind = {}
    for kind, steps, launched in probe.calls:
        if kind in ("round", "end"):
            continue
        entry = per_kind.setdefault(kind, {"calls": 0, "launches": defaultdict(int)})
        entry["calls"] += 1
        for k, v in launched.items():
            entry["launches"][k] += v
        on_target = kind in ("prefill", "tick", "verify")
        expect = step_launches(cfg, paged and on_target, steps if hybrid else 1)
        if not hybrid and kind in ("prefill", "draft prefill", "verify"):
            expect = dict(expect, decode_attention=0, paged_decode_attention=0)
        expect = {k: v for k, v in expect.items() if v}
        check(launched == expect, f"{label}: a {kind} call ({steps} steps) launched "
                                  f"{launched}, expected {expect}")
        for k, v in launched.items():
            total[k] += v
    check({k: v for k, v in counts.items() if v} == dict(total),
          f"{label}: the run launched {counts}, its calls {dict(total)}")
    for calls in probe.rounds():
        kinds = [k for k, _, _ in calls]
        if "tick" in kinds:
            check(kinds in (["tick"], ["tick", "draft"]),
                  f"{label}: a gamma = 0 round ran {kinds}")
        else:
            n = kinds.index("verify")
            tail = kinds[n + 1:]
            check(set(kinds[:n]) <= {"draft"}
                  and tail in ((["replay"],) if hybrid else ([], ["draft"])),
                  f"{label}: a speculating round ran {kinds}")
    return {k: {"calls": v["calls"], "launches": dict(v["launches"])} for k, v in per_kind.items()}


class RejectionLog:
    """Records (request id, stream index) of each position where a round
    rejected a draft token: the token the verify emitted there in place
    of the draft's."""

    def __init__(self, eng):
        self.positions = []
        self.offered = self.accepted = 0
        observe, emit = eng.spec.observe, eng._emit
        state = []

        def observed(a, offered):
            observe(a, offered)
            self.offered += offered
            self.accepted += a
            state[:] = [a, offered, a + 1]

        def emitted(req, tok):
            emit(req, tok)
            if state and state[2] > 0:
                state[2] -= 1
                if state[2] == 0 and state[0] < state[1]:
                    self.positions.append((req.rid, len(req.tokens) - 1))
        eng.spec.observe, eng._emit = observed, emitted


def spec_round_state_check(eng) -> dict:
    """Wraps the engine's verify so that every call in which a lane
    speculates (n_input >= 2) is checked: the recurrent states it commits,
    and each lane's K/V rows below its committed position, against
    ``decode_step`` run token by token from a copy of the caches taken
    before the call over each lane's committed tokens (lanes past their
    count masked off). The copy's launches are not the run's: they are
    taken off the counters. Returns the result, filled in as rounds run:
    each round's n_input and commits, whether all matched bit for bit, the
    largest errors, and whether all held by ``parity.within``."""
    from repro_torch.kernels import KERNELS, launch_counts
    from repro_torch.kernels.parity import within
    from repro_torch.models.layers import tree_map

    verify, model = eng._verify, eng.model
    result = {"rounds": [], "bitwise": True, "ok": True, "max_abs_err": {}}

    def checked(params, tokens, caches, n_input, positions, tables=None):
        if int(n_input.max()) < 2:
            return verify(params, tokens, caches, n_input, positions, tables)
        before = tree_map(lambda t: t.clone(), caches, is_leaf=torch.is_tensor)
        greedy, caches = verify(params, tokens, caches, n_input, positions, tables)
        counts = launch_counts()
        g, x, ni = greedy.cpu(), tokens.cpu(), n_input.cpu()
        commit = []
        for b in range(x.shape[0]):
            a = 0
            while a < int(ni[b]) - 1 and int(g[b, a]) == int(x[b, a + 1]):
                a += 1
            commit.append(a + 1 if int(ni[b]) > 0 else 0)
        commit_t = torch.tensor(commit, device=tokens.device)
        seq = before
        for t in range(max(commit)):
            _, seq = model.decode_step(params, tokens[:, t:t + 1], seq, positions + t,
                                       block_tables=tables, mask=t < commit_t)
        for name, fn in KERNELS.items():
            fn.launches = counts[name]
        pairs = [(name, caches["mamba"][name], seq["mamba"][name]) for name in ("conv", "ssm")]
        pairs += [(name, caches["attn"][name][:, b, :int(positions[b]) + n],
                   seq["attn"][name][:, b, :int(positions[b]) + n])
                  for name in ("k", "v") for b, n in enumerate(commit) if n]
        errs = result["max_abs_err"]
        for name, got, want in pairs:
            result["bitwise"] &= bool(torch.equal(got, want))
            e, o = within(got, want, got.dtype)
            errs[name] = max(errs.get(name, 0.0), e)
            result["ok"] &= o
        result["rounds"].append({"n_input": ni.tolist(), "committed": commit})
        check(result["ok"], f"round {len(result['rounds'])}: the verify's committed state "
                            f"differs from a sequential decode_step")
        return greedy, caches

    eng._verify = checked
    return result


def serve_speculative(model, params, reqs, drafts: dict, *, n_slots: int, max_len: int,
                      chunk: int, gamma_max: int, plain_runs=None,
                      state_check: bool = False) -> dict:
    """Serve ``reqs`` through ``ServeEngine`` with each draft ({name:
    (params, pools)}) over each of its pools, probing every call's launches
    (``check_spec_launches``) and logging rejected drafts; then every
    stream is held to teacher-forced offline decode (``check_streams``)
    and, where ``plain_runs`` (the non-speculative engine's runs, by pool)
    are given, compared with the same pool's. With the "perfect" draft
    (the target's own weights) every rejection must sit at a near-tie of
    offline decode. ``state_check``: the first run's rounds are held to
    token-by-token decode (``spec_round_state_check``)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    runs, state = {}, None
    for draft_name, (dparams, pools) in drafts.items():
        for pool in pools:
            block_size = BLOCK_SIZE if pool == "paged" else None
            label = f"{draft_name} draft, {pool}"
            eng = ServeEngine(model, params, n_slots=n_slots, max_len=max_len,
                              block_size=block_size,
                              scheduler=Scheduler(n_slots, prefill_chunk=chunk),
                              draft_model=model, draft_params=dparams, gamma_max=gamma_max)
            probe, rejected = CallProbe(eng), RejectionLog(eng)
            if state_check and state is None:
                state = spec_round_state_check(eng)
            rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
            torch.cuda.synchronize()
            reset_launch_counts()
            results = eng.run()
            torch.cuda.synchronize()
            counts = launch_counts()
            st = eng.stats
            calls = check_spec_launches(cfg, probe, counts, block_size is not None, label)
            rate = rejected.accepted / max(rejected.offered, 1)
            print(f"  {label}: {st.prefill_calls} prefill calls, {st.spec_rounds} rounds, "
                  f"{st.decode_ticks} gamma = 0 ticks, {st.draft_ticks} draft ticks, "
                  f"{rejected.accepted} / {rejected.offered} drafts accepted ({rate:.3f}), "
                  f"{st.generated_tokens} tokens in {st.wall_seconds:.2f} s; decode "
                  f"{st.decode_tokens_per_wsec:.1f} tokens/s (host clock); calls "
                  f"{dict((k, v['calls']) for k, v in calls.items())}; "
                  f"launches {dict((k, v) for k, v in counts.items() if v)}")
            for rid, (p, m, _) in zip(rids, reqs):
                toks = results[rid].tokens
                check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
                      f"{label}: request {rid} produced a malformed stream")
            check(st.spec_rounds > 0, f"{label}: no round speculated")
            runs[label] = {"pool": pool, "tokens": [results[r].tokens for r in rids], "stats": st,
                           "launches": counts, "calls": calls, "offered": rejected.offered,
                           "accepted": rejected.accepted, "rejections": rejected.positions,
                           "hist": eng.spec.hist.tolist()}
    streams = check_streams(model, params, reqs, runs, max_len)
    for label, r in runs.items():
        if plain_runs is not None:
            r["equal_to_plain"] = sum(a == b for a, b in
                                      zip(r["tokens"], plain_runs[r["pool"]]["tokens"]))
        if label.startswith("perfect"):
            margins = [OFFLINE[(cfg.name, i, tuple(r["tokens"][i]))][1][j]
                       for i, j in r["rejections"]]
            for (i, j), gap in zip(r["rejections"], margins):
                check(gap < TIE_TOL, f"{label}: request {i} rejected the target's own "
                                     f"token {j} at an offline top-2 gap {gap:.4f}")
            print(f"  {label}: {r['accepted']} of {r['offered']} offered tokens accepted; "
                  f"the {len(margins)} lane-rounds that rejected one (the rest of their "
                  f"windows unjudged) each did so at a near-tie (offline top-2 gaps "
                  f"{[round(g, 4) for g in margins]} < {TIE_TOL})")
            r["rejection_gaps"] = margins
    if plain_runs is not None:
        print("  streams equal to the non-speculative engine's on the same pool: "
              + ", ".join(f"{k} {r['equal_to_plain']} of {len(reqs)}" for k, r in runs.items()))
    if state_check:
        multi = sum(sum(n >= 2 for n in r["n_input"]) >= 2 for r in state["rounds"])
        accepted = sum(any(c >= 2 for c in r["committed"]) for r in state["rounds"])
        print(f"  {len(state['rounds'])} speculating rounds on the contiguous pool ({multi} of "
              f"them on two lanes or more, {accepted} with an accepted draft) held to "
              f"decode_step token by token: recurrent states and K/V rows bitwise "
              f"{state['bitwise']}, max |err| "
              + ", ".join(f"{k} {v:.2e}" for k, v in state["max_abs_err"].items()))
        check(multi > 0, "no round speculated on two lanes")
    return {"runs": runs, "streams": streams, "state_check": state}


def time_snapshot(model, params) -> dict:
    """The draft's snapshot at zamba2's serving pool (``Z_SLOTS`` slots of
    ``Z_MAX_LEN`` rows): a clone of every recurrent state leaf, timed as a
    kernel (CUDA events, cold L2, median of 60) beside its bound, the
    state's bytes read once and written once."""
    from repro_torch.serve import DraftRunner

    dr = DraftRunner(model, params, Z_SLOTS, Z_MAX_LEN)
    nbytes = dr.pool.state_bytes_per_slot() * Z_SLOTS
    b, kind = bound(2 * nbytes, 0)
    out = dict(shape=f"{Z_SLOTS} slots x {dr.pool.state_bytes_per_slot() / 2**20:.2f} MiB of "
                     f"recurrent state", bytes=nbytes, ms=time_ms(dr.snapshot),
               bound_ms=b, bound_by=kind)
    print(f"  draft snapshot: {out['shape']}: {out['ms']:.4f} ms, bound {b:.4f} ms ({kind})")
    return out


def profile_spec_round(model, params, dparams, n_rounds: int = 3) -> dict:
    """A steady window of ``n_rounds`` speculative rounds of 4 lanes
    (prompts of 400-600 tokens, the contiguous pool, the noisy draft),
    after a warm-up of two: host wall time, device time, idle share,
    launches, and device time by kernel class, per round."""
    from repro_torch.serve import Scheduler, ServeEngine

    rng = np.random.default_rng(SEED + 22)
    eng = ServeEngine(model, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                      scheduler=Scheduler(N_SLOTS, prefill_chunk=PREFILL_CHUNK),
                      draft_model=model, draft_params=dparams, gamma_max=SPEC_GAMMA)
    for _ in range(N_SLOTS):
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=int(rng.integers(400, 600))),
                   200)
    while not eng._decoding.all():            # admit and prefill all lanes
        eng.step()

    def rounds(n=n_rounds):
        for _ in range(n):
            eng.step()

    rounds(2)                                 # warm-up
    st = eng.stats
    r0, t0 = st.spec_rounds, st.generated_tokens
    out = window(f"speculative round, contiguous pool, 4 lanes, gamma <= {SPEC_GAMMA}",
                 rounds, rounds, n_rounds, "round")
    out["rounds"] = st.spec_rounds - r0
    out["tokens_per_round"] = (st.generated_tokens - t0) / (2 * n_rounds)
    print(f"    {out['rounds']} of {2 * n_rounds} steps were speculating rounds; "
          f"{out['tokens_per_round']:.2f} tokens a round (4 lanes)")
    return out


# ---------------------------------------------------------------------------
# Phase 17: prefix sharing, preempt-and-requeue and migration
# ---------------------------------------------------------------------------

#: llama3.2-1b shared-prefix traffic: ``PREFIX_REQUESTS`` prompts of one
#: common ``PREFIX_LEN``-token prefix (32 full blocks of 16) plus 16-64
#: unique tokens, 16-48 new tokens each; the first arrives alone and the
#: others once its prefill (3 chunks, ~0.056 virtual s) has registered the
#: prefix, while it still decodes. Then two requests with identical
#: prompts of the prefix plus 32
#: tokens (34 full blocks): the second matches its whole prompt and
#: re-feeds its last token through a forked tail block.
PREFIX_LEN, PREFIX_REQUESTS = 512, 8
#: Preemption: phase 4's traffic on a 64-block sharing arena. Its
#: requests need 6-36 blocks of 16 each; 64 blocks admit the first two
#: prefills (33 and 28 blocks), not both lanes' decode growth.
PREEMPT_BLOCKS = 64
#: Migration: the first two of phase 4's requests, exported after 8
#: emitted tokens each; zamba2's first request after 4.
MIGRATE_REQUESTS, MIGRATE_AFTER, Z_MIGRATE_AFTER = 2, 8, 4
#: zamba2-1.2b preemption: 3 requests of 16-32 prompt and 8-16 new tokens
#: (each ends needing 2-3 blocks of 16) on a sharing arena of 4 blocks.
Z_PREEMPT_BLOCKS = 4


def prefix_workload(vocab: int):
    rng = np.random.default_rng(SEED + 30)
    prefix = rng.integers(0, vocab, size=PREFIX_LEN).astype(np.int32)
    reqs = []
    for i in range(PREFIX_REQUESTS):
        tail = rng.integers(0, vocab, size=int(rng.integers(16, 65))).astype(np.int32)
        reqs.append((np.concatenate([prefix, tail]), int(rng.integers(16, 49)),
                     0.0 if i == 0 else 0.06 + 0.005 * i))
    twin = np.concatenate([prefix, rng.integers(0, vocab, size=2 * BLOCK_SIZE).astype(np.int32)])
    return reqs + [(twin, 24, 0.2), (twin.copy(), 24, 0.21)]


def serve_probed(model, params, reqs, label: str, *, n_slots: int, max_len: int, chunk: int,
                 **kw) -> dict:
    """Serve ``reqs`` through one ``ServeEngine`` (``kw``: its pool
    options), probing every call's launches (``check_spec_launches``) and
    counting copy-on-write forks; the streams must be well formed and a
    paged arena must drain with its invariants intact. An MoE's router
    choices are recorded as ``serve`` records them."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Scheduler, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(model, params, n_slots=n_slots, max_len=max_len,
                      scheduler=Scheduler(n_slots, prefill_chunk=chunk), **kw)
    probe = CallProbe(eng)
    mgr = eng.pool.manager
    forks = []
    if mgr is not None:
        fork = mgr.fork
        mgr.fork = lambda *a: forks.append(fork(*a)) or forks[-1]
    rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
    finish = record_served_experts(eng) if cfg.moe is not None else None
    torch.cuda.synchronize()
    reset_launch_counts()
    with RouterRecord() if finish else contextlib.nullcontext() as rec:
        results = eng.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    calls = check_spec_launches(cfg, probe, counts, mgr is not None, label)
    for rid, (p, m, _) in zip(rids, reqs):
        toks = results[rid].tokens
        check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
              f"{label}: request {rid} produced a malformed stream")
    if mgr is not None:
        check(not mgr.audit(), f"{label}: block manager audit {mgr.audit()}")
        check(mgr.n_used_blocks == 0, f"{label}: {mgr.n_used_blocks} blocks held at the drain")
    st = eng.stats
    out = {"tokens": [results[r].tokens for r in rids], "stats": st, "launches": counts,
           "calls": {k: v["calls"] for k, v in calls.items()}, "forks": len(forks),
           "kv_bytes_high_water": eng.pool.kv_bytes_high_water(),
           "preempt_events": sum(kind == "preempt" for kind, _, _ in eng.events)}
    if finish:
        index = {rid: i for i, rid in enumerate(rids)}
        out["experts"] = {(index[rid], q): ex for (rid, q), ex in finish(rec).items()}
    print(f"  {label}: {st.prefill_calls} prefill calls ({st.prefill_tokens} tokens), "
          f"{st.decode_ticks} decode ticks, {st.generated_tokens} tokens in "
          f"{st.wall_seconds:.2f} s; prefix hits {st.prefix_hits} ({st.prefix_rows_shared} rows "
          f"shared), {len(forks)} forks, {st.preempted_requests} preemptions; KV high-water "
          f"{out['kv_bytes_high_water'] / 2**20:.2f} MiB; calls {out['calls']}; launches "
          f"{dict((k, v) for k, v in counts.items() if v)}")
    return out


def run_summary(r: dict) -> dict:
    st = r["stats"]
    return {"prefill_calls": st.prefill_calls, "prefill_tokens": st.prefill_tokens,
            "decode_ticks": st.decode_ticks, "generated_tokens": st.generated_tokens,
            "wall_seconds": st.wall_seconds, "decode_tokens_per_s": st.decode_tokens_per_wsec,
            "prefix_hits": st.prefix_hits, "prefix_rows_shared": st.prefix_rows_shared,
            "preempted_requests": st.preempted_requests, "forks": r["forks"],
            "kv_bytes_high_water": r["kv_bytes_high_water"], "calls": r["calls"],
            "launches": r["launches"]}


def serve_shared_prefix(model, params) -> dict:
    """``prefix_workload`` over a paged pool with and without sharing: at
    least 6 admissions adopt the prefix, the prefill tokens fall by
    exactly the rows shared, the full match forks its tail block, and
    every stream holds by the near-tie rule."""
    reqs = prefix_workload(model.cfg.vocab_size)
    runs = {label: serve_probed(model, params, reqs, f"{label} prefix", n_slots=N_SLOTS,
                                max_len=MAX_LEN, chunk=PREFILL_CHUNK, block_size=BLOCK_SIZE,
                                prefix_sharing=sharing)
            for label, sharing in (("shared", True), ("unshared", False))}
    sh, un = runs["shared"]["stats"], runs["unshared"]["stats"]
    check(sh.prefix_hits >= 6, f"only {sh.prefix_hits} admissions adopted the prefix")
    check(un.prefix_hits == 0, "the unshared run adopted a prefix")
    check(un.prefill_tokens - sh.prefill_tokens == sh.prefix_rows_shared,
          f"prefill tokens fell by {un.prefill_tokens - sh.prefill_tokens}, rows shared "
          f"{sh.prefix_rows_shared}")
    check(runs["shared"]["forks"] >= 1, "the full-match re-feed forked no block")
    equal = sum(a == b for a, b in zip(runs["shared"]["tokens"], runs["unshared"]["tokens"]))
    print(f"  prefill tokens {un.prefill_tokens} -> {sh.prefill_tokens} (-{sh.prefix_rows_shared} "
          f"rows shared); KV high-water {runs['unshared']['kv_bytes_high_water'] / 2**20:.2f} "
          f"-> {runs['shared']['kv_bytes_high_water'] / 2**20:.2f} MiB; streams equal to the "
          f"unshared run's: {equal} of {len(reqs)}")
    streams = check_streams(model, params, reqs, runs, MAX_LEN)
    return {"runs": {k: run_summary(v) for k, v in runs.items()}, "streams": streams,
            "requests": len(reqs), "shared_equals_unshared": equal}


def serve_preempted(model, params, reqs, label: str, *, n_slots: int, max_len: int, chunk: int,
                    arena_blocks: int, unpreempted=None) -> dict:
    """``reqs`` on a small sharing arena: lanes are preempted and replayed,
    every stream holds by the near-tie rule, and the arena drains clean.
    ``unpreempted``: the same requests' streams from a run without
    preemption, which the positions departing from are counted against."""
    need = max(-(-(len(p) + m) // BLOCK_SIZE) for p, m, _ in reqs)
    print(f"  {len(reqs)} requests on {arena_blocks} blocks of {BLOCK_SIZE}; the largest "
          f"needs {need}")
    r = serve_probed(model, params, reqs, label, n_slots=n_slots, max_len=max_len,
                     chunk=chunk, block_size=BLOCK_SIZE, arena_blocks=arena_blocks,
                     prefix_sharing=True)
    check(r["stats"].preempted_requests >= 1, f"{label}: no lane was preempted")
    check(r["preempt_events"] == r["stats"].preempted_requests, f"{label}: preempt events")
    streams = check_streams(model, params, reqs, {label: r}, max_len)
    out = {"run": run_summary(r), "streams": streams, "largest_blocks": need}
    if unpreempted is not None:
        out["departures_from_unpreempted"] = sum(
            a != b for got, want in zip(r["tokens"], unpreempted) for a, b in zip(got, want))
        out["equal_to_unpreempted"] = sum(a == b for a, b in zip(r["tokens"], unpreempted))
        print(f"  {label}: {out['equal_to_unpreempted']} of {len(reqs)} streams equal to the "
              f"unpreempted run's; {out['departures_from_unpreempted']} positions depart")
    return out


def migrate(model, params, reqs, label: str, *, n_slots: int, max_len: int, chunk: int,
            after: int, **kw) -> dict:
    """Serve ``reqs`` through one engine (unmigrated), and again through a
    source engine that exports each request after ``after`` emitted tokens
    into a second engine that finishes it; every call's launches probed.
    The migrated streams hold by the near-tie rule and are compared with
    the unmigrated ones token for token (departures counted). Then a ticket
    with one byte of its first K leaf flipped must raise
    ``TicketIntegrityError`` and leave the destination's pool unchanged."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.serve import Scheduler, ServeEngine, TicketIntegrityError

    base = serve_probed(model, params, reqs, f"{label}, unmigrated", n_slots=n_slots,
                        max_len=max_len, chunk=chunk, **kw)

    def engine():
        return ServeEngine(model, params, n_slots=n_slots, max_len=max_len,
                           scheduler=Scheduler(n_slots, prefill_chunk=chunk), **kw)

    src, dst = engine(), engine()
    probe = CallProbe(src, dst)
    rids = [src.submit(p, m, arrival=a) for p, m, a in reqs]
    torch.cuda.synchronize()
    reset_launch_counts()
    tickets, t0 = {}, time.perf_counter()
    while len(tickets) < len(reqs):
        check(src.step() != "done", f"{label}: the source drained before every export")
        for i, rid in enumerate(rids):
            if i not in tickets and len(src.request(rid).tokens) == after:
                tickets[i] = src.export_request(rid)
    check(src.pool.n_active == 0, f"{label}: the source still holds a slot")
    if src.pool.paged:
        check(src.pool.manager.n_used_blocks == 0, f"{label}: the source still holds blocks")
    new = {i: dst.import_request(t) for i, t in tickets.items()}
    check(None not in new.values(), f"{label}: the destination refused a ticket")
    results = dst.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    paged = src.pool.paged
    check_spec_launches(model.cfg, probe, counts, paged, f"{label}, migrated")
    tokens = [results[new[i]].tokens for i in range(len(reqs))]
    departures = sum(a != b for got, want in zip(tokens, base["tokens"])
                     for a, b in zip(got, want))
    snap_bytes = [sum(t.numel() * t.element_size()
                      for t in tree_leaves(t.snapshot.data, is_leaf=torch.is_tensor))
                  for t in tickets.values()]
    print(f"  {label}: {len(tickets)} requests exported after {after} tokens "
          f"(snapshots of {[round(b / 2**20, 2) for b in snap_bytes]} MiB) and finished on a "
          f"second engine in {seconds:.2f} s; {departures} positions depart from the "
          f"unmigrated streams; launches {dict((k, v) for k, v in counts.items() if v)}")
    streams = check_streams(model, params, reqs, {"migrated": {"tokens": tokens},
                                                  "unmigrated": base}, max_len)
    # A corrupt ticket: one byte of the first K leaf of the snapshot flipped.
    ticket = tickets[0]
    flipped = []

    def flip_first(t):
        if not flipped:
            t = t.clone()
            t.reshape(-1)[:1].view(torch.uint8)[0] ^= 1
            flipped.append(t)
        return t
    bad = dataclasses.replace(ticket, snapshot=dataclasses.replace(
        ticket.snapshot, data=tree_map(flip_first, ticket.snapshot.data,
                                       is_leaf=torch.is_tensor)))
    before = [t.clone() for t in tree_leaves(dst.pool.caches, is_leaf=torch.is_tensor)]
    used = dst.pool.manager.n_used_blocks if paged else 0
    try:
        dst.import_request(bad)
        rejected = False
    except TicketIntegrityError:
        rejected = True
    unchanged = (dst.pool.n_active == 0
                 and (not paged or dst.pool.manager.n_used_blocks == used)
                 and all(torch.equal(a, b) for a, b in
                         zip(before, tree_leaves(dst.pool.caches, is_leaf=torch.is_tensor))))
    print(f"  {label}: a ticket with one byte of a K leaf flipped raises TicketIntegrityError: "
          f"{rejected}; destination pool unchanged: {unchanged}")
    check(rejected and unchanged, f"{label}: the corrupt ticket was not refused cleanly")
    return {"unmigrated": run_summary(base), "migrated_seconds": seconds,
            "launches": counts, "departures": departures, "snapshot_bytes": snap_bytes,
            "streams": streams, "corrupt_ticket_rejected": rejected,
            "destination_unchanged": unchanged}


def time_shared_decode(gen) -> dict:
    """K4 over the shared block tables of ``parity.SHARED_DECODE_SHAPES[0]``
    (llama3.2-1b's geometry, a 512-token common prefix, bf16) beside its
    plain version, SDPA on the gathered rows and its bound: every live
    arena row read once however many tables name it, q read, out written
    and the live table entries read."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode_attention, paged_decode_attention_plain
    from repro_torch.kernels.parity import (
        DECODE_BLOCK, SHARED_DECODE_SHAPES, shared_block_arena,
    )
    from repro_torch.models.attention import paged_kv_view

    H, Hkv, D, S, lens, shared = SHARED_DECODE_SHAPES[0]
    dev = torch.device("cuda")
    k_ar, v_ar, tables = shared_block_arena(Hkv, D, S, lens, shared, gen, torch.bfloat16, dev)
    B = len(lens)
    q = torch.randn((B, H, D), generator=gen).to(dev, torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    t = tables.cpu()
    rows = {(int(t[b, i // DECODE_BLOCK]), i % DECODE_BLOCK) for b in range(B)
            for i in range(lens[b])}
    n_entries = sum(-(-n // DECODE_BLOCK) for n in lens)
    nbytes = len(rows) * Hkv * D * 2 * 2 + 2 * B * H * D * 2 + B * 4 + n_entries * 4
    b, kind = bound(nbytes, sum(lens) * H * (4 * D + 5))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    kp = paged_kv_view(k_ar, tables).transpose(1, 2)
    vp = paged_kv_view(v_ar, tables).transpose(1, 2)
    out = {"shared_paged_decode_attention": dict(
        shape=f"q ({B}, {H}, {D}), arenas {tuple(k_ar.shape)} bf16, block {DECODE_BLOCK}, "
              f"lengths {lens}, rows 0-1 sharing {shared} blocks, row 2 a fork of the last",
        unique_rows=len(rows),
        ms=time_ms(lambda: paged_decode_attention(q, k_ar, v_ar, tables, lengths)),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kp, vp, attn_mask=mask, enable_gqa=True)),
        bound_ms=b, bound_by=kind)}
    print_kernel_times(out)
    return out


def time_slot_copies(model, rows: int) -> dict:
    """``snapshot_slot`` and ``restore_slot`` of one llama slot holding
    ``rows`` rows (32 KiB of KV a row) over each pool of phase 4's
    geometry, timed with CUDA events (cold L2, median of 60) beside their
    byte bound: the snapshot's bytes read once and written once. A paged
    call uploads its block ids first, which waits for the device, so its
    time holds that host round trip too."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import SlotPool

    out = {}
    for pool, bsz in (("contiguous", None), ("paged", BLOCK_SIZE)):
        src, dst = (SlotPool(model, N_SLOTS, MAX_LEN, block_size=bsz, device="cuda")
                    for _ in range(2))
        slot = src.allocate(0, MAX_LEN)
        src.ensure_rows(slot, rows)
        src.positions[slot] = rows
        snap = src.snapshot_slot(slot)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(snap.data, is_leaf=torch.is_tensor))

        def restore(dst=dst, snap=snap):
            dst.free(dst.restore_slot(snap, owner=0, n_tokens=MAX_LEN))

        b, kind = bound(2 * nbytes, 0)
        out[pool] = {"rows": rows, "bytes": nbytes,
                     "snapshot_ms": time_ms(lambda: src.snapshot_slot(slot)),
                     "restore_ms": time_ms(restore), "bound_ms": b, "bound_by": kind}
        print(f"  {pool}: a slot of {rows} rows, snapshot {nbytes / 2**20:.2f} MiB: "
              f"snapshot_slot {out[pool]['snapshot_ms']:.4f} ms, restore_slot "
              f"{out[pool]['restore_ms']:.4f} ms, bound {b:.4f} ms ({kind})")
    return out


# ---------------------------------------------------------------------------
# Phase 18: observability and the multi-replica fleet
# ---------------------------------------------------------------------------

#: The fleet: 3 paged replicas of phase 4's geometry over one params dict.
#: Node faults, on the plane's ticks (one engine action a tick): replica
#: 1 fails while it decodes, rejoins at 140, and replica 2 drains at 170,
#: while it decodes copies dispatched during the failure, so the drain's
#: tickets go to the rejoined replica 1 (a peer that already holds a copy
#: of a request is never offered its ticket). The steps were chosen by
#: running the fleet with the same traffic at a 1-layer width on the CPU:
#: the plane's timeline depends on lengths and virtual costs, not on the
#: tokens.
FLEET_REPLICAS = 3
FLEET_EVENTS = ((80, "fail", 1), (140, "rejoin", 1), (170, "drain", 2))
#: Transport faults: a drop and a duplicate early on, and a corruption of
#: the drain's first ticket (the 52nd transmission on fe -> r1), which
#: replica 1's import must refuse.
FLEET_DIRECTIVES = (("fe", "r0", "drop", 5), ("r0", "fe", "dup", 9), ("fe", "r1", "corrupt", 51))


def serve_observed(model, params, reqs, runs: dict) -> dict:
    """(a) Phase 4's traffic again on both pools with ``Observability()``:
    the streams, the stats and every call's launches equal phase 4's
    (``runs``), the trace validates with no span left open, and the
    engine's counters equal its ``EngineStats``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability, validate_trace
    from repro_torch.serve import Scheduler, ServeEngine

    out = {}
    for pool, block_size in (("contiguous", None), ("paged", BLOCK_SIZE)):
        label = f"{pool}, obs on"
        obs = Observability()
        eng = ServeEngine(model, params, n_slots=N_SLOTS, max_len=MAX_LEN, block_size=block_size,
                          scheduler=Scheduler(N_SLOTS, prefill_chunk=PREFILL_CHUNK), obs=obs)
        probe = CallProbe(eng)
        rids = [eng.submit(p, m, arrival=a) for p, m, a in reqs]
        torch.cuda.synchronize()
        reset_launch_counts()
        results = eng.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        calls = check_spec_launches(model.cfg, probe, counts, block_size is not None, label)
        st, base = eng.stats, runs[pool]["stats"]
        check(counts == runs[pool]["launches"],
              f"{label}: launched {counts}, phase 4 {runs[pool]['launches']}")
        check([results[r].tokens for r in rids] == runs[pool]["tokens"],
              f"{label}: a stream differs from phase 4's obs-off stream")
        for k in ("prefill_calls", "prefill_tokens", "decode_ticks", "generated_tokens"):
            check(getattr(st, k) == getattr(base, k), f"{label}: {k} differs from phase 4's")
        errors = validate_trace(obs.tracer.events)
        check(errors == [] and obs.tracer.open_spans == [],
              f"{label}: trace errors {errors[:3]}, open spans {obs.tracer.open_spans}")
        snap = obs.metrics.snapshot()
        for k in ("decode_ticks", "generated_tokens", "prefill_tokens"):
            check(snap[f"engine.{k}"] == getattr(st, k),
                  f"{label}: engine.{k} {snap[f'engine.{k}']} != {getattr(st, k)}")
        out[pool] = {"wall_seconds": st.wall_seconds, "obs_off_wall_seconds": base.wall_seconds,
                     "trace_events": len(obs.tracer.events),
                     "calls": {k: v["calls"] for k, v in calls.items()}, "launches": counts}
        print(f"  {label}: streams, stats and launches equal phase 4's; "
              f"{len(obs.tracer.events)} trace events, valid, no open span; host wall "
              f"{st.wall_seconds:.2f} s with obs, {base.wall_seconds:.2f} s without (phase 4; "
              f"not claimed)")
    return out


def serve_fleet(model, params, reqs) -> dict:
    """(b) ``reqs`` through a ``Frontend`` over ``FLEET_REPLICAS`` paged
    replicas sharing ``params``, hedged (cost 0.001 a copy), under
    ``FLEET_EVENTS`` and ``FLEET_DIRECTIVES``. Every request completes
    (none dropped), at least one ticket lands and one is refused, the
    streams hold by the near-tie rule, every pool and arena drains, the
    router holds nothing, the trace validates with no open span, and every
    call of every replica launches what phase 4's calls do. The seal and
    the verify of each ticket (``ticket_checksum``, which copies the
    snapshot to the host) are timed on the host clock."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import SimplifiedDelayModel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import Observability, validate_trace
    from repro_torch.runtime import FaultEvent
    from repro_torch.serve import FaultDirective, Frontend, Replica, TransportFaults

    cfg = model.cfg
    obs = Observability()
    replicas = [Replica(i, model, params, n_slots=N_SLOTS, max_len=MAX_LEN, block_size=BLOCK_SIZE,
                        prefill_chunk=PREFILL_CHUNK, obs=obs) for i in range(FLEET_REPLICAS)]
    probe = CallProbe(*(rep.engine for rep in replicas))
    fe = Frontend(replicas, SimplifiedDelayModel(lambda_y=2.0), cost_per_replica=0.001,
                  retry_budget=3, events=[FaultEvent(*e) for e in FLEET_EVENTS],
                  transport_faults=TransportFaults([FaultDirective(*d)
                                                    for d in FLEET_DIRECTIVES]),
                  obs=obs)
    landed = {}                        # node fault -> decoding copies it found

    def noting(key, rep, fn):
        def wrapped(*a):
            landed[key] = len(rep.engine.decoding_rids())
            return fn(*a)
        return wrapped

    for rep in replicas:
        rep.fail = noting(f"fail {rep.id}", rep, rep.fail)
    drain = fe.drain
    fe.drain = lambda r: noting(f"drain {r}", replicas[r], drain)(r)
    checksum, stamps = engine_mod.ticket_checksum, []

    def timed(ticket):
        t0 = time.perf_counter()
        digest = checksum(ticket)
        stamps.append(("seal" if ticket.checksum is None else "verify",
                       (time.perf_counter() - t0) * 1e3))
        return digest

    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    engine_mod.ticket_checksum = timed
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = fe.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        engine_mod.ticket_checksum = checksum
    counts = launch_counts()
    calls = {k: v["calls"] for k, v in check_spec_launches(cfg, probe, counts, True,
                                                           "fleet").items()}
    s = fe.summary()
    print(f"  events {FLEET_EVENTS}; transport {FLEET_DIRECTIVES}; decoding copies each node "
          f"fault found: {landed}")
    print(f"  {len(reqs)} requests in {seconds:.2f} s, {fe.ticks} plane ticks; summary {s}")
    seals = [ms for kind, ms in stamps if kind == "seal"]
    verifies = [ms for kind, ms in stamps if kind == "verify"]
    print(f"  tickets: seal ms {[round(x, 3) for x in seals]}, verify ms "
          f"{[round(x, 3) for x in verifies]} (ticket_checksum on the host clock, the "
          f"snapshot's copy to the host included); calls {calls}; launches "
          f"{dict((k, v) for k, v in counts.items() if v)}")
    check(landed.get("fail 1", 0) >= 1, f"the fail found no decoding copy on replica 1: {landed}")
    check(landed.get("drain 2", 0) >= 1, f"the drain found no decoding copy on replica 2: {landed}")
    check(s["completed"] == len(reqs) and s["dropped"] == 0,
          f"fleet: {s['completed']} completed, {s['dropped']} dropped")
    check(s["migrations"] >= 1 and s["ticket_rejects"] >= 1,
          f"fleet: {s['migrations']} migrations, {s['ticket_rejects']} rejected tickets")
    check(s["transport_dropped"] >= 1 and s["transport_duplicated"] >= 1
          and s["transport_corrupted"] == 1, "fleet: a transport fault did not land")
    for rep in replicas:
        mgr = rep.engine.pool.manager
        check(rep.engine.pool.n_active == 0 and rep.engine.live_rids() == []
              and mgr.n_free_blocks == mgr.num_blocks and not mgr.audit(),
              f"replica {rep.id} holds slots or blocks at the end")
    check(not fe.router.inflight.any() and not fe.transport.busy(),
          f"router in flight {fe.router.inflight.tolist()} at the end")
    errors = validate_trace(obs.tracer.events)
    check(errors == [] and obs.tracer.open_spans == [],
          f"fleet: trace errors {errors[:3]}, open spans {obs.tracer.open_spans}")
    streams = check_streams(model, params, reqs,
                            {"fleet": {"tokens": [results[g].tokens for g in gids]}}, MAX_LEN)
    return {"summary": s, "seconds": seconds, "ticks": fe.ticks, "landed": landed,
            "events": FLEET_EVENTS, "directives": FLEET_DIRECTIVES, "seal_ms": seals,
            "verify_ms": verifies, "trace_events": len(obs.tracer.events),
            "calls": calls, "launches": counts, "streams": streams}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 19: the registry's other GQA decoders at full width
# ---------------------------------------------------------------------------

#: (a) qwen2.5-3b serves the first ``QWEN_REQUESTS`` of phase 4's requests
#: over both pools; (b) the wide
#: models each serve ``W_REQUESTS`` requests (prompts of 32-256 tokens,
#: 8-32 new) over the paged pool: ``W_SLOTS`` slots of ``W_MAX_LEN``
#: rows, ``W_CHUNK``-token chunks, so that the last request waits for a
#: freed slot and its blocks (cut from 6 requests to fit the script's
#: time limit). qwen3-moe routes dropless.
QWEN_ARCH = "qwen2.5-3b"
#: qwen2.5-3b serves the first ``QWEN_REQUESTS`` of phase 4's 8 requests
#: over both pools and profiles its tick on the paged pool only (cut from
#: all 8 and both pools to fit the script's time limit).
QWEN_REQUESTS = 6
WIDE_ARCHS = ("command-r-35b", "chameleon-34b", "qwen3-moe-30b-a3b")
W_REQUESTS, W_SLOTS, W_MAX_LEN, W_CHUNK = 5, 4, 512, 128
#: Phase 19's serving runs full width cut to ``QWEN_SERVE_LAYERS`` layers
#: (qwen2.5-3b, from 36) and ``W_LAYERS`` (the wide models, from 40 and
#: 48): a decode tick is host-bound, its time goes with its launches,
#: and the script at full depth ran past its 1,200 s limit on an H100.
#: qwen2.5-3b still trains at full depth.
QWEN_SERVE_LAYERS, W_LAYERS = 12, 8
#: Leaves a model initializes to zeros or ones (norm scales and biases,
#: q/k/v biases, xLSTM's gate and conv biases), and the noise added to them
#: before serving, so that the biases, LayerNorm's affine and the qk-norm's
#: scales do real arithmetic.
CONSTANT_LEAVES = ("scale", "bias", "bq", "bk", "bv", "conv_b", "b_if")
CONST_NOISE = 0.1
#: qwen2.5-3b training: 8 workers of one 512-token row each at every beta
#: (4096 tokens a step at k = 8). Its 3.09 B parameters in bf16 with f32
#: AdamW moments hold ~29 GiB; 32 x 512 tokens would add ~36 GiB of
#: saved products and ~30 GiB of f32 logits and their gradient.
QWEN_TRAIN_B, QWEN_TRAIN_STEPS = 8, 12
def serving_config(name: str):
    """The registry's config; an MoE routes dropless (capacity-dropped
    routing depends on the chunk's other tokens, so a served stream could
    not equal offline decode)."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=True))
    return cfg


def wide_workload(vocab: int):
    return zamba_workload(vocab, W_REQUESTS, (32, 257), (8, 33), SEED + 40)


def load_full_width(model, seed: int) -> dict:
    """Random bf16 parameters on the card from ``seed``, the constant
    leaves made noisy; prints the memory held before and the peak after."""
    from repro_torch.models import count_params_analytic

    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = noisy_params(model.init(seed, device="cuda"), CONST_NOISE, seed + 1,
                          only=CONSTANT_LEAVES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  {cfg.name}: {count_params_analytic(cfg):,} parameters ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"{cfg.dtype}) drawn in {time.perf_counter() - t0:.1f} s; memory allocated before "
          f"{before / 2**30:.2f} GiB, peak after {peak / 2**30:.2f} GiB")
    return params


def check_near_tie_share(streams: dict, label: str) -> None:
    """Neither near-tie rule may excuse more than a quarter of the
    positions compared."""
    n = streams["positions_compared"]
    for key in ("near_ties", "router_flips"):
        check(streams[key] <= n / 4,
              f"{label}: the {key} rule excused {streams[key]} of {n} positions")


def time_wide_kernels(cfg, reqs, n_slots: int, max_len: int, gen) -> dict:
    """K3 and K4 at the model's tick shape (its lanes at their prompt
    length plus half their new tokens), and K2 at the tick's rows: its
    norms' (n_slots, 1, d_model) where they are RMSNorms, and its
    qk-norm's (n_slots * heads, 1, 128) query and key rows."""
    lens = [len(p) + m // 2 for p, m, _ in reqs[:n_slots]]
    out = time_decode(n_slots, max_len, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, lens, gen)
    if cfg.norm == "rmsnorm":
        out[f"rmsnorm_d{cfg.d_model}"] = time_rmsnorm_rows(n_slots, cfg.d_model, gen)
    if cfg.qk_norm:
        for label, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads)):
            out[f"rmsnorm_{label}_norm"] = time_rmsnorm_rows(n_slots * heads, cfg.head_dim, gen)
    print_kernel_times(out)
    return out


def dense_decode_vs_plain(cfg) -> dict:
    """A GQA config at full width cut to 2 layers in f32 (``cut_for_parity``),
    over each pool: one right-padded prefill chunk into blank caches (4
    rows of 16, 9, 12 and 5 tokens), then 2 decode ticks, through the
    kernels on the card (launches: ``step_launches`` a call, no K3/K4 in
    the prefill) and through the plain versions on the CPU, from the same
    parameters (drawn on the card, the constant leaves made noisy, then
    copied). The chunk's and each tick's logits and every K/V row below
    its row's length are held by ``parity.within`` (f32), phase 15's
    rule."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.parity import k2_per_call, within
    from repro_torch.models import Model
    from repro_torch.models.attention import paged_kv_view
    from repro_torch.models.layers import tree_map

    small = cut_for_parity(cfg)
    model = Model(small)
    gpu_params = noisy_params(model.init(SEED, device="cuda"), CONST_NOISE, SEED + 42,
                              only=CONSTANT_LEAVES)
    cpu_params = tree_map(lambda t: t.cpu(), gpu_params, is_leaf=torch.is_tensor)
    gen = torch.Generator().manual_seed(SEED + 43)
    B, P, rows, bs, n_ticks = 4, 16, 64, 16, 2
    lens = torch.tensor([16, 9, 12, 5])
    V = small.vocab_size
    chunk = torch.randint(0, V, (B, P), generator=gen)
    chunk[torch.arange(P)[None, :] >= lens[:, None]] = 0
    ticks = torch.randint(0, V, (n_ticks, B, 1), generator=gen)
    tables = (torch.randperm(B * rows // bs, generator=gen) + 1).reshape(B, -1).int()
    out, ok = {}, True
    for pool, paged in (("contiguous", False), ("paged", True)):
        kw = dict(block_size=bs, num_blocks=B * rows // bs) if paged else {}
        res = {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            caches = model.blank_caches(B, rows, device=dev, **kw)
            tt = tables.to(dev) if paged else None
            reset_launch_counts()
            t0 = time.perf_counter()
            lg, caches = model.prefill_with_cache(params, chunk.to(dev), caches,
                                                  length=lens.to(dev), start_index=0,
                                                  block_tables=tt)
            if params is gpu_params:
                torch.cuda.synchronize()
                prefill_counts = launch_counts()
                reset_launch_counts()
            logits, pos = [lg], lens.clone()
            for t in range(n_ticks):
                lg, caches = model.decode_step(params, ticks[t].to(dev), caches, pos.to(dev),
                                               block_tables=tt)
                logits.append(lg)
                pos = pos + 1
            if params is gpu_params:
                torch.cuda.synchronize()
                tick_counts = launch_counts()
            res[params is gpu_params] = (logits, caches, time.perf_counter() - t0)
        expect = step_launches(small, paged, n_ticks)
        expect = {k: v * n_ticks for k, v in expect.items()}
        expect_prefill = dict(expect, decode_attention=0, paged_decode_attention=0,
                              rmsnorm=k2_per_call(small))
        check(tick_counts == expect, f"{pool}: tick launches {tick_counts}, expected {expect}")
        check(prefill_counts == expect_prefill,
              f"{pool}: prefill launches {prefill_counts}, expected {expect_prefill}")
        (lg_g, c_g, s_g), (lg_c, c_c, s_c) = res[True], res[False]
        errs = {"logits": max(within(a.cpu(), b, torch.float32)[0] for a, b in zip(lg_g, lg_c))}
        ok &= all(within(a.cpu(), b, torch.float32)[1] for a, b in zip(lg_g, lg_c))
        e_max = 0.0
        for sg, sc in zip(c_g, c_c):
            for g_layer, c_layer in zip(sg, sc):
                for name in ("k", "v"):
                    g, c = g_layer[name].cpu(), c_layer[name]
                    if paged:
                        g, c = paged_kv_view(g, tables), paged_kv_view(c, tables)
                    for b in range(B):
                        e, o = within(g[b, :pos[b]], c[b, :pos[b]], torch.float32)
                        e_max = max(e_max, e)
                        ok &= o
        errs["K/V"] = e_max
        print(f"  {small.name} cut to 2 layers, f32, {pool}: a prefill chunk and {n_ticks} "
              f"ticks, card {s_g:.2f} s vs CPU plain {s_c:.2f} s; max |err|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; launches: prefill {dict((k, v) for k, v in prefill_counts.items() if v)}, "
              f"ticks {dict((k, v) for k, v in tick_counts.items() if v)} "
              f"({'ok' if ok else 'FAIL'})")
        out[pool] = {"max_abs_err": errs, "prefill_launches": prefill_counts,
                     "tick_launches": tick_counts}
    check(ok, f"the cut-down {small.name} decode: card vs plain on the CPU")
    return out


def remat_step_pair(model, params) -> dict:
    """One SGD step (lr 1e-2, gradients clipped to norm 1) of ``model``
    under remat "selective" and one under "full", from the same parameters
    on the same batch (8 workers of one 512-token row, mask of k = 4): the
    losses must be equal bit for bit (the forward is the same work), the
    gradient norms within 1e-3 relative (the recomputed forward feeds the
    same backward; what differs is which products' outputs are saved and
    which recomputed), and the selective step must lower the loss of its
    own batch. Peak memory and host wall of each, and the bytes each
    holds for its backward once its forward has run (``saved_bytes``:
    the step's peak comes later, in the optimizer's f32 passes)."""
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step

    cfg = model.cfg
    batch = token_batch(cfg.vocab_size, 8, 1, TRAIN_S, [1.0, 0.0] * 4)
    batch = {k: v.to("cuda") if torch.is_tensor(v) else v for k, v in batch.items()}
    batch["lr"] = 1e-2
    opt = sgd()
    out = {}
    for remat in ("selective", "full"):
        rmodel = Model(dataclasses.replace(cfg, remat=remat))
        step = make_train_step(rmodel, opt)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params,
                          is_leaf=torch.is_tensor)
        loss, metrics = rmodel.train_loss(leaves, batch)
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - base
        del loss, metrics, leaves              # the graph and what it saved
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # The step updates a copy in place (the next remat starts from
        # the same parameters), where it once made a new tree.
        new, _, m = step(tree_map(torch.clone, params, is_leaf=torch.is_tensor),
                         opt.init(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[remat] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "peak_bytes": peak, "peak_over_params_bytes": peak - base,
                      "saved_bytes": saved, "wall_s": wall}
        if remat == "selective":
            out["loss_after_step"] = float(step(new, opt.init(new), batch)[2]["loss"])
        del new, m
        print(f"  remat {remat!r}: loss {out[remat]['loss']!r}, grad norm "
              f"{out[remat]['grad_norm']!r}, peak memory {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB over the parameters), held for the "
              f"backward after the forward {saved / 2**30:.2f} GiB, host wall {wall:.2f} s")
    a, b = out["selective"], out["full"]
    print(f"  the batch's loss after the selective step: {out['loss_after_step']!r}")
    check(out["loss_after_step"] < a["loss"], "the step did not lower its own batch's loss")
    check(a["loss"] == b["loss"], "selective and full remat give other losses")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 1e-3 * b["grad_norm"],
          "selective and full remat give gradient norms more than 1e-3 apart")
    out["grad_norm_bitwise_equal"] = a["grad_norm"] == b["grad_norm"]
    return out


def phase19() -> dict:
    """(a)-(e) of phase 19: see the module docstring."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    out = {"launches": [], "streams": {}, "load": {}, "serve": {}, "times": {},
           "profiles": {}, "step_parity": {}}
    gen = torch.Generator().manual_seed(SEED + 44)

    qcfg = dataclasses.replace(serving_config(QWEN_ARCH), n_layers=QWEN_SERVE_LAYERS)
    qmodel = Model(qcfg)
    print(f"  (a) {qcfg.name}, cut to {qcfg.n_layers} layers: the first {QWEN_REQUESTS} of "
          f"phase 4's requests over both pools, {N_SLOTS} slots of {MAX_LEN}, "
          f"{PREFILL_CHUNK}-token chunks")
    params = load_full_width(qmodel, SEED + 45)
    reqs = workload(qcfg.vocab_size)[:QWEN_REQUESTS]
    runs = serve(qmodel, params, reqs)
    out["streams"][qcfg.name] = check_streams(qmodel, params, reqs, runs, MAX_LEN)
    check_near_tie_share(out["streams"][qcfg.name], qcfg.name)
    out["serve"][qcfg.name] = {p: {"launches": r["launches"], "ticks": r["stats"].decode_ticks,
                                   "prefill_calls": r["stats"].prefill_calls,
                                   "wall_s": r["stats"].wall_seconds,
                                   "decode_tokens_per_s": r["stats"].decode_tokens_per_wsec}
                               for p, r in runs.items()}
    out["launches"] += [r["launches"] for r in runs.values()]
    out["times"][qcfg.name] = time_wide_kernels(qcfg, reqs, N_SLOTS, MAX_LEN, gen)
    out["profiles"][qcfg.name] = profile_ticks(
        qmodel, params, (("paged", BLOCK_SIZE),), n_slots=N_SLOTS,
        max_len=MAX_LEN, chunk=PREFILL_CHUNK, prompt=(400, 600), seed=SEED + 41)
    del params

    for name in WIDE_ARCHS:
        cfg = dataclasses.replace(serving_config(name), n_layers=W_LAYERS)
        print(f"  (c) {name}: step parity")
        out["step_parity"][name] = dense_decode_vs_plain(cfg)
        model = Model(cfg)
        print(f"  (b) {name}, cut to {cfg.n_layers} layers: {W_REQUESTS} requests over the "
              f"paged pool (block {BLOCK_SIZE}), {W_SLOTS} slots of {W_MAX_LEN}, "
              f"{W_CHUNK}-token chunks")
        params = load_full_width(model, SEED + 46)
        out["load"][name] = torch.cuda.max_memory_allocated()
        reqs = wide_workload(cfg.vocab_size)
        runs = serve(model, params, reqs, (("paged", BLOCK_SIZE),), n_slots=W_SLOTS,
                     max_len=W_MAX_LEN, chunk=W_CHUNK)
        out["streams"][name] = check_streams(model, params, reqs, runs, W_MAX_LEN)
        check_near_tie_share(out["streams"][name], name)
        r = runs["paged"]
        out["serve"][name] = {"launches": r["launches"], "ticks": r["stats"].decode_ticks,
                              "prefill_calls": r["stats"].prefill_calls,
                              "wall_s": r["stats"].wall_seconds,
                              "decode_tokens_per_s": r["stats"].decode_tokens_per_wsec,
                              "peak_bytes": torch.cuda.max_memory_allocated()}
        out["launches"].append(r["launches"])
        out["times"][name] = time_wide_kernels(cfg, reqs, W_SLOTS, W_MAX_LEN, gen)
        out["profiles"][name] = profile_ticks(
            model, params, (("paged", BLOCK_SIZE),), n_slots=W_SLOTS, max_len=W_MAX_LEN,
            chunk=W_CHUNK, prompt=(200, 300), seed=SEED + 41)
        del params

    tcfg = dataclasses.replace(get_config(QWEN_ARCH), remat="selective")
    tmodel = Model(tcfg)
    print(f"  (d) training {tcfg.name} at full width through the adaptive-(k, beta) loop: "
          f"{tcfg.n_layers} layers, {tcfg.dtype}, remat {tcfg.remat!r}, {QWEN_TRAIN_B} x "
          f"{TRAIN_S} tokens at every beta")
    gc.collect()
    torch.cuda.empty_cache()
    # k stays 1 over these steps, so each step's loss is one 512-token row's:
    # it moves by +-0.1 from row to row, more than 12 steps lower it
    # (lr 3e-4, 1e-3 and 3e-3 tried on the card). The step pair below
    # checks instead that a step lowers the loss of its own batch.
    trained = train_full_width(tmodel, QWEN_TRAIN_STEPS, global_batch=QWEN_TRAIN_B,
                               loss_falls=False)
    out["launches"].append(trained["launches"])
    params = trained.pop("params")
    out["train_loop"] = trained
    print("    one step under remat 'selective' and one under 'full', same batch")
    out["remat_pair"] = remat_step_pair(tmodel, params)
    del params
    print("    K1 and K2 vs plain PyTorch at each batch shape the loop ran")
    worst = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "rmsnorm": 0.0,
             "rmsnorm_bwd": 0.0}
    check_loop_shapes(tcfg, trained["shapes"], worst)
    out["loop_shape_worst"] = worst
    out["flash_times"] = time_flash(QWEN_TRAIN_B, TRAIN_S, tcfg.n_heads, tcfg.n_kv_heads,
                                    tcfg.head_dim, gen)
    print_times(out["flash_times"])
    return out



# ---------------------------------------------------------------------------
# Phase 20: MLA (deepseek-v3) and xLSTM serving
# ---------------------------------------------------------------------------

#: deepseek-v3 at full width cut to ``DS_LAYERS`` layers (its 3 dense
#: layers, then 2 MoE), bf16, dropless: ``DS_REQUESTS`` requests (prompts
#: of 32-160 tokens, 8-24 new) over ``DS_SLOTS`` slots of ``DS_MAX_LEN``
#: rows, ``DS_CHUNK``-token chunks; the shared-prefix run: ``DS_PREFIX``
#: common tokens (8 blocks of 16) and 4 tails of 8-40 (``ds_prefix_workload``).
DS_ARCH, DS_LAYERS = "deepseek-v3-671b", 5
DS_REQUESTS, DS_SLOTS, DS_MAX_LEN, DS_CHUNK, DS_PREFIX = 4, 4, 256, 128, 128
#: xlstm-125m at full width cut to ``XL_LAYERS`` layers (5 mLSTM, 1 sLSTM;
#: from 12, to fit the script's 1,200 s limit: an xLSTM step is
#: host-bound; phase 21 trains the same cut): ``XL_REQUESTS`` requests (prompts of
#: 16-64 tokens, 8-32 new) over ``XL_SLOTS`` slots of ``XL_MAX_LEN`` rows
#: (the chunk only schedules: xLSTM prefills a token a step); a draft of
#: the target plus noise ``SPEC_NOISE`` with gamma <= ``XL_SPEC_GAMMA``; 3
#: requests of 16-32 and 8-16 tokens (2-3 blocks of 16 each) on a sharing
#: arena of ``XL_PREEMPT_BLOCKS`` blocks, which must preempt.
XL_ARCH = "xlstm-125m"
XL_REQUESTS, XL_SLOTS, XL_MAX_LEN, XL_CHUNK = 6, 4, 256, 64
XL_SPEC_GAMMA, XL_PREEMPT_BLOCKS, XL_LAYERS = 3, 4, 6


def ds_prefix_workload(vocab: int):
    """The first request (32 new tokens) is still resident when the other
    three arrive (its prefill and ~8 ticks later, on the scheduler's
    virtual clock), so they can adopt its prefix blocks."""
    rng = np.random.default_rng(SEED + 52)
    prefix = rng.integers(0, vocab, size=DS_PREFIX).astype(np.int32)
    return [(np.concatenate([prefix, rng.integers(0, vocab, size=int(rng.integers(8, 41)))
                             .astype(np.int32)]),
             32 if i == 0 else int(rng.integers(8, 17)), 0.0 if i == 0 else 0.025 + 0.003 * i)
            for i in range(4)]


def run_peak(label: str, fn):
    """``fn()``, and the peak memory allocated while it ran, printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"    {label}: peak memory allocated {peak / 2**30:.2f} GiB")
    return out, peak


def serve_summary(runs: dict, peak: int) -> dict:
    return {pool: {"launches": r["launches"], "ticks": r["stats"].decode_ticks,
                   "prefill_calls": r["stats"].prefill_calls,
                   "prefill_tokens": r["stats"].prefill_tokens,
                   "wall_s": r["stats"].wall_seconds,
                   "decode_tokens_per_s": r["stats"].decode_tokens_per_wsec, "peak_bytes": peak}
            for pool, r in runs.items()}


def time_k2_widths(widths, rows: int, gen) -> dict:
    """K2 forward at ``rows`` rows of each width (``time_rmsnorm_rows``)."""
    out = {f"rmsnorm_d{d}": time_rmsnorm_rows(rows, d, gen) for d in widths}
    print_kernel_times(out)
    return out


def phase20() -> dict:
    """(a)-(d) of phase 20: see the module docstring."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    out = {"launches": [], "streams": {}, "serve": {}, "profiles": {}, "times": {}}
    gen = torch.Generator().manual_seed(SEED + 50)

    cfg = dataclasses.replace(serving_config(DS_ARCH), n_layers=DS_LAYERS)
    model = Model(cfg)
    plan = ", ".join(f"{seg.count} {seg.kind}" for seg in model.segments)
    print(f"  (a) {cfg.name} cut to {DS_LAYERS} layers ({plan}), "
          f"MLA q_lora {cfg.mla.q_lora_rank} / kv_lora {cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared, "
          f"dropless; {DS_REQUESTS} requests over both pools, {DS_SLOTS} slots of {DS_MAX_LEN}, "
          f"{DS_CHUNK}-token chunks")
    params = load_full_width(model, SEED + 51)
    out["load_peak_bytes"] = torch.cuda.max_memory_allocated()
    reqs = zamba_workload(cfg.vocab_size, DS_REQUESTS, (32, 161), (8, 25), SEED + 53)
    runs, peak = run_peak("absorbed decode", lambda: serve(
        model, params, reqs, n_slots=DS_SLOTS, max_len=DS_MAX_LEN, chunk=DS_CHUNK))
    out["streams"][cfg.name] = check_streams(model, params, reqs, runs, DS_MAX_LEN)
    check_near_tie_share(out["streams"][cfg.name], cfg.name)
    out["serve"][cfg.name] = serve_summary(runs, peak)
    out["launches"] += [r["launches"] for r in runs.values()]

    ecfg = dataclasses.replace(cfg, mla_absorb=False, name=f"{cfg.name} (expand)")
    emodel = Model(ecfg)
    print("    the expand path (the latent cache expanded per head each tick), contiguous pool")
    eruns, peak = run_peak("expand decode", lambda: serve(
        emodel, params, reqs, (("contiguous", None),), n_slots=DS_SLOTS, max_len=DS_MAX_LEN,
        chunk=DS_CHUNK))
    out["streams"][ecfg.name] = check_streams(emodel, params, reqs, eruns, DS_MAX_LEN)
    check_near_tie_share(out["streams"][ecfg.name], ecfg.name)
    out["serve"][ecfg.name] = serve_summary(eruns, peak)
    out["launches"] += [r["launches"] for r in eruns.values()]
    out["expand_equals_absorbed"] = sum(
        a == b for a, b in zip(eruns["contiguous"]["tokens"], runs["contiguous"]["tokens"]))
    print(f"    expand streams equal to the absorbed contiguous run's: "
          f"{out['expand_equals_absorbed']} of {len(reqs)}")

    preqs = ds_prefix_workload(cfg.vocab_size)
    print(f"    4 requests sharing a {DS_PREFIX}-token prefix on the paged pool with sharing")
    shared, peak = run_peak("shared prefix", lambda: serve_probed(
        model, params, preqs, "shared prefix", n_slots=DS_SLOTS, max_len=DS_MAX_LEN,
        chunk=DS_CHUNK, block_size=BLOCK_SIZE, prefix_sharing=True))
    st = shared["stats"]
    check(st.prefix_hits >= 1 and st.prefix_rows_shared >= DS_PREFIX,
          f"the shared-prefix run shared {st.prefix_rows_shared} rows in {st.prefix_hits} hits")
    out["streams"][f"{cfg.name} shared prefix"] = check_streams(model, params, preqs,
                                                                {"shared": shared}, DS_MAX_LEN)
    out["shared_prefix"] = dict(run_summary(shared), peak_bytes=peak)
    out["launches"].append(shared["launches"])

    print("    steady ticks (torch.profiler) and K2 at deepseek's widths")
    out["profiles"][cfg.name] = profile_ticks(
        model, params, (("contiguous", None), ("paged", BLOCK_SIZE)), n_slots=DS_SLOTS,
        max_len=DS_MAX_LEN, chunk=DS_CHUNK, prompt=(100, 160), seed=SEED + 54)
    out["profiles"][ecfg.name] = profile_ticks(
        emodel, params, (("contiguous", None),), n_slots=DS_SLOTS, max_len=DS_MAX_LEN,
        chunk=DS_CHUNK, prompt=(100, 160), seed=SEED + 54)
    m = cfg.mla
    out["times"][cfg.name] = time_k2_widths((cfg.d_model, m.q_lora_rank, m.kv_lora_rank),
                                            DS_SLOTS, gen)
    del params

    xcfg = dataclasses.replace(get_config(XL_ARCH), n_layers=XL_LAYERS)
    xmodel = Model(xcfg)
    plan = ", ".join(f"{seg.count} {seg.kind}" for seg in xmodel.segments)
    print(f"  (b) {xcfg.name} at full width cut to {xcfg.n_layers} layers ({plan}; "
          f"d_model {xcfg.d_model}, {xcfg.n_heads} heads), {XL_REQUESTS} requests over both pools, "
          f"{XL_SLOTS} slots of {XL_MAX_LEN}")
    params = load_full_width(xmodel, SEED + 55)
    reqs = zamba_workload(xcfg.vocab_size, XL_REQUESTS, (16, 65), (8, 33), SEED + 56)
    runs, peak = run_peak("xlstm", lambda: serve(
        xmodel, params, reqs, n_slots=XL_SLOTS, max_len=XL_MAX_LEN, chunk=XL_CHUNK))
    out["streams"][xcfg.name] = check_streams(xmodel, params, reqs, runs, XL_MAX_LEN)
    check_near_tie_share(out["streams"][xcfg.name], xcfg.name)
    out["serve"][xcfg.name] = serve_summary(runs, peak)
    out["launches"] += [r["launches"] for r in runs.values()]
    print(f"    speculative: a draft of the target plus noise {SPEC_NOISE}, gamma <= "
          f"{XL_SPEC_GAMMA}, both pools")
    spec, peak = run_peak("xlstm speculative", lambda: serve_speculative(
        xmodel, params, reqs, {"noisy": (noisy_params(params, SPEC_NOISE, SEED + 57),
                                         ("contiguous", "paged"))},
        n_slots=XL_SLOTS, max_len=XL_MAX_LEN, chunk=XL_CHUNK, gamma_max=XL_SPEC_GAMMA,
        plain_runs=runs))
    out["spec"] = {label: {"rounds": r["stats"].spec_rounds, "offered": r["offered"],
                           "accepted": r["accepted"], "gamma0_ticks": r["stats"].decode_ticks,
                           "draft_ticks": r["stats"].draft_ticks, "calls": r["calls"],
                           "launches": r["launches"], "wall_s": r["stats"].wall_seconds,
                           "equal_to_plain": r["equal_to_plain"], "peak_bytes": peak}
                   for label, r in spec["runs"].items()}
    out["streams"][f"{xcfg.name} speculative"] = spec["streams"]
    out["launches"] += [r["launches"] for r in spec["runs"].values()]
    zreqs = zamba_workload(xcfg.vocab_size, 3, (16, 33), (8, 17), SEED + 58, gap=0.0)
    print(f"    preemption: {len(zreqs)} requests with sharing on {XL_PREEMPT_BLOCKS} blocks "
          f"(recurrent states are never adopted)")
    pre, peak = run_peak("xlstm preempted", lambda: serve_preempted(
        xmodel, params, zreqs, "xlstm preempted", n_slots=XL_SLOTS, max_len=XL_MAX_LEN,
        chunk=XL_CHUNK, arena_blocks=XL_PREEMPT_BLOCKS))
    check(pre["run"]["prefix_hits"] == 0, "xlstm adopted a prefix")
    out["preempt"] = dict(pre, peak_bytes=peak)
    out["launches"].append(pre["run"]["launches"])
    print("    steady ticks (torch.profiler) and K2 at xlstm's widths")
    out["profiles"][xcfg.name] = profile_ticks(
        xmodel, params, (("contiguous", None), ("paged", BLOCK_SIZE)), n_slots=XL_SLOTS,
        max_len=XL_MAX_LEN, chunk=XL_CHUNK, prompt=(32, 64), seed=SEED + 59)
    out["times"][xcfg.name] = time_k2_widths(
        (xcfg.d_model, int(xcfg.d_model * xcfg.xlstm.mlstm_proj_factor)), XL_SLOTS, gen)
    del params
    return out


# ---------------------------------------------------------------------------
# Phase 21: training deepseek-v3 (MLA, MoE, MTP, Adafactor) and xLSTM (momentum)
# ---------------------------------------------------------------------------

#: deepseek-v3 at full width cut to ``DS_TRAIN_LAYERS`` layers (1 MLA dense,
#: 1 MLA MoE; the MTP head on), bf16, remat full, capacity-dropped routing,
#: Adafactor at ``DS_TRAIN_LR``: 8 workers, ``DS_TRAIN_B`` x 512 tokens at
#: beta 1, ``DS_TRAIN_STEPS`` steps. Its f32 step on the card vs the CPU
#: runs at the CPU tests' widths (``cfg.reduced``: d_model 128, 8 experts
#: of top 2, vocab 512; MTP on): at full width the host's step and its
#: f32 draw took ~95 s of the script's 1,200 on an H100 machine.
DS_TRAIN_LAYERS, DS_TRAIN_B, DS_TRAIN_STEPS, DS_TRAIN_LR = 2, 8, 12, 3e-4
#: The own-batch check's lr for deepseek: a fresh Adafactor's first step
#: moves every weight by about lr, which at d_model 7168 is a large step
#: (second-order effects, not the gradient's direction, decide whether a
#: step at the loop's lr lowers the loss); at 1e-5 the step is small
#: beside the weights and still moves bf16 weights near zero.
DS_CHECK_LR = 1e-5
#: xlstm-125m at full width cut to ``XL_LAYERS``, bf16, remat full, momentum ``XL_MU``
#: at ``XL_TRAIN_LR`` (SGD-like updates of the clipped gradient must move
#: bf16 weights: at lr 3e-4 a 155 M-parameter model's per-weight step,
#: ~1e-4 lr, is far below a bf16 step of its weights), ``XL_TRAIN_B`` x 512
#: tokens, ``XL_TRAIN_STEPS`` steps.
XL_TRAIN_B, XL_TRAIN_STEPS, XL_TRAIN_LR, XL_MU = 32, 12, 0.5, 0.9


def ds_train_config():
    """deepseek-v3 cut to ``DS_TRAIN_LAYERS`` layers, the first dense."""
    from repro_torch.configs import get_config

    cfg = get_config(DS_ARCH)
    return dataclasses.replace(cfg, n_layers=DS_TRAIN_LAYERS, remat="full",
                               moe=dataclasses.replace(cfg.moe, first_k_dense=1))


def own_batch_drop(model, params, opt, lr: float, global_batch: int) -> dict:
    """Two steps of ``opt`` from a fresh state on one batch of
    ``global_batch`` rows (8 workers, all responding): the second step's
    loss, the batch's loss after the first step, must be below the
    first's."""
    from repro_torch.runtime import make_train_step

    step = make_train_step(model, opt)
    batch = token_batch(model.cfg.vocab_size, 8, global_batch // 8, TRAIN_S, [1.0] * 8)
    batch = {k: v.to("cuda") if torch.is_tensor(v) else v for k, v in batch.items()}
    batch["lr"] = lr
    state = opt.init(params)
    _, state, m1 = step(params, state, batch)
    _, state, m2 = step(params, state, batch)
    before, after = float(m1["loss"]), float(m2["loss"])
    print(f"    one step on its own batch ({global_batch} x {TRAIN_S}, lr {lr}): loss "
          f"{before!r} -> {after!r}")
    check(after < before, "the step did not lower its own batch's loss")
    return {"loss_before": before, "loss_after": after}


def time_opt_step(params, opt, lr: float, label: str) -> dict:
    """The optimizer's in-place step over ``params`` (random gradients of
    their shapes and dtypes, a clip scale of 0.5): median device time of 3
    steps after one (CUDA events), beside its byte bound (each parameter
    and gradient read, each parameter written, each f32 state tensor read
    and written, at 3.35 TB/s)."""
    from repro_torch.models.layers import tree_leaves, tree_map

    grads = tree_map(lambda p: torch.randn_like(p).mul_(1e-3), params, is_leaf=torch.is_tensor)
    state = opt.init(params)
    scale = torch.tensor(0.5, device="cuda")
    ms = time_ms(lambda: opt.step(grads, state, params, lr, scale), n=3, warmup=1)
    leaves = tree_leaves(params, is_leaf=torch.is_tensor)
    nbytes = sum(3 * p.numel() * p.element_size() for p in leaves)
    nbytes += sum(2 * t.numel() * t.element_size()
                  for t in tree_leaves(state, is_leaf=torch.is_tensor) if t.dim())
    b, kind = bound(nbytes, 0)
    out = {"label": label, "ms": ms, "bound_ms": b, "bound_by": kind, "bytes": nbytes,
           "parameters": sum(p.numel() for p in leaves)}
    print(f"    {label}: {ms:.2f} ms a step over {out['parameters']:,} parameters; bound "
          f"{b:.2f} ms ({kind}: {nbytes / 1e9:.1f} GB)")
    return out


def check_k2_training_rows(shapes, widths, dtype) -> dict:
    """K2 forward and backward vs their plain versions at B * S rows of
    each width for every batch shape (B, S) a loop ran; the worst error of
    each."""
    gen = torch.Generator().manual_seed(SEED + 60)
    worst = {"rmsnorm": 0.0, "rmsnorm_bwd": 0.0}
    for rows in sorted({B * S for B, S in shapes}):
        for D in widths:
            worst["rmsnorm"] = max(worst["rmsnorm"], hold_rms_norm((rows, D), dtype, gen))
            worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"],
                                       hold_rms_norm_bwd((rows, D), dtype, gen))
    return worst


def train_family(label: str, model, params, steps: int, global_batch: int, opt_fn,
                 lr: float, widths, check_lr: float) -> dict:
    """Phase 21's loop for one model: the own-batch check from the loaded
    ``params`` at ``check_lr``, then the adaptive loop (``train_full_width``;
    the loss need not fall over so few steps), K2 at every shape the loop
    ran and at the widths' training rows (timed), one profiled step and
    the optimizer's step timed."""
    cfg = model.cfg
    out = {"own_batch": own_batch_drop(model, params, opt_fn(), check_lr, global_batch)}
    trained = train_full_width(model, steps, global_batch=global_batch, loss_falls=False,
                               optimizer=opt_fn(), lr=lr, params=params)
    out["train_loop"] = {k: v for k, v in trained.items() if k != "params"}
    out["launches"] = trained["launches"]
    print(f"    K2 forward and backward vs plain at every batch shape the loop ran, D "
          f"{', '.join(map(str, widths))}")
    out["k2_loop_shapes"] = check_k2_training_rows(trained["shapes"], widths,
                                                   getattr(torch, cfg.dtype))
    gen = torch.Generator().manual_seed(SEED + 61)
    out["k2_times"] = {f"d{D}": time_rmsnorm(global_batch * TRAIN_S, D, gen) for D in widths}
    for D, t in out["k2_times"].items():
        print(f"    D {D[1:]}:")
        print_times(t)
    print(f"    one {label} train step, profiled")
    out["profile"] = profile_train_step(model, params, opt_fn(), global_batch)
    out["opt_step"] = time_opt_step(params, opt_fn(), lr, f"{label}'s optimizer step")
    return out


def phase21() -> dict:
    """(a)-(e) of phase 21: see the module docstring."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import adafactor, momentum

    out = {"launches": [], "parity": {}}
    xcfg = get_config(XL_ARCH)
    xsmall = dataclasses.replace(xcfg, n_layers=2, dtype="float32",
                                 xlstm=dataclasses.replace(xcfg.xlstm, slstm_every=2))
    print(f"  (c) one train step of {XL_ARCH} at full width cut to 2 layers (mLSTM, sLSTM), "
          f"f32: kernels on the card vs plain on the CPU")
    out["parity"][XL_ARCH] = step_vs_plain(xsmall, per_step_launches(xsmall))
    dcfg = ds_train_config()
    dsmall = dcfg.reduced(n_layers=DS_TRAIN_LAYERS, remat="full")
    print(f"  (c) one train step of {DS_ARCH} at the CPU tests' widths ({dsmall.n_layers} "
          f"layers, d_model {dsmall.d_model}, {dsmall.moe.n_experts} experts of top "
          f"{dsmall.moe.top_k}, MTP on), f32: kernels on the card vs plain on the CPU")
    out["parity"][DS_ARCH] = step_vs_plain(dsmall, per_step_launches(dsmall))
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(dcfg)
    plan = ", ".join(f"{seg.count} {seg.kind}" for seg in model.segments)
    print(f"  (a) {dcfg.name} at full width cut to {DS_TRAIN_LAYERS} layers ({plan}), MTP on, "
          f"{dcfg.dtype}, remat {dcfg.remat!r}, capacity factor {dcfg.moe.capacity_factor}, "
          f"Adafactor at lr {DS_TRAIN_LR}: {DS_TRAIN_B} x {TRAIN_S} tokens, {DS_TRAIN_STEPS} "
          f"steps")
    params = load_full_width(model, SEED + 62)
    out["ds_load_peak_bytes"] = torch.cuda.max_memory_allocated()
    m = dcfg.mla
    out[DS_ARCH] = train_family(DS_ARCH, model, params, DS_TRAIN_STEPS, DS_TRAIN_B, adafactor,
                                DS_TRAIN_LR, (dcfg.d_model, m.q_lora_rank, m.kv_lora_rank),
                                DS_CHECK_LR)
    out["launches"].append(out[DS_ARCH]["launches"])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    xmodel = Model(dataclasses.replace(xcfg, n_layers=XL_LAYERS))
    plan = ", ".join(f"{seg.count} {seg.kind}" for seg in xmodel.segments)
    print(f"  (b) {xcfg.name} at full width cut to {XL_LAYERS} layers ({plan}), {xcfg.dtype}, "
          f"remat {xcfg.remat!r}, momentum {XL_MU} at lr {XL_TRAIN_LR}: {XL_TRAIN_B} x "
          f"{TRAIN_S} tokens, {XL_TRAIN_STEPS} steps")
    params = load_full_width(xmodel, SEED + 63)
    inner = int(xcfg.d_model * xcfg.xlstm.mlstm_proj_factor)
    out[XL_ARCH] = train_family(XL_ARCH, xmodel, params, XL_TRAIN_STEPS, XL_TRAIN_B,
                                lambda: momentum(XL_MU), XL_TRAIN_LR, (xcfg.d_model, inner),
                                XL_TRAIN_LR)
    out["launches"].append(out[XL_ARCH]["launches"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 22: hubert-xlarge trained through K1 at D 80; the simulation engines
# ---------------------------------------------------------------------------

HUBERT_ARCH = "hubert-xlarge"
#: The masked fastest-k steps' worker mask (the fastest 6 of 8) and their
#: count before one step with all 8; AdamW at ``HUBERT_LR`` on one batch.
HUBERT_K6 = (1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0)
HUBERT_MASKED_STEPS, HUBERT_LR = 3, 1e-4
#: benchmarks/perf_sim.py's Fig. 4 points (n 20, s 20, 24 seeds, an eval
#: every 10), cut from its 20,000 iterations to ``SIM_ITERS`` (a card's
#: iteration is host-bound at ~1.4 ms; at 5,000 the lanes walk 15 of
#: adaptive-(k, beta)'s 17 stages and 4 of adaptive-k's 10), and the seeds
#: the scalar engine runs.
SIM_POINTS = (("fig4_kbeta", "adaptive_kbeta"), ("fig4_k", "adaptive_k"))
SIM_N, SIM_SEEDS, SIM_ITERS, SIM_EVAL = 20, 24, 5_000, 10
SIM_SCALAR_SEEDS = (0, 23)
#: Iterations of each point's profiled window on the card.
SIM_PROFILE_ITERS = 256
#: Lane trajectories of two runs that sum in other orders: relative.
SIM_TRAJ_RTOL = 1e-9


def sim_setup(strategy: str):
    """perf_sim's problem (v 400, d 10, 20 workers), strategy and delay
    model, from the port's ``core``."""
    from repro_torch.core import LinregProblem, SimplifiedDelayModel, StrategyConfig

    problem = LinregProblem.generate(v=SIM_N * 20, d=10, n_workers=SIM_N, seed=1)
    cfg = StrategyConfig(strategy, n=SIM_N, s=20, k_max=SIM_N // 2,
                         beta_grid=(0.2, 0.4, 0.6, 0.8, 1.0))
    return problem, cfg, SimplifiedDelayModel(lambda_y=1.0, x=0.01)


def sim_cpu_task(strategy: str, seed, iters: int):
    """Run in a worker process: ``simulate_batch`` on the CPU (``seed``
    None) or the scalar ``simulate`` at ``seed``, ``iters`` iterations;
    (result, wall seconds)."""
    from repro_torch.core import simulate, simulate_batch

    torch.set_num_threads(1)
    problem, cfg, model = sim_setup(strategy)
    t0 = time.perf_counter()
    if seed is None:
        res = simulate_batch(problem, cfg, model, seeds=SIM_SEEDS, max_iters=iters,
                             eval_every=SIM_EVAL, device="cpu")
    else:
        res = simulate(problem, cfg, model, seed=seed, max_iters=iters, eval_every=SIM_EVAL)
    return res, time.perf_counter() - t0


def train_hubert(model, params) -> dict:
    """hubert at full width and depth on one batch of ``TRAIN_B`` x
    ``TRAIN_S`` frames (8 workers): ``HUBERT_MASKED_STEPS`` AdamW steps
    with the fastest 6 of 8 contributing, then one with all 8. Each step's
    launches must be ``per_step_launches`` (K1 forward twice a layer under
    full remat, backward once), the masked steps' own-batch loss must
    fall, every loss be finite; the training peak is printed."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw
    from repro_torch.runtime import make_train_step

    cfg = model.cfg
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = step_batch(cfg, 8, TRAIN_B // 8, TRAIN_S, HUBERT_K6)
    batch = {k: v.to("cuda") if torch.is_tensor(v) else v for k, v in batch.items()}
    batch["lr"] = HUBERT_LR
    expect = per_step_launches(cfg)
    total = dict.fromkeys(expect, 0)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(HUBERT_MASKED_STEPS + 1):
        if i == HUBERT_MASKED_STEPS:
            batch["worker_mask"] = torch.ones(8, device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check(counts == expect, f"hubert step {i}: launches {counts}, not {expect}")
        for k, v in counts.items():
            total[k] += v
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "contributors": float(m["contributors"]), "wall_s": wall}
        steps.append(rec)
        print(f"    step {i}: k = {rec['contributors']:.0f} of 8, loss {rec['loss']!r}, grad "
              f"norm {rec['grad_norm']:.4f}, {wall:.2f} s; K1 forward "
              f"{counts['flash_attention']}, backward {counts['flash_attention_bwd']}")
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in steps]
    check(all(np.isfinite(losses)), "a hubert loss is not finite")
    check([r["contributors"] for r in steps] == [6.0] * HUBERT_MASKED_STEPS + [8.0],
          "the worker masks did not contribute 6, then 8 workers")
    masked = losses[:HUBERT_MASKED_STEPS]
    check(masked[-1] < masked[0], f"the masked steps' own-batch loss did not fall: {masked}")
    print(f"    own-batch loss {masked[0]!r} -> {masked[-1]!r} over the k = 6 steps; training "
          f"peak memory {peak / 2**30:.2f} GiB")
    return {"steps": steps, "per_step": expect, "launches": total, "peak_bytes": peak}


def phase22a(card: str) -> tuple:
    """(a) of phase 22 but its profiled step: see the module docstring.
    Returns its results, the full-depth model and its trained
    parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params_analytic

    cfg = get_config(HUBERT_ARCH)
    out = {}
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    print(f"  (a) one train step of {HUBERT_ARCH} at full width cut to 2 layers, f32, frames "
          f"in: kernels on the card vs plain on the CPU")
    out["parity"] = step_vs_plain(small, per_step_launches(small))
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    print(f"  (a) {HUBERT_ARCH} at full width and depth: {count_params_analytic(cfg):,} "
          f"parameters, {cfg.n_layers} encoder layers of {cfg.n_heads} x {cfg.head_dim} heads, "
          f"{cfg.dtype}, remat {cfg.remat!r}, AdamW at lr {HUBERT_LR}; {TRAIN_B} x {TRAIN_S} "
          f"frames of the frame stream, 8 workers, beta 1")
    params = load_full_width(model, SEED + 70)
    out["load_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["parameters"] = count_params_analytic(cfg)
    out.update(train_hubert(model, params))
    gen = torch.Generator().manual_seed(SEED + 71)
    shape = (TRAIN_B, TRAIN_S, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
    print("    K1 forward and backward vs plain at the step's shape (non-causal, bf16)")
    out["k1_err"] = hold_flash(shape, False, torch.bfloat16, gen)
    print("    K1 at the step's shape (CUDA events, cold L2, median of 30)")
    out["k1_times"] = time_flash(TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                 gen, causal=False)
    print_times(out["k1_times"])
    return out, model, params


def sim_log(log) -> list:
    return [(int(i), st.k, st.beta) for i, st in log]


def hold_sim(label: str, card, cpu, scalars: dict) -> dict:
    """The card's ``simulate_batch`` against the CPU's (stage logs,
    iterations, eval counts exactly; times and costs within 1e-12, gaps
    within ``SIM_TRAJ_RTOL``, relative) and its lanes against the scalar
    engine's runs at their seeds."""
    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / np.maximum(np.abs(np.asarray(b)), 1e-300)))

    logs = [sim_log(a) == sim_log(b) for a, b in zip(card.stage_logs, cpu.stage_logs)]
    check(all(logs), f"{label}: stage logs differ on lanes "
                     f"{[i for i, ok in enumerate(logs) if not ok]}")
    for f in ("iterations", "reached", "n_evals"):
        check(np.array_equal(getattr(card, f), getattr(cpu, f)), f"{label}: {f} differ")
    err = {f: rel(getattr(card, f), getattr(cpu, f))
           for f in ("times", "comp_at_eval", "comm_at_eval", "runtime")}
    check(all(e <= 1e-12 for e in err.values()), f"{label}: times or costs differ: {err}")
    err["gaps"] = rel(card.gaps, cpu.gaps)
    check(err["gaps"] <= SIM_TRAJ_RTOL, f"{label}: gaps differ by {err['gaps']:.3e}")
    times_bitwise = bool(np.array_equal(card.times, cpu.times))
    lanes = {}
    for seed, sc in scalars.items():
        lane = card.lane(seed)
        check(sim_log(lane.stage_log) == sim_log(sc.stage_log),
              f"{label}: lane {seed}'s stage log is not the scalar engine's")
        lanes[seed] = {"gaps": rel(lane.gaps, sc.gaps), "times": rel(lane.times, sc.times),
                       "stages": len(sc.stage_log)}
        check(lanes[seed]["gaps"] <= SIM_TRAJ_RTOL and lanes[seed]["times"] <= 1e-12,
              f"{label}: lane {seed} vs the scalar engine: {lanes[seed]}")
    stages = [len(log) for log in card.stage_logs]
    print(f"    {label}: stage logs equal on all {len(logs)} lanes ({min(stages)}-{max(stages)} "
          f"stages), card vs CPU max relative gap diff {err['gaps']:.3e}, times bit for bit "
          f"{times_bitwise}; scalar lanes {lanes}")
    return {"max_rel": err, "times_bitwise": times_bitwise, "scalar_lanes": lanes,
            "stages": stages}


def schedule_readout() -> dict:
    """``evaluate_schedule`` at the reference's Fig. 4 calibration
    (tests/test_paper_claims.py): ours vs adaptive-k runtime ratio,
    computation saved and communication added."""
    from repro_torch.core import SGDHyperParams, StrategyConfig, evaluate_schedule

    problem, _, model = sim_setup("adaptive_k")
    lam = np.linalg.eigvalsh(2.0 * problem.X.T @ problem.X / problem.v)
    c = float(2.0 * lam.min())
    fl1 = 0.1846 * problem.eta / 9.284e-6
    hp = SGDHyperParams(eta=problem.eta, L=2.0, c=c, s=problem.s,
                        sigma_grad2=fl1 * 2 * c * problem.s / (problem.eta * 2.0))
    e0 = problem.gap(np.zeros(problem.d))
    res = {s: evaluate_schedule(StrategyConfig(s, n=SIM_N, s=20, k_max=SIM_N // 2,
                                               beta_grid=(0.2, 0.4, 0.6, 0.8, 1.0)),
                                model, hp, e0=e0, target=2e-2)
           for s in ("adaptive_kbeta", "adaptive_k")}
    ours, ak = res["adaptive_kbeta"], res["adaptive_k"]
    out = {"runtime_ratio": ours.runtime / ak.runtime,
           "computation_change": ours.comp_cost / ak.comp_cost - 1,
           "communication_change": ours.comm_cost / ak.comm_cost - 1,
           "stages": [ours.n_stages, ak.n_stages]}
    print(f"    evaluate_schedule (host): runtime ratio {out['runtime_ratio']!r}, computation "
          f"{100 * out['computation_change']:+.2f} %, communication "
          f"{100 * out['communication_change']:+.2f} % (ours vs adaptive-k)")
    return out


def phase22b(cpu: dict, card: str) -> dict:
    """(b) of phase 22: see the module docstring. ``cpu`` holds the worker
    processes' results, which have all ended: nothing else runs on the
    host while the card's simulations are timed and profiled."""
    from repro_torch.core import simulate_batch

    out = {"points": {}}
    for name, strategy in SIM_POINTS:
        problem, cfg, model = sim_setup(strategy)

        def run(iters: int):
            return simulate_batch(problem, cfg, model, seeds=SIM_SEEDS, max_iters=iters,
                                  eval_every=SIM_EVAL, device="cuda")

        run(SIM_PROFILE_ITERS)
        profile = window(f"{name} simulate_batch, {SIM_SEEDS} lanes",
                         lambda: run(SIM_PROFILE_ITERS), lambda: run(SIM_PROFILE_ITERS),
                         SIM_PROFILE_ITERS, "iteration")
        t0 = time.perf_counter()
        card_res = run(SIM_ITERS)
        card_s = time.perf_counter() - t0
        cpu_res, cpu_s = cpu[name, None]
        scalars = {sd: cpu[name, sd][0] for sd in SIM_SCALAR_SEEDS}
        scalar_s = statistics.mean(cpu[name, sd][1] for sd in SIM_SCALAR_SEEDS)
        print(f"    {name} ({strategy}, n {SIM_N}, {SIM_SEEDS} seeds, {SIM_ITERS} iterations): "
              f"card {card_s:.2f} s, CPU {cpu_s:.2f} s (one thread, in a worker process), "
              f"scalar engine {scalar_s:.2f} s a seed; card {card}")
        held = hold_sim(name, card_res, cpu_res, scalars)
        out["points"][name] = {"card_s": card_s, "cpu_s": cpu_s, "scalar_s_per_seed": scalar_s,
                               "us_per_iteration_card": card_s / SIM_ITERS * 1e6,
                               "profile": profile, **held}
    out["schedule"] = schedule_readout()
    return out


def phase22(card: str) -> dict:
    """Phase 22: the CPU's simulations start in worker processes (one a
    point and scalar seed), and (a) trains hubert on the card meanwhile;
    once every worker has ended, one hubert step is profiled and (b) runs
    the card's simulations and holds them to the CPU's."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.optim import adamw

    ctx = multiprocessing.get_context("spawn")
    jobs = [(name, seed) for name, _ in SIM_POINTS for seed in (None, *SIM_SCALAR_SEEDS)]
    with concurrent.futures.ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
        futures = {(name, seed): pool.submit(sim_cpu_task, dict(SIM_POINTS)[name], seed,
                                             SIM_ITERS)
                   for name, seed in jobs}
        hubert, model, params = phase22a(card)
        cpu = {key: f.result() for key, f in futures.items()}
    print(f"    one profiled hubert train step (k = 4 of 8), the worker processes ended; "
          f"card {card}")
    hubert["profile"] = profile_train_step(model, params, adamw(), TRAIN_B)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) the simulation engines: simulate_batch's lanes on the card (float64) vs "
          f"on the CPU, and vs the scalar engine at seeds {SIM_SCALAR_SEEDS}; a window of "
          f"{SIM_PROFILE_ITERS} iterations profiled at each point")
    return {"hubert": hubert, "sim": phase22b(cpu, card)}


# ---------------------------------------------------------------------------
# Phase 23: the chaos search at full width, and the int8 codec
# ---------------------------------------------------------------------------

#: Sampled chaos schedules on the card: ``sample_schedule(default_rng([0,
#: i]))`` for i < CHAOS_SCHEDULES, as ``--fast`` runs them.
CHAOS_SCHEDULES = 4
CHAOS_KNOBS = {"max_ticks": 6_000}
#: ``tests/test_chaos_search.py``'s leak schedule: (step, kind, worker,
#: factor) events and one (src, dst, op, nth, ticks) directive, singleton
#: dispatch (cost 10.0 a copy), so that the fail's cancel is the only one.
CHAOS_LEAK_EVENTS = ((8, "fail", 1, 1.0), (70, "rejoin", 1, 1.0), (40, "slow", 2, 2.0))
CHAOS_LEAK_DIRECTIVES = (("r1", "fe", "delay", 50, 3),)
#: The codec's gradient tree: llama3.2-1b's parameter shapes in bf16, a
#: float32 residual of 0.01 x N(0, 1); the leaves also encoded on the CPU.
CODEC_SEED = SEED + 40
CODEC_LEAVES = {"embed": ("embed",), "attention wq": ("stack", 0, 0, "attn", "wq"),
                "mlp w_in": ("stack", 0, 0, "ffn", "w_in")}


def load_chaos_search():
    """``tools/chaos_search_torch.py`` as a module of its own, loaded by
    path (``tools`` is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chaos_search_torch", ROOT / "tools" / "chaos_search_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class CardChaos:
    """The chaos twin's ``run_schedule`` as the card runs it; installed as
    the module's ``run_schedule``, so that ``shrink``'s probes go through
    it too. Each run's launch counters are reset just before it and read
    just after; every call of every replica must launch what phase 4's
    calls do (``CallProbe``); the shapes K2 and K4 are launched at are
    recorded (``recording``). ``byte_identity`` is held by the near-tie
    rule: where a run's streams part from the offline references and
    every request completed, ``check_streams`` (teacher-forced offline
    decode) must excuse every departure, and the excused violation leaves
    the report. Every other oracle stays exact."""

    def __init__(self, chaos, wl):
        self.run, self.max_len = chaos.run_schedule, chaos.MAX_LEN
        self.runs, self.probes = [], []
        self.launches = defaultdict(int)
        self.shapes = {"rmsnorm": set(), "paged_decode_attention": set()}
        fleet = wl.fleet

        def probed(obs):
            replicas = fleet(obs)
            self.probes.append(CallProbe(*(rep.engine for rep in replicas)))
            return replicas
        wl.fleet = probed

    @contextlib.contextmanager
    def recording(self):
        """Record the input shapes of K2 and K4 as the model calls them."""
        import repro_torch.models.attention as attention
        import repro_torch.models.layers as layers

        k2, k4 = layers._rms_norm_kernel, attention._paged_decode_kernel

        def rms(x, *a):
            self.shapes["rmsnorm"].add(tuple(x.shape))
            return k2(x, *a)

        def paged(q, k, v, tables, lengths):
            self.shapes["paged_decode_attention"].add(
                (tuple(q.shape), tuple(k.shape), tuple(tables.shape)))
            return k4(q, k, v, tables, lengths)
        layers._rms_norm_kernel, attention._paged_decode_kernel = rms, paged
        try:
            yield
        finally:
            layers._rms_norm_kernel, attention._paged_decode_kernel = k2, k4

    def __call__(self, wl, sched, **knobs):
        from repro_torch.kernels import launch_counts, reset_launch_counts

        label = f"chaos run {len(self.runs)}"
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        report = self.run(wl, sched, **knobs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        calls = check_spec_launches(wl.model.cfg, self.probes[-1], counts, True, label)
        for k, v in counts.items():
            self.launches[k] += v
        excused = 0
        if "byte_identity" in report.signature() and len(report.streams) == len(wl.requests):
            streams = check_streams(wl.model, wl.params, wl.requests,
                                    {label: {"tokens": [report.streams[g] for g in
                                                        range(len(wl.requests))]}},
                                    self.max_len)
            excused = streams["near_ties"]
            report.violations = [v for v in report.violations
                                 if v["oracle"] != "byte_identity"]
        launched = {k: v for k, v in counts.items() if v}
        self.runs.append({"schedule": sched.as_dict(), "knobs": knobs,
                          "signature": list(report.signature()), "ticks": report.ticks,
                          "seconds": seconds, "summary": report.summary,
                          "calls": {k: v["calls"] for k, v in calls.items()},
                          "launches": launched, "near_ties_excused": excused})
        print(f"  {label}: {sched.size()} atoms, cost {sched.cost_per_replica}, knobs {knobs}: "
              f"signature {report.signature()}, {report.ticks} plane ticks, {seconds:.2f} s; "
              f"{excused} near-ties excused; summary {report.summary}; launches {launched}")
        return report


def hold_paged_decode(q_shape, arena_shape, table_shape, gen) -> float:
    """K4 (bf16) at a shape phase 23 launched, held by ``hold_paged_tables``:
    random arenas of ``arena_shape``, each row's live blocks drawn from
    the arena without replacement, row 0 full and the others of random
    lengths."""
    dev, dt = torch.device("cuda"), torch.bfloat16
    (B, H, D), (n, bs, Hkv, _), T = q_shape, arena_shape, table_shape[1]
    q = torch.randn(q_shape, generator=gen).to(dev, dt)
    k_ar = torch.randn(arena_shape, generator=gen).to(dev, dt)
    v_ar = torch.randn(arena_shape, generator=gen).to(dev, dt)
    lens = [T * bs] + torch.randint(1, T * bs + 1, (B - 1,), generator=gen).tolist()
    ids = (torch.randperm(n - 1, generator=gen) + 1).tolist()
    tables = torch.zeros(table_shape, dtype=torch.int32)
    for b in range(B):
        for t in range(-(-lens[b] // bs)):
            tables[b, t] = ids.pop()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return hold_paged_tables(q, k_ar, v_ar, tables.to(dev), lengths,
                             f"K4 bf16 q {q_shape}, arenas {arena_shape}, tables "
                             f"{table_shape}, lengths {lens}")


def phase23a(card: str) -> dict:
    """(a) The chaos search at llama3.2-1b's full width: the sampled
    schedules pass every oracle; the leak schedule trips
    ``block_conservation`` with the seeded bug armed, shrinks to its one
    fail atom, replays to the same signature twice and passes every
    oracle unarmed; K2 and K4 are held against plain and timed at the
    shapes the runs launched them at."""
    chaos = load_chaos_search()
    t0 = time.perf_counter()
    wl = chaos.Workload(ARCH, n_requests=4, reduced=False, device="cuda")
    torch.cuda.synchronize()
    print(f"    workload {wl.as_dict()}: {wl.model.cfg.dtype}, prompts "
          f"{[len(p) for p, _, _ in wl.requests]}, new tokens "
          f"{[m for _, m, _ in wl.requests]}; weights and offline references in "
          f"{time.perf_counter() - t0:.1f} s")
    runner = CardChaos(chaos, wl)
    chaos.run_schedule = runner
    out = {"workload": wl.as_dict()}
    with runner.recording():
        for i in range(CHAOS_SCHEDULES):
            sched = chaos.sample_schedule(np.random.default_rng([0, i]))
            report = runner(wl, sched, **CHAOS_KNOBS)
            check(report.ok, f"sampled schedule {i} {sched.as_dict()}: {report.violations}")
        leak = chaos.Schedule(
            events=[chaos.FaultEvent(step=s, kind=k, worker=w, factor=f)
                    for s, k, w, f in CHAOS_LEAK_EVENTS],
            directives=[chaos.FaultDirective(a, b, op, nth, ticks=t)
                        for a, b, op, nth, t in CHAOS_LEAK_DIRECTIVES],
            partitions=[], cost_per_replica=10.0)
        print(f"    the leak schedule {leak.as_dict()} with the seeded bug armed, shrunk")
        sig = runner(wl, leak, leak_blocks=True, **CHAOS_KNOBS).signature()
        check("block_conservation" in sig, f"the armed leak schedule gave {sig}")
        n_before = len(runner.runs)
        small = chaos.shrink(wl, leak, sig, leak_blocks=True, **CHAOS_KNOBS)
        shrink_runs = len(runner.runs) - n_before
        check(small.size() == 1 and small.events and small.events[0].kind == "fail",
              f"the leak schedule shrank to {small.as_dict()}")
        replays = [runner(wl, small, leak_blocks=True, **CHAOS_KNOBS).signature()
                   for _ in range(2)]
        check(replays == [sig, sig], f"the shrunk repro replayed as {replays}, not {sig}")
        print("    the leak schedule unarmed")
        clean = runner(wl, leak, **CHAOS_KNOBS)
        check(clean.ok, f"the unarmed leak schedule: {clean.violations}")
    out.update(runs=runner.runs, leak_signature=list(sig), shrunk=small.as_dict(),
               shrink_runs=shrink_runs, launches=dict(runner.launches),
               shapes={k: sorted(v) for k, v in runner.shapes.items()},
               near_ties_excused=sum(r["near_ties_excused"] for r in runner.runs))
    on_path = {k for k, v in runner.launches.items() if v}
    check(on_path == {"rmsnorm", "paged_decode_attention"},
          f"phase 23's chaos runs launched {dict(runner.launches)}")
    print(f"    {len(runner.runs)} runs ({shrink_runs} of them shrink probes); launches "
          f"{dict(runner.launches)}; K2 shapes {sorted(runner.shapes['rmsnorm'])}; K4 shapes "
          f"{sorted(runner.shapes['paged_decode_attention'])}")

    print("    K2 and K4 vs plain PyTorch at the shapes the chaos runs launched")
    gen = torch.Generator().manual_seed(SEED + 41)
    worst = {"rmsnorm": max(hold_rms_norm(s, torch.bfloat16, gen)
                            for s in sorted(runner.shapes["rmsnorm"])),
             "paged_decode_attention": max(hold_paged_decode(*s, gen)
                                           for s in sorted(
                                               runner.shapes["paged_decode_attention"]))}
    print("    timing (CUDA events, cold L2, median of 60)")
    cfg = wl.model.cfg
    lens = [len(p) + m - 1 for p, m, _ in wl.requests[:2]]
    times = {"paged_decode_attention": time_decode(
        2, chaos.MAX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, lens, gen,
        block=chaos.BLOCK_SIZE)["paged_decode_attention"]}
    for rows in sorted({int(np.prod(s[:-1])) for s in runner.shapes["rmsnorm"]}):
        times[f"rmsnorm_{rows}_rows"] = time_rmsnorm_rows(rows, cfg.d_model, gen)
    print_kernel_times(times)
    out.update(max_abs_err=worst, kernel_times=times)
    return out


def tree_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def phase23b(card: str) -> dict:
    """(b) The int8 error-feedback codec over a seeded bf16 gradient tree
    of llama3.2-1b's parameter shapes (and a float32 residual), on the
    card: a few leaves encoded and compressed on the card and on the CPU,
    bit for bit; every leaf's round trip within scale/2 (plus one f32
    epsilon of |v|: the quotient's and the product's roundings); one
    ``ef_compress_tree`` over the whole tree timed and its launches
    counted, beside its byte bound."""
    from repro_torch.configs import get_config
    from repro_torch.dist import Int8Codec, ef_compress_tree
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves, tree_map

    specs = Model(get_config(ARCH)).param_specs()
    gen = torch.Generator(device="cuda").manual_seed(CODEC_SEED)
    grads = tree_map(lambda s: torch.randn(s.shape, generator=gen, device="cuda",
                                           dtype=torch.bfloat16), specs)
    resid = tree_map(lambda s: 0.01 * torch.randn(s.shape, generator=gen, device="cuda"), specs)
    n = sum(x.numel() for x in tree_leaves(grads))
    print(f"    gradient tree: {len(tree_leaves(grads))} bf16 leaves, {n:,} elements; float32 "
          f"residual")
    equal = {}
    for name, path in CODEC_LEAVES.items():
        g, r = tree_at(grads, path), tree_at(resid, path)
        v = g.float() + r
        q, s = Int8Codec.encode(v)
        qc, sc = Int8Codec.encode(v.cpu())
        (d, nr), (dc, nrc) = (ef_compress_tree({"g": g}, {"g": r}),
                              ef_compress_tree({"g": g.cpu()}, {"g": r.cpu()}))
        same = {"q": torch.equal(q.cpu(), qc),
                "scale": torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32)),
                "decoded": torch.equal(d["g"].cpu().view(torch.int16), dc["g"].view(torch.int16)),
                "residual": torch.equal(nr["g"].cpu().view(torch.int32),
                                        nrc["g"].view(torch.int32))}
        equal[name] = same
        print(f"  {name} {tuple(g.shape)}: scale {s.item():.6e}; card == CPU bit for bit: {same}")
        check(all(same.values()), f"the codec on the card differs from the CPU at {name}: {same}")
        del v, q, qc, d, nr, dc, nrc
    excess = 0.0
    for g, r in zip(tree_leaves(grads), tree_leaves(resid)):
        v = g.float() + r
        q, s = Int8Codec.encode(v)
        err = (Int8Codec.decode(q, s).double() - v.double()).abs() - s.double() / 2
        eps = torch.finfo(torch.float32).eps * v.abs().double()
        excess = max(excess, (err / eps.clamp(min=torch.finfo(torch.float64).tiny)).max().item())
        check(bool((err <= eps).all()), "a codec round trip exceeds scale/2 + eps |v|")
        del v, q, err, eps
    print(f"  every leaf: |decode(encode(v)) - v| <= scale/2 + eps |v|; the largest excess over "
          f"scale/2: {max(excess, 0.0):.3f} eps |v|")
    launches = device_events(lambda: ef_compress_tree(grads, resid))
    ms = time_ms(lambda: ef_compress_tree(grads, resid), n=5, warmup=1)
    b, kind = bound(n * (2 + 4 + 2 + 4), 0)
    print(f"  ef_compress_tree over the whole tree: {ms:.3f} ms (CUDA events, cold L2, median "
          f"of 5), {launches} device events; bound {b:.3f} ms ({kind}: bf16 g and f32 r read, "
          f"bf16 decoded and f32 residual written), {ms / b:.1f}x; card {card}")
    del grads, resid
    gc.collect()
    torch.cuda.empty_cache()
    return {"elements": n, "leaves_equal_to_cpu": equal, "max_excess_over_half_scale_eps": excess,
            "ms": ms, "bound_ms": b, "bound_by": kind, "device_events": launches}


def phase23(card: str) -> dict:
    """Phase 23: (a) the chaos search at full width, (b) the codec."""
    print(f"  (a) the chaos search over {ARCH} at full width: 3 paged replicas of 2 slots, "
          f"64 rows, block 8, one params dict, 4 requests")
    search = phase23a(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (b) the int8 error-feedback codec over {ARCH}'s gradient tree")
    return {"chaos_search": search, "compression": phase23b(card)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Model, count_params_analytic

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.load_library()
    print(f"[2] built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())
    print("    K1's bf16 kernels on the main paths (cuobjdump -sass, ptxas -v):")
    tensor_cores = check_tensor_cores(lib, _build.build_log())
    print("    K5's bf16 kernels (cuobjdump -sass, ptxas -v):")
    ssd_tensor_cores = check_ssd_tensor_cores(lib, _build.build_log())
    print("    K3's and K4's split and merge kernels (ptxas -v):")
    decode_resources = check_decode_resources(_build.build_log())
    print("    K2's forward, backward and dscale-sum kernels (ptxas -v):")
    rmsnorm_resources = check_rmsnorm_resources(_build.build_log())

    print("[3] kernels vs plain PyTorch on the card")
    worst = check_kernels()

    cfg = get_config(ARCH)
    print(f"[4] serving {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}")
    model = Model(cfg)
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    runs = serve(model, params, workload(cfg.vocab_size))
    check_streams(model, params, workload(cfg.vocab_size), runs, MAX_LEN)

    print("[5] timing (CUDA events, cold L2, median of 60)")
    times, long_decode = time_kernels(cfg, workload(cfg.vocab_size))
    print("[6] where serving time goes (torch.profiler)")
    profiled = profile_serving(model, params)
    del params

    print("[7] training kernels vs plain PyTorch on the card")
    train_worst = check_training_kernels()
    print(f"[8] one train step, {cfg.name} at full width cut to 2 layers, f32: kernels on "
          f"the card vs plain on the CPU")
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    parity = step_vs_plain(small, per_step_launches(small))
    print(f"[9] training {cfg.name} at full width through the adaptive-(k, beta) loop: "
          f"{cfg.n_layers} layers, {cfg.dtype}, remat {cfg.remat!r}, {TRAIN_B} x {TRAIN_S} "
          f"tokens at beta 1")
    trained = train_full_width(model, TRAIN_STEPS)
    print("    the training kernels vs plain PyTorch at each batch shape the loop ran")
    check_loop_shapes(cfg, trained["shapes"], train_worst)
    print("[10] training kernels' times (CUDA events, cold L2, median of 30) and one "
          "profiled train step")
    train_times = time_training_kernels(cfg)
    train_profile = profile_train_step(model, trained.pop("params"))
    del model

    print("[11] the SSD scan (K5) forward and backward vs plain PyTorch on the card")
    train_worst.update(check_ssd_kernels())
    zcfg = get_config(ZAMBA_ARCH)
    zsmall = dataclasses.replace(zcfg, n_layers=2, attn_every=2, dtype="float32")
    print(f"[12] one train step, {zcfg.name} at full width cut to 2 Mamba2 layers and one "
          f"shared call, f32: kernels on the card vs plain on the CPU")
    zparity = step_vs_plain(zsmall, per_step_launches(zsmall))
    zmodel = Model(zcfg)
    print(f"[13] training {zcfg.name} at full width through the adaptive-(k, beta) loop: "
          f"{zcfg.n_layers} Mamba2 layers and {zcfg.n_layers // zcfg.attn_every} shared "
          f"calls, {zcfg.dtype}, remat {zcfg.remat!r}, {ZAMBA_TRAIN_B} x {TRAIN_S} tokens at "
          f"beta 1, {count_params_analytic(zcfg):,} parameters")
    ztrained = train_full_width(zmodel, ZAMBA_STEPS, global_batch=ZAMBA_TRAIN_B)
    print("    K5, K1 and K2 vs plain PyTorch at each batch shape the loop ran")
    check_zamba_loop_shapes(zcfg, ztrained["shapes"], train_worst)
    print("[14] the SSD scan's and the shared block's K1 times (CUDA events, cold L2, "
          "median of 30) and one profiled zamba2 train step")
    ssd_times = time_ssd_kernels(zcfg)
    dw = 2 * zcfg.d_model
    zamba_flash_times = time_flash(TRAIN_B, TRAIN_S, zcfg.n_heads, zcfg.n_heads,
                                   dw // zcfg.n_heads, torch.Generator().manual_seed(SEED + 8))
    print_times(zamba_flash_times)
    zamba_rms_times = time_rmsnorm(TRAIN_B * TRAIN_S, 2 * zcfg.d_model,
                                   torch.Generator().manual_seed(SEED + 9))
    print_times(zamba_rms_times)
    zamba_profile = profile_train_step(zmodel, ztrained.pop("params"))
    worst["rmsnorm"] = max(worst["rmsnorm"], train_worst["rmsnorm"])

    t15 = time.perf_counter()
    zscfg = dataclasses.replace(zcfg, n_layers=Z_SERVE_LAYERS)
    print(f"[15] serving {zcfg.name} at full width cut to {zscfg.n_layers} Mamba2 layers, "
          f"{zscfg.n_layers // zscfg.attn_every} shared calls of {zcfg.n_heads} x "
          f"{dw // zcfg.n_heads}, vocab {zcfg.vocab_size}, {zcfg.dtype}")
    print(f"    cut to 2 Mamba2 layers and one shared call, f32: a prefill chunk and 4 "
          f"ticks with a lane masked, kernels on the card vs plain on the CPU")
    zdecode_parity = zamba_decode_vs_plain(zcfg)
    zmodel = Model(zscfg)
    zparams = zmodel.init(SEED, device="cuda")
    print(f"    {Z_REQUESTS} requests through ServeEngine, {Z_SLOTS} slots of {Z_MAX_LEN} "
          f"rows, {Z_CHUNK}-token prefill chunks")
    zruns, zstreams = serve_zamba(zmodel, zparams)
    print("    timing (CUDA events, cold L2, median of 60)")
    zamba_decode_times = time_zamba_kernels(zcfg, zamba_workload(zcfg.vocab_size))
    print("    where zamba2 serving time goes (torch.profiler)")
    zamba_serve_profile = profile_zamba_serving(zmodel, zparams)
    zamba_serve_seconds = time.perf_counter() - t15
    print(f"    phase 15 took {zamba_serve_seconds:.1f} s")

    t16 = time.perf_counter()
    print("[16] speculative serving: draft ticks, one verify, exact-argmax acceptance and "
          "a rollback, gamma adapted to the acceptance rate")
    print("    cut to 2 layers (zamba2: 2 Mamba2 layers, one shared call), f32: "
          "verify_with_cache and the replay, kernels on the card vs plain on the CPU")
    spec_parity = {"dense": verify_vs_plain(cfg), "hybrid": verify_vs_plain(zcfg)}
    model = Model(cfg)
    params = model.init(SEED, device="cuda")
    reqs = workload(cfg.vocab_size)
    print(f"    {cfg.name}: the first {SPEC_REQUESTS} of phase 4's {len(reqs)} requests, "
          f"{N_SLOTS} slots of {MAX_LEN} rows, gamma <= {SPEC_GAMMA}, drafts: the target plus noise {SPEC_NOISE} (noisy), "
          f"the target itself (perfect), and plus noise {SPEC_POOR} (poor; "
          f"contiguous pool)")
    noisy = noisy_params(params, SPEC_NOISE, SEED + 20)
    both = ("contiguous", "paged")
    spec = serve_speculative(model, params, reqs[:SPEC_REQUESTS],
                             {"noisy": (noisy, both), "perfect": (params, both),
                              "poor": (noisy_params(params, SPEC_POOR, SEED + 26),
                                       ("contiguous",))},
                             n_slots=N_SLOTS, max_len=MAX_LEN, chunk=PREFILL_CHUNK,
                             gamma_max=SPEC_GAMMA, plain_runs=runs)
    check("tick" in spec["runs"]["poor draft, contiguous"]["calls"],
          "the poor draft never made the controller fall back to gamma = 0")
    zreqs = zamba_workload(zcfg.vocab_size, Z_SPEC_REQUESTS, (16, 33), (8, 17), SEED + 24,
                           gap=0.0)
    print(f"    {zcfg.name}: {len(zreqs)} requests, {Z_SLOTS} slots of {Z_MAX_LEN} rows, "
          f"{Z_CHUNK}-token chunks, gamma <= {Z_SPEC_GAMMA}, a draft of the target plus "
          f"noise {SPEC_NOISE}")
    zspec = serve_speculative(zmodel, zparams, zreqs,
                              {"noisy": (noisy_params(zparams, SPEC_NOISE, SEED + 23), both)},
                              n_slots=Z_SLOTS, max_len=Z_MAX_LEN, chunk=Z_CHUNK,
                              gamma_max=Z_SPEC_GAMMA, state_check=True)
    print("    timing (CUDA events, cold L2, median of 60): the zamba2 draft's snapshot, K2 "
          "at a verify's rows")
    spec_snapshot = time_snapshot(zmodel, zparams)
    del zparams
    gen = torch.Generator().manual_seed(SEED + 25)
    spec_rms_times = {f"rmsnorm_verify_{4 * (1 + g)}": time_rmsnorm_rows(4 * (1 + g),
                                                                         cfg.d_model, gen)
                      for g in (1, SPEC_GAMMA)}
    print_kernel_times(spec_rms_times)
    print("    one steady speculative round (torch.profiler)")
    spec_profile = profile_spec_round(model, params, noisy)
    del params, noisy
    spec_serve_seconds = time.perf_counter() - t16
    print(f"    phase 16 took {spec_serve_seconds:.1f} s")

    t17 = time.perf_counter()
    print("[17] prefix sharing (copy-on-write blocks), preempt-and-requeue and migration")
    params = model.init(SEED, device="cuda")
    print(f"    {cfg.name}: {PREFIX_REQUESTS} requests sharing a {PREFIX_LEN}-token prefix and "
          f"two identical block-aligned prompts, {N_SLOTS} slots of {MAX_LEN} rows, block "
          f"{BLOCK_SIZE}, {PREFILL_CHUNK}-token chunks, with and without sharing")
    prefix_serve = serve_shared_prefix(model, params)
    print("    timing (CUDA events, cold L2, median of 60): K4 over shared block tables")
    prefix_serve["k4_shared_tables"] = time_shared_decode(torch.Generator().manual_seed(SEED + 32))
    print(f"    {cfg.name}: phase 4's {len(reqs)} requests with sharing on {PREEMPT_BLOCKS} "
          f"blocks")
    preempt_serve = serve_preempted(model, params, reqs, "preempted", n_slots=N_SLOTS,
                                    max_len=MAX_LEN, chunk=PREFILL_CHUNK,
                                    arena_blocks=PREEMPT_BLOCKS,
                                    unpreempted=runs["paged"]["tokens"])
    print(f"    {cfg.name}: {MIGRATE_REQUESTS} of phase 4's requests exported after "
          f"{MIGRATE_AFTER} tokens, contiguous to contiguous and paged to paged (sharing)")
    migration = {pool: migrate(model, params, reqs[:MIGRATE_REQUESTS], f"{pool} migration",
                               n_slots=N_SLOTS, max_len=MAX_LEN, chunk=PREFILL_CHUNK,
                               after=MIGRATE_AFTER, **kw)
                 for pool, kw in (("contiguous", {}),
                                  ("paged", dict(block_size=BLOCK_SIZE, prefix_sharing=True)))}
    print("    timing (CUDA events, cold L2, median of 60): snapshot_slot and restore_slot")
    migration["slot_copies"] = time_slot_copies(
        model, max(len(p) for p, _, _ in reqs[:MIGRATE_REQUESTS]) + MIGRATE_AFTER - 1)
    del params
    zparams = zmodel.init(SEED, device="cuda")
    zreqs = zamba_workload(zcfg.vocab_size, 3, (16, 33), (8, 17), SEED + 31, gap=0.0)
    print(f"    {zcfg.name}: {len(zreqs)} requests with sharing on {Z_PREEMPT_BLOCKS} blocks, "
          f"{Z_SLOTS} slots of {Z_MAX_LEN} rows, {Z_CHUNK}-token chunks (preemption only: "
          f"recurrent states cannot be adopted)")
    zamba_preempt = serve_preempted(zmodel, zparams, zreqs, "zamba2 preempted", n_slots=Z_SLOTS,
                                    max_len=Z_MAX_LEN, chunk=Z_CHUNK,
                                    arena_blocks=Z_PREEMPT_BLOCKS)
    check(zamba_preempt["run"]["prefix_hits"] == 0, "zamba2 adopted a prefix")
    zamba_preempt["migration"] = migrate(zmodel, zparams, zreqs[:1], "zamba2 contiguous migration",
                                         n_slots=Z_SLOTS, max_len=Z_MAX_LEN, chunk=Z_CHUNK,
                                         after=Z_MIGRATE_AFTER)
    del zparams
    migrations = (migration["contiguous"], migration["paged"], zamba_preempt["migration"])
    phase17 = [r["launches"] for r in prefix_serve["runs"].values()]
    phase17 += [preempt_serve["run"]["launches"], zamba_preempt["run"]["launches"]]
    phase17 += [m["launches"] for m in migrations]
    phase17 += [m["unmigrated"]["launches"] for m in migrations]
    phase17_seconds = time.perf_counter() - t17
    print(f"    phase 17 took {phase17_seconds:.1f} s")

    t18 = time.perf_counter()
    print("[18] observability and the multi-replica fleet")
    params = model.init(SEED, device="cuda")
    print(f"    {cfg.name}: phase 4's {len(reqs)} requests on both pools with Observability()")
    observed = serve_observed(model, params, reqs, runs)
    print(f"    {cfg.name}: phase 4's {len(reqs)} requests through a Frontend over "
          f"{FLEET_REPLICAS} paged replicas (block {BLOCK_SIZE}, {N_SLOTS} slots of {MAX_LEN}, "
          f"{PREFILL_CHUNK}-token chunks) sharing one params dict, hedged, with "
          f"Observability()")
    fleet = serve_fleet(model, params, reqs)
    del params
    phase18 = [r["launches"] for r in observed.values()] + [fleet["launches"]]
    phase18_seconds = time.perf_counter() - t18
    print(f"    phase 18 took {phase18_seconds:.1f} s; card {card}")
    del model, zmodel

    t19 = time.perf_counter()
    print(f"[19] the registry's other GQA decoders at full width ({QWEN_ARCH}, "
          f"{', '.join(WIDE_ARCHS)}), each loaded alone, and {QWEN_ARCH} trained with "
          f"selective remat")
    gqa = phase19()
    phase19_seconds = time.perf_counter() - t19
    print(f"    phase 19 took {phase19_seconds:.1f} s; card {card}")

    t20 = time.perf_counter()
    print(f"[20] MLA and xLSTM serving: {DS_ARCH} at full width cut to {DS_LAYERS} layers, "
          f"{XL_ARCH} at full width and depth")
    mla_xlstm = phase20()
    phase20_seconds = time.perf_counter() - t20
    print(f"    phase 20 took {phase20_seconds:.1f} s; card {card}")

    t21 = time.perf_counter()
    print(f"[21] training {DS_ARCH} (full width cut to {DS_TRAIN_LAYERS} layers, MTP, "
          f"Adafactor) and {XL_ARCH} (full width and depth, momentum) through the "
          f"adaptive-(k, beta) loop")
    train21 = phase21()
    phase21_seconds = time.perf_counter() - t21
    print(f"    phase 21 took {phase21_seconds:.1f} s; card {card}")
    for fam in (DS_ARCH, XL_ARCH):
        worst["rmsnorm"] = max(worst["rmsnorm"], train21[fam]["k2_loop_shapes"]["rmsnorm"])
        train_worst["rmsnorm_bwd"] = max(train_worst["rmsnorm_bwd"],
                                         train21[fam]["k2_loop_shapes"]["rmsnorm_bwd"])
    gc.collect()
    torch.cuda.empty_cache()

    t22 = time.perf_counter()
    print(f"[22] {HUBERT_ARCH} (frames in, a bidirectional encoder, K1 at D 80) trained by "
          f"the masked fastest-k step, and the simulation engines on the card")
    p22 = phase22(card)
    phase22_seconds = time.perf_counter() - t22
    print(f"    phase 22 took {phase22_seconds:.1f} s; card {card}")
    hubert = p22["hubert"]

    t23 = time.perf_counter()
    print(f"[23] the chaos search over {ARCH}'s fleet at full width (eight oracles, the seeded "
          f"cancel-path leak, ddmin shrink, replays) and the int8 error-feedback codec")
    p23 = phase23(card)
    phase23_seconds = time.perf_counter() - t23
    print(f"    phase 23 took {phase23_seconds:.1f} s; card {card}")
    chaos = p23["chaos_search"]
    worst["rmsnorm"] = max(worst["rmsnorm"], chaos["max_abs_err"]["rmsnorm"])

    name, limit = [s.strip() for s in card.split(",", 1)]
    sources = {
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:26",
                    times["rmsnorm_decode"], worst["rmsnorm"],
                    runs["contiguous"]["launches"]["rmsnorm"]
                    + runs["paged"]["launches"]["rmsnorm"]),
        "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/kernel.py:26",
                        train_times["rmsnorm_bwd"], train_worst["rmsnorm_bwd"],
                        trained["launches"]["rmsnorm_bwd"]),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:74",
                             times["decode_attention"], worst["decode_attention"],
                             runs["contiguous"]["launches"]["decode_attention"]),
        "paged_decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:187",
                                   times["paged_decode_attention"],
                                   worst["paged_decode_attention"],
                                   runs["paged"]["launches"]["paged_decode_attention"]),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:89",
                            train_times["flash_attention"], train_worst["flash_attention"],
                            trained["launches"]["flash_attention"]),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention/kernel.py:89",
                                train_times["flash_attention_bwd"],
                                train_worst["flash_attention_bwd"],
                                trained["launches"]["flash_attention_bwd"]),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:74",
                     ssd_times["ssd_scan"], train_worst["ssd_scan"],
                     ztrained["launches"]["ssd_scan"]),
        "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                         "src/repro/kernels/ssd_scan/kernel.py:74",
                         ssd_times["ssd_scan_bwd"], train_worst["ssd_scan_bwd"],
                         ztrained["launches"]["ssd_scan_bwd"]),
    }
    kernels = []
    for kname, (src, replaces, t, err, launches) in sources.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "zamba_serve_launches": sum(r["launches"][kname] for r in zruns.values()),
            "spec_serve_launches": sum(r["launches"][kname] for s in (spec, zspec)
                                       for r in s["runs"].values()),
            "phase17_launches": sum(c[kname] for c in phase17),
            "phase18_launches": sum(c[kname] for c in phase18),
            "phase19_launches": sum(c[kname] for c in gqa["launches"]),
            "phase20_launches": sum(c[kname] for c in mla_xlstm["launches"]),
            "phase21_launches": sum(c[kname] for c in train21["launches"]),
            "phase22_launches": hubert["launches"][kname],
            "phase23_launches": chaos["launches"].get(kname, 0),
        })
    # K4 at block 8, the chaos fleet's geometry: launches over phase 23's
    # runs, times at its decode tick's shape.
    t = chaos["kernel_times"]["paged_decode_attention"]
    kernels.append({
        "name": "paged_decode_attention (block 8)", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:187",
        "launches": chaos["launches"]["paged_decode_attention"],
        "max_abs_err": chaos["max_abs_err"]["paged_decode_attention"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
        "phase23_launches": chaos["launches"]["paged_decode_attention"],
    })
    # K1's (80, 80) instances, hubert's main path: launches over phase 22's
    # train steps, times at their shape (non-causal).
    for kname in ("flash_attention", "flash_attention_bwd"):
        t = hubert["k1_times"][kname]
        kernels.append({
            "name": f"{kname} (D 80)", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
            "launches": hubert["launches"][kname],
            "max_abs_err": dict(zip(("flash_attention", "flash_attention_bwd"),
                                    hubert["k1_err"]))[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "phase22_launches": hubert["launches"][kname],
        })
    report = {
        "kernels": kernels,
        "card": name, "power_limit": limit,
        "rmsnorm_prefill_shape": times["rmsnorm_prefill"],
        "launch_floor_ms": times["launch_floor_ms"],
        "rmsnorm_train_forward": train_times["rmsnorm"],
        "decode_long_context": long_decode,
        "decode_tokens_per_s": {p: runs[p]["stats"].decode_tokens_per_wsec for p in runs},
        "profile": profiled,
        "train_step_parity": parity,
        "train_loop": trained,
        "train_kernel_shapes": {k: v["shape"] for k, v in train_times.items()},
        "train_profile": train_profile,
        "zamba_step_parity": zparity,
        "zamba_train_loop": ztrained,
        "ssd_kernel_shapes": {k: v["shape"] for k, v in ssd_times.items()},
        "zamba_flash_times": zamba_flash_times,
        "zamba_rmsnorm_times": zamba_rms_times,
        "k1_tensor_cores": tensor_cores,
        "k5_tensor_cores": ssd_tensor_cores,
        "decode_kernel_resources": decode_resources,
        "k2_resources": rmsnorm_resources,
        "zamba_train_profile": zamba_profile,
        "zamba_serve": {
            pool: {"steps": r["steps"], "launches": r["launches"],
                   "prefill_calls": r["stats"].prefill_calls,
                   "prefill_tokens": r["stats"].prefill_tokens,
                   "decode_ticks": r["stats"].decode_ticks,
                   "wall_seconds": r["stats"].wall_seconds,
                   "decode_tokens_per_s": r["stats"].decode_tokens_per_wsec,
                   "state_bytes_per_slot": r["state_bytes_per_slot"],
                   "kv_bytes_high_water": r["kv_bytes_high_water"],
                   "kv_bytes_contiguous": r["kv_bytes_contiguous"]}
            for pool, r in zruns.items()},
        "zamba_serve_streams": zstreams,
        "zamba_decode_parity": zdecode_parity,
        "zamba_decode_times": zamba_decode_times,
        "zamba_serve_profile": zamba_serve_profile,
        "zamba_serve_seconds": zamba_serve_seconds,
        "spec_parity": spec_parity,
        "spec_serve": {
            f"{arch}, {label}": {
                "rounds": r["stats"].spec_rounds, "gamma0_ticks": r["stats"].decode_ticks,
                "draft_ticks": r["stats"].draft_ticks, "offered": r["offered"],
                "accepted": r["accepted"], "acceptance_hist": r["hist"],
                "prefill_calls": r["stats"].prefill_calls,
                "generated_tokens": r["stats"].generated_tokens,
                "wall_seconds": r["stats"].wall_seconds,
                "decode_tokens_per_s": r["stats"].decode_tokens_per_wsec,
                "calls": r["calls"], "launches": r["launches"],
                "rejection_gaps": r.get("rejection_gaps"),
                "equal_to_plain": r.get("equal_to_plain")}
            for arch, s in ((cfg.name, spec), (zcfg.name, zspec))
            for label, r in s["runs"].items()},
        "spec_serve_streams": {cfg.name: spec["streams"], zcfg.name: zspec["streams"]},
        "spec_state_check": zspec["state_check"],
        "spec_rmsnorm_times": spec_rms_times,
        "spec_profile": spec_profile,
        "spec_snapshot": spec_snapshot,
        "spec_serve_seconds": spec_serve_seconds,
        "prefix_serve": prefix_serve,
        "preempt_serve": preempt_serve,
        "migration": migration,
        "zamba_preempt": zamba_preempt,
        "phase17_seconds": phase17_seconds,
        "observed_serve": observed,
        "fleet": fleet,
        "phase18_seconds": phase18_seconds,
        "gqa_configs": gqa,
        "phase19_seconds": phase19_seconds,
        "mla_xlstm": mla_xlstm,
        "phase20_seconds": phase20_seconds,
        "mla_xlstm_train": train21,
        "phase21_seconds": phase21_seconds,
        "hubert_train": hubert,
        "sim_engines": p22["sim"],
        "phase22_seconds": phase22_seconds,
        "chaos_search": chaos,
        "compression": p23["compression"],
        "phase23_seconds": phase23_seconds,
        "seconds": time.perf_counter() - t_start,
    }
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
