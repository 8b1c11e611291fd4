"""The port's CUDA kernels on the card (marked ``gpu``; skipped without
one). This file imports no JAX, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain version on the same CUDA inputs (f32 at
2e-5; bf16 at 2e-2, plus one bf16 step of the value for RMSNorm; the
training kernels by ``repro_torch.kernels.parity``, whose shapes and
tolerances chip_smoke.py shares: K1 by ``flash_within``, which adds what
rounding P and dS to bf16 may move each output by), the wrappers are shown
never to reach a plain version for a CUDA tensor, the decode kernels to
refuse a gradient, and the reduced model's decode tick and train step to
run through the kernels. Paged flash decode is also held over the block
tables prefix sharing leaves, and the sharing pool's block copy, snapshot
and restore on CUDA to the same copies on the CPU, bit for bit. A
three-replica fleet with observability on serves through a kill and a
rejoin on the card. The reduced qwen2.5-3b, command-r-35b, chameleon-34b
and qwen3-moe-30b-a3b serve through the kernels, and qwen2.5-3b takes a
train step under selective remat. K2 is held at the MLA and xLSTM loops'
training rows, the in-place optimizer step on the card to the same step
on the CPU, and the reduced deepseek-v3 (with its MTP loss) and xLSTM
take a train step through the kernels, as does hubert-xlarge reduced at
its head dim 80 (frames in, K1 non-causal), held to the CPU's step. The
chaos search's twin runs its sampled and leak schedules on the card, and
the int8 error-feedback codec there equals the CPU's bit for bit.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses
import importlib

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_rounding_terms
from repro_torch.kernels.parity import (
    DECODE_SHAPES, FLASH_SHAPES, NEAR_ULPS, RMS_CHUNK_SHAPES, RMS_DECODE_SHAPES,
    RMS_TRAIN_SHAPES, RMS_VERIFY_SHAPES,
    SHARED_DECODE_SHAPES, SSD_SHAPES, dscale_bf16_slack,
    flash_within, k2_per_call, shared_block_arena, ssd_within, within,
)
from repro_torch.kernels.ssd_scan import ssd_bwd_term_sums
from repro_torch.models import Model
from repro_torch.models.attention import paged_kv_view
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime import make_train_step
from repro_torch.serve import Scheduler, ServeEngine, SlotPool, generate_offline

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1, 2048), (3, 100, 576), (7, 64), (16384, 2048),
                                   (16384, 4096), (64, 16384), (5, 8191)])
def test_rms_norm_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = torch.randn(shape[-1:], generator=g).to(cuda, dtype)
    out, ref = K.rms_norm(x, scale), K.rms_norm_plain(x, scale)
    rtol = 1 / 128 if dtype == torch.bfloat16 else 0.0
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_DECODE_SHAPES)
def test_rms_norm_kernel_at_decode_rows(cuda, dtype, shape):
    """K2 forward at a decode step's rows (one or four, at D 2048, zamba2's
    4096, chameleon's 8192, the qk-norm's 128, deepseek's 7168, 1536 and
    512 and xlstm's 768 and 1536): plain's value, and a second launch bit
    for bit."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    out = K.rms_norm(x, scale)
    _close(out, K.rms_norm_plain(x, scale), dtype)
    assert torch.equal(K.rms_norm(x, scale), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,S,lens,bs", DECODE_SHAPES)
def test_decode_kernels_match_plain(cuda, dtype, H, Hkv, D, S, lens, bs):
    """K3 and K4 against their plain versions at ``parity.DECODE_SHAPES``
    (K3 on live rows: its contract is length >= 1; K4 in blocks of
    ``bs``); K3 == K4 bit for bit on identical rows, a second launch gives
    the same bits (the splits merge in a fixed order), and a length-0 row
    is exact zeros."""
    g = torch.Generator().manual_seed(1)
    B = len(lens)
    q = torch.randn((B, H, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    live = lengths > 0
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    out = K.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(out[live].float(),
                               K.decode_attention_plain(q, k, v, lengths)[live].float(),
                               atol=atol, rtol=0)
    # The same rows through a shuffled arena whose other rows are garbage.
    T = S // bs
    perm = torch.randperm(B * T, generator=g) + 1
    tables = perm.reshape(B, T).to(torch.int32)
    k_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, dtype)
    v_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, dtype)
    k_ar[perm.to(cuda)] = k.reshape(B * T, bs, Hkv, D)
    v_ar[perm.to(cuda)] = v.reshape(B * T, bs, Hkv, D)
    tables = tables.to(cuda)
    paged = K.paged_decode_attention(q, k_ar, v_ar, tables, lengths)
    torch.testing.assert_close(
        paged.float(),
        K.paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths).float(),
        atol=atol, rtol=0)
    assert torch.equal(paged, out), "K3 and K4 differ on identical rows"
    assert torch.equal(K.decode_attention(q, k, v, lengths), out), "K3 is not deterministic"
    assert torch.equal(K.paged_decode_attention(q, k_ar, v_ar, tables, lengths), paged), \
        "K4 is not deterministic"
    assert (paged[~live] == 0).all()
    zero = K.paged_decode_attention(q[:1], k_ar, v_ar, tables[:1],
                                    torch.zeros(1, dtype=torch.int32, device=cuda))
    assert (zero == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,S,lens,bs", [c for c in DECODE_SHAPES if len(c[4]) > 1])
def test_decode_rows_do_not_depend_on_the_batch(cuda, dtype, H, Hkv, D, S, lens, bs):
    """The split plan reads no batch size: row b of a K3 and of a K4 launch
    over the batch equals, bit for bit, a launch of row b alone at the
    same max_rows (K3 on live rows, its contract being length >= 1)."""
    g = torch.Generator().manual_seed(3)
    B = len(lens)
    T = S // bs
    q = torch.randn((B, H, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    perm = torch.randperm(B * T, generator=g) + 1
    k_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, dtype)
    v_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, dtype)
    k_ar[perm.to(cuda)] = k.reshape(B * T, bs, Hkv, D)
    v_ar[perm.to(cuda)] = v.reshape(B * T, bs, Hkv, D)
    tables = perm.reshape(B, T).to(cuda, torch.int32)
    out = K.decode_attention(q, k, v, lengths)
    paged = K.paged_decode_attention(q, k_ar, v_ar, tables, lengths)
    for b in range(B):
        one = K.paged_decode_attention(q[b:b + 1], k_ar, v_ar, tables[b:b + 1],
                                       lengths[b:b + 1])
        assert torch.equal(one[0], paged[b]), f"K4 row {b}"
        if lens[b] > 0:
            one = K.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1])
            assert torch.equal(one[0], out[b]), f"K3 row {b}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,S,lens,bs", DECODE_SHAPES)
def test_decode_attention_partial_matches_plain(cuda, dtype, H, Hkv, D, S, lens, bs):
    """K3's partial form at ``parity.DECODE_SHAPES`` (a rank's block of rows
    among them, lanes with no live row too): its f32 output within 2e-5
    and its lse within 1e-5 (relative, 1e-5 absolute near 0) of the plain
    partial form (f32 sums in another order); a row of length 0 gives
    exact zeros and lse -inf; the output rounded to q's dtype equals K3's
    bit for bit (the same kernels, K3 rounding at the end); a second
    launch gives the same bits; and the launch counts on K3's counter."""
    g = torch.Generator().manual_seed(7)
    B = len(lens)
    q = torch.randn((B, H, D), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    live = lengths > 0
    before = K.decode_attention.launches
    out, lse = K.decode_attention_partial(q, k, v, lengths)
    assert K.decode_attention.launches == before + 1
    ref, ref_lse = K.decode_attention_partial_plain(q, k, v, lengths)
    assert out.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(out[live], ref[live], atol=2e-5, rtol=0)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-5, rtol=1e-5)
    assert (out[~live] == 0).all() and torch.isneginf(lse[~live]).all()
    assert torch.equal(out.to(dtype), K.decode_attention(q, k, v, lengths))
    again = K.decode_attention_partial(q, k, v, lengths)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,S,lens,shared", SHARED_DECODE_SHAPES)
def test_paged_decode_over_shared_tables(cuda, dtype, H, Hkv, D, S, lens, shared):
    """K4 where two rows name the same first blocks and a third names a
    fork of one of them (``parity.shared_block_arena``): plain's value, a
    second launch bit for bit, each row bit for bit equal to a launch of
    that row alone, and K3 on the gathered rows bit for bit."""
    g = torch.Generator().manual_seed(5)
    k_ar, v_ar, tables = shared_block_arena(Hkv, D, S, lens, shared, g, dtype, cuda)
    q = torch.randn((len(lens), H, D), generator=g).to(cuda, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = K.paged_decode_attention(q, k_ar, v_ar, tables, lengths)
    _close(out, K.paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths), dtype)
    assert torch.equal(K.paged_decode_attention(q, k_ar, v_ar, tables, lengths), out)
    for b in range(len(lens)):
        alone = K.paged_decode_attention(q[b:b + 1], k_ar, v_ar, tables[b:b + 1],
                                         lengths[b:b + 1])
        assert torch.equal(alone[0], out[b]), b
    k, v = paged_kv_view(k_ar, tables), paged_kv_view(v_ar, tables)
    assert torch.equal(K.decode_attention(q, k, v, lengths), out)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2"])
def test_block_copy_snapshot_and_restore_on_the_card(cuda, arch):
    """The sharing pool's device copies on CUDA, bit for bit against the
    same copies of the same bytes on the CPU: a fork's ``slot_block_copy``
    (every other block untouched), ``snapshot_slot`` (a slot's owned blocks
    and its recurrent states) and ``restore_slot`` into a second pool."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = Model(cfg)

    def pools(device):
        return [SlotPool(model, 3, 64, block_size=8, prefix_sharing=True, device=device)
                for _ in range(2)]

    runs = {}
    for device in ("cpu", cuda):
        src, dst = pools(device)
        for i, leaf in enumerate(tree_leaves(src.caches, is_leaf=torch.is_tensor)):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(i)))
        s0, s1 = src.allocate(0, 40), src.allocate(1, 40)
        src.ensure_rows(s0, 33)
        src.manager.adopt(s1, src.manager._owned[s0][:4])
        src.ensure_writable(s1, 31, 32)              # forks the shared block 3
        assert src.manager._owned[s1][:3] == src.manager._owned[s0][:3]
        src.positions[s0], src.positions[s1] = 33, 32
        snap = src.snapshot_slot(s1)
        dst.allocate(0, 16)
        dst.ensure_rows(0, 16)
        slot = dst.restore_slot(snap, owner=7, n_tokens=40)
        runs[str(device)] = (src.caches, snap.data, dst.caches, slot,
                             list(src.manager._owned[s1]), list(dst.manager._owned[slot]))
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert cpu[3:] == card[3:]
    for a, b in zip(tree_leaves(cpu[:3], is_leaf=torch.is_tensor),
                    tree_leaves(card[:3], is_leaf=torch.is_tensor)):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("bs", [1, 12, 48])
def test_paged_decode_kernel_takes_any_block_size(cuda, bs):
    """K4 over arenas whose block size is no power of two (or is 1):
    equal to its plain version, and bit for bit to K3 on the same rows."""
    g = torch.Generator().manual_seed(8)
    H, Hkv, D, T = 32, 8, 64, 40
    S = T * bs
    lens = [1, bs, S // 2 + 1, S]
    B = len(lens)
    q = torch.randn((B, H, D), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    perm = torch.randperm(B * T, generator=g) + 1
    k_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, torch.bfloat16)
    v_ar = torch.randn((B * T + 1, bs, Hkv, D), generator=g).to(cuda, torch.bfloat16)
    k_ar[perm.to(cuda)] = k.reshape(B * T, bs, Hkv, D)
    v_ar[perm.to(cuda)] = v.reshape(B * T, bs, Hkv, D)
    tables = perm.reshape(B, T).to(cuda, torch.int32)
    paged = K.paged_decode_attention(q, k_ar, v_ar, tables, lengths)
    torch.testing.assert_close(
        paged.float(),
        K.paged_decode_attention_plain(q, k_ar, v_ar, tables, lengths).float(),
        atol=2e-2, rtol=0)
    assert torch.equal(paged, K.decode_attention(q, k, v, lengths))


def test_wrappers_never_fall_back_to_plain(cuda, monkeypatch):
    """For CUDA tensors the plain versions are never called."""
    def boom(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    # The package re-exports the wrappers under the modules' names, so
    # fetch the modules themselves.
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    rn = importlib.import_module("repro_torch.kernels.rmsnorm")
    monkeypatch.setattr(rn, "rms_norm_plain", boom)
    monkeypatch.setattr(da, "decode_attention_plain", boom)
    monkeypatch.setattr(da, "paged_decode_attention_plain", boom)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(rn, "rms_norm_bwd_plain", boom)
    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", boom)
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    monkeypatch.setattr(ss, "_states_plain", boom)
    monkeypatch.setattr(ss, "ssd_scan_bwd_plain", boom)
    x = torch.randn((2, 64), device=cuda, requires_grad=True)
    K.rms_norm(x, torch.ones(64, device=cuda)).sum().backward()
    qa = torch.randn((1, 16, 4, 32), device=cuda, requires_grad=True)
    ka = torch.randn((1, 16, 2, 32), device=cuda, requires_grad=True)
    K.flash_attention(qa, ka, ka, causal=True).sum().backward()
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(qa.transpose(1, 2), ka, ka, causal=True)
    xs = torch.randn((1, 40, 2, 16), device=cuda, requires_grad=True)
    dts = torch.rand((1, 40, 2), device=cuda, requires_grad=True)
    As = -torch.ones(2, device=cuda, requires_grad=True)
    bc = torch.randn((1, 40, 1, 16), device=cuda, requires_grad=True)
    K.ssd_scan(xs, dts, As, bc, bc, chunk=16)[0].sum().backward()
    with pytest.raises(ValueError, match="contiguous"):
        K.ssd_scan(xs.transpose(2, 3).contiguous().transpose(2, 3), dts, As, bc, bc, chunk=16)
    x = x.detach()
    q = torch.randn((1, 4, 32), device=cuda)
    kv = torch.randn((1, 32, 2, 32), device=cuda)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda)
    K.decode_attention(q, kv, kv, lengths)
    K.paged_decode_attention(q, kv, kv, torch.tensor([[0, 0]], dtype=torch.int32,
                                                     device=cuda), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        K.rms_norm(x.t(), torch.ones(2, device=cuda))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_VERIFY_SHAPES)
def test_rms_norm_kernel_at_verify_rows(cuda, dtype, shape):
    """K2 forward at a llama3.2-1b verify's rows (4 lanes of 1 + gamma,
    gamma 1 to 6): plain's value, and a second launch bit for bit."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    out = K.rms_norm(x, scale)
    _close(out, K.rms_norm_plain(x, scale), dtype)
    assert torch.equal(K.rms_norm(x, scale), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_CHUNK_SHAPES)
def test_rms_norm_kernel_at_chunk_rows(cuda, dtype, shape):
    """K2 forward at a 128-token prefill chunk of chameleon-34b (D 8192),
    at the qk-norm's rows of chameleon-34b and qwen3-moe-30b-a3b (D 128)
    and at deepseek-v3's norms (D 7168, 1536, 512): plain's value, and a
    second launch bit for bit."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    out = K.rms_norm(x, scale)
    _close(out, K.rms_norm_plain(x, scale), dtype)
    assert torch.equal(K.rms_norm(x, scale), out)


def _cut(arch):
    """The 2-layer f32 cut of a full-width config (zamba2: 2 Mamba2 layers
    and one shared call), its model and CPU parameters (zamba2's LoRA
    up-projections drawn at random)."""
    cfg = get_config(arch)
    over = dict(n_layers=2, dtype="float32")
    if cfg.family in ("ssm", "hybrid"):
        over["attn_every"] = 2
    cfg = dataclasses.replace(cfg, **over)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    if cfg.family in ("ssm", "hybrid"):
        g = torch.Generator().manual_seed(4)
        shared = params["stack"]["shared"]
        for name in ("lora_qkv_b", "lora_mlp_b"):
            shared[name] = 0.05 * torch.randn(shared[name].shape, generator=g)
    return model, params


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_verify_on_the_card_matches_the_cpu(cuda, arch, paged):
    """``verify_with_cache`` and the replay of the 2-layer f32 cut at full
    width: 4 lanes prefilled with 16, 9, 12 and 5 tokens, one window of 4
    at per-row starts with n_input 0, 1, 4 and 4 (random drafts: the
    chain breaks at once), through the kernels on the card and the plain
    versions on the CPU. The logits at every position, the recurrent
    states and each lane's K/V rows below its committed position agree
    by ``parity.within`` (f32); the dense verify launches K2 once a norm
    and no K3/K4, the hybrid's each scan step as a decode step."""
    model, cpu_params = _cut(arch)
    cfg = model.cfg
    hybrid = cfg.family in ("ssm", "hybrid")
    card, cpu = cuda, torch.device("cpu")
    params = {card: tree_map(lambda t: t.to(card), cpu_params, is_leaf=torch.is_tensor),
              cpu: cpu_params}
    B, P, S, rows, bs = 4, 16, 4, 64, 16
    g = torch.Generator().manual_seed(5)
    lens = torch.tensor([16, 9, 12, 5])
    n_input = torch.tensor([0, 1, 4, 4])
    chunk = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    inputs = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    tables = (torch.randperm(B * rows // bs, generator=g) + 1).reshape(B, -1).int()
    out = []
    for dev in (card, cpu):
        kw = dict(block_size=bs, num_blocks=B * rows // bs) if paged else {}
        tt = tables.to(dev) if paged else None
        res = []
        for commit in (None, torch.where(n_input > 0, 1, 0) if hybrid else n_input):
            caches = model.blank_caches(B, rows, device=dev, **kw)
            _, caches = model.prefill_with_cache(params[dev], chunk.to(dev), caches,
                                                 length=lens.to(dev), block_tables=tt)
            K.reset_launch_counts()
            ni = n_input if commit is None else commit
            logits, caches = model.verify_with_cache(
                params[dev], inputs.to(dev), caches, ni.to(dev), lens.to(dev), tt,
                greedy_commit=commit is None)
            res.append((logits, caches, K.launch_counts()))
        out.append(res)
    calls = cfg.n_layers // cfg.attn_every if hybrid else 0
    attn = "paged_decode_attention" if paged else "decode_attention"
    launches = out[0][0][2]
    if hybrid:
        assert launches["rmsnorm"] == (2 * cfg.n_layers + 2 * calls + 1) * S
        assert launches[attn] == calls * S
    else:
        assert launches["rmsnorm"] == 2 * cfg.n_layers + 1
    assert sum(launches.values()) == launches["rmsnorm"] + (launches[attn] if hybrid else 0)
    _close(out[0][0][0].cpu(), out[1][0][0], torch.float32)
    # Random drafts: the hybrid commits the pending token only.
    commit = torch.where(n_input > 0, 1, 0) if hybrid else n_input
    for (_, got, _), (_, want, _) in zip(*out):
        if hybrid:
            for name in ("conv", "ssm"):
                _close(got["mamba"][name].cpu(), want["mamba"][name], torch.float32)
            pairs = [(got["attn"][n][c].cpu(), want["attn"][n][c])
                     for n in ("k", "v") for c in range(calls)]
        else:
            pairs = [(gl[n].cpu(), wl[n]) for gs, ws in zip(got, want)
                     for gl, wl in zip(gs, ws) for n in ("k", "v")]
        for a, b in pairs:
            if paged:
                a, b = paged_kv_view(a, tables), paged_kv_view(b, tables)
            for lane in range(B):
                upto = int(lens[lane] + commit[lane])
                _close(a[lane, :upto], b[lane, :upto], torch.float32)


@pytest.mark.parametrize("block_size", [None, 16])
def test_engine_runs_through_the_kernels(cuda, block_size):
    """A reduced llama3.2-1b served on the card: every norm is a K2 launch
    (2L+1 per prefill call and per decode tick), every decode attention a
    K3 (contiguous) or K4 (paged) launch, and the streams are finite."""
    cfg = get_config("llama3.2-1b").reduced()
    model = Model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, params, n_slots=3, max_len=64, block_size=block_size,
                      scheduler=Scheduler(3, prefill_chunk=8))
    g = torch.Generator().manual_seed(2)
    for i in range(5):
        prompt = torch.randint(0, cfg.vocab_size, (int(5 + 4 * i),), generator=g)
        eng.submit(prompt.numpy(), 6, arrival=0.002 * i)
    K.reset_launch_counts()
    results = eng.run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = eng.stats
    L = cfg.n_layers
    assert counts["rmsnorm"] == (2 * L + 1) * (st.prefill_calls + st.decode_ticks)
    attn = "paged_decode_attention" if block_size else "decode_attention"
    assert counts[attn] == L * st.decode_ticks > 0
    # Serving runs the autograd-wrapped K2 forward exactly as often as
    # before, and never a training kernel.
    assert sum(counts.values()) == counts["rmsnorm"] + counts[attn]
    assert all(len(r.tokens) == 6 for r in results.values())


@pytest.mark.parametrize("block_size", [None, 16])
def test_zamba_engine_runs_through_the_kernels(cuda, block_size):
    """A reduced zamba2 served on the card: every decode step (a tick, or
    one token of the scanned prefill) launches K2 once per norm (2 per
    Mamba2 layer, 2 per shared call, the final one) and K3 (contiguous) or
    K4 (paged) once per shared call; no training kernel runs, and every
    stream equals its offline decode on the card."""
    cfg = get_config("zamba2").reduced()
    model = Model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, params, n_slots=3, max_len=64, block_size=block_size,
                      scheduler=Scheduler(3, prefill_chunk=8))
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (int(5 + 4 * i),), generator=g).numpy()
               for i in range(5)]
    rids = [eng.submit(p, 6, arrival=0.002 * i) for i, p in enumerate(prompts)]
    K.reset_launch_counts()
    results = eng.run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = eng.stats
    steps = st.decode_ticks + st.prefill_tokens
    calls = cfg.n_layers // cfg.attn_every
    attn = "paged_decode_attention" if block_size else "decode_attention"
    assert counts["rmsnorm"] == (2 * cfg.n_layers + 2 * calls + 1) * steps
    assert counts[attn] == calls * steps > 0
    assert sum(counts.values()) == counts["rmsnorm"] + counts[attn]
    for rid, p in zip(rids, prompts):
        assert results[rid].tokens == generate_offline(model, params, p, 6, 64)


def _close(out, ref, dtype, slack=0.0):
    err, ok = within(out, ref, dtype, slack)
    assert ok, f"max |err| {err:.3e} ({dtype})"


def _hold_flash(cuda, dtype, causal, shape, mul=1.0):
    """K1 forward and backward vs plain, q and k scaled by ``mul``, by
    ``parity.flash_within`` (bf16: the kernels round P and dS to bf16)
    and, at ``mul`` 1, by ``parity.within`` alone as well."""
    B, Sq, Skv, H, Hkv, D, Dv = shape
    g = torch.Generator().manual_seed(3)
    q = (torch.randn((B, Sq, H, D), generator=g) * mul).to(cuda, dtype)
    k = (torch.randn((B, Skv, Hkv, D), generator=g) * mul).to(cuda, dtype)
    v = torch.randn((B, Skv, Hkv, Dv), generator=g).to(cuda, dtype)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(cuda, dtype)
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = K.flash_attention_plain(q, k, v, causal=causal)
    grads = K.flash_attention_bwd(q, k, v, ref, ref_lse, do, causal=causal)
    refs = K.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do, causal=causal)
    terms = flash_attention_rounding_terms(q, k, v, ref, ref_lse, do, causal=causal)
    _close(lse, ref_lse, torch.float32)
    for a, b, t in zip((out,) + grads, (ref,) + refs, terms):
        err, ok = flash_within(a, b, dtype, t)
        assert ok, f"max |err| {err:.3e} ({dtype})"
        if mul == 1.0:
            _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,Dv", FLASH_SHAPES)
def test_flash_attention_kernels_match_plain(cuda, dtype, causal, B, Sq, Skv, H, Hkv, D, Dv):
    _hold_flash(cuda, dtype, causal, (B, Sq, Skv, H, Hkv, D, Dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_at_large_scores(cuda, dtype):
    """llama3.2-1b's training shape with q and k scaled by 4: scores near
    100 exercise the online rescale and exponentials that underflow (in
    f32, under products in 3xTF32)."""
    _hold_flash(cuda, dtype, True, (32, 512, 512, 32, 8, 64, 64), mul=4.0)


@pytest.mark.parametrize("shape", [(32, 128, 128, 9, 3, 64, 64), (32, 64, 64, 4, 2, 32, 32)],
                         ids=["smollm-135m", "elastic_failover"])
def test_flash_attention_f32_repeats_bit_for_bit(cuda, shape):
    """The f32 forward and backward launched twice give the same bits at
    the training entry points' shapes: no atomics, every sum (the dK/dV
    launch's over the G query heads too) in a fixed order. The exact
    resume of ``elastic_failover_torch`` on the card rests on it."""
    B, Sq, Skv, H, Hkv, D, Dv = shape
    g = torch.Generator().manual_seed(7)
    q = torch.randn((B, Sq, H, D), generator=g).to(cuda)
    k = torch.randn((B, Skv, Hkv, D), generator=g).to(cuda)
    v = torch.randn((B, Skv, Hkv, Dv), generator=g).to(cuda)
    do = torch.randn((B, Sq, H, Dv), generator=g).to(cuda)
    (o1, l1), (o2, l2) = (K.flash_attention_fwd(q, k, v, causal=True) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    first, second = (K.flash_attention_bwd(q, k, v, o1, l1, do, causal=True) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1, 2048), (8192, 2048), (16384, 2048), (3, 100, 576),
                                   (7, 64), (5, 33), (16384, 4096), (4096, 8192)])
def test_rms_norm_bwd_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    dy = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    (dx, ds), (rx, rs) = K.rms_norm_bwd(dy, x, scale), K.rms_norm_bwd_plain(dy, x, scale)
    _close(dx, rx, dtype)
    # bf16 dscale: x^ may round the other way only where its f32 value
    # lies within NEAR_ULPS of a bf16 midpoint; one bf16 step of |g * n|
    # for each of those.
    slack = dscale_bf16_slack(dy, x, near_ulps=NEAR_ULPS)[0] if dtype == torch.bfloat16 else 0.0
    _close(ds, rs, dtype, slack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16384, 2048), (16384, 4096), (5, 33), (4, 1, 2048)])
def test_rms_norm_kernels_repeat_bit_for_bit(cuda, dtype, shape):
    """A second launch gives the forward's output, dx and dscale bit for
    bit: each row's sums run in a fixed order, and the groups' dscale
    partials are summed in a fixed order without atomics."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    dy = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    assert torch.equal(K.rms_norm(x, scale), K.rms_norm(x, scale))
    (dx, ds), (dx2, ds2) = K.rms_norm_bwd(dy, x, scale), K.rms_norm_bwd(dy, x, scale)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


def test_decode_kernels_refuse_grad(cuda):
    q = torch.randn((1, 4, 32), device=cuda, requires_grad=True)
    kv = torch.randn((1, 32, 2, 32), device=cuda)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        K.decode_attention(q, kv, kv, lengths)
    with pytest.raises(RuntimeError, match="no backward"):
        K.paged_decode_attention(q, kv, kv, torch.tensor([[0, 0]], dtype=torch.int32,
                                                         device=cuda), lengths)
    with torch.no_grad():
        K.decode_attention(q, kv, kv, lengths)


def test_decode_kernels_refuse_unsupported_inputs(cuda):
    """A head_dim that is no multiple of 8, or an input that is not
    16-byte aligned, raises instead of reaching the 16-byte loads."""
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda)
    q, kv = torch.randn((1, 4, 12), device=cuda), torch.randn((1, 32, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.decode_attention(q, kv, kv, lengths)
    q = torch.randn(1 + 4 * 32, device=cuda)[1:].view(1, 4, 32)
    kv = torch.randn((1, 32, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.decode_attention(q, kv, kv, lengths)
    with pytest.raises(ValueError, match="aligned"):
        K.paged_decode_attention(q, kv, kv, torch.tensor([[0, 0]], dtype=torch.int32,
                                                         device=cuda), lengths)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_runs_through_the_kernels(cuda, remat, monkeypatch):
    """A reduced llama3.2-1b train step on the card launches K1 forward and
    K2 forward once per use (twice under full remat), K1 and K2 backward
    once, never a plain version, and gives every RMSNorm scale a
    non-zero gradient."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rn = importlib.import_module("repro_torch.kernels.rmsnorm")

    def boom(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    for mod, name in ((fa, "flash_attention_plain"), (fa, "flash_attention_bwd_plain"),
                      (rn, "rms_norm_plain"), (rn, "rms_norm_bwd_plain")):
        monkeypatch.setattr(mod, name, boom)
    cfg = get_config("llama3.2-1b").reduced(remat=remat)
    model = Model(cfg)
    params = model.init(0, device=cuda)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (4, 33), generator=g).to(cuda)
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:],
             "worker_mask": torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda), "lr": 1e-3}
    K.reset_launch_counts()
    # The step updates its parameters in place: it gets a copy, and the
    # scales it returns are held to the originals.
    new = tree_map(torch.clone, params, is_leaf=torch.is_tensor)
    new, _, metrics = make_train_step(model, adamw())(new, adamw().init(new), batch)
    torch.cuda.synchronize()
    L, r = cfg.n_layers, 2 if remat == "full" else 1
    assert K.launch_counts() == {
        "rmsnorm": r * 2 * L + 1, "rmsnorm_bwd": 2 * L + 1, "flash_attention": r * L,
        "flash_attention_bwd": L, "decode_attention": 0, "paged_decode_attention": 0,
        "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert torch.isfinite(metrics["loss"]) and float(metrics["contributors"]) == 3.0
    # Every norm scale moved: its gradient reached the optimizer.
    scales = [layer[n]["scale"] for layer in new["stack"][0] for n in ("attn_norm", "mlp_norm")]
    old = [layer[n]["scale"] for layer in params["stack"][0] for n in ("attn_norm", "mlp_norm")]
    for a, b in zip(scales + [new["final_norm"]["scale"]],
                    old + [params["final_norm"]["scale"]]):
        assert not torch.equal(a, b)
    assert len(tree_leaves(new, is_leaf=torch.is_tensor)) == \
        len(tree_leaves(params, is_leaf=torch.is_tensor))


def test_norm_scales_get_gradients_on_the_card(cuda):
    cfg = get_config("llama3.2-1b").reduced(remat="full")
    model = Model(cfg)
    params = model.init(0, device=cuda)
    for leaf in tree_leaves(params, is_leaf=torch.is_tensor):
        leaf.requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (2, 17), device=cuda)
    loss, _ = model.train_loss(params, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
    loss.backward()
    norms = [layer[n]["scale"] for layer in params["stack"][0]
             for n in ("attn_norm", "mlp_norm")] + [params["final_norm"]["scale"]]
    for s in norms:
        assert s.grad is not None and bool((s.grad != 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zamba", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_scan_kernels_match_plain(cuda, dtype, zamba, B, S, H, P, G, N, chunk):
    """K5 forward (y and every chunk's state) and backward against their
    plain versions, by ``parity.ssd_within``: ddt, dA, dB and dC, long
    sums whose addends may cancel, get a share of the size they were
    formed from.
    ``zamba``: zamba2-1.2b's initial decay (A = -e, dt = softplus(N(0, 1)))."""
    from repro_torch.kernels.ssd_scan import _states_plain, _unlay

    g = torch.Generator().manual_seed(6)
    x = torch.randn((B, S, H, P), generator=g).to(cuda, dtype)
    if zamba:
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g)).to(cuda)
        A = torch.full((H,), -2.718281828, device=cuda)
    else:
        dt = (0.01 + 0.29 * torch.rand((B, S, H), generator=g)).to(cuda)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=g)).to(cuda)
    Bm = torch.randn((B, S, G, N), generator=g).to(cuda, dtype)
    Cm = torch.randn((B, S, G, N), generator=g).to(cuda, dtype)
    dy = torch.randn((B, S, H, P), generator=g).to(cuda, dtype)
    y, states = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    ref_y, ref_states = _states_plain(x, dt, A, Bm, Cm, chunk)
    assert ssd_within(y, _unlay(ref_y, S).to(dtype), dtype)[1]
    assert ssd_within(states, ref_states, torch.float32)[1]
    grads = K.ssd_scan_bwd(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    y2, states2 = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(states2, states), "K5 is not deterministic"
    for a, b in zip(K.ssd_scan_bwd(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk), grads):
        assert torch.equal(a, b), "K5's backward is not deterministic"
    refs = K.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    terms = (None,) + ssd_bwd_term_sums(x, dt, A, Bm, Cm, ref_states, dy, chunk=chunk)
    for name, a, b, t in zip(("dx", "ddt", "dA", "dB", "dC"), grads, refs, terms):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err, ok = ssd_within(a, b, a.dtype, t)
        assert ok, f"{name}: max |err| {err:.3e}"


@pytest.mark.parametrize("remat", ["none", "full"])
def test_zamba_train_step_runs_through_the_kernels(cuda, remat, monkeypatch):
    """A reduced zamba2 train step on the card launches K5 forward once per
    Mamba2 layer (twice under full remat) and K5 backward once, K1 per
    shared call, K2 per norm, never a plain version, with a finite loss."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rn = importlib.import_module("repro_torch.kernels.rmsnorm")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")

    def boom(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    for mod, name in ((fa, "flash_attention_plain"), (fa, "flash_attention_bwd_plain"),
                      (rn, "rms_norm_plain"), (rn, "rms_norm_bwd_plain"),
                      (ss, "_states_plain"), (ss, "ssd_scan_bwd_plain")):
        monkeypatch.setattr(mod, name, boom)
    cfg = get_config("zamba2").reduced(remat=remat)
    model = Model(cfg)
    params = model.init(0, device=cuda)
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (4, 65), generator=g).to(cuda)
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:],
             "worker_mask": torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda), "lr": 1e-3}
    K.reset_launch_counts()
    _, _, metrics = make_train_step(model, adamw())(params, adamw().init(params), batch)
    torch.cuda.synchronize()
    L, r, calls = cfg.n_layers, 2 if remat == "full" else 1, cfg.n_layers // cfg.attn_every
    assert K.launch_counts() == {
        "rmsnorm": r * 2 * (L + calls) + 1, "rmsnorm_bwd": 2 * (L + calls) + 1,
        "flash_attention": r * calls, "flash_attention_bwd": calls,
        "decode_attention": 0, "paged_decode_attention": 0,
        "ssd_scan": r * L, "ssd_scan_bwd": L}
    assert torch.isfinite(metrics["loss"])


def test_fleet_with_obs_runs_on_the_card(cuda):
    """The reference observability tests' chaos fleet on the card: three
    paged replicas of the reduced smollm-135m (f32) sharing one params
    dict behind a ``Frontend`` with ``Observability()``, replica 1 killed
    at tick 12 and rejoined at 60. Every stream equals the card's offline
    decode, no span is left open, the trace validates, and every pool and
    arena drains; the shared weights are unchanged."""
    import numpy as np

    from repro_torch.core import SimplifiedDelayModel
    from repro_torch.obs import Observability, validate_trace
    from repro_torch.runtime import FaultEvent
    from repro_torch.serve import Frontend, Replica

    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg)
    params = model.init(0, device=cuda)
    before = [t.clone() for t in tree_leaves(params, is_leaf=torch.is_tensor)]
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(8):
        p, m = int(rng.integers(4, 16)), int(rng.integers(6, 14))
        reqs.append((rng.integers(0, cfg.vocab_size, size=p).astype(np.int32), m, i * 0.002))
    obs = Observability()
    replicas = [Replica(i, model, params, n_slots=2, max_len=64, block_size=8, obs=obs)
                for i in range(3)]
    fe = Frontend(replicas, SimplifiedDelayModel(lambda_y=2.0), cost_per_replica=0.001,
                  events=[FaultEvent(step=12, kind="fail", worker=1),
                          FaultEvent(step=60, kind="rejoin", worker=1)],
                  deadline=0.5, retry_budget=3, obs=obs)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert fe.summary()["dropped"] == 0
    assert [out[g].tokens for g in gids] == [
        generate_offline(model, params, p, m, 64) for p, m, _ in reqs]
    assert obs.tracer.open_spans == [] and validate_trace(obs.tracer.events) == []
    for rep in replicas:
        assert rep.engine.pool.n_active == 0
        assert rep.engine.pool.manager.n_used_blocks == 0
    assert (fe.router.inflight == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params, is_leaf=torch.is_tensor)))


@pytest.mark.parametrize("block_size", [None, 16])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "command-r-35b", "chameleon-34b",
                                  "qwen3-moe-30b-a3b"])
def test_gqa_configs_serve_through_the_kernels(cuda, arch, block_size):
    """The reduced configs (qwen3-moe dropless) served on the card: every
    RMSNorm is a K2 launch (``k2_per_call`` per prefill call and per
    tick), every decode attention a K3 or K4 launch, nothing else; the
    streams have their lengths and equal the card's offline decode where
    its top-2 gap is not a near-tie (f32: 1e-4)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=True))
    model = Model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, params, n_slots=3, max_len=64, block_size=block_size,
                      scheduler=Scheduler(3, prefill_chunk=8))
    g = torch.Generator().manual_seed(7)
    reqs = [(torch.randint(0, cfg.vocab_size, (5 + 4 * i,), generator=g).numpy(), 6)
            for i in range(5)]
    rids = [eng.submit(p, m, arrival=0.002 * i) for i, (p, m) in enumerate(reqs)]
    K.reset_launch_counts()
    results = eng.run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = eng.stats
    attn = "paged_decode_attention" if block_size else "decode_attention"
    assert counts["rmsnorm"] == k2_per_call(cfg) * (st.prefill_calls + st.decode_ticks)
    assert counts[attn] == cfg.n_layers * st.decode_ticks > 0
    assert sum(counts.values()) == counts["rmsnorm"] + counts[attn]
    for rid, (p, m) in zip(rids, reqs):
        got = results[rid].tokens
        choice, gaps = generate_offline(model, params, p, m, 64, forced=got)
        assert len(got) == m
        assert all(a == b or gap < 1e-4 for a, b, gap in zip(got, choice, gaps))


@pytest.mark.parametrize("block_size", [None, 16])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-125m"])
def test_mla_and_xlstm_serve_through_the_kernels(cuda, arch, block_size):
    """The reduced deepseek-v3 (dropless) and xlstm-125m served on the
    card: every RMSNorm is a K2 launch (``k2_per_call`` per prefill call
    and per tick; xLSTM prefills a token a step, so per prefilled token),
    and nothing else launches (MLA's attention and the xLSTM recurrences
    are plain PyTorch); the streams have their lengths and equal the
    card's offline decode where its top-2 gap is not a near-tie (f32:
    1e-4)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=True))
    model = Model(cfg)
    params = model.init(0, device=cuda)
    eng = ServeEngine(model, params, n_slots=3, max_len=64, block_size=block_size,
                      scheduler=Scheduler(3, prefill_chunk=8))
    g = torch.Generator().manual_seed(9)
    reqs = [(torch.randint(0, cfg.vocab_size, (5 + 4 * i,), generator=g).numpy(), 6)
            for i in range(5)]
    rids = [eng.submit(p, m, arrival=0.002 * i) for i, (p, m) in enumerate(reqs)]
    K.reset_launch_counts()
    results = eng.run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    st = eng.stats
    steps = st.prefill_tokens if model.recurrent else st.prefill_calls
    assert counts["rmsnorm"] == k2_per_call(cfg) * (steps + st.decode_ticks) > 0
    assert sum(counts.values()) == counts["rmsnorm"]
    for rid, (p, m) in zip(rids, reqs):
        got = results[rid].tokens
        choice, gaps = generate_offline(model, params, p, m, 64, forced=got)
        assert len(got) == m
        assert all(a == b or gap < 1e-4 for a, b, gap in zip(got, choice, gaps))


def test_selective_train_step_runs_through_the_kernels(cuda):
    """A reduced qwen2.5-3b train step under ``remat="selective"``: K1 and
    K2 forward twice (attention and norms are not saved products, so the
    backward recomputes them), their backward once; the loss equals
    ``"none"``'s bit for bit and the gradient norm within 1e-6."""
    cfg = get_config("qwen2.5-3b").reduced()
    g = torch.Generator().manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (4, 33), generator=g).to(cuda)
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:],
             "worker_mask": torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda), "lr": 1e-3}
    out = {}
    for remat in ("none", "selective"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        params = model.init(0, device=cuda)
        K.reset_launch_counts()
        _, _, metrics = make_train_step(model, adamw())(params, adamw().init(params), batch)
        torch.cuda.synchronize()
        out[remat] = (K.launch_counts(), metrics)
    L = cfg.n_layers
    assert out["selective"][0] == {
        "rmsnorm": 2 * 2 * L + 1, "rmsnorm_bwd": 2 * L + 1, "flash_attention": 2 * L,
        "flash_attention_bwd": L, "decode_attention": 0, "paged_decode_attention": 0,
        "ssd_scan": 0, "ssd_scan_bwd": 0}
    (_, a), (_, b) = out["none"], out["selective"]
    assert torch.equal(a["loss"], b["loss"])
    assert abs(float(a["grad_norm"]) - float(b["grad_norm"])) <= 1e-6 * float(a["grad_norm"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_TRAIN_SHAPES)
def test_rms_norm_kernels_at_training_rows(cuda, dtype, shape):
    """K2 forward and backward at the MLA and xLSTM loops' training rows
    (deepseek-v3's D 7168, 1536 and 512; xlstm-125m's 768 and 1536):
    plain's values (bf16 dscale with its midpoint slack), and a second
    launch bit for bit."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    dy = torch.randn(shape, generator=g).to(cuda, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(cuda, dtype)
    out = K.rms_norm(x, scale)
    _close(out, K.rms_norm_plain(x, scale), dtype)
    (dx, ds), (rx, rs) = K.rms_norm_bwd(dy, x, scale), K.rms_norm_bwd_plain(dy, x, scale)
    _close(dx, rx, dtype)
    slack = dscale_bf16_slack(dy, x, near_ulps=NEAR_ULPS)[0] if dtype == torch.bfloat16 else 0.0
    _close(ds, rs, dtype, slack)
    assert torch.equal(K.rms_norm(x, scale), out)
    dx2, ds2 = K.rms_norm_bwd(dy, x, scale)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("name", ["adafactor", "momentum", "adamw"])
def test_in_place_optimizer_step_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    """Three in-place steps (clip scale 0.5) in f32 of a tree with a
    stacked three-layer segment, a one-layer one, vectors, 3-D factored
    leaves and (Adafactor, at a lowered ``MAP_ELEMS``) sliced leaves of
    both kinds, chunks small enough to cut leaves into runs of matrices
    and rows: the card's parameters and state within 1e-6 of the CPU's
    (the row, column and RMS sums run in other orders)."""
    from repro_torch.optim import get_optimizer
    from repro_torch.optim import optimizers as O

    monkeypatch.setattr(O, "CHUNK_ELEMS", 20000)
    monkeypatch.setattr(O, "MAP_ELEMS", 2 ** 16)
    g = torch.Generator().manual_seed(10)

    def tree():
        def layer():
            return {"b": torch.randn(40, 12, generator=g), "norm": {"scale": torch.randn(
                160, generator=g)}, "w": torch.randn(160, 192, generator=g),
                "w_h": torch.randn(2, 128, 144, generator=g)}
        return {"embed": torch.randn(300, 160, generator=g), "experts": torch.randn(
            3, 160, 144, generator=g), "stack": [[layer() for _ in range(3)], [layer()]]}

    cpu = tree()
    card = tree_map(lambda t: t.to(cuda), cpu, is_leaf=torch.is_tensor)
    opt = get_optimizer(name)
    sc, sg = opt.init(cpu), opt.init(card)
    for _ in range(3):
        grads = tree()
        sc = opt.step(grads, sc, cpu, 0.05, torch.tensor(0.5))
        sg = opt.step(tree_map(lambda t: t.to(cuda), grads, is_leaf=torch.is_tensor), sg, card,
                      0.05, torch.tensor(0.5, device=cuda))
    for a, b in zip(tree_leaves((card, sg), is_leaf=torch.is_tensor),
                    tree_leaves((cpu, sc), is_leaf=torch.is_tensor)):
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-125m"])
def test_mla_and_xlstm_train_step_runs_through_the_kernels(cuda, arch, monkeypatch):
    """A clipped step of the reduced model under full remat (deepseek-v3:
    an MLA dense and an MLA MoE layer, the MTP loss, Adafactor; xLSTM: an
    mLSTM and an sLSTM block, momentum) on the card: K2 forward twice a
    rematerialised norm and once for the final norm and the MTP block's
    and norm, its backward once each, nothing else launched, no plain
    version reached, finite metrics."""
    from repro_torch.optim import adafactor, momentum

    rn = importlib.import_module("repro_torch.kernels.rmsnorm")

    def boom(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    for name in ("rms_norm_plain", "rms_norm_bwd_plain"):
        monkeypatch.setattr(rn, name, boom)
    cfg = get_config(arch).reduced(remat="full")
    if cfg.xlstm is not None:
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, slstm_every=2))
    opt = adafactor() if cfg.mtp else momentum(0.9)
    model = Model(cfg)
    params = model.init(0, device=cuda)
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(0, cfg.vocab_size, (4, 33), generator=g).to(cuda)
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:],
             "worker_mask": torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda), "lr": 1e-3}
    K.reset_launch_counts()
    _, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    norms = k2_per_call(cfg) - 1
    once = 1 + (k2_per_call(dataclasses.replace(cfg, n_layers=1)) if cfg.mtp else 0)
    assert K.launch_counts() == {
        "rmsnorm": 2 * norms + once, "rmsnorm_bwd": norms + once, "flash_attention": 0,
        "flash_attention_bwd": 0, "decode_attention": 0, "paged_decode_attention": 0,
        "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hubert_train_step_runs_through_the_kernels(cuda, remat, monkeypatch):
    """hubert-xlarge reduced at its head dim (2 heads of 80, d_model 160),
    frames in: a clipped AdamW step with a fastest-k worker mask launches
    K1 forward once a layer (twice under full remat) and its backward
    once, non-causal, nothing else (LayerNorm is plain PyTorch), never a
    plain version; then the same step on the CPU through the plain
    versions agrees in loss and gradient norm (f32, 1e-5 relative)."""
    from repro_torch.data import make_frame_stream

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    seen = []
    fwd = fa.flash_attention_fwd

    def spy(q, k, v, *, causal):
        seen.append((tuple(q.shape), causal))
        return fwd(q, k, v, causal=causal)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    cfg = get_config("hubert-xlarge").reduced(n_heads=2, n_kv_heads=2, head_dim=80,
                                              d_model=160, remat=remat)
    model = Model(cfg)
    cpu_params = model.init(0, device="cpu")
    x, labels = make_frame_stream(cfg.d_model, seed=4)(8, 48, cfg.vocab_size)
    batch = {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels),
             "worker_mask": torch.tensor([1.0, 1.0, 0.0, 1.0]), "lr": 1e-3}
    metrics = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev), cpu_params, is_leaf=torch.is_tensor)
        b = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
        K.reset_launch_counts()
        _, _, metrics[dev.type] = make_train_step(model, adamw())(params, adamw().init(params), b)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            L, r = cfg.n_layers, 2 if remat == "full" else 1
            assert K.launch_counts() == {
                "rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention": r * L,
                "flash_attention_bwd": L, "decode_attention": 0, "paged_decode_attention": 0,
                "ssd_scan": 0, "ssd_scan_bwd": 0}
            assert seen and all(s == ((8, 48, 2, 80), False) for s in seen[:r * L])
    for key in ("loss", "grad_norm"):
        assert float(metrics["cuda"][key]) == pytest.approx(float(metrics["cpu"][key]), rel=1e-5)
    assert float(metrics["cuda"]["contributors"]) == 3.0


def test_chaos_search_on_the_card(cuda):
    """The chaos twin (``tools/chaos_search_torch.py``) on the card at the
    reduced smollm-135m (f32, the port's seeded weights): two sampled
    schedules pass every oracle (streams equal the card's offline decode
    exactly); the leak schedule with the seeded cancel-path bug armed
    trips ``block_conservation``, shrinks to its one fail atom and replays
    to the same signature, and passes every oracle unarmed; K2 and K4 ran."""
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.chaos_search_torch import (
        FaultDirective, FaultEvent, Schedule, Workload, run_schedule, sample_schedule, shrink,
    )

    wl = Workload(n_requests=4, device=cuda)
    knobs = {"max_ticks": 6_000}
    K.reset_launch_counts()
    for i in range(2):
        report = run_schedule(wl, sample_schedule(np.random.default_rng([0, i])), **knobs)
        assert report.ok, report.violations
    counts = K.launch_counts()
    assert counts["rmsnorm"] > 0 and counts["paged_decode_attention"] > 0
    assert {k for k, v in counts.items() if v} == {"rmsnorm", "paged_decode_attention"}
    leak = Schedule(
        events=[FaultEvent(step=8, kind="fail", worker=1),
                FaultEvent(step=70, kind="rejoin", worker=1),
                FaultEvent(step=40, kind="slow", worker=2, factor=2.0)],
        directives=[FaultDirective("r1", "fe", "delay", 50, ticks=3)],
        partitions=[], cost_per_replica=10.0)
    sig = run_schedule(wl, leak, leak_blocks=True, **knobs).signature()
    assert "block_conservation" in sig
    small = shrink(wl, leak, sig, leak_blocks=True, **knobs)
    assert small.size() == 1 and small.events[0].kind == "fail"
    assert run_schedule(wl, small, leak_blocks=True, **knobs).signature() == sig
    assert run_schedule(wl, leak, **knobs).ok


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_codec_on_the_card_matches_the_cpu(cuda, dtype):
    """``Int8Codec`` and ``ef_compress_tree`` on CUDA tensors equal the same
    calls on the CPU bit for bit (q, scale, decoded, residual), over a
    nested tree with a wide range of magnitudes and an all-zero leaf."""
    from repro_torch.dist import Int8Codec, ef_compress_tree

    g = torch.Generator().manual_seed(3)
    grads = {"a": torch.randn(4096, 33, generator=g),
             "b": [torch.randn(1000, generator=g) * torch.exp(12 * torch.rand(1000, generator=g)),
                   torch.zeros(17)],
             "c": {"d": -torch.rand(513, generator=g)}}
    grads = tree_map(lambda t: t.to(dtype), grads, is_leaf=torch.is_tensor)
    resid = tree_map(lambda t: 0.01 * torch.randn(t.shape, generator=g), grads,
                     is_leaf=torch.is_tensor)
    on_card = tree_map(lambda t: t.to(cuda), (grads, resid), is_leaf=torch.is_tensor)
    for x in tree_leaves(grads, is_leaf=torch.is_tensor):
        q, s = Int8Codec.encode(x.to(cuda))
        qc, sc = Int8Codec.encode(x)
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu().view(torch.int32),
                                                        sc.view(torch.int32))
    want = ef_compress_tree(grads, resid)
    got = ef_compress_tree(*on_card)
    for a, b in zip(tree_leaves(got, is_leaf=torch.is_tensor),
                    tree_leaves(want, is_leaf=torch.is_tensor)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.cpu().view(bits), b.view(bits))


def _meta_calls(dtype):
    """(name, call(device) -> outputs) for every kernel wrapper at a small
    shape: K3 / K4 with every row live, so that the card's work (its
    lengths') is the meta branch's (every cache row)."""
    g = torch.Generator().manual_seed(11)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)

    q, k, v, do = r(2, 64, 4, 64), r(2, 64, 2, 64), r(2, 64, 2, 64), r(2, 64, 4, 64)
    x, scale, gy = r(40, 256), 1 + 0.1 * r(256), r(40, 256)
    dq, dk_, dv_ = r(3, 8, 64), r(3, 256, 2, 64), r(3, 256, 2, 64)
    lengths = torch.full((3,), 256, dtype=torch.int32)
    arena_k, arena_v = r(17, 16, 2, 64), r(17, 16, 2, 64)
    tables = (torch.arange(48, dtype=torch.int32) % 16 + 1).reshape(3, 16)
    xs, dts, A = r(2, 96, 4, 32), torch.rand(2, 96, 4, generator=g) * 0.1, -torch.rand(4, generator=g)
    Bm, Cm, dy = r(2, 96, 1, 32), r(2, 96, 1, 32), r(2, 96, 4, 32)

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    def flash(dev):
        qq, kk, vv = on(dev, q, k, v)
        return K.flash_attention_fwd(qq, kk, vv, causal=True)

    def flash_bwd(dev):
        qq, kk, vv, dd = on(dev, q, k, v, do)
        o, lse = K.flash_attention_fwd(qq, kk, vv, causal=True) if dev != "meta" else (
            torch.empty_like(qq), torch.empty((2, 4, 64), device="meta"))
        return K.flash_attention_bwd(qq, kk, vv, o, lse, dd, causal=True)

    def ssd_bwd(dev):
        a = on(dev, xs, dts, A, Bm, Cm, dy)
        _, states = K.ssd_scan_fwd(*a[:5], chunk=32)
        return K.ssd_scan_bwd(*a[:5], states, a[5], chunk=32)

    return [
        ("rmsnorm", lambda dev: K.rms_norm(*on(dev, x, scale))),
        ("rmsnorm_bwd", lambda dev: K.rms_norm_bwd(*on(dev, gy, x, scale))),
        ("flash_attention", flash),
        ("flash_attention_bwd", flash_bwd),
        ("decode_attention", lambda dev: K.decode_attention(*on(dev, dq, dk_, dv_, lengths))),
        ("paged_decode_attention",
         lambda dev: K.paged_decode_attention(*on(dev, dq, arena_k, arena_v, tables, lengths))),
        ("ssd_scan", lambda dev: K.ssd_scan_fwd(*on(dev, xs, dts, A, Bm, Cm), chunk=32)),
        ("ssd_scan_bwd", ssd_bwd),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_meta_branches_match_the_cuda_path(cuda, dtype):
    """Each wrapper's meta branch returns the shapes and dtypes of its CUDA
    path's outputs and reports the same work for the same shapes, and
    launches nothing; the CUDA path reports one work a launch."""
    for name, call in _meta_calls(dtype):
        seen = {"cuda": [], "meta": []}
        for dev in ("cuda", "meta"):
            K.work_hook = lambda n, f, b, dev=dev: seen[dev].append((n, f, b))
            K.reset_launch_counts()
            try:
                out = call(dev)
            finally:
                K.work_hook = None
            outs = out if isinstance(out, tuple) else (out,)
            if dev == "cuda":
                want = [(t.shape, t.dtype) for t in outs]
                assert K.launch_counts()[name] >= 1, name
            else:
                assert [(t.shape, t.dtype) for t in outs] == want, name
                assert all(t.device.type == "meta" for t in outs)
                assert sum(K.launch_counts().values()) == 0, name
        mine = [w for w in seen["cuda"] if w[0] == name]
        assert mine and mine == [w for w in seen["meta"] if w[0] == name], (name, seen)
