"""``repro_torch.analysis.op_cost`` against hand-worked ground truth (the
twins of the reference's HLO cost tests in
``tests/test_sharding_and_cost.py``), its collective bytes against the
reference's ``collective_bytes_from_hlo``, its peak of live bytes, and
the kernels' work formulas against the figures of PERF.md's kernel table
(``chip_smoke.py``'s bounds at the H100's datasheet rates)."""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.hlo import collective_bytes_from_hlo
from repro.analysis.hlo_cost import COLLECTIVES as REF_COLLECTIVES
from repro_torch import kernels as K
from repro_torch.analysis.op_cost import COLLECTIVES, count, counting

ROOT = Path(__file__).resolve().parents[1]

HBM = 3.35e12
BF16 = 989e12
F32 = 67e12
TF32X3 = 494.7e12 / 3   # dense TF32 over the three products of 3xTF32


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_loop_of_matmuls_counts_every_trip():
    def f(w, x):
        h = x
        for _ in range(7):
            h = torch.tanh(h @ w)
        return h.sum()

    _, cost = count(f, _meta(64, 64), _meta(8, 64))
    assert cost.flops == 7 * 2 * 8 * 64 * 64
    assert cost.unknown_trip_counts == 0


def test_nested_loops_count_exactly():
    def f(w, x):
        h = x
        for _ in range(5):
            g = h
            for _ in range(3):
                g = torch.tanh(g @ w)
            h = g
        return h.sum()

    _, cost = count(f, _meta(32, 32), _meta(4, 32))
    assert cost.flops == 5 * 3 * 2 * 4 * 32 * 32


@pytest.mark.parametrize("shape", [(8, 64, 32), (3, 17, 5)])
def test_matmul_backward_counts_twice_its_forward(shape):
    m, k, n = shape
    a, b = _meta(m, k, grad=True), _meta(k, n, grad=True)
    _, fwd = count(lambda: a @ b)
    _, both = count(lambda: (a @ b).sum().backward())
    assert fwd.flops == 2 * m * k * n
    assert both.flops == 3 * fwd.flops


def test_einsum_and_linear_reach_the_products():
    x, w, bias = _meta(4, 10, 16), _meta(24, 16), _meta(24)
    _, lin = count(torch.nn.functional.linear, x, w, bias)
    _, ein = count(lambda: torch.einsum("bsd,hd->bsh", x, w))
    assert lin.flops == ein.flops == 2 * 40 * 16 * 24


def test_bytes_skip_views_and_count_in_place_ops_twice():
    x = _meta(256)                                   # 1 KiB
    _, cost = count(lambda t: (t.view(16, 16).unsqueeze(0).reshape(-1) * 2).add_(1).detach(),
                    x)
    # mul: 1 KiB in, 1 KiB out; add_: 1 KiB in, 1 KiB written; views and detach: 0.
    assert cost.hbm_bytes == 4 * 1024
    _, copy = count(lambda t: t.view(16, 16).t().reshape(-1), x)
    assert copy.hbm_bytes == 2 * 1024                # a strided reshape copies
    assert cost.by_op["aten.mul.Tensor"] == [1, 2048.0, 0.0]


def test_peak_live_bytes_by_hand():
    """Arguments 1 KiB; a = 2x (+1 KiB), b = 3a (+1 KiB: 3 KiB), a freed
    (2 KiB), c = cat(b, b) (+2 KiB: 4 KiB), b freed, v = c[:10] shares c's
    storage. Peak 4 KiB; without the free it would be 5."""
    def f(x):
        a = x * 2
        b = a * 3
        del a
        c = torch.cat([b, b])
        del b
        v = c[:10]
        return v

    x = _meta(256)
    with counting((x,)) as cost:
        v = f(x)
        assert v.numel() == 10
    assert cost.argument_bytes == 1024
    assert cost.peak_bytes == 4 * 1024


def test_view_keeps_its_storage_live():
    x = _meta(256)
    with counting((x,)) as cost:
        a = x * 2
        v = a[:8]
        del a
        b = x + 1                                   # a's storage is still held by v
        del v, b
        c = x - 1
        del c
    assert cost.peak_bytes == 3 * 1024


_COLLECTIVE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.analysis.op_cost import counting

    mesh = make_test_mesh((4, 2), ("data", "model"))
    g = mesh.get_group("data")
    out = {}
    x = torch.empty(6, 40, dtype=torch.bfloat16, device="meta")
    y = torch.empty(24, 40, dtype=torch.float32, device="meta")
    cases = {
        "all-gather functional": lambda: fc.all_gather_tensor(x, 0, g),
        "all-gather in place": lambda: dist.all_gather_into_tensor(
            torch.empty(24, 40, dtype=torch.bfloat16, device="meta"), x, group=g),
        "all-reduce functional": lambda: fc.all_reduce(y, "sum", g),
        "all-reduce in place": lambda: dist.all_reduce(y, group=g),
        "reduce-scatter functional": lambda: fc.reduce_scatter_tensor(y, "sum", 0, g),
        "reduce-scatter in place": lambda: dist.reduce_scatter_tensor(
            torch.empty(6, 40, device="meta"), y, group=g),
        "all-to-all functional": lambda: fc.all_to_all_single(y, None, None, g),
        "all-to-all in place": lambda: dist.all_to_all_single(torch.empty_like(y), y, group=g),
        "collective-permute send": lambda: dist.send(x, 1),
        "collective-permute recv": lambda: dist.recv(x, 1),
    }
    for name, fn in cases.items():
        with counting() as cost:
            r = fn()
            if hasattr(r, "wait"):
                r.wait()
        out[name] = {"bytes": dict(cost.collective_bytes),
                     "counts": dict(cost.collective_counts),
                     "sources": [s for s, _ in cost.top_collective_sources()]}
    print(json.dumps(out))
""")


def test_collective_bytes_equal_the_reference_hlo_convention():
    """Each collective kind, functional and in place, on a fake group: its
    per-device bytes are those ``collective_bytes_from_hlo`` gives an HLO
    op of the same output shape; one op of one kind each."""
    assert COLLECTIVES == REF_COLLECTIVES
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _COLLECTIVE_SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    out_shape = {"all-gather": "bf16[24,40]", "all-reduce": "f32[24,40]",
                 "reduce-scatter": "f32[6,40]", "all-to-all": "f32[24,40]",
                 "collective-permute": "bf16[6,40]"}
    assert len(got) == 10
    for name, rec in got.items():
        kind = name.split()[0]
        hlo = f"  %c = {out_shape[kind]}{{1,0}} {kind}(f32[1] %p), replica_groups={{}}"
        want = collective_bytes_from_hlo(hlo)
        assert rec["bytes"] == {kind: float(want[kind])}, (name, rec, want)
        assert rec["counts"] == {f"{kind}_count": 1.0}, name
        assert len(rec["sources"]) == 1


# ---------------------------------------------------------------------------
# Kernel work formulas vs PERF.md's kernel table (chip_smoke.py's bounds)
# ---------------------------------------------------------------------------

def _bound_ms(flops, nbytes, peak):
    return max(nbytes / HBM, flops / peak) * 1e3


@pytest.mark.parametrize("shape,causal,fwd_ms,bwd_ms", [
    ((32, 512, 512, 32, 8, 64, 64), True, 0.0507, 0.1008),       # llama3.2-1b
    ((32, 512, 512, 32, 32, 128, 128), True, 0.1609, 0.3211),    # zamba2's shared block
    ((8, 512, 512, 16, 2, 128, 128), True, 0.0113, 0.0226),      # qwen2.5-3b
    ((32, 512, 512, 16, 16, 80, 80), False, 0.0504, 0.1086),     # hubert-xlarge
], ids=["llama", "zamba2", "qwen2.5", "hubert"])
def test_flash_work_reproduces_the_kernel_table(shape, causal, fwd_ms, bwd_ms):
    f, b = K.flash_attention_work(*shape, 2, causal)
    fb, bb = K.flash_attention_bwd_work(*shape, 2, causal)
    assert round(_bound_ms(f, b, BF16), 4) == fwd_ms
    assert round(_bound_ms(fb, bb, BF16), 4) == bwd_ms
    if not causal:
        assert round(f / 1e9, 1) == 42.9 and round(fb / 1e9, 1) == 107.4
        assert b / HBM * 1e3 > f / BF16 * 1e3 and fb / BF16 > bb / HBM


@pytest.mark.parametrize("rows,D,fwd_ms,bwd_ms", [
    (16384, 2048, 0.0401, 0.0601), (16384, 4096, 0.0801, 0.1202),
    (4096, 7168, 0.03506, 0.05259), (4096, 1536, 0.00751, 0.01127),
    (4096, 512, 0.00250, 0.00376), (16384, 768, 0.01502, 0.02254),
    (16384, 1536, 0.03005, 0.04507),
])
def test_rmsnorm_work_reproduces_the_kernel_table(rows, D, fwd_ms, bwd_ms):
    digits = 4 if rows == 16384 and D >= 2048 else 5
    assert round(_bound_ms(*K.rms_norm_work(rows, D, 2), F32), digits) == fwd_ms
    assert round(_bound_ms(*K.rms_norm_bwd_work(rows, D, 2), F32), digits) == bwd_ms


@pytest.mark.parametrize("kernel,fwd_ms,bwd_ms", [("flash", 0.0076, 0.0151),
                                                    ("rmsnorm", 0.00563, 0.00845)])
def test_smollm_f32_work_reproduces_the_kernel_table(kernel, fwd_ms, bwd_ms):
    """smollm-135m's f32 training rows (32 x 128 tokens): K1 at G 3, D 64,
    causal, bound by bytes at the rate its 3xTF32 kernels can reach (at
    FFMA's 67 TFLOP/s it would be bound by operations); K2 at D 576, by
    bytes."""
    if kernel == "flash":
        shape = (32, 128, 128, 9, 3, 64, 64)
        fwd = K.flash_attention_work(*shape, 4, True)
        bwd = K.flash_attention_bwd_work(*shape, 4, True)
        assert fwd[1] / HBM > fwd[0] / TF32X3 and bwd[1] / HBM > bwd[0] / TF32X3
        assert fwd[0] / F32 > fwd[1] / HBM and bwd[0] / F32 > bwd[1] / HBM
        peak, digits = TF32X3, 4
    else:
        fwd, bwd = K.rms_norm_work(4096, 576, 4), K.rms_norm_bwd_work(4096, 576, 4)
        peak, digits = F32, 5
    assert round(_bound_ms(*fwd, peak), digits) == fwd_ms
    assert round(_bound_ms(*bwd, peak), digits) == bwd_ms


def test_decode_work_reproduces_the_kernel_table():
    lens = [543, 450, 237, 408]
    f, b = K.decode_attention_work(4, 32, 8, 64, 2, sum(lens))
    assert round(_bound_ms(f, b, F32), 5) == 0.00101
    blocks = sum(-(-n // 16) for n in lens)
    fp, bp = K.paged_decode_attention_work(4, 32, 8, 64, 2, sum(lens), blocks)
    assert fp == f and bp == b + 4 * blocks
    assert round(_bound_ms(fp, bp, F32), 5) == 0.00101
    f, b = K.paged_decode_attention_work(4, 16, 2, 128, 2, sum(lens), blocks)  # qwen2.5-3b
    assert round(_bound_ms(f, b, F32), 6) == 0.000511
    # A rank's shapes of llama3.2-1b's decode on two ranks (phase 27 (e)):
    # K3's partial form over rank 0's 512 rows, K3 at 16 / 4 heads.
    f, b = K.decode_attention_partial_work(4, 32, 8, 64, 2, 101 + 510 + 512 + 512)
    assert round(_bound_ms(f, b, F32), 5) == 0.00101
    f, b = K.decode_attention_work(4, 16, 4, 64, 2, 101 + 510 + 701 + 1001)
    assert round(_bound_ms(f, b, F32), 6) == 0.000712


def test_ssd_work_reproduces_the_kernel_table():
    shape = (32, 512, 64, 64, 1, 64, 128)                              # zamba2-1.2b
    assert round(_bound_ms(*K.ssd_scan_work(*shape, 2), BF16), 4) == 0.0826
    assert round(_bound_ms(*K.ssd_scan_bwd_work(*shape, 2), BF16), 4) == 0.1252
    f, _ = K.ssd_scan_work(*shape, 2)
    assert K.ssd_scan_bwd_work(*shape, 2)[0] == 2 * f


def test_work_table_covers_every_kernel():
    assert set(K.WORK) == set(K.KERNELS)
    assert K.work_hook is None


def test_kernel_work_is_counted_and_cpu_branches_report_nothing():
    """The meta branch reports its launch's work through the hook (and the
    counter adds it); the CPU branch runs the plain version, whose aten
    ops the counter sees one by one, and reports nothing."""
    q, k = _meta(2, 64, 4, 32), _meta(2, 64, 2, 32)
    with counting() as meta:
        K.flash_attention_fwd(q, k, k, causal=True)
    f, b = K.flash_attention_work(2, 64, 64, 4, 2, 32, 32, 4, True)
    assert meta.kernel_work == {"flash_attention": {"launches": 1, "flops": f, "bytes": b}}
    assert meta.flops == f and meta.hbm_bytes == b
    with counting() as cpu:
        K.flash_attention_fwd(torch.zeros(2, 64, 4, 32), torch.zeros(2, 64, 2, 32),
                              torch.zeros(2, 64, 2, 32), causal=True)
    assert cpu.kernel_work == {} and cpu.flops > 0
    assert K.launch_counts()["flash_attention"] == 0
    with pytest.raises(RuntimeError, match="already active"):
        with counting():
            with counting():
                pass
    assert K.work_hook is None
