"""A CPU rehearsal of ``chip_smoke.py`` phase 27 (e): the tensor-parallel
decode of llama3.2-1b, cut to a small width, on two gloo ranks of the CPU,
against the plain single-rank step, with the planted faults, and the meta
count of a decode step on a fake (1, 2) group.

The phase's own functions run unchanged: the card's generators, tensors
and synchronisation are redirected to the CPU, where every kernel wrapper
runs its plain version. Prints each rank's readings per layout: the logits'
and caches' largest differences from the plain step (relative to its
largest value), with each planted fault, the greedy departures, and the
collectives of a counted step beside the meta count.

    PYTHONPATH=src python tools/p27e_rehearse.py
    P27_OVER='{"n_layers": 16, "d_model": 512, "n_heads": 8, "n_kv_heads": 4,
        "head_dim": 64, "d_ff": 1024}' PYTHONPATH=src python tools/p27e_rehearse.py

``P27_OVER`` (JSON) overrides fields of the reduced config (default: 2
layers, bf16, a vocab of 512, the rest ``ModelConfig.reduced``'s). The
reversed-heads fault needs 2 kv heads a rank or more: with one it
reverses nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

DEFAULT = {"n_layers": 2, "dtype": "bfloat16", "vocab_size": 512}


def patch() -> None:
    """llama3.2-1b at the reduced size, and "cuda" read as the CPU."""
    import repro_torch.configs as configs
    import repro_torch.models.model as model

    real = configs.get_config
    over = dict(DEFAULT, **json.loads(os.environ.get("P27_OVER", "{}")))

    def small(name):
        cfg = real(name)
        return cfg.reduced(**over) if name == "llama3.2-1b" else cfg

    configs.get_config = small
    model.resolve_device = lambda d: torch.device("cpu")
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    for name in ("randn", "randint", "tensor"):
        def on_cpu(*a, _f=getattr(torch, name), **k):
            if k.get("device") == "cuda":
                k["device"] = "cpu"
            return _f(*a, **k)
        setattr(torch, name, on_cpu)
    torch.cuda.synchronize = lambda *a, **k: None


def rank_main(rank: int, d: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    patch()
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank, world_size=2)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = get_config(cs.ARCH)
    *setup, full = cs.p27_setup(cfg, mesh, keep_full=True)
    out = cs.p27_decode(rank, mesh, setup[0], setup[1], full, cs.P27_DEC_RTOL, True, True)
    model, params, _, _, full = cs.p27_setup(cs.cut_for_parity(cfg), mesh, keep_full=True)
    f32 = cs.p27_decode(rank, mesh, model, params, full, cs.P27_F32_RTOL, False, True)
    Path(d, f"rank_{rank}.json").write_text(json.dumps({"decode": out, "f32": f32}))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    d = tempfile.mkdtemp(prefix="p27e_rehearse_")
    mp.spawn(rank_main, args=(d,), nprocs=2, join=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            "import p27e_rehearse as r; r.patch(); import chip_smoke; chip_smoke.p27_meta()")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    meta = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, check=True)
    meta = json.loads(meta.stdout.strip().splitlines()[-1])
    import chip_smoke as cs

    for r in range(2):
        a = json.loads(Path(d, f"rank_{r}.json").read_text())
        for layout in cs.P27_DEC_LAYOUTS:
            dd, f, m = a["decode"][layout], a["f32"][layout], meta["decode"][layout]
            print(f"rank {r} {layout}: logits {max(dd['logits_rel_err']):.3e} (limit "
                  f"{cs.P27_DEC_RTOL:g}), with {cs.P27_FAULTS[layout]} "
                  f"{dd['planted_rel_err']:.3e}; caches {dd['cache_rel_err']:.3e}; greedy "
                  f"flips {dd['greedy_flips']}, departures at plain gaps under {cs.TIE_TOL:g} "
                  f"{dd['near_tie_departures']}; f32 cut "
                  f"{max(f['logits_rel_err']):.3e}, with the fault {f['planted_rel_err']:.3e}; "
                  f"collectives {dd['collective_counts']} {dd['collective_bytes']}, meta "
                  f"{m['collective_counts']} {m['collective_bytes']}; replicas equal "
                  f"{dd['replicas_equal']}")


if __name__ == "__main__":
    main()
