"""Perf probe: trace one cell on meta tensors and attribute its
collective traffic to the port's source lines (port of
``repro.launch.perf_probe``): peak GiB per device, FLOPs, bytes and
collective bytes per device, and the top collective sources.

  PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch llama3.2-1b \\
      --shape train_4k [--variant baseline] [--multi-pod]
"""

import argparse

from repro_torch.launch import dryrun as dr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dr.apply_variant(get_config(args.arch), args.variant)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    cost, _, _, _, _, _ = dr.trace_cell(cfg, shape, mesh, args.variant)

    print(f"\ncell: {cfg.name} x {args.shape} ({'pod2' if args.multi_pod else 'pod1'}) "
          f"variant={args.variant}")
    print(f"peak GiB/dev: {cost.peak_bytes / 2**30:.2f}")
    print(f"flops/dev: {cost.flops:.3e}  hbm/dev: {cost.hbm_bytes:.3e}  "
          f"coll/dev: {cost.total_collective_bytes():.3e}")
    print("\ntop collective sources (GiB/device/step):")
    for src, b in cost.top_collective_sources(args.top):
        print(f"  {b / 2**30:9.2f}  {src[:140]}")


if __name__ == "__main__":
    main()
