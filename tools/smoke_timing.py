#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes.

    python3 tools/smoke_timing.py > smoke.log 2> timing.log

Needs what ``chip_smoke.py`` needs (one CUDA card, ``nvcc``). Runs
``chip_smoke.main()`` unchanged, with each of its phase functions
(``FUNCTIONS``) wrapped to add up the wall seconds its calls take. As
each call of a second or more returns it prints, on standard error,
``CALL name: seconds, ending at seconds`` (the script's clock), and after
the run (also when a phase fails) one ``TIMING name: seconds in calls``
line a function, the slowest first.
Times are inclusive: a function's time holds the time of the functions
it calls. The script's 1,200 s limit makes this the way to choose what
a growing script cuts first.
"""

from __future__ import annotations

import functools
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FUNCTIONS = """serve check_streams profile_ticks profile_serving time_kernels check_kernels
load_full_width dense_decode_vs_plain time_wide_kernels train_full_width step_vs_plain
profile_train_step remat_step_pair check_loop_shapes check_training_kernels
time_training_kernels check_ssd_kernels time_ssd_kernels zamba_decode_vs_plain serve_zamba
profile_zamba_serving verify_vs_plain serve_speculative profile_spec_round
serve_shared_prefix serve_preempted migrate serve_observed serve_fleet phase19 phase20
phase21 train_family own_batch_drop time_opt_step check_k2_training_rows time_rmsnorm
time_flash time_zamba_kernels time_snapshot time_shared_decode time_slot_copies
check_zamba_loop_shapes time_k2_widths phase22 phase22a phase22b train_hubert hold_sim
phase23 phase23a phase23b hold_paged_decode time_decode time_rmsnorm_rows window
serve_probed train_hubert hold_flash check_tensor_cores check_ssd_tensor_cores""".split()


def main() -> int:
    spent, calls = defaultdict(float), defaultdict(int)
    t_start = time.perf_counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                spent[name] += t1 - t0
                calls[name] += 1
                if t1 - t0 >= 1.0:
                    print(f"CALL {name}: {t1 - t0:.1f} s, ending at {t1 - t_start:.1f} s",
                          file=sys.stderr, flush=True)
        return wrapper

    for name in FUNCTIONS:
        setattr(chip_smoke, name, timed(name, getattr(chip_smoke, name)))
    try:
        return chip_smoke.main()
    finally:
        for name, t in sorted(spent.items(), key=lambda kv: -kv[1]):
            print(f"TIMING {name}: {t:.1f} s in {calls[name]} calls", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
