"""The port's entry points against the reference's, on the CPU:
``examples/serve_lm_torch.py``, ``train_lm_torch.py`` and
``quickstart_torch.py`` beside ``serve_lm.py``, ``train_lm.py`` and
``quickstart.py``.

Each reference example runs unchanged from its file, in a child process
of its own for each command line (``tests/_torch_examples_ref.py``),
all started at the module's first test, while its twin runs here with
``--device cpu`` and the reference's own initial parameters (its
``Model.init`` at the example's seeds, crossed with
``params_from_numpy``). The train_lm tests come last: the test process
serves and simulates while the reference's loop runs.

* serve_lm, at README's four command lines for smollm (contiguous,
  ``--paged``, ``--speculative --draft smollm``, ``--prefill-chunk 8``)
  and at ``--arch xlstm`` (recurrent caches): every stream token for
  token, and the prefill calls and tokens, decode ticks, generated tokens,
  the arena's high-water and the speculation counts;
* train_lm, tiny preset, ``--steps 20 --fail-worker-at 10``: per step the
  stage, the fleet and the simulated time equal (sim time within 1e-9),
  the losses within 1e-4 relative (two frameworks' f32 sums, 20 AdamW
  steps apart), the printed stage path and batch shapes equal;
* quickstart: the analytic runtime ratio, computation reduction and
  communication overhead within 1e-12, and each live simulation through
  the packages' ``simulate`` at the example's arguments with
  ``max_iters`` cut to ``SIM_ITERS``: stage logs and the time to the gap.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_examples_ref import SERVE_ARGS, TRAIN_ARGS, load, start
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy

#: quickstart's simulations are cut to this many iterations.
SIM_ITERS = 4000
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def children(request, tmp_path_factory):
    """The reference runs this file reads, each command line in a child of
    its own, started at once (``start``)."""
    return start(request, tmp_path_factory.mktemp("examples_ref"))


def crossed(arch: str, seed: int):
    """The reference's ``Model.init(PRNGKey(seed))`` of ``arch`` reduced, as
    the port's tree on the CPU."""
    tree = ref_build(ref_config(arch).reduced()).init(jax.random.PRNGKey(seed))
    return params_from_numpy(get_config(arch).reduced(), jax.tree.map(np.asarray, tree),
                             device="cpu")


def quickstart_run(name: str, *argv) -> dict:
    """Run ``examples/NAME.py``'s main with its module's ``simulate`` and
    ``evaluate_schedule`` wrapped: each call's result is recorded, and
    ``max_iters`` is cut to ``SIM_ITERS``."""
    mod = load(name)
    seen = {"schedules": [], "sims": []}
    simulate, evaluate = mod.simulate, mod.evaluate_schedule

    def sim(*a, **kw):
        assert kw["max_iters"] == 20_000
        r = simulate(*a, **dict(kw, max_iters=SIM_ITERS))
        seen["sims"].append(r)
        return r

    def schedule(*a, **kw):
        r = evaluate(*a, **kw)
        seen["schedules"].append(r)
        return r

    mod.simulate, mod.evaluate_schedule = sim, schedule
    seen["records"] = mod.main(*argv)
    return seen


@pytest.fixture(scope="module")
def quickstart_pair():
    return quickstart_run("quickstart"), quickstart_run("quickstart_torch", [])


def test_quickstart_analytic_equals_reference(quickstart_pair):
    ref, twin = quickstart_pair
    (ours, ak), (t_ours, t_ak) = ref["schedules"], twin["schedules"]
    want = dict(runtime_ratio=ours.runtime / ak.runtime,
                computation_reduction=1 - ours.comp_cost / ak.comp_cost,
                communication_overhead=ours.comm_cost / ak.comm_cost - 1)
    got = twin["records"]["analytic"]
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12, abs=1e-12), key
    assert got["stage_path"] == [(s.k, s.beta) for s in ours.stages[:8]]
    assert [(s.k, s.beta) for s in t_ak.stages] == [(s.k, s.beta) for s in ak.stages]


def test_quickstart_simulation_equals_reference(quickstart_pair):
    ref, twin = quickstart_pair
    assert len(ref["sims"]) == len(twin["sims"]) == 2
    for a, b, strat in zip(ref["sims"], twin["sims"], ("adaptive_kbeta", "adaptive_k")):
        assert [(it, s.k, s.beta) for it, s in b.stage_log] == \
            [(it, s.k, s.beta) for it, s in a.stage_log]
        assert b.time_to_gap(2e-2) == pytest.approx(a.time_to_gap(2e-2), rel=1e-12)
        rec = twin["records"]["simulation"][strat]
        assert rec["stages"] == len(a.stage_log)
        assert rec["time_to_gap"] == b.time_to_gap(2e-2)


@pytest.fixture(scope="module", params=SERVE_ARGS, ids=lambda a: " ".join(a) or "contiguous")
def serve_pair(request, children):
    argv = request.param
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else "smollm"
    draft = crossed("smollm", 1) if "--speculative" in argv else None
    twin = load("serve_lm_torch").main([*argv, "--device", "cpu"], params=crossed(arch, 0),
                                       draft_params=draft)
    return children[argv].result(), twin


def test_serve_streams_equal_reference(serve_pair):
    ref, twin = serve_pair
    assert len(twin["streams"]) == 6
    assert twin["streams"] == ref["streams"]
    assert twin["serve"]["device"] == "CPU"


def test_serve_counts_equal_reference(serve_pair):
    ref, twin = serve_pair
    s = ref["stats"]
    assert twin["prefill"] == dict(calls=s["prefill_calls"], tokens=s["prefill_tokens"],
                                   decode_ticks=s["decode_ticks"])
    assert twin["generated"]["tokens"] == s["generated_tokens"]
    assert twin["generated"]["tokens_per_vsec"] == pytest.approx(
        s["generated_tokens"] / s["virtual_seconds"], rel=1e-12)
    if ref["high_water"] is None:
        assert "kv_arena" not in twin
    else:
        arena = twin["kv_arena"]
        assert (arena["high_water"], arena["blocks"]) == ref["high_water"]
    if ref["spec"] is None:
        assert "speculation" not in twin
    else:
        spec = twin["speculation"]
        assert (spec["rounds"], spec["draft_ticks"], spec["accepted"]) == \
            (s["spec_rounds"], s["draft_ticks"], s["spec_accepted"])
        assert spec["accept_hist"] == ref["spec"][1]
        assert spec["p_ewma"] == pytest.approx(ref["spec"][0], rel=1e-12)


@pytest.fixture(scope="module")
def train_pair(children):
    twin_mod = load("train_lm_torch")
    cfg = twin_mod.preset_config("tiny", 128)
    ref_cfg = ref_config("smollm-135m").reduced(n_layers=4, d_model=128, vocab_size=512,
                                                max_seq_len=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    tree = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    seen = {}
    train = twin_mod.train

    def recorded(*a, **kw):
        out = train(*a, **kw)
        seen.update(history=out["history"], sim_time=out["sim_time"])
        return out

    twin_mod.train = recorded
    rec = twin_mod.main([*TRAIN_ARGS, "--device", "cpu"],
                        params=params_from_numpy(cfg, jax.tree.map(np.asarray, tree),
                                                 device="cpu"))
    return children["train_lm"].result(), seen, rec


def test_train_control_plane_equals_reference(train_pair):
    """Every step's stage, fleet, contributors and simulated time; the
    batch shapes and the final simulated time."""
    ref, twin, rec = train_pair
    assert len(twin["history"]) == len(ref["history"]) == 20
    for a, b in zip(ref["history"], twin["history"]):
        for key in ("step", "k", "beta", "n_workers", "contributors"):
            assert a[key] == b[key], (key, a, b)
        assert ("switched_to" in a) == ("switched_to" in b)
        assert b["sim_time"] == pytest.approx(a["sim_time"], rel=1e-9, abs=1e-9)
    assert rec["compiled_shapes"] == ref["compiled_shapes"]
    assert rec["sim_time"] == pytest.approx(ref["sim_time"], rel=1e-9)


def test_train_losses_and_records_equal_reference(train_pair):
    ref, twin, rec = train_pair
    for a, b in zip(ref["history"], twin["history"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=LOSS_RTOL), a["step"]
    path = [(h["k"], h["beta"]) for h in ref["history"] if "switched_to" in h]
    assert rec["stage_path"] == path and path
    assert rec["start_loss"] == twin["history"][0]["loss"]
    assert rec["final_loss"] == twin["history"][-1]["loss"]
