"""The port's elastic demos against the reference's, on the CPU:
``examples/elastic_failover_torch.py`` and ``elastic_serving_torch.py``
beside ``elastic_failover.py`` and ``elastic_serving.py``.

Each reference demo runs unchanged from its file, in a child process
of its own (``tests/_torch_examples_ref.py``), started at the module's
first test, while its twin runs here with ``--device cpu`` and the
reference's own initial parameters (``Model.init(PRNGKey(0))``, crossed
with ``params_from_numpy``). Each twin asserts the reference's guarantees
itself (a failing assertion fails its test):

* elastic_failover: the fleet's path (slow worker demoted, failed worker
  removed, rejoin), and exact resume from the step-80 checkpoint: every
  resumed step equal to the uninterrupted run's, bit for bit. Against the
  reference, both runs' stages, workers, contributors and simulated times
  are equal, losses within 1e-4 relative (100 AdamW steps apart), and the
  printed records come in the same order with the same fleet and resume
  fields.
* elastic_serving: zero dropped requests, streams byte-identical to
  per-request offline decode, a trace ``validate_trace`` accepts with no
  span left open. Against the reference: the streams, the plane's
  summary and every record equal, and the trace holds as many events.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax
import numpy as np
import pytest

from _torch_examples_ref import load, start
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def children(request, tmp_path_factory):
    """The reference runs this file reads, each in a child of its own,
    started at once (``start``)."""
    return start(request, tmp_path_factory.mktemp("examples_ref"))


def crossed(cfg, ref_cfg):
    tree = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    return params_from_numpy(cfg, jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def failover_pair(children):
    twin = load("elastic_failover_torch")
    cfg = twin.build()[0].cfg
    ref_cfg = ref_config("smollm-135m").reduced(n_layers=2, d_model=64, vocab_size=256,
                                                max_seq_len=64)
    runs = []
    train = twin.train

    def recorded(*a, **kw):
        out = train(*a, **kw)
        runs.append(out)
        return out

    twin.train = recorded
    rec = twin.main(["--device", "cpu"], params=crossed(cfg, ref_cfg))
    return children["elastic_failover"].result(), runs, rec


def test_failover_twin_resumes_exactly(failover_pair):
    """The twin's own assertions passed (exact resume among them); its
    records say so."""
    _, runs, rec = failover_pair
    kinds = [r["kind"] for r in rec["records"]]
    assert kinds[-1] == "verdict" and rec["records"][-1]["fields"]["ok"] is True
    check = next(r["fields"] for r in rec["records"] if r["kind"] == "resume_check")
    assert check["resumed_at"] == 80 and check["identical_steps"] == 20
    tail = [h for h in runs[0]["history"] if h["step"] >= 80]
    assert tail == runs[1]["history"]


@pytest.mark.parametrize("run", [0, 1], ids=["chaos", "resumed"])
def test_failover_history_equals_reference(failover_pair, run):
    ref, runs, _ = failover_pair
    a_hist, b_out = ref["runs"][run]["history"], runs[run]
    assert len(a_hist) == len(b_out["history"]) == (100 if run == 0 else 20)
    for a, b in zip(a_hist, b_out["history"]):
        for key in ("step", "k", "beta", "n_workers", "contributors"):
            assert a[key] == b[key], (key, a, b)
        assert ("switched_to" in a) == ("switched_to" in b)
        assert b["sim_time"] == pytest.approx(a["sim_time"], rel=1e-9, abs=1e-9)
        assert b["loss"] == pytest.approx(a["loss"], rel=LOSS_RTOL), a["step"]
    assert np.asarray(b_out["alive"]).tolist() == ref["runs"][run]["alive"]
    assert b_out["controller"].cfg.n == ref["runs"][run]["n"]


def test_failover_records_equal_reference(failover_pair):
    ref, _, rec = failover_pair
    want, got = ref["records"], rec["records"]
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for a, b in zip(want, got):
        if a["kind"] == "train_step":
            for key in ("step", "k", "beta", "workers"):
                assert a["fields"][key] == b["fields"][key]
        else:
            assert a["fields"] == b["fields"], a["kind"]


@pytest.fixture(scope="module")
def serving_pair(children):
    cfg = get_config("smollm-135m").reduced()
    rec = load("elastic_serving_torch").main(
        ["--device", "cpu"], params=crossed(cfg, ref_config("smollm-135m").reduced()))
    return children["elastic_serving"].result(), rec


def test_serving_streams_and_summary_equal_reference(serving_pair):
    ref, rec = serving_pair
    assert rec["streams"] == ref["streams"]
    assert {k: float(v) for k, v in rec["summary"].items()} == ref["summary"]
    assert rec["summary"]["dropped"] == 0 and rec["summary"]["completed"] == 10


def test_serving_records_equal_reference(serving_pair):
    ref, rec = serving_pair
    assert rec["records"] == ref["records"]
    verdict = rec["records"][-1]
    assert verdict["kind"] == "verdict" and verdict["fields"]["ok"] is True
    assert verdict["fields"]["trace_events"] == ref["trace_events"]
