"""The reference's side of ``tests/test_torch_examples.py`` and
``tests/test_torch_examples_elastic.py``: runs JAX examples from
``examples/`` by path, records what each did, and pickles it.

    python tests/_torch_examples_ref.py NAME OUT.pkl [ARG ...]

NAME is ``serve_lm`` or ``train_lm``, run at the command line ARG ...
(one of ``SERVE_ARGS``; ``TRAIN_ARGS``), ``elastic_failover`` or
``elastic_serving``. Each example's ``main()`` runs unchanged from its
file; the names it imported (``ServeEngine``, ``train``, ``Frontend``)
are wrapped in its module to record the engine's streams and stats, the
loop's outputs and the plane's streams, summary and trace. The tests
start these runs in child processes (``start``), one a command line, so
that the reference's JAX compiles run side by side and beside the twins'
runs in the test process.
"""

from __future__ import annotations

import atexit
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: serve_lm's command lines: README's four, then the recurrent caches.
SERVE_ARGS = ((), ("--paged",), ("--speculative", "--draft", "smollm"),
              ("--prefill-chunk", "8"), ("--arch", "xlstm"))
TRAIN_ARGS = ("--steps", "20", "--fail-worker-at", "10")


def load(name: str):
    """``examples/NAME.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv=()):
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved


def history(out) -> dict:
    return {"history": out["history"], "sim_time": float(out["sim_time"]),
            "compiled_shapes": [tuple(s) for s in out["compiled_shapes"]],
            "alive": np.asarray(out["alive"]).tolist(), "n": int(out["controller"].cfg.n)}


def serve_lm(*argv: str) -> dict:
    mod = load("serve_lm")
    seen = {}

    class Engine(mod.ServeEngine):
        def run(self, *a, **kw):
            results = super().run(*a, **kw)
            mgr = self.pool.manager if self.pool.paged else None
            seen["run"] = {
                "streams": {rid: list(results[rid].tokens) for rid in sorted(results)},
                "stats": dataclasses.asdict(self.stats),
                "high_water": None if mgr is None else (mgr.used_high_water, mgr.num_blocks),
                "spec": None if not self.speculative else
                (float(self.spec.p), np.asarray(self.spec.hist).tolist()),
            }
            return results

    mod.ServeEngine = Engine
    run_main(mod, argv)
    return seen["run"]


def train_lm(*argv: str) -> dict:
    mod = load("train_lm")
    seen = {}
    train = mod.train

    def recorded(*a, **kw):
        out = train(*a, **kw)
        seen.update(history(out))
        return out

    mod.train = recorded
    run_main(mod, argv)
    return seen


def elastic_failover() -> dict:
    mod = load("elastic_failover")
    runs, obs_seen = [], []
    train = mod.train

    def recorded(*a, **kw):
        out = train(*a, **kw)
        runs.append(history(out))
        obs_seen.append(kw["obs"])
        return out

    mod.train = recorded
    run_main(mod)
    return {"runs": runs, "records": obs_seen[-1].log.to_jsonable()}


def elastic_serving() -> dict:
    mod = load("elastic_serving")
    seen = {}
    frontend = mod.Frontend

    class Frontend(frontend):
        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            seen["streams"] = [list(out[g].tokens) for g in sorted(out)]
            seen["summary"] = {k: float(v) for k, v in self.summary().items()}
            seen["obs"] = self.obs
            return out

    mod.Frontend = Frontend
    run_main(mod)
    obs = seen.pop("obs")
    seen["records"] = obs.log.to_jsonable()
    seen["trace_events"] = len(obs.tracer.events)
    return seen


class Child:
    """``python tests/_torch_examples_ref.py NAME OUT ARGV...`` started in
    the background; ``result()`` waits for it and unpickles its record,
    ``stop()`` ends it if it still runs."""

    def __init__(self, name: str, out: Path, argv=()):
        self.out = Path(out)
        self.log = self.out.with_suffix(".log")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen([sys.executable, __file__, name, str(self.out), *argv],
                                         env=env, cwd=ROOT, stdout=log,
                                         stderr=subprocess.STDOUT)
        self._result = None

    def result(self, timeout: float = 600) -> dict:
        if self._result is None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            assert self.proc.returncode == 0, self.log.read_text()[-4000:]
            self._result = pickle.loads(self.out.read_bytes())
        return self._result

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


#: The reference runs each test file reads: key -> (NAME, argv).
RUNS = {
    "test_torch_examples.py": {**{argv: ("serve_lm", argv) for argv in SERVE_ARGS},
                               "train_lm": ("train_lm", TRAIN_ARGS)},
    "test_torch_examples_elastic.py": {name: (name, ()) for name in ("elastic_failover",
                                                                     "elastic_serving")},
}
_STARTED: dict = {}


def start(request, out_dir: Path) -> dict:
    """The requesting test file's runs, ``{key: Child}``, each started
    once a process. Outside xdist the first file to ask also starts the
    other file's runs where the session holds its tests: that is there
    only so that the two files take at most 90 s in one process (their
    children overlap); under ``--dist loadfile`` a worker starts its own
    file's runs alone."""
    files = {Path(request.node.fspath).name}
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        files |= {Path(item.fspath).name for item in request.session.items} & set(RUNS)
    for file in sorted(files - set(_STARTED)):
        _STARTED[file] = {key: Child(name, Path(out_dir) / f"{name}-{i}.pkl", argv)
                          for i, (key, (name, argv)) in enumerate(RUNS[file].items())}
    return _STARTED[Path(request.node.fspath).name]


@atexit.register
def _stop() -> None:
    for children in _STARTED.values():
        for child in children.values():
            child.stop()


def main() -> int:
    name, out, argv = sys.argv[1], Path(sys.argv[2]), sys.argv[3:]
    result = globals()[name](*argv)
    tmp = out.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(result))
    tmp.rename(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
