"""The port stands alone: it imports nothing of JAX or of the reference
package, keeps the reference's configs field for field, runs on the card
by default, and its chip smoke test refuses to run without a card."""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import ast
import dataclasses
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch import resolve_device
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.dist.sharding import make_mesh
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

#: The entry points' twins (``examples/*_torch.py``).
TWINS = ("serve_lm_torch", "train_lm_torch", "elastic_failover_torch",
         "elastic_serving_torch", "quickstart_torch")

_BLOCKED = f"TWINS = {TWINS!r}\n" + """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(mod.name)
import chip_smoke
import tools.chaos_search_torch
import importlib.util
for twin in TWINS:
    spec = importlib.util.spec_from_file_location(twin, f"examples/{twin}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
missing = {"repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
           "repro_torch.models.zamba", "repro_torch.serve.speculative",
           "repro_torch.obs.trace", "repro_torch.serve.transport",
           "repro_torch.serve.router", "repro_torch.serve.replica",
           "repro_torch.serve.frontend", "repro_torch.models.moe",
           "repro_torch.models.xlstm", "repro_torch.core.error_model",
           "repro_torch.core.switching", "repro_torch.core.schedule",
           "repro_torch.core.simulation", "repro_torch.core.vector_sim",
           "repro_torch.dist.compression", "tools.chaos_search_torch",
           "repro_torch.dist.sharding", "repro_torch.dist.pipeline_parallel",
           "repro_torch.configs.shapes", "repro_torch.launch.specs",
           "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
           "repro_torch.launch.perf_probe", "repro_torch.analysis.op_cost",
           "repro_torch.analysis.roofline", "repro_torch.analysis.report"} - set(sys.modules)
assert not missing, missing
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_port_imports_without_jax_or_reference():
    """Every module of the port, chip_smoke.py and the entry points'
    twins import with jax and the reference package blocked, and none of
    them gets loaded."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_source_names_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tools" / "flash_tiles.py",
                                         ROOT / "tools" / "rmsnorm_tiles.py",
                                         ROOT / "tools" / "chaos_search_torch.py"]
    files += [ROOT / "examples" / f"{twin}.py" for twin in TWINS]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("over", [None, {}, {"n_heads": 6, "n_kv_heads": 2}])
def test_configs_equal_reference_fields(name, over):
    port, ref = get_config(name), ref_config(name)
    if over is not None:
        port, ref = port.reduced(**over), ref.reduced(**over)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]


def test_aliases_resolve_like_reference():
    """Every alias of the reference's, each to the same config; the
    registry holds all ten of the reference's entries."""
    from repro.configs.registry import ALIASES as REF_ALIASES, ARCHS as REF_ARCHS

    assert ALIASES == REF_ALIASES and sorted(ARCHS) == sorted(REF_ARCHS)
    for alias, name in ALIASES.items():
        assert get_config(alias) == get_config(name)
        assert ref_config(alias).name == name
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_entry_points_default_to_the_card():
    """device defaults to "cuda"; without a card that raises instead of
    falling back to the CPU, in the package and in the entry points'
    twins run with no ``--device`` (all but quickstart's, which uses no
    card), which exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    model = Model(get_config("smollm-135m").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.blank_caches(1, 16)
    assert resolve_device("cpu").type == "cpu"
    # All at once: each spends its time importing torch.
    procs = [subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{twin}.py")],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for twin in TWINS if twin != "quickstart_torch"]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device is available" in err, err[-2000:]


def test_build_model_like_reference():
    """The port's ``repro_torch.models`` exports every name of the
    reference's ``repro.models`` (``build_model`` among them)."""
    import repro.models
    import repro_torch.models
    from repro_torch.models import build_model

    assert set(repro.models.__all__) <= set(repro_torch.models.__all__)
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    assert isinstance(model, Model) and model.cfg == cfg


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No card: non-zero exit and no result line. A directory holding only
    chip_smoke.py: non-zero exit as well."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # Both runs at once: each spends its time importing torch.
    procs = [
        subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    ]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in out


def test_make_mesh_defaults_to_the_card_and_never_falls_back(tmp_path):
    """``make_mesh`` defaults to "cuda"; a CUDA mesh over a gloo group
    raises instead of running on another backend, a CPU mesh over gloo
    is built, and a mesh must cover the world."""
    assert inspect.signature(make_mesh).parameters["device"].default == "cuda"
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                                         rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="nccl"):
            make_mesh((1,), ("data",))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((2,), ("data",), device="cpu")
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        torch.distributed.destroy_process_group()
