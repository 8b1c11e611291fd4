"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` source compiles to an object for ``sm_90a`` (one
``nvcc`` per source, all started together), and the objects link into one
shared library ``build/repro_torch/librepro_torch_<hash>.so`` at the root
of the checkout, where ``<hash>`` covers the sources and the flags. The
library is built at first use and rebuilt whenever that hash changes; a
file lock keeps concurrent processes from building it twice. The C entry
points take raw pointers and a stream (``ctypes.c_void_p``) and return
``cudaGetLastError()`` after the launch.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

__all__ = ["load_library", "library_path", "build_dir", "build_log", "sources"]

_PKG = Path(__file__).resolve().parents[1]            # src/repro_torch
_CSRC = _PKG / "csrc"
_ROOT = _PKG.parents[1]                               # checkout root

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
]

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def build_dir() -> Path:
    return _ROOT / "build" / "repro_torch"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_{_digest()}.so"


def build_log() -> str:
    """nvcc's output for the current library (ptxas resource usage)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ([str(Path(CUDA_HOME) / "bin" / "nvcc")] if CUDA_HOME else []) + [
        shutil.which("nvcc") or ""
    ]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(target: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed, log = [], []
        for cmd, p in procs:
            out, _ = p.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if p.returncode != 0:
                failed.append(log[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        # ptxas's register / shared-memory / spill report, kept beside the
        # library (``build_log``).
        target.with_suffix(".log").write_text("\n".join(log))
        tmp_lib = Path(tmp) / target.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n{res.stdout}")
        os.replace(tmp_lib, target)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_rmsnorm_fwd.argtypes = [P, P, P, I, I, F] + [I] * 6 + [P]
    lib.repro_rmsnorm_fwd.restype = I
    lib.repro_rmsnorm_bwd.argtypes = [P] * 6 + [I, I, F] + [I] * 6 + [P]
    lib.repro_rmsnorm_bwd.restype = I
    lib.repro_flash_attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, P]
    lib.repro_flash_attention_fwd.restype = I
    lib.repro_flash_attention_bwd.argtypes = [
        P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, P
    ]
    lib.repro_flash_attention_bwd.restype = I
    lib.repro_decode_attention_fwd.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.repro_decode_attention_fwd.restype = I
    lib.repro_paged_decode_attention_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.repro_paged_decode_attention_fwd.restype = I
    lib.repro_ssd_scan_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.repro_ssd_scan_fwd.restype = I
    lib.repro_ssd_scan_bwd.argtypes = [P] * 15 + [I] * 8 + [P]
    lib.repro_ssd_scan_bwd.restype = I
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        target = library_path()
        target.parent.mkdir(parents=True, exist_ok=True)
        with open(target.parent / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not target.exists():
                    _build(target)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        _lib = _bind(ctypes.CDLL(str(target)))
    return _lib
