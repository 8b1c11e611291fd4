"""Checkpointing: atomic, async, resumable (port of
``repro.runtime.checkpoint``).

Layout (one directory per step):
    <root>/step_000123/
        arrays.npz          — every tensor leaf, by its tree path
        meta.json           — step, schema, each leaf's dtype, extras
    <root>/LATEST           — atomically updated pointer file

Guarantees:
  * atomicity  — writes land in a tmp dir, fsync'd, then os.rename (POSIX
    atomic) + pointer update; a crash mid-save never corrupts LATEST;
  * async      — ``save_async`` copies every tensor to host memory
    synchronously and writes in a daemon thread, overlapping the next
    steps (the copy is taken even for CPU tensors: the optimizer updates
    its moments in place);
  * lossless   — a tensor is stored as its own bits: bf16 as its 16-bit
    pattern, never widened and rounded back, so a resumed run is
    bit-exact;
  * resume     — ``restore_latest`` reloads (state, extras) into the
    structure, dtypes and devices of a given tree;
  * retention  — keep_last N checkpoints, older ones pruned post-save;
  * meshes     — a tree of DTensors is saved as full leaves: every rank
    gathers them (a collective), rank 0 writes, and the others wait at a
    barrier until the write is done. ``restore`` lays each full leaf out
    as its ``like`` leaf is laid out, on that leaf's own mesh, so a
    checkpoint written on one mesh restores onto another (an elastic
    restart).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import full_value, local_block
from repro_torch.models.layers import tree_map

__all__ = ["CheckpointError", "CheckpointManager", "CHECKPOINT_SCHEMA"]

#: bump when the on-disk layout changes incompatibly.
CHECKPOINT_SCHEMA = 1

#: dtypes stored through an integer view of the same width.
_BIT_VIEWS = {torch.bfloat16: torch.int16}
_DTYPE_NAMES = {str(dt).replace("torch.", ""): dt for dt in (
    torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)}


class CheckpointError(RuntimeError):
    """A checkpoint on disk cannot be loaded: truncated or corrupt
    ``arrays.npz``/``meta.json``, a schema version this build does not
    understand, or leaves that do not match the tree restored into.
    Always names the offending path."""


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if torch.is_tensor(tree):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint leaf at {prefix!r} is a {type(tree).__name__}, "
                        "not a tensor")
    for key, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    view = _BIT_VIEWS.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy(order="C"))
    return t.view(dtype) if dtype in _BIT_VIEWS else t


def _fsync_dir(path: Path) -> None:
    """fsync a DIRECTORY: durably commit its entries (the renames)."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, root: str | Path, keep_last: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False

    # -- save ---------------------------------------------------------------
    @staticmethod
    def _host_copy(state) -> Tuple[Dict[str, torch.Tensor], bool]:
        """(every leaf, full, copied to host memory; whether the tree holds
        DTensors, whose gathering every rank joins)."""
        flat = _flatten_with_paths(state)
        meshed = any(isinstance(v, DTensor) for v in flat.values())
        return {k: full_value(v).detach().to(
            "cpu", copy=True) for k, v in flat.items()}, meshed

    def save(self, step: int, state, extras: Optional[dict] = None) -> Path:
        """Synchronous atomic save of a tensor tree + json-serializable extras."""
        flat, meshed = self._host_copy(state)
        final = self.root / f"step_{step:09d}"
        if not meshed or dist.get_rank() == 0:
            final = self._write(step, flat, extras)
        if meshed:
            dist.barrier()
        return final

    def _write(self, step: int, flat: Dict[str, torch.Tensor], extras) -> Path:
        tmp = self.root / f".tmp_step_{step:09d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: _to_numpy(v) for k, v in flat.items()})
        meta = {"step": step, "time": time.time(), "schema": CHECKPOINT_SCHEMA,
                "dtypes": {k: str(v.dtype).replace("torch.", "") for k, v in flat.items()},
                "extras": extras or {}}
        (tmp / "meta.json").write_text(json.dumps(meta))
        # Durability order: file contents -> tmp dir entries -> atomic
        # rename -> parent dir entry (the rename itself) -> LATEST.
        for f in tmp.iterdir():
            with open(f, "rb") as fh:
                os.fsync(fh.fileno())
        _fsync_dir(tmp)
        final = self.root / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.root)
        self._update_latest(final.name)
        self._prune()
        return final

    def save_async(self, step: int, state, extras: Optional[dict] = None):
        """Copy every tensor to host memory now; write in the background."""
        self.wait()  # one in-flight save at a time
        flat, self._barrier = self._host_copy(state)
        if self._barrier and dist.get_rank() != 0:
            return

        def work():
            try:
                self._write(step, flat, extras)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = self.root / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.root / name).exists():
            return None
        try:
            return int(name.split("_")[-1])
        except ValueError as e:
            raise CheckpointError(
                f"corrupt LATEST pointer {ptr}: {name!r} is not a "
                "step_NNNNNNNNN directory name"
            ) from e

    def restore(self, step: int, like, device_put_fn: Optional[Callable] = None
                ) -> Tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf comes back with the stored bits, on the device of its
        ``like`` leaf, which it must match in shape and dtype; a DTensor
        leaf comes back laid out as it is, on its mesh.
        ``device_put_fn(leaf, like_leaf)``, when given, places each full
        host leaf instead (the reference's elastic-restart hook)."""
        d = self.root / f"step_{step:09d}"
        if not d.is_dir():
            raise CheckpointError(f"no checkpoint directory at {d}")
        arrays_path, meta_path = d / "arrays.npz", d / "meta.json"
        try:
            meta = json.loads(meta_path.read_text())
        except FileNotFoundError as e:
            raise CheckpointError(f"checkpoint missing {meta_path}") from e
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointError(
                f"truncated or corrupt checkpoint metadata at {meta_path}: {e}"
            ) from e
        if meta.get("schema", 1) != CHECKPOINT_SCHEMA:
            raise CheckpointError(
                f"checkpoint {meta_path} has schema version {meta.get('schema')!r}; "
                f"this build reads version {CHECKPOINT_SCHEMA}"
            )
        try:
            with np.load(arrays_path) as data:
                arrays = {k: data[k] for k in data.files}
        except FileNotFoundError as e:
            raise CheckpointError(f"checkpoint missing {arrays_path}") from e
        except Exception as e:  # zipfile.BadZipFile, OSError, ValueError, ...
            raise CheckpointError(
                f"truncated or corrupt checkpoint arrays at {arrays_path}: {e}"
            ) from e

        want = _flatten_with_paths(like)
        out = {}
        for key, leaf in want.items():
            if key not in arrays:
                raise CheckpointError(f"checkpoint {d} missing leaf {key}")
            t = _from_numpy(arrays[key], _DTYPE_NAMES[meta["dtypes"][key]])
            if t.dtype != leaf.dtype or tuple(t.shape) != tuple(leaf.shape):
                raise CheckpointError(
                    f"checkpoint {d} leaf {key} is {t.dtype} {tuple(t.shape)}, "
                    f"expected {leaf.dtype} {tuple(leaf.shape)}")
            if device_put_fn is not None:
                out[key] = device_put_fn(t, leaf)
            elif isinstance(leaf, DTensor):
                out[key] = DTensor.from_local(
                    local_block(t, leaf.device_mesh, leaf.placements).to(leaf.to_local().device),
                    leaf.device_mesh, leaf.placements, run_check=False)
            else:
                out[key] = t.to(leaf.device)
        leaves = iter(out[k] for k in want)
        return tree_map(lambda _: next(leaves), like, is_leaf=torch.is_tensor), meta["extras"]

    def restore_latest(self, like, device_put_fn: Optional[Callable] = None):
        step = self.latest_step()
        if step is None:
            return None
        state, extras = self.restore(step, like, device_put_fn)
        return step, state, extras

    # -- internals ------------------------------------------------------------
    def _update_latest(self, name: str):
        ptr_tmp = self.root / ".LATEST_tmp"
        with open(ptr_tmp, "w") as fh:
            fh.write(name)
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(ptr_tmp, self.root / "LATEST")
        _fsync_dir(self.root)  # the pointer flip must survive a crash too

    def _prune(self):
        steps = sorted(
            p for p in self.root.iterdir()
            if p.is_dir() and p.name.startswith("step_")
        )
        for old in steps[: -self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)
