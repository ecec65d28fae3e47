"""Checkpointer: atomic, async (counterpart of
``repro.checkpoint.checkpointer``), in the reference's on-disk format:

    <dir>/step_<n>/arrays.npz     each leaf's raw bytes (uint8), keyed
                                  by its "/"-joined path
    <dir>/step_<n>/manifest.json  step, keys, dtype names, shapes (and
                                  logical specs, when given)
    <dir>/LATEST                  pointer file (atomic os.replace)

A snapshot is written to ``step_<n>.tmp`` and renamed, so a crash
mid-save never corrupts LATEST; ``save(block=False)`` copies the tensors
to the host at once and writes on a worker thread; the newest ``keep``
snapshots are kept.  A checkpoint of either package restores bit for
bit in the other: dtypes are recorded by name (``bfloat16``,
``float32``, ...), and bf16 is read back through a uint8 view, with no
``ml_dtypes``.  No mesh yet: specs are written only when given.

:meth:`Checkpointer.restore` copies into the ``like`` tree's tensors in
place (checking keys, shapes and dtypes), where the reference returns a
new tree: at full width the train state is ~31 GB on an 80 GB card, and
a second copy would not fit beside it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import flatten

# --------------------------------------------------------------------- #
# Tree <-> flat dict
# --------------------------------------------------------------------- #

def _unflatten_into(like: dict, flat: dict, prefix: str = "") -> dict:
    """``flat`` ({"a/b": leaf}, :func:`repro_torch.bridge.flatten`'s keys)
    as nested dicts shaped as ``like``."""
    return {k: (_unflatten_into(v, flat, f"{prefix}{k}/")
                if isinstance(v, dict) else flat[f"{prefix}{k}"])
            for k, v in like.items()}


def _to_host(x) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (a copy of a device tensor)."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu", copy=True).contiguous()


# --------------------------------------------------------------------- #
# Save / load one tree
# --------------------------------------------------------------------- #

def save_tree(path: str, tree: dict, step: int,
              specs: Optional[Any] = None) -> None:
    """Write ``tree`` (leaves: tensors or numpy arrays) atomically to
    ``path`` (a step directory).  ``specs``, when given, is {leaf key:
    [mesh axis name or None, ...]}, written as it is."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes, shapes = {}, {}, {}
    for k, v in flatten(tree).items():
        t = _to_host(v)
        arrays[k] = t.reshape(-1).view(torch.uint8).numpy()
        dtypes[k] = str(t.dtype).removeprefix("torch.")
        shapes[k] = list(t.shape)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays),
                "dtypes": dtypes, "shapes": shapes}
    if specs is not None:
        manifest["specs"] = specs
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A leaf from its raw bytes: numpy's and ml_dtypes' dtype names
    (``float32``, ``bfloat16``, ``float8_e4m3fn``, ...) are torch's."""
    t = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
    return t.view(getattr(torch, dtype)).reshape(shape)


def load_tree(path: str, like: dict) -> Tuple[dict, int, Optional[dict]]:
    """(tree of CPU tensors shaped as ``like``, step, specs or None)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: _from_bytes(data[k], manifest["dtypes"][k],
                               manifest["shapes"][k]) for k in data.files}
    return (_unflatten_into(like, flat), int(manifest["step"]),
            manifest.get("specs"))


# --------------------------------------------------------------------- #
# Checkpointer
# --------------------------------------------------------------------- #

class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------- #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        try:
            with open(os.path.join(self.dir, "LATEST")) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return None

    # -- save ---------------------------------------------------------- #
    def save(self, tree: dict, step: int, specs: Optional[Any] = None,
             block: bool = True) -> None:
        """Snapshot ``tree`` to the host now (training may then update the
        device tensors in place), then write it: on a worker thread
        unless ``block`` or the checkpointer is synchronous."""
        self.wait()
        host = {k: _to_host(v) for k, v in flatten(tree).items()}

        def write():
            save_tree(self._step_dir(step), host, step, specs)
            tmp = os.path.join(self.dir, "LATEST.tmp")
            with open(tmp, "w") as f:
                f.write(str(step))
            os.replace(tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if self.async_save and not block:
            def run():
                try:
                    write()
                except BaseException as e:      # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------- #
    def restore(self, step: int, like: dict):
        """(``like`` with snapshot ``step`` copied into its tensors in
        place, the step, specs).  Raises when a key, shape or dtype
        differs."""
        tree, s, specs = load_tree(self._step_dir(step), like)
        got, want = flatten(tree), flatten(like)
        with torch.no_grad():
            for k, dst in want.items():
                src = got[k]
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"checkpoint leaf {k}: {tuple(src.shape)} "
                        f"{src.dtype}, state {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src)
        return like, s, specs

    def restore_latest(self, like: dict):
        step = self.latest_step()
        if step is None:
            return None
        tree, s, _ = self.restore(step, like)
        return tree, s

    def wait(self) -> None:
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()
