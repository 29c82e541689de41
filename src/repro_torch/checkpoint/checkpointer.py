"""Asynchronous checkpointing with atomic commit and restore.

Design:

* every leaf of a nested dict of arrays is written as its own ``.npy``
  under ``step_<N>.tmp/`` (one file per leaf, so each writer of a
  multi-writer job could own its own leaves; here the one process writes
  everything),
* the directory is atomically renamed to ``step_<N>/`` and a ``MANIFEST.json``
  (leaves, shapes, dtypes, step, time) makes partial writes detectable:
  a crash mid-write can never yield a directory that passes validation,
* writes happen on a background thread (the caller never blocks on disk),
  with ``wait()`` to drain,
* ``restore_latest`` scans for the newest valid manifest and rebuilds the
  tree, as numpy arrays or as torch tensors on a device the caller names.

Leaves may be numpy arrays, Python or numpy scalars, or torch tensors on
the card or the host (snapshotted with ``detach().cpu()``).  numpy has no
``bfloat16``: a bf16 tensor is written as its ``int16`` bit pattern and its
manifest entry says ``"dtype": "bfloat16"``, so it restores to the same
bits.  fp32, fp64 and integer leaves are plain ``.npy`` files in the same
layout as the reference package's checkpointer, so either package reads
the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

#: manifest dtype of a leaf stored as its int16 bit pattern
BFLOAT16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _snapshot(v: Any) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and the dtype its manifest records."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), BFLOAT16
        arr = t.numpy().copy()
    else:
        arr = np.asarray(v)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot (device→host copy) synchronously, write asynchronously."""
        self.wait()
        flat = {k: _snapshot(v) for k, v in _flatten(tree).items()}

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                manifest = {"step": step, "leaves": {}, "time": time.time()}
                for key, (arr, dtype) in flat.items():
                    fname = key.replace("/", "__") + ".npy"
                    np.save(os.path.join(tmp, fname), arr)
                    manifest["leaves"][key] = {
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": dtype,
                    }
                with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic commit
                self._gc()
            except Exception as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                man = os.path.join(self.dir, name, "MANIFEST.json")
                if os.path.exists(man):
                    out.append(int(name.removeprefix("step_")))
        return sorted(out)

    def restore(self, step: int, device=None) -> tuple[int, Any]:
        """Read step ``step`` back as ``(step, tree)``.

        ``device=None`` returns numpy leaves (what the controller state
        needs), except bf16 leaves, which numpy cannot hold: those come
        back as CPU ``torch.bfloat16`` tensors.  A device returns every
        leaf as a torch tensor there."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            assert list(arr.shape) == meta["shape"], f"corrupt leaf {key}"
            if meta["dtype"] == BFLOAT16:
                if arr.dtype != np.int16:
                    raise ValueError(f"bf16 leaf {key} is stored as {arr.dtype}, not int16")
                leaf = torch.from_numpy(arr).view(torch.bfloat16)
            else:
                leaf = arr
            if device is not None:
                leaf = torch.as_tensor(leaf).to(device)
            flat[key] = leaf
        return manifest["step"], _unflatten(flat)

    def restore_latest(self, device=None) -> tuple[int, Any] | None:
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], device)
