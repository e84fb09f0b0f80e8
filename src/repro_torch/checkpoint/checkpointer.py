"""Checkpoints of a train state, in the reference's on-disk format.

A port of ``src/repro/checkpoint/checkpointer.py``.  Layout:
``<dir>/step_<n>/arrays.npz + manifest.json``, staged in a ``.tmp``
directory and renamed into place, so a crash mid-save never corrupts the
latest step.  Array names are the tree paths (``params/blocks/attn/wq``),
shapes the stacked ``[L, ...]`` ones, so a checkpoint written by either
package restores in the other.

* ``save`` copies every leaf to the host, then writes, on a background
  thread when ``async_save`` so the step loop never blocks on disk.
* ``restore`` rebuilds the target's tree from the arrays, on the device
  the caller names (default: the card), each leaf at its saved dtype.
* ``keep`` bounds the steps on disk.

bfloat16 leaves are written as the reference writes them: their raw two
bytes per value (numpy type ``V2``) with ``bfloat16`` in the manifest;
``restore`` reads them back as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import pytree
from ..bitset import resolve_device


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array as written, manifest dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any) -> None:
        flat = [(name, *_to_host(t))
                for name, t in pytree.leaves_with_paths(state)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: list) -> None:
        tmp = os.path.join(self.directory, f".tmp_step_{step}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{name: arr for name, arr, _ in flat})
        manifest = {
            "step": step,
            "arrays": [{"name": n, "shape": list(a.shape), "dtype": dt}
                       for n, a, dt in flat],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None, *,
                device="cuda") -> tuple[int, Any]:
        """(step, tree): the arrays of ``step`` (default: the latest) in
        the structure of ``target``, on ``device`` (default: the card)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {a["name"]: a["dtype"]
                      for a in json.load(f)["arrays"]}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            paths = [name for name, _ in pytree.leaves_with_paths(target)]
            leaves = [_from_host(data[n], dtypes[n]).to(dev) for n in paths]
        return step, pytree.unflatten(paths, leaves)
