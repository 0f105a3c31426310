"""Checkpoints with an atomic commit and an asynchronous writer (port of
`repro.ckpt.checkpoint`, same layout).

Layout:  <dir>/step_<n>.tmp/ -> (atomic rename) -> <dir>/step_<n>/
           manifest.json     leaf paths, shapes, dtypes, step
           arr_<i>.npy       one file per leaf, copied to the host

* the rename means a crash mid-save never corrupts the latest checkpoint;
* restore takes a TARGET tree (``like``) and puts each leaf on that leaf's
  device in its dtype, whatever device saved it;
* the manager copies the tree to the host synchronously and hands the
  copies to a writer thread, so the device keeps stepping while it writes;
* ``keep`` bounds disk use: the newest ``keep`` checkpoints survive.

bf16 has no numpy dtype: such a leaf is stored as its uint16 bit pattern
and the manifest names "bfloat16".
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of one leaf."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, state, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    paths = tree_paths(state)
    host = [_to_host(leaf) for _, leaf in paths]
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": int(step),
        "leaves": [
            {"path": p, "file": f"arr_{i}.npy", "shape": list(a.shape),
             "dtype": dt}
            for i, ((p, _), (a, dt)) in enumerate(zip(paths, host))
        ],
    }
    for i, (a, _) in enumerate(host):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(directory, keep)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def _gc(directory: str, keep: int):
    for s in _steps(directory)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, like, shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    in the dtype of the matching leaf of ``like``, on its device, or with
    ``shardings`` (a matching tree of `sharding.NamedSharding`s, the
    current mesh's: the elastic path) placed as `sharding.place` places
    it."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = tree_paths(like)
    if [p for p, _ in want] != [m["path"] for m in manifest["leaves"]]:
        raise ValueError(f"checkpoint {path} has {len(manifest['leaves'])} "
                         f"leaves that do not match the target's {len(want)}")
    out = []
    for (p, lk), meta in zip(want, manifest["leaves"]):
        a = np.load(os.path.join(path, meta["file"]))
        if tuple(a.shape) != tuple(lk.shape):
            raise ValueError(f"{p}: checkpoint shape {a.shape} != target "
                             f"{tuple(lk.shape)}")
        t = torch.from_numpy(a)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        out.append(t.to(device=lk.device, dtype=lk.dtype))
    tree = tree_unflatten(like, out)
    if shardings is not None:
        from repro_torch.sharding import place

        tree = place(tree, shardings)
    return tree


@dataclass
class CheckpointManager:
    """Periodic, asynchronous checkpointing for the trainer loop."""

    directory: str
    interval: int = 100
    keep: int = 3
    async_save: bool = True
    _thread: threading.Thread | None = field(default=None, repr=False)
    _error: BaseException | None = field(default=None, repr=False)
    last_saved: int = -1

    def maybe_save(self, step: int, state, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()
        # copy to the host now: the writer owns the copies, whatever later
        # steps do to the state's tensors
        host = tree_unflatten(state, [t.detach().cpu().clone()
                                      for _, t in tree_paths(state)])
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host, self.keep)
        self.last_saved = step
        return True

    def _write(self, step, host):
        try:
            save_checkpoint(self.directory, step, host, self.keep)
        except BaseException as e:  # reported by wait() on the caller's thread
            self._error = e

    def wait(self):
        """Join the writer; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like, shardings=None):
        """(state restored into ``like``, placed by ``shardings`` when given,
        its step), or (None, None) when the directory holds no
        checkpoint."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_checkpoint(self.directory, step, like, shardings), step
