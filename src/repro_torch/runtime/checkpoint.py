"""Checksummed, async checkpointing (the reference's
``runtime/checkpoint.py``, numpy-backed, same layout)::

    <dir>/step_<N>/
        manifest.json       # per leaf: path, file, shape, dtype, crc32
        leaf_<i>.npy        # one file per leaf
        COMMIT              # written last: a checkpoint without it is torn

Leaves are ordered and named as ``jax.tree_util`` orders and ``keystr``
names them (dict keys sorted, ``['a']`` for a key, ``[0]`` for a list
item), so a tree of the reference's structure written by either package
is read by the other.  ``latest_step`` returns committed steps only, so a
crash mid-write never restores a torn state.  ``AsyncCheckpointer`` copies
the tree to the host when ``save`` is called (the training step updates
the state in place afterwards) and writes to disk in a worker thread;
``restore`` verifies the CRCs.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map, unflatten_like

Tree = Any


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, also of a CPU
    tensor's memory)."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("checkpoint: bfloat16 leaves have no numpy "
                             "dtype here; keep training state in float32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(dir_: str, step: int, tree: Tree) -> str:
    """Synchronous save; returns the step directory."""
    step_dir = os.path.join(dir_, f"step_{step:08d}")
    tmp = step_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fname = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp, step_dir)
    return step_dir


def latest_step(dir_: str) -> Optional[int]:
    """The newest committed step under ``dir_`` (None when there is none):
    a step directory without its ``COMMIT`` file, or a ``.tmp`` one, is a
    torn write and never restored."""
    if not os.path.isdir(dir_):
        return None
    steps = []
    for name in os.listdir(dir_):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(dir_, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(dir_: str, step: int, like: Tree, verify: bool = True) -> Tree:
    """Restore into the structure of ``like`` (shapes checked; with
    ``verify`` each leaf's CRC too, ``IOError`` on a mismatch): each leaf
    a tensor of the file's dtype on the device of ``like``'s leaf, and
    requiring grad where it does (a non-tensor leaf: on the CPU)."""
    step_dir = os.path.join(dir_, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for path, leaf in leaves_with_paths(like):
        e = by_path[path]
        arr = np.load(os.path.join(step_dir, e["file"]))
        if verify:
            crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if crc != e["crc32"]:
                raise IOError(f"checksum mismatch for {path} "
                              f"in {step_dir}")
        if list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {path}: ckpt "
                             f"{arr.shape} vs expected {np.shape(leaf)}")
        t = torch.from_numpy(arr)
        if torch.is_tensor(leaf):
            t = t.to(leaf.device).requires_grad_(leaf.requires_grad)
        out.append(t)
    return unflatten_like(like, out)


def prune(dir_: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(dir_):
        return
    steps = sorted(s for s in (
        int(n.split("_")[1]) for n in os.listdir(dir_)
        if n.startswith("step_") and not n.endswith(".tmp")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(dir_, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread writer: ``save()`` copies the tree to the host at
    once and enqueues the disk write; ``wait()`` drains; a writer's error
    surfaces on the next call."""

    def __init__(self, dir_: str, keep: int = 3):
        self.dir = dir_
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.dir, step, tree)
                prune(self.dir, self.keep)
            except BaseException as e:     # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Tree) -> None:
        if self._err:
            err, self._err = self._err, None
            raise err
        self._q.put((step, tree_map(_host, tree)))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()


__all__ = ["AsyncCheckpointer", "latest_step", "prune", "restore", "save"]
