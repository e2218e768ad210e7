"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``).

The on-disk layout is the reference's, byte for byte where the data is
equal, so a checkpoint written by either framework restores in the
other:

* one ``.npy`` per leaf, named by its ``/``-joined path with ``.`` in
  place of ``/`` (dict keys sorted, lists indexed);
* bf16 leaves stored as their ``uint16`` bits with ``"dtype":
  "bfloat16"`` in the manifest (``.npy`` has no bf16).  The bits are
  reinterpreted through ``torch.int16``; nothing here needs
  ``ml_dtypes``;
* a JSON manifest (``{"step", "extra", "leaves"}``) written LAST, then
  the step directory atomically renamed from ``step_N.tmp`` to
  ``step_N`` -- a crashed save is never mistaken for a complete one;
* keep-last-k garbage collection; ``latest_step()`` sees complete
  checkpoints only;
* optional async mode: the save takes a host snapshot synchronously
  (every leaf copied off the device before ``save`` returns, so the
  next step may update the state in place), then writes it on a worker
  thread; ``wait()`` joins it (the next save does, and the loop does
  before it restores).

Leaves are tensors, numpy arrays or Python ints.  The reference's
TrainState holds ``step`` as a 0-d int32 array and the port's as an
int: an int is written as a 0-d int32 ``.npy``, and ``restore`` hands a
0-d integer leaf back as an int.  ``restore(device=...)`` puts every
tensor on one device, where the reference places shards by
``shardings=``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import typing

import numpy as np
import torch

from repro_torch import resolve_device


def _flatten(tree, prefix=""):
    """Flatten a tree of leaves into {path: leaf} with /-joined keys."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _fix_lists(tree)


def _fix_lists(node):
    if isinstance(node, dict):
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [_fix_lists(node[str(i)]) for i in range(len(keys))]
        return {k: _fix_lists(v) for k, v in node.items()}
    return node


def _host(leaf):
    """(numpy array to write, manifest dtype name) of one leaf; a copy
    off the device for a tensor, bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        # a copy even where the tensor lies on the CPU already
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _leaf(arr: np.ndarray, dtype_name: str, device: torch.device):
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        return int(arr)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False) -> None:
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: typing.Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, extra: dict = None) -> str:
        self.wait()
        # sync snapshot; I/O may be async
        snapshot = {path: _host(leaf)
                    for path, leaf in _flatten(state).items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, snapshot, extra or {}),
                daemon=True)
            self._thread.start()
            return self._final_path(step)
        return self._write(step, snapshot, extra or {})

    def _final_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, snapshot: dict, extra: dict) -> str:
        final = self._final_path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for path, (arr, dtype_name) in snapshot.items():
            fname = path.replace("/", ".") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][path] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": dtype_name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic completeness marker
        self._gc()
        return final

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._final_path(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> typing.List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name,
                                                "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> typing.Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int = None, device="cuda"):
        """Load a checkpoint (the latest without ``step``): (tree,
        manifest), or (None, None) if there is none.  Tensors go to
        ``device``; a 0-d integer leaf (the TrainState's step) comes back
        as an int."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        device = resolve_device(device)
        path = self._final_path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {key: _leaf(np.load(os.path.join(path, info["file"])),
                           info["dtype"], device)
                for key, info in manifest["leaves"].items()}
        return _unflatten(flat), manifest
