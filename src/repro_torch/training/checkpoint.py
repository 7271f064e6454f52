"""Atomic, resumable checkpointing of tensor trees.

The counterpart of ``repro/training/checkpoint.py``, with its on-disk
layout:

  step_<N>.tmp/            written first
    manifest.json          step, extra, per-leaf file / shape / dtype
    <leaf-path>.npy        one file per tree leaf (nested dicts and lists;
                           list items are ``__<i>`` path parts)
  step_<N>/                ``os.replace`` of the .tmp dir == the commit

A crash mid-write leaves only a .tmp dir, which :func:`latest_step` and
:func:`restore` ignore; retention keeps the newest ``keep`` checkpoints;
:class:`AsyncCheckpointer` writes in a background thread.

NumPy has no bfloat16 (and the card's machine has no ``ml_dtypes``), so a
bfloat16 leaf is stored as its bits, ``uint16``, with ``"bfloat16"`` in the
manifest, and restored bit for bit.  :func:`restore` places every leaf on
one target ``device`` where the reference takes shardings.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.nn import tree_map

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/__{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any], skeleton: Any, prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten(flat, skeleton[k], f"{prefix}/{k}")
                for k in skeleton}
    if isinstance(skeleton, (tuple, list)):
        vals = [_unflatten(flat, v, f"{prefix}/__{i}")
                for i, v in enumerate(skeleton)]
        return type(skeleton)(vals)
    return flat[prefix]


def _leaf_file(path: str) -> str:
    return path.strip("/").replace("/", ".") + ".npy"


@dataclasses.dataclass(frozen=True)
class _HostLeaf:
    """A leaf copied to the host: its array and dtype name."""
    arr: np.ndarray
    dtype: str


def _to_host(leaf) -> _HostLeaf:
    """A leaf (tensor, array or number) as a host copy that later in-place
    updates of the tensor cannot reach; a bfloat16 tensor's array holds its
    bits as uint16."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                             BF16)
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return _HostLeaf(arr, str(arr.dtype))


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; returns the commit
    path.  ``tree``'s leaves are tensors, arrays or numbers."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "extra": extra or {}, "leaves": {}}
    for path, leaf in _flatten(tree).items():
        host = _to_host(leaf)
        fn = _leaf_file(path)
        np.save(os.path.join(tmp, fn), host.arr)
        meta["leaves"][path] = {"file": fn, "shape": list(host.arr.shape),
                                "dtype": host.dtype}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic commit
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, skeleton: Any, step: Optional[int] = None,
            device: Device = None) -> Tuple[Any, Dict]:
    """Load a checkpoint (the newest when ``step`` is None) into
    ``skeleton``'s structure, every leaf a tensor on ``device`` (``None``:
    the card).  Returns ``(tree, extra)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    device = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        meta = json.load(f)
    flat = {}
    for path in _flatten(skeleton):
        info = meta["leaves"][path]
        arr = np.load(os.path.join(d, info["file"]))
        flat[path] = _from_numpy(arr, info["dtype"], device)
    return _unflatten(flat, skeleton), meta["extra"]


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Copy every leaf to the host now (a blocking copy, which waits for
        the device), then write in a thread: the optimizer updates the
        state in place, and would otherwise overwrite a leaf mid-write."""
        self.wait()
        host_tree = tree_map(_to_host, tree)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree, extra,
                               self.keep), daemon=True)
        self._thread.start()
