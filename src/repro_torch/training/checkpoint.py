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

A tree whose leaves are DTensors (a state laid out on a mesh) is saved as
the same full arrays: every rank gathers each leaf (``full_tensor()``, a
collective, issued on the calling thread and in one order on every rank),
the rank at the mesh's origin alone writes, and all ranks then meet at a
barrier, so none reads :func:`latest_step` before the commit.  A
checkpoint written on any number of ranks restores on any other.

NumPy has no bfloat16 (and the card's machine has no ``ml_dtypes``), so a
bfloat16 leaf is stored as its bits, ``uint16``, with ``"bfloat16"`` in the
manifest, and restored bit for bit.  :func:`restore` places every leaf on
one target ``device``, or, given ``shardings``, lays each out on its mesh
as a DTensor: the elastic path, where a checkpoint saved under one layout
is restored under another.
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
from repro_torch.distributed.sharding import is_dtensor

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
    """A leaf (tensor, DTensor, array or number) as a host copy that later
    in-place updates of the tensor cannot reach; a bfloat16 tensor's array
    holds its bits as uint16.  A DTensor is gathered whole first (a
    collective: every rank of its mesh must make the same call)."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                             BF16)
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return _HostLeaf(arr, str(arr.dtype))


def _mesh_of(tree: Any):
    """The mesh of ``tree``'s first DTensor leaf, or None (a plain tree)."""
    for leaf in _flatten(tree).values():
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _writes(mesh) -> bool:
    """Whether this process writes a tree on ``mesh``: the rank at the
    mesh's origin does (with no mesh, whoever saves)."""
    return mesh is None or not any(mesh.get_coordinate())


def _join_gathers(tree: Any) -> None:
    """A rank that does not write: its part in gathering every DTensor
    leaf of ``tree``, in the writer's order."""
    for leaf in _flatten(tree).values():
        if is_dtensor(leaf):
            leaf.full_tensor()


def _barrier(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; returns the commit
    path.  ``tree``'s leaves are tensors, DTensors, arrays or numbers; a
    tree of DTensors is saved by every rank of their mesh together (see the
    module's doc)."""
    mesh = _mesh_of(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writes(mesh):
        _write(ckpt_dir, step, tree, extra, keep)
    else:
        _join_gathers(tree)
    _barrier(mesh)
    return final


def _write(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict],
           keep: int) -> None:
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
            device: Device = None, shardings: Optional[Any] = None
            ) -> Tuple[Any, Dict]:
    """Load a checkpoint (the newest when ``step`` is None) into
    ``skeleton``'s structure, every leaf a tensor on ``device`` (``None``:
    the card).  ``shardings``: a tree of the skeleton's structure whose
    leaves are ``distributed.sharding.NamedSharding`` s — each leaf is then
    a DTensor laid out so on its mesh (on the mesh's device type), this
    rank keeping its own shard of the full array every rank reads.
    Returns ``(tree, extra)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        meta = json.load(f)
    flat_sh = _flatten(shardings) if shardings is not None else None
    if flat_sh is None:
        device = resolve_device(device)
    flat = {}
    for path in _flatten(skeleton):
        info = meta["leaves"][path]
        arr = np.load(os.path.join(d, info["file"]))
        if flat_sh is None:
            flat[path] = _from_numpy(arr, info["dtype"], device)
            continue
        from repro_torch.distributed.sharding import distribute
        sh = flat_sh[path]
        dev = resolve_device(sh.mesh.device_type)
        flat[path] = distribute(_from_numpy(arr, info["dtype"], dev), sh)
    return _unflatten(flat, skeleton), meta["extra"]


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one in flight at a time).

    A tree of DTensors is gathered on every rank's calling thread; the
    writing rank's thread writes it, and :meth:`wait` (which every
    :meth:`save` calls first) joins the write and then meets the other
    ranks at a barrier."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._mesh = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self._mesh)
        self._mesh = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Copy every leaf to the host now (a blocking copy, which waits for
        the device), then write in a thread: the optimizer updates the
        state in place, and would otherwise overwrite a leaf mid-write."""
        self.wait()
        self._mesh = _mesh_of(tree)
        if not _writes(self._mesh):
            _join_gathers(tree)
            return
        host_tree = _unflatten({path: _to_host(leaf) for path, leaf
                                in _flatten(tree).items()}, tree)
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree, extra,
                               self.keep), daemon=True)
        self._thread.start()
