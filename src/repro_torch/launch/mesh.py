"""Production mesh builders: H100 fleets as ``torch.distributed``
DeviceMeshes.

The reference lays its fleets out as TPU v5e pods (``repro/launch/mesh.py``:
(16, 16) and (2, 16, 16)).  The same fleet sizes laid out for H100 nodes of
eight cards joined by NVLink:

  single-pod  (32, 8)       axes (data, model)        = 256 cards, 32 nodes
  multi-pod   (2, 32, 8)    axes (pod, data, model)   = 512 cards, 64 nodes

'model' runs inside a node (NVLink); 'data' and 'pod' cross nodes
(InfiniBand).  A production mesh lives on a ``"fake"`` process group
(``torch.testing``'s ``FakeStore``): this process plays rank 0, collectives
complete without moving data, and no second card is touched.  It is the
process's default group, so one process holds one fleet at a time;
:func:`release` destroys it.  This module tears down only a group it made
itself: a fleet asked for under a process group of the caller's raises.

Functions, not module constants: importing this module starts nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch.distributed as dist

from repro_torch.device import Device, resolve_device


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the single- or multi-pod fleet."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def _device_type(device: Device) -> str:
    """The mesh's device type: ``"cpu"`` or ``"cuda"`` (``None``: the card,
    raising without one)."""
    return resolve_device(device).type


#: the meshes built on the present default group, by (type, shape, axes):
#: DTensor caches its redistribution plans by mesh layout, group names
#: included, so a layout is built once per group
_MESHES: Dict[tuple, Any] = {}
#: whether the present default group is one this module made
_OWNED = False


def fake_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Device = None):
    """A DeviceMesh of ``shape`` over a ``"fake"`` default process group of
    ``prod(shape)`` ranks, this process rank 0.  A default group this
    module made for another fleet is destroyed first; one the caller made
    is left alone, and then this raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    key = (_device_type(device), tuple(shape), tuple(axes))
    world = math.prod(shape)
    global _OWNED
    if dist.is_initialized() and not _OWNED:
        raise RuntimeError(
            "a process group made outside launch.mesh is active: run the "
            "dry-run in a process of its own")
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        release()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        _OWNED = True
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(key[0], key[1], mesh_dim_names=key[2])
    return _MESHES[key]


def make_production_mesh(multi_pod: bool = False, device: Device = None):
    """The single- or multi-pod H100 fleet, as :func:`fake_mesh`."""
    return fake_mesh(*production_shape(multi_pod), device=device)


def make_host_mesh(device: Device = None):
    """``("data",)`` over the cards this process really has: the ranks of
    the process group it was started in (one card each), or this one card
    alone when it was started without one."""
    global _OWNED
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWNED = True
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def release() -> None:
    """Destroy the default process group (and every group of its meshes)
    if this module made it; a group of the caller's stays."""
    global _OWNED
    _MESHES.clear()
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False
