"""Halo transports: how neighbouring shards swap their edges.

The reference exchanges halos with ``jax.lax.ppermute`` inside
``shard_map``.  A transport is the port's counterpart: per partitioned
mesh axis the engine makes two calls of :meth:`Transport.shift`, one that
sends every shard's high edge to its successor (which receives it as its
low halo) and one that sends the low edge to the predecessor.  A shard
with no neighbour on the sending side receives zeros, the zero-flux
physical boundary, as ``ppermute`` fills them.

The engine holds this process's shards stacked in one tensor of shape
``(B, *shard dims, *spatial)``, one shard dim per partitioned mesh axis.
Two transports implement the same interface on that layout:

  LocalTransport         every shard in this process, on one device (the
                         counterpart of the reference's forced host devices:
                         several shards share a card or the CPU).  A shift
                         is one slice copy along the shard dim plus the zero
                         fill of the edge shard's slab.
  ProcessGroupTransport  one shard per rank of a ``torch.distributed``
                         process group (shard dims of extent 1), exchanged
                         point to point with ``dist.batch_isend_irecv``:
                         ``gloo`` on the CPU, NCCL between cards.

Every transport counts its shifts (``calls``) and the bytes that crossed a
shard boundary (``sent_bytes``), so ``repro_torch.vet`` can hold a step to
exactly two shifts per partitioned axis.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Transport", "LocalTransport", "ProcessGroupTransport",
           "default_transport"]


class Transport:
    """Edge exchange between neighbouring shards (see the module doc)."""

    def __init__(self) -> None:
        self.mesh: Any = None
        self.calls = 0
        self.sent_bytes = 0

    def reset(self) -> None:
        """Set the counters to 0."""
        self.calls = 0
        self.sent_bytes = 0

    # -- binding ---------------------------------------------------------------
    def bind(self, mesh: Any) -> Tuple[torch.device, Tuple[Optional[int], ...]]:
        """Attach to ``mesh``; returns this process's device and, per mesh
        axis, the coordinate of the shard it holds (``None``: all of them)."""
        if self.mesh is not None and self.mesh != mesh:
            raise ValueError("a transport serves one mesh; make another "
                             "transport for this one")
        self.mesh = mesh
        return self._bind(mesh)

    def _bind(self, mesh: Any
              ) -> Tuple[torch.device, Tuple[Optional[int], ...]]:
        raise NotImplementedError

    # -- exchange --------------------------------------------------------------
    def shift(self, src: torch.Tensor, dst: torch.Tensor, dim: int,
              axis: int, step: int) -> None:
        """Write into ``dst`` the ``src`` slab of the neighbouring shard.

        ``dim`` is the shard dim of mesh axis ``axis`` in both views.
        ``step=+1``: shard ``i`` receives shard ``i-1``'s slab (zeros at
        ``i = 0``); ``step=-1``: shard ``i+1``'s (zeros at the last).
        """
        raise NotImplementedError

    def gather(self, blocks: torch.Tensor) -> torch.Tensor:
        """Every shard's block, stacked ``(B, *mesh partitioned, *block)``,
        from this process's ``blocks``.  Runs once per call, after the last
        step: it is the assembly of the answer, not part of a step."""
        raise NotImplementedError


class LocalTransport(Transport):
    """Every shard in this process, on one device (see the module doc)."""

    def _bind(self, mesh: Any
              ) -> Tuple[torch.device, Tuple[Optional[int], ...]]:
        devices = set(mesh.devices)
        if len(devices) != 1:
            raise ValueError(
                f"LocalTransport keeps every shard on one device, but the "
                f"mesh spans {sorted(str(d) for d in devices)}: build the "
                f"mesh with one repeated device, or run one process per "
                f"device with ProcessGroupTransport")
        return mesh.devices[0], (None,) * len(mesh.axis_names)

    def shift(self, src: torch.Tensor, dst: torch.Tensor, dim: int,
              axis: int, step: int) -> None:
        self.calls += 1
        n = src.shape[dim]
        if step > 0:
            dst.narrow(dim, 1, n - 1).copy_(src.narrow(dim, 0, n - 1))
            dst.narrow(dim, 0, 1).zero_()
        else:
            dst.narrow(dim, 0, n - 1).copy_(src.narrow(dim, 1, n - 1))
            dst.narrow(dim, n - 1, 1).zero_()
        self.sent_bytes += (src.numel() // n) * (n - 1) * src.element_size()

    def gather(self, blocks: torch.Tensor) -> torch.Tensor:
        return blocks


class ProcessGroupTransport(Transport):
    """One shard per rank of a ``torch.distributed`` process group.

    Rank ``i`` holds the shard at the row-major position ``i`` of the
    mesh and runs on ``mesh.devices[i]``.  Edges travel point to point
    (``dist.batch_isend_irecv``); :meth:`gather` assembles the answer
    with one ``all_gather`` after the last step.  NCCL needs one card per
    rank.
    """

    def __init__(self, group: Any = None) -> None:
        super().__init__()
        self.group = group
        self._coords: Tuple[int, ...] = ()
        self._parts: Tuple[int, ...] = ()

    def _bind(self, mesh: Any
              ) -> Tuple[torch.device, Tuple[Optional[int], ...]]:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupTransport needs an initialized "
                               "torch.distributed process group")
        parts = mesh.parts
        world = dist.get_world_size(self.group)
        if world != math.prod(parts):
            raise ValueError(f"mesh {parts} has {math.prod(parts)} shards "
                             f"but the process group has {world} ranks")
        rank = dist.get_rank(self.group)
        self._parts = parts
        self._coords = tuple(int(c) for c in np.unravel_index(rank, parts))
        return mesh.devices[rank], self._coords

    def _rank_at(self, coords: Tuple[int, ...]) -> int:
        import torch.distributed as dist
        flat = int(np.ravel_multi_index(coords, self._parts))
        return (flat if self.group is None
                else dist.get_global_rank(self.group, flat))

    def shift(self, src: torch.Tensor, dst: torch.Tensor, dim: int,
              axis: int, step: int) -> None:
        import torch.distributed as dist
        self.calls += 1
        c, n = self._coords[axis], self._parts[axis]
        ops: List[Any] = []
        buf = None
        if 0 <= c + step < n:            # my slab goes to c + step
            to = list(self._coords)
            to[axis] = c + step
            payload = src.contiguous()
            ops.append(dist.P2POp(dist.isend, payload, self._rank_at(
                tuple(to)), self.group))
            self.sent_bytes += payload.numel() * payload.element_size()
        if 0 <= c - step < n:            # and c - step's comes to me
            frm = list(self._coords)
            frm[axis] = c - step
            buf = torch.empty(src.shape, dtype=src.dtype, device=src.device)
            ops.append(dist.P2POp(dist.irecv, buf, self._rank_at(
                tuple(frm)), self.group))
        for req in (dist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        if buf is None:
            dst.zero_()
        else:
            dst.copy_(buf)

    def gather(self, blocks: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        world = math.prod(self._parts)
        mine = blocks.contiguous()
        everyone = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(everyone, mine, group=self.group)
        nshard = sum(1 for p in self._parts if p > 1)
        stacked = torch.stack(everyone)              # (W, B, 1.., *block)
        stacked = stacked.reshape((world,) + tuple(mine.shape[:1])
                                  + tuple(mine.shape[1 + nshard:]))
        stacked = stacked.reshape(tuple(p for p in self._parts if p > 1)
                                  + tuple(stacked.shape[1:]))
        return stacked.movedim(nshard, 0)


def default_transport(mesh: Any) -> Transport:
    """The transport ``mesh`` needs: ``LocalTransport`` when every shard
    lies on one device, ``ProcessGroupTransport`` when the shards span
    devices and an initialized process group has one rank per shard;
    raises otherwise."""
    if len(set(mesh.devices)) == 1:
        return LocalTransport()
    import torch.distributed as dist
    shards = len(mesh.devices)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == shards:
        return ProcessGroupTransport()
    raise ValueError(
        f"the mesh spans {len(set(mesh.devices))} devices: run one process "
        f"per shard in a torch.distributed process group of {shards} ranks "
        f"(ProcessGroupTransport), or build the mesh on one repeated device "
        f"(LocalTransport)")
