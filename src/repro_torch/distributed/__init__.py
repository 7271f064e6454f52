"""repro_torch.distributed — halo-exchange execution of grids partitioned
over a mesh of shards (the reference's ``repro.distributed.halo``).

  halo.py       GridMesh / grid_mesh and ShardedStencilEngine.
  transport.py  the edge exchange: LocalTransport (every shard in this
                process, on one device) and ProcessGroupTransport (one
                shard per rank of a torch.distributed process group).
"""
from repro_torch.distributed.halo import (GridMesh, ShardedStencilEngine,
                                          grid_mesh)
from repro_torch.distributed.transport import (LocalTransport,
                                               ProcessGroupTransport,
                                               Transport, default_transport)

__all__ = ["GridMesh", "LocalTransport", "ProcessGroupTransport",
           "ShardedStencilEngine", "Transport", "default_transport",
           "grid_mesh"]
