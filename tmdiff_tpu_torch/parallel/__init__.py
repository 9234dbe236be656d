"""The ("data", "space") device mesh on torch.distributed: `mesh` (ranks,
placement, collectives), `halo` (the conv halo exchange) and `dryrun` (a
world of processes on one host)."""
from tmdiff_tpu_torch.parallel.mesh import (Mesh, init_distributed, make_mesh, shard_batch,
                                            shard_slices)

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_batch", "shard_slices"]
