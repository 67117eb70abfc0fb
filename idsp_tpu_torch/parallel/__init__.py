"""Scale-out over `torch.distributed` (port of `idsp_tpu.parallel`).

* **Channel parallelism**: independent DSP channels split over the
  ranks -- no communication (`stream.channel_slice`,
  `stream.channel_sharding`).
* **Time/sequence parallelism**: long sample streams split over the
  ranks; per-sample recurrences are recast per stage:
  - FIR/discriminator history -> neighbour halo exchange
    (`halo_exchange_prev`; K41 `halo_rdma.halo_exchange_prev_rdma`)
  - linear IIR (biquad) -> block-local scan + cross-rank affine-prefix
    fixup (`sharded_df1_float`, exact for floats up to reassociation)
  - fixed-point IIR -> carry relayed across ranks (`sharded_df1_q_relay`)
* **Pipeline parallelism**: cascade stages on successive ranks
  (`pipeline`).

Each function is the per-rank body of a `torch.distributed` program
(the counterpart of a `shard_map` body): the mesh axis is a ``group``,
JAX's collectives are `_comm`'s.  One process per rank, launched by
``torchrun`` or `torch.multiprocessing`.
"""

from . import distributed
from .mesh import local_mesh, make_mesh
from .stream import halo_exchange_prev, sharded_df1_float, time_sharded_prev

__all__ = [
    "halo_exchange_prev",
    "local_mesh",
    "make_mesh",
    "sharded_df1_float",
    "time_sharded_prev",
]
