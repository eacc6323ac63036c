"""Scale-out across processes, one a card: data parallelism (the
counterpart of the JAX package's ``parallel/mesh.py`` data axis) and, on a
(data, spatial) grid, height sharding for serving and training (its
``spatial`` axis: ``parallel/mesh.py``, ``parallel/halo.py``, and the sharded
warps of ``parallel/warp_spmd.py``)."""

from superslomo_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier, init_data_parallel, is_main, launched, rank, world,
)
from superslomo_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Grid, make_grid, row_blocks  # noqa: F401
