"""Data parallelism across processes, one a card (the counterpart of the JAX
package's ``parallel/mesh.py`` data axis)."""

from superslomo_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier, init_data_parallel, is_main, launched, rank, world,
)
