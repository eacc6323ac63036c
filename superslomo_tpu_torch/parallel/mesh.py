"""A (data, spatial) grid of ranks: the counterpart of the JAX package's
``parallel/mesh.py`` mesh, with ``torch.distributed`` groups in place of
mesh axes.

``make_grid(n_data, n_spatial)`` lays the ranks of the process group that
``parallel.init_data_parallel`` joined out as ``n_data`` rows of
``n_spatial``: rank r sits at data index r // n_spatial and spatial index
r % n_spatial. The ranks of one data row share each sample's frames, each
holding a block of its rows (``row_blocks``); the ranks of one spatial
column hold the same rows of different samples. Every rank creates every
data group and every spatial group, in the same order (``dist.new_group``
is collective over the whole process group).

Row blocks differ from the JAX package's split. JAX shards H evenly over the
``spatial`` axis (``make_mesh`` with ``batch_sharding``): 736 rows over 2
shards leave 368 a shard, 23 rows at 1/16 scale, so the U-Net's last 2x2
pool straddles the shard boundary and XLA's partitioner moves a row across
by itself. Here each rank holds whole 32-row units (``row_blocks``), so
every 2x2 pool of the U-Net stays on its rank, and the ``H % 32`` check of
``UNet.forward`` holds for each block. The outputs are the same function of
the frames either way.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.distributed as dist

DATA_AXIS = "data"  # the grid's axes, named as the JAX package's mesh axes
SPATIAL_AXIS = "spatial"
ROW_UNIT = 32  # a block's rows are whole units: the U-Net's five 2x2 pools


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in an ``n_data`` x ``n_spatial`` grid and its two
    groups. ``spatial_ranks`` are the global ranks of its data row, top
    block first; ``data_ranks`` those of its spatial column."""

    n_data: int
    n_spatial: int
    rank: int
    data_group: object
    spatial_group: object
    data_ranks: Tuple[int, ...]
    spatial_ranks: Tuple[int, ...]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial


def make_grid(n_data: int, n_spatial: int) -> Grid:
    """The (data, spatial) grid over the joined process group.

    Raises RuntimeError without a process group, ValueError unless
    ``n_data`` and ``n_spatial`` are positive and ``n_data * n_spatial`` is
    the number of ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_grid needs a process group: call parallel.init_data_parallel first")
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"a grid needs n_data, n_spatial >= 1, got {n_data} x {n_spatial}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_spatial != world:
        raise ValueError(f"grid {n_data} x {n_spatial} != {world} ranks")
    data_groups = [tuple(d * n_spatial + s for d in range(n_data)) for s in range(n_spatial)]
    spatial_groups = [tuple(d * n_spatial + s for s in range(n_spatial)) for d in range(n_data)]
    # collective over every rank, in one order everywhere
    made = {ranks: dist.new_group(list(ranks)) for ranks in data_groups + spatial_groups}
    mine_d, mine_s = data_groups[rank % n_spatial], spatial_groups[rank // n_spatial]
    return Grid(n_data, n_spatial, rank, made[mine_d], made[mine_s], mine_d, mine_s)


def row_blocks(H: int, n_spatial: int) -> Tuple[int, ...]:
    """The rows of each spatial rank's block, top first: whole 32-row units,
    as even as they go, the larger blocks first (736 rows: 384 + 352 on 2
    ranks, 192 + 192 + 192 + 160 on 4). Raises unless H is a multiple of 32
    with at least one unit a rank."""
    if H % ROW_UNIT:
        raise ValueError(f"H = {H} is not a multiple of {ROW_UNIT}")
    units = H // ROW_UNIT
    if units < n_spatial:
        raise ValueError(f"H = {H} has {units} {ROW_UNIT}-row units, fewer than {n_spatial} spatial ranks")
    per, extra = divmod(units, n_spatial)
    return tuple(ROW_UNIT * (per + (s < extra)) for s in range(n_spatial))


def block_start(blocks, s: int) -> int:
    """The frame row where spatial rank ``s``'s block starts."""
    return sum(blocks[:s])
