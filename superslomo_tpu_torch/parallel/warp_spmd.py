"""The sharded warps: the counterpart of the JAX package's
``parallel/warp_spmd.py`` (``warp_sharded``, ``warp_multiflow_sharded``).

Under a (data, spatial) grid (``parallel/mesh.py``) each rank holds a block
of every frame's rows (``row_blocks``), and a warp of its rows reads rows of
other ranks. Both warps here take this rank's rows of the image (or planes)
and of the flows and return this rank's rows of the warp. Each carries a
globally coherent guard, as JAX's does: this rank's max |flow| (both
components) is reduced with MAX over the spatial group, so every rank of the
group takes the same branch. At or under ``halo.halo_reach(blocks)`` the
warp reads ``halo.warp_source``'s planes (this rank's rows and
``halo.HALO_ROWS`` rows of each neighbour, zeros past the frame); beyond it,
the whole height gathered from the spatial ranks (``halo.gather_rows``,
under ``halo.full_height_warps()``). The kernels take each position in frame
rows, so either branch gives one process's rows of the warp, bit for bit.

The guard costs one host sync a call (the MAX is read on the host to pick
the branch), which JAX's device-side ``lax.cond`` does not. The fused step
(``models/superslomo.py``) calls ``warp_multiflow_sharded`` with
``unguarded=True``: the halo branch with no reduction and no sync, as JAX's
Evaluator fast path does; the step returns its flows' bound, and the
Evaluator reruns a batch beyond ``halo.halo_reach(blocks)`` under
``halo.full_height_warps()``, where both branches read the whole height
(``eval/evaluate_interpolation.py``).

Gradients: both warps are differentiable in the image (planes) and the
flows. The image's gradient of the halo rows or of the whole height goes
back to the ranks that own those rows (the backward of
``halo.exchange_rows`` or of ``halo.gather_rows``), so each rank holds its
own rows' gradient. Within ``halo_reach`` this equals JAX's ``g_bwd`` (its
halo path's gradient). Beyond it the port departs from JAX on purpose:
JAX's backward is still the halo path's, which drops the taps beyond the
halo; the port's is the exact gradient of the path it ran, one process's
gradient, which is JAX's single-device ``backward_warp`` gradient. The
train step under a grid makes the same choice (``models/superslomo.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from superslomo_tpu_torch import ops
from superslomo_tpu_torch.parallel import halo
from superslomo_tpu_torch.parallel.mesh import Grid


def warp_sharded(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the single-flow warp, NCHW, guarded: (b, C, h, W)
    f32 or bf16 image x (b, 2, h, W) flow (u, v) → (b, C, h, W) in the
    image's dtype, under the grid in effect (``halo.spatial``). What
    ``ops.warp_auto`` runs there without ``rows``."""
    grid = _active()
    blocks = halo.frame_blocks(img.shape[2], grid)
    planes, window = _source(img, blocks, grid, (flow,), False)
    return ops.warp_auto(planes, flow, rows=window)


def warp_multiflow_sharded(planes: torch.Tensor, flows, blocks, unguarded: bool = False):
    """This rank's rows of multi-flow warps of one source, in the planar
    shapes of the port's fused step: (b, k·C, h, W) f32 or bf16 planes and
    k flows ``(u, v)``, each (b, n, h, W) f32 → k warps (b, C, n, h, W) in
    the planes' dtype, the i-th of the planes' i-th C channels by the i-th
    flows. One exchange (or gather) of the planes' rows serves all k: the
    fused step warps frame 0 and frame 1 of its 6-channel pair so.
    ``blocks``: every spatial rank's rows (``halo.frame_blocks``). The guard
    reads every |u| and |v|; ``unguarded=True`` skips it (the fused step)."""
    grid = _active()
    c = planes.shape[1] // len(flows)
    if c * len(flows) != planes.shape[1]:
        raise ValueError(f"{planes.shape[1]} channels do not split evenly over {len(flows)} flows")
    source, window = _source(planes, blocks, grid, [f for uv in flows for f in uv], unguarded)
    return tuple(ops.warp_multiflow_planar(source[:, i * c:(i + 1) * c], u, v, rows=window)
                 for i, (u, v) in enumerate(flows))


def _active() -> Grid:
    grid = halo.active()
    if grid is None:
        raise RuntimeError("no spatial grid in effect: enter halo.spatial(grid) with 2 or more spatial ranks")
    return grid


def _source(x, blocks, grid: Grid, flows, unguarded):
    """``halo.warp_source``'s planes of ``x`` and their window: the halo
    rows (or the whole height, under ``halo.full_height_warps()`` in
    effect) when ``unguarded`` or when the max |flow| over ``flows`` and the
    spatial group (one all-reduce, read on the host) is within the reach,
    else the whole height."""
    if unguarded or _flow_bound(grid, flows) <= halo.halo_reach(blocks):
        return halo.warp_source(x, blocks, grid)
    with halo.full_height_warps():
        return halo.warp_source(x, blocks, grid)


def _flow_bound(grid: Grid, flows) -> float:
    local = torch.stack([f.detach().abs().amax().to(torch.float32) for f in flows]).amax().reshape(1)
    return float(halo.all_reduce(local, dist.ReduceOp.MAX, grid.spatial_group))
