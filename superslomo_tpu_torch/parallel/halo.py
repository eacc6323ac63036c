"""Height sharding: each frame's rows split across the spatial ranks of a
grid (``parallel/mesh.py``), with halo rows exchanged between neighbouring
ranks before every op that reads across a block's edge. The counterpart of
the JAX package's ``parallel/warp_spmd.py`` and of the conv halos (and
their transposes) that XLA's partitioner inserts there by itself.

Under ``spatial(grid)`` (the counterpart of JAX's ``ops.warp_mesh``) the
layers consult this module:
- every ``layers.Conv2d`` of kernel k receives k // 2 rows from each
  neighbour (zeros at the frame's first and last rows, the conv's own zero
  padding) and convolves with no row padding;
- every ``upsample_2x_bilinear`` receives 1 row from each neighbour (the
  frame's edge row repeated at the frame's edges: the upsample's clamp) and
  drops the 2 output rows at each end;
- the multi-flow warps of the fused step read this rank's rows and
  ``HALO_ROWS`` rows of each neighbour (the halo warp), or, under
  ``full_height_warps()`` (the counterpart of JAX's guarded program), the
  whole height gathered from every rank of the data row.
Pools and pointwise ops stay local: a block is whole 32-row units, so no
2x2 pool straddles two ranks.

The warps read their planes through a row window (``RowWindow``): the
kernel computes each sample position in frame rows, exactly as one process
does, and reads the rows it holds, so within ``halo_reach`` the halo warp
gives one process's result bit for bit, and the full-height warp does for
any flow. The full-height path gathers only the planes: the flows and the
output stay this rank's rows.

``HALO_ROWS`` is the JAX package's 136 (its 128-row kernel band + 8).
Nothing in the port's kernel fixes it (the Hopper kernel has no band); it
keeps the halo path exact for the flows of the JAX package's band at the
same cost in exchanged rows, and a rank's block is at least 160 rows at 720p
on 4 ranks, so the one-hop halo is whole. The fused step returns its flow
bound; a caller that runs the halo warps checks it against ``halo_reach``
and reruns a batch beyond it under ``full_height_warps()``
(``eval/evaluate_interpolation.py``).

The transport is point-to-point (``dist.batch_isend_irecv``) on the grid's
spatial group. Gloo's send and receive take host memory only, so over gloo
(ranks sharing one card, which NCCL refuses) the rows of a CUDA tensor are
staged through host copies; the compute stays on the card. Over NCCL they
go card to card.

Under autograd both transports are differentiable, each backward one
point-to-point round the other way. ``exchange_rows``' backward keeps the
gradient of this rank's own rows and adds to it the halo rows' gradients
that the neighbours send back for the rows this rank sent them (at the
frame's edges a replicated row's gradient is summed into the edge row, a
zero row's dropped). ``gather_rows``' backward (a gather to every rank; a
gather to one rank serves inference only) sends each block of the whole
height's gradient to the rank that owns it, and sums what every rank sends
it into this rank's block. So the convs, the upsamples and the warps
under a grid (the warps' image or planes' gradient covers the halo rows or
the whole height they read: ``ops``, ``parallel/warp_spmd.py``) give one
process's gradients, and the fused step under a grid is differentiable in
its parameters and its frames. The train step's warps read whole frames
gathered from data, which needs no gradient (``models/superslomo.py``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from superslomo_tpu_torch.parallel.mesh import Grid, block_start

HALO_ROWS = 136

_GRID: Optional[Grid] = None
_FULL_HEIGHT = False

# since the last reset_counts(): exchanges made by exchange_rows and the bytes
# this rank sent in them, in the forward and in the backward apart, and the
# calls of gather_rows and of its backward
counts = {"exchanges": 0, "bytes_sent": 0, "backward_exchanges": 0, "backward_bytes_sent": 0, "gathers": 0,
          "backward_gathers": 0}


def reset_counts() -> None:
    counts.update(dict.fromkeys(counts, 0))


@contextlib.contextmanager
def spatial(grid: Grid):
    """Run the layers with each frame's rows split over ``grid``'s spatial
    ranks: tensors hold this rank's block of rows."""
    global _GRID
    prev, _GRID = _GRID, grid
    try:
        yield grid
    finally:
        _GRID = prev


@contextlib.contextmanager
def full_height_warps():
    """Under ``spatial``, warp against the whole height gathered from the
    spatial ranks (exact for any flow) instead of the halo rows."""
    global _FULL_HEIGHT
    prev, _FULL_HEIGHT = _FULL_HEIGHT, True
    try:
        yield
    finally:
        _FULL_HEIGHT = prev


def active() -> Optional[Grid]:
    """The grid in effect when it splits rows (2 or more spatial ranks), else None."""
    return _GRID if _GRID is not None and _GRID.n_spatial > 1 else None


def halo_reach(blocks) -> int:
    """The largest |flow| (px) for which the halo warp over blocks of these
    rows is exact: one-hop halos of min(HALO_ROWS, the smallest block) rows,
    less the bilinear tap one row below."""
    return min(HALO_ROWS, min(blocks)) - 1


def _p2p(sends, recvs, group) -> None:
    """Post every (tensor, global peer) send and receive in one batch and wait
    for them; received rows are copied into the given (possibly strided)
    tensors. Over gloo the wire buffers live in host memory."""
    staged = dist.get_backend(group) == "gloo"

    def wire(t):
        t = t.contiguous()
        return t.cpu() if staged else t

    out = [(wire(t), peer) for t, peer in sends]
    into = [(torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device), t, peer)
            for t, peer in recvs]
    ops = [dist.P2POp(dist.isend, b, peer, group) for b, peer in out]
    ops += [dist.P2POp(dist.irecv, b, peer, group) for b, _, peer in into]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for b, t, _ in into:
        t.copy_(b)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``t`` reduced by ``op`` over ``group`` (every rank without one), in
    place; under gloo a CUDA tensor goes through a host copy."""
    staged = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    wire = t.cpu() if staged else t
    dist.all_reduce(wire, op, group=group)
    if staged:
        t.copy_(wire)
    return t



def _grid(grid):
    grid = grid or active()
    if grid is None:
        raise RuntimeError("no spatial grid in effect: enter halo.spatial(grid) with 2 or more spatial ranks")
    return grid


def _format(x):
    return torch.channels_last if x.dim() == 4 and x.stride(1) == 1 and x.shape[1] > 1 else torch.contiguous_format


def exchange_rows(x: torch.Tensor, top: int, bottom: int, edge: str = "zeros", grid: Optional[Grid] = None):
    """(N, C, h, W) rows of this rank → (N, C, top + h + bottom, W): ``top``
    rows of the rank above, these, and ``bottom`` rows of the rank below, in
    ``x``'s dtype and memory format. At the frame's first and last rows the
    halo is zeros (``edge="zeros"``) or the edge row repeated
    (``"replicate"``). Differentiable: the backward sends the halo rows'
    gradient back to the ranks that own those rows and adds what they send
    back to this rank's rows."""
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"edge must be 'zeros' or 'replicate', got {edge!r}")
    grid = _grid(grid)
    h = x.shape[2]
    if max(top, bottom) > h:
        raise ValueError(f"a one-hop halo of {max(top, bottom)} rows needs blocks of as many rows, got {h}")
    return _ExchangeRows.apply(x, top, bottom, edge, grid)


def _neighbours(grid: Grid):
    """(the rank above, the rank below): global ranks, None past the frame's edges."""
    s, ranks = grid.spatial_index, grid.spatial_ranks
    return (ranks[s - 1] if s > 0 else None), (ranks[s + 1] if s + 1 < grid.n_spatial else None)


def _bytes(sends) -> int:
    return sum(t.numel() * t.element_size() for t, _ in sends)


class _ExchangeRows(torch.autograd.Function):
    """``exchange_rows``: the forward receives the neighbours' rows around
    this rank's; the backward is its transpose, one round the other way."""

    @staticmethod
    def forward(ctx, x, top, bottom, edge, grid):
        N, C, h, W = x.shape
        ctx.top, ctx.bottom, ctx.edge, ctx.grid = top, bottom, edge, grid
        out = torch.empty((N, C, top + h + bottom, W), dtype=x.dtype, device=x.device, memory_format=_format(x))
        out[:, :, top:top + h].copy_(x)
        above, below = _neighbours(grid)
        sends, recvs = [], []
        for rows, dst, neighbour, ours, edge_row in (
                (top, out[:, :, :top], above, x[:, :, :bottom], x[:, :, :1]),
                (bottom, out[:, :, top + h:], below, x[:, :, h - top:], x[:, :, h - 1:])):
            if neighbour is not None:  # the neighbour's rows in, ours out
                if rows:
                    recvs.append((dst, neighbour))
                if ours.shape[2]:
                    sends.append((ours, neighbour))
            elif rows and edge == "zeros":
                dst.zero_()
            elif rows:
                dst.copy_(edge_row.expand_as(dst))
        _p2p(sends, recvs, grid.spatial_group)
        counts["exchanges"] += 1
        counts["bytes_sent"] += _bytes(sends)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        top, bottom, grid = ctx.top, ctx.bottom, ctx.grid
        h = grad_out.shape[2] - top - bottom
        grad = grad_out[:, :, top:top + h].clone(memory_format=_format(grad_out))
        above, below = _neighbours(grid)
        sends, recvs = [], []
        # the rows this rank sent up (its first `bottom`) and down (its last
        # `top`) take the gradient of the neighbours' halos
        for rows, halo_grad, neighbour, mine, edge_row in (
                (top, grad_out[:, :, :top], above, grad[:, :, :bottom], grad[:, :, :1]),
                (bottom, grad_out[:, :, top + h:], below, grad[:, :, h - top:], grad[:, :, h - 1:])):
            if neighbour is not None:
                if rows:
                    sends.append((halo_grad, neighbour))
                if mine.shape[2]:
                    recvs.append((torch.empty(mine.shape, dtype=grad.dtype, device=grad.device), mine, neighbour))
            elif rows and ctx.edge == "replicate":  # the edge row repeated: its rows' gradient summed into it,
                edge_row += halo_grad.sum(dim=2, keepdim=True, dtype=torch.float32)  # rounded once
        _p2p(sends, [(buf, peer) for buf, _, peer in recvs], grid.spatial_group)
        for buf, mine, _ in recvs:
            mine += buf
        counts["backward_exchanges"] += 1
        counts["backward_bytes_sent"] += _bytes(sends)
        return grad, None, None, None, None


def gather_rows(x: torch.Tensor, blocks, dst: Optional[int] = None, grid: Optional[Grid] = None):
    """Put the spatial ranks' blocks of rows (dim 2 of ``x``) together: the
    whole height on spatial rank ``dst`` (None elsewhere), or on every rank
    when ``dst`` is None; in ``x``'s memory format for a 4-D ``x``.

    With ``dst`` None it is differentiable: the backward sends each block of
    the whole height's gradient to the rank that owns it, which sums what
    every rank sends it into its block's gradient, in f32, rounded once.
    With ``dst`` it serves inference only (the Evaluator's predictions), and
    raises where ``x`` needs a gradient under autograd: the ranks other than
    ``dst`` would hold nothing to backpropagate through, and ``dst``'s
    backward would wait for them."""
    grid = _grid(grid)
    s = grid.spatial_index
    if x.shape[2] != blocks[s]:
        raise ValueError(f"this rank holds {x.shape[2]} rows, its block is {blocks[s]}")
    if dst is None:
        return _GatherRows.apply(x, tuple(blocks), grid)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("gather_rows to one rank (dst) has no gradient: gather to every rank (dst=None)")
    return _gather(x, blocks, (dst,), grid)


def _gather(x, blocks, receivers, grid):
    """The forward of ``gather_rows`` to the spatial ranks ``receivers``:
    the whole height on each of them, None elsewhere."""
    s, ranks = grid.spatial_index, grid.spatial_ranks
    sends = [(x, ranks[r]) for r in receivers if r != s]
    out, recvs = None, []
    if s in receivers:
        shape = x.shape[:2] + (sum(blocks),) + x.shape[3:]
        fmt = _format(x) if x.dim() == 4 else torch.contiguous_format
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)
        out.narrow(2, block_start(blocks, s), blocks[s]).copy_(x)
        recvs = [(out.narrow(2, block_start(blocks, r), blocks[r]), ranks[r])
                 for r in range(grid.n_spatial) if r != s]
    _p2p(sends, recvs, grid.spatial_group)
    counts["gathers"] += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` to every spatial rank: the forward puts the blocks
    together; the backward is its transpose, one round the other way."""

    @staticmethod
    def forward(ctx, x, blocks, grid):
        ctx.blocks, ctx.grid, ctx.fmt = blocks, grid, _format(x) if x.dim() == 4 else None
        return _gather(x, blocks, range(grid.n_spatial), grid)

    @staticmethod
    def backward(ctx, grad_out):
        blocks, grid = ctx.blocks, ctx.grid
        s, ranks = grid.spatial_index, grid.spatial_ranks
        others = [r for r in range(grid.n_spatial) if r != s]
        mine = grad_out.shape[:2] + (blocks[s],) + grad_out.shape[3:]
        # this rank's gradient of each other rank's block goes back to it
        sends = [(grad_out.narrow(2, block_start(blocks, r), blocks[r]), ranks[r]) for r in others]
        recvs = [(torch.empty(mine, dtype=grad_out.dtype, device=grad_out.device), ranks[r]) for r in others]
        _p2p(sends, recvs, grid.spatial_group)
        acc = grad_out.narrow(2, block_start(blocks, s), blocks[s]).float()
        for buf, _ in recvs:  # in rank order
            acc += buf.float()
        counts["backward_gathers"] += 1
        grad = acc.to(grad_out.dtype)
        return (grad.contiguous(memory_format=ctx.fmt) if ctx.fmt else grad), None, None


def frame_blocks(rows: int, grid: Optional[Grid] = None):
    """Every spatial rank's block rows, top first, from each rank's ``rows``
    (one small all-reduce over the data row)."""
    grid = _grid(grid)
    t = torch.zeros(grid.n_spatial, dtype=torch.int64)
    t[grid.spatial_index] = rows
    dev = "cuda" if dist.get_backend(grid.spatial_group) == "nccl" else "cpu"
    t = t.to(dev)
    dist.all_reduce(t, group=grid.spatial_group)
    return tuple(int(r) for r in t.tolist())


class RowWindow(NamedTuple):
    """Where a warp's rows lie in the frame: the output's (and the flows')
    first row ``y_base``, the planes' first row ``p_base`` and their number
    ``p_rows``, and the frame's ``frame_rows``. A sample position is taken in
    frame rows; taps outside the frame or outside the planes' rows read 0."""

    y_base: int
    p_base: int
    p_rows: int
    frame_rows: int


def warp_source(pair: torch.Tensor, blocks, grid: Optional[Grid] = None):
    """The planes a warp of this rank's rows reads, as ``(planes,
    RowWindow)``: ``pair`` (N, C, h, W) with ``hv = min(HALO_ROWS, the
    smallest block)`` rows of each neighbour (zeros past the frame's edges),
    one exchange for all its channels; under ``full_height_warps()``, the
    whole height gathered from every spatial rank."""
    grid = _grid(grid)
    y_base, H = block_start(blocks, grid.spatial_index), sum(blocks)
    if _FULL_HEIGHT:
        return gather_rows(pair, blocks, grid=grid), RowWindow(y_base, 0, H, H)
    hv = min(HALO_ROWS, min(blocks))
    planes = exchange_rows(pair, hv, hv, "zeros", grid)
    return planes, RowWindow(y_base, y_base - hv, planes.shape[2], H)
