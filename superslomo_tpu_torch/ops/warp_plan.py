"""Launch plans of the tiled warp kernels (csrc/warp_tile.cuh).

A plan says how a kernel reads its flows and writes its output, from the
strides and address alignment of the tensors. Plans are plain functions of
those, so the CPU tests hold them, and they are cached, so a launch pays for
one lookup.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

# a block's output tile (width, height) and the adjacent pixels of a row a
# thread owns: csrc/warp_tile.cuh's Tile
TILE_W, TILE_H, PX = 64, 8, 2
# a launch's dynamic shared memory stays within what every kernel may take
# without an opt-in
SMEM_DEFAULT = 48 * 1024

FLOW_SCALAR, FLOW_PAIR, FLOW_PLANAR_VEC = 0, 1, 2
OUT_SCALAR, OUT_ROWS, OUT_PLANAR_VEC = 0, 1, 2


class Layout(NamedTuple):
    """What a plan needs to know of a (B, C, H, W) tensor."""

    strides: tuple  # element strides (b, c, y, x)
    ptr: int  # address of element (0, 0, 0, 0) mod 16 (all a plan reads of it)
    esize: int  # bytes an element


class Plan(NamedTuple):
    """The 3 ints of the kernels' Plan struct (csrc/warp_tile.cuh)."""

    flow_mode: int
    out_mode: int
    smem: int  # dynamic shared memory bytes of the launch


def layout(t: torch.Tensor) -> Layout:
    return Layout(tuple(t.stride()), t.data_ptr() % 16, t.element_size())


def planar_vec_ok(t: Layout, W: int) -> bool:
    """Whether every thread's PX adjacent values of t (x stride 1) make one
    aligned PX-wide access: PX divides W and every stride, and the base
    address is PX elements aligned."""
    return (t.strides[3] == 1 and W % PX == 0 and t.ptr % (PX * t.esize) == 0
            and all(s % PX == 0 for s in t.strides[:3]))


def flow_mode(flow: Layout, W: int) -> int:
    """One 8-byte load a pixel where (u, v) are adjacent and 8-byte aligned;
    else PX-wide loads of u and of v where they are planar; else scalars."""
    if flow.strides[1] == 1 and flow.ptr % 8 == 0 and all(s % 2 == 0 for s in (flow.strides[0], *flow.strides[2:])):
        return FLOW_PAIR
    return FLOW_PLANAR_VEC if planar_vec_ok(flow, W) else FLOW_SCALAR


@functools.lru_cache(maxsize=256)
def plan_single(flow: Layout, out: Layout, C: int, W: int) -> Plan:
    """The single-flow forward's plan. A dense channels_last output goes out
    through a shared tile of whole rows (where the tile fits SMEM_DEFAULT); a
    planar one in PX-wide stores."""
    tile_bytes = TILE_W * TILE_H * C * out.esize
    if out.strides[1] == 1 and out.strides[3] == C and tile_bytes <= SMEM_DEFAULT:
        return Plan(flow_mode(flow, W), OUT_ROWS, tile_bytes)
    return Plan(flow_mode(flow, W), OUT_PLANAR_VEC if planar_vec_ok(out, W) else OUT_SCALAR, 0)


@functools.lru_cache(maxsize=256)
def plan_multiflow(u: Layout, v: Layout, out: Layout, W: int) -> Plan:
    """The multi-flow warp's plan: u and v (B, n, H, W) each read PX-wide
    where both allow it; the contiguous (B, C, n, H, W) output, as (B, C·n,
    H, W) planes, stored PX-wide where aligned."""
    fmode = FLOW_PLANAR_VEC if planar_vec_ok(u, W) and planar_vec_ok(v, W) else FLOW_SCALAR
    return Plan(fmode, OUT_PLANAR_VEC if planar_vec_ok(out, W) else OUT_SCALAR, 0)


def as_ints(plan: Sequence[int]):
    """The plan as the C array the kernels take."""
    return (ctypes.c_int * len(plan))(*plan)
