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
# the multi-flow backward's output tile (width, height: two rows a thread,
# whole warps along x), the source pixels kept in shared memory on each side
# of it, and the most threads its kernel's blocks have (csrc/warp_multiflow.cu)
MF_GRAD_TILE = (64, 8)
MF_GRAD_MARGIN = 4
MF_GRAD_THREADS = 256

FLOW_SCALAR, FLOW_PAIR, FLOW_PLANAR_VEC = 0, 1, 2
IN_SCALAR, IN_PLANAR_VEC = 0, 1
OUT_SCALAR, OUT_ROWS, OUT_PLANAR_VEC, OUT_PAIR = 0, 1, 2, 3


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


class MfGradPlan(NamedTuple):
    """The 4 ints of the multi-flow backward's MfGradPlan struct
    (csrc/warp_multiflow.cu)."""

    tile_w: int
    tile_h: int
    margin: int
    smem: int  # dynamic shared memory bytes: the window of min(C, 4) channels


class GradPlan(NamedTuple):
    """The 3 ints of the gradient kernels' GradPlan struct (csrc/warp_tile.cuh)."""

    flow_mode: int
    grad_mode: int  # how the output gradient is read (IN_SCALAR for the flow gradient)
    out_mode: int  # how the flow gradient is stored (OUT_SCALAR for the image gradient)


def layout(t: torch.Tensor) -> Layout:
    return Layout(tuple(t.stride()), t.data_ptr() % 16, t.element_size())


def planar_vec_ok(t: Layout, W: int) -> bool:
    """Whether every thread's PX adjacent values of t (x stride 1) make one
    aligned PX-wide access: PX divides W and every stride, and the base
    address is PX elements aligned."""
    return (t.strides[3] == 1 and W % PX == 0 and t.ptr % (PX * t.esize) == 0
            and all(s % PX == 0 for s in t.strides[:3]))


def pair_ok(t: Layout) -> bool:
    """Whether channels 0 and 1 of every pixel of an f32 (B, 2, H, W) t are
    adjacent and 8-byte aligned: one 8-byte access a pixel."""
    return t.strides[1] == 1 and t.ptr % 8 == 0 and all(s % 2 == 0 for s in (t.strides[0], *t.strides[2:]))


def flow_mode(flow: Layout, W: int) -> int:
    """One 8-byte load a pixel where (u, v) are adjacent and 8-byte aligned;
    else PX-wide loads of u and of v where they are planar; else scalars."""
    if pair_ok(flow):
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


def grad_mode(g: Layout, W: int) -> int:
    """A thread's PX adjacent output-gradient values read PX-wide where
    planar and aligned, else by element."""
    return IN_PLANAR_VEC if planar_vec_ok(g, W) else IN_SCALAR


def offsets_fit_int32(strides: tuple, C: int, H: int, W: int) -> bool:
    """Whether every tap offset inside one (C, H, W) image with these element
    strides fits a 32-bit int (the flow-gradient kernel's index math): taps
    lie within [-2, W+2] x [-2, H+2] once positions are clamped."""
    _, sc, sy, sx = (abs(s) for s in strides)
    return (C - 1) * sc + (H + 2) * sy + (W + 2) * sx < 2**31


@functools.lru_cache(maxsize=256)
def plan_flow_grad(flow: Layout, grad_flow: Layout) -> GradPlan:
    """The flow-gradient kernel's plan. Its threads own pixels that are not
    adjacent, so every access is a pixel's: one 8-byte (u, v) load and one
    8-byte (du, dv) store where the pair is adjacent and aligned, else by
    element; the output gradient by element."""
    return GradPlan(FLOW_PAIR if pair_ok(flow) else FLOW_SCALAR, IN_SCALAR,
                    OUT_PAIR if pair_ok(grad_flow) else OUT_SCALAR)


@functools.lru_cache(maxsize=256)
def plan_img_grad(flow: Layout, grad_out: Layout, W: int) -> GradPlan:
    """The image-gradient kernel's plan: how its threads, PX adjacent pixels
    each, read the flow and the output gradient (it scatters into a scratch
    of its own layout)."""
    return GradPlan(flow_mode(flow, W), grad_mode(grad_out, W), OUT_SCALAR)


@functools.lru_cache(maxsize=256)
def plan_multiflow(u: Layout, v: Layout, out: Layout, W: int) -> Plan:
    """The multi-flow warp's plan: u and v (B, n, H, W) each read PX-wide
    where both allow it; the contiguous (B, C, n, H, W) output, as (B, C·n,
    H, W) planes, stored PX-wide where aligned."""
    fmode = FLOW_PLANAR_VEC if planar_vec_ok(u, W) and planar_vec_ok(v, W) else FLOW_SCALAR
    return Plan(fmode, OUT_PLANAR_VEC if planar_vec_ok(out, W) else OUT_SCALAR, 0)


def mf_grad_window(tile, margin) -> int:
    """Pixels of a multi-flow backward block's source window: its tile,
    ``margin`` more on each side and one more column and row."""
    return (tile[0] + 2 * margin + 1) * (tile[1] + 2 * margin + 1)


@functools.lru_cache(maxsize=256)
def plan_multiflow_grad(C: int) -> MfGradPlan:
    """The multi-flow backward's plan for C channels: the tile MF_GRAD_TILE,
    the margin MF_GRAD_MARGIN, and the shared memory of the window for
    min(C, 4) channels (a block sums one group of 4). Raises unless the tile
    is whole warps along x of at most MF_GRAD_THREADS threads and the window
    fits SMEM_DEFAULT."""
    tile_w, tile_h = MF_GRAD_TILE
    if tile_w % 32 or tile_h % 2 or tile_w * tile_h // 2 > MF_GRAD_THREADS:
        raise ValueError(f"a {tile_w}x{tile_h} tile is not whole warps along x of at most {MF_GRAD_THREADS} threads")
    smem = min(C, 4) * mf_grad_window(MF_GRAD_TILE, MF_GRAD_MARGIN) * 4
    if smem > SMEM_DEFAULT:
        raise ValueError(f"a window of {smem} bytes exceeds the {SMEM_DEFAULT} a block takes without an opt-in")
    return MfGradPlan(tile_w, tile_h, MF_GRAD_MARGIN, smem)


def as_ints(plan: Sequence[int]):
    """The plan as the C array the kernels take."""
    return (ctypes.c_int * len(plan))(*plan)
