"""Tensor ops of the port: the warps, pooling and resize.

The warps are the ops with hand-written kernels. A CUDA tensor goes to the
kernel (ops/warp_cuda.py, ops/warp_single_cuda.py), which launches or raises;
a CPU tensor goes to the plain PyTorch version (ops/warp.py). Nothing falls
back from one to the other. Both warps are differentiable in every input, on
the card and on the CPU: on the card their ``torch.autograd.Function``s
compute the gradients with their own backward kernels (the multi-flow warp's
one kernel over all n flows, the single-flow warp's two gradient kernels),
on the CPU autograd differentiates the plain versions. Under a row window
(height sharding, ``parallel.halo.RowWindow``) the image's or planes'
gradient covers the rows they hold, and ``parallel.halo`` sends the
gradient of rows that another rank owns back to it.

Under ``parallel.halo.spatial(grid)`` with two or more spatial ranks,
``warp_auto(img, flow)`` without ``rows`` is the sharded warp
(``parallel.warp_spmd.warp_sharded``), as the JAX package's ``warp_auto``
is under ``ops.warp_mesh``; ``warp_multiflow_planar`` is not routed, as
JAX's is not.
"""

from __future__ import annotations

import torch

from superslomo_tpu_torch.ops.pooling import avg_pool_2x2, max_pool_2x2  # noqa: F401
from superslomo_tpu_torch.ops.resize import upsample_2x_bilinear  # noqa: F401
from superslomo_tpu_torch.ops.warp import (  # noqa: F401
    warp_multiflow_backward_reference, warp_multiflow_planar_reference, warp_single_reference)
from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda, warp_multiflow_planar_cuda
from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda, warp_single_cuda
from superslomo_tpu_torch.parallel import halo


def warp_multiflow_planar(planes, u, v, out_dtype=None, rows=None):
    """Planar multi-flow warp: (B, C, H, W) f32 or bf16 image planes x
    (B, n, H, W) f32 u/v → (B, C, n, H, W), stored in the planes' dtype (the
    only pairs the step uses: bf16 stage-2 input warps, f32 final warps).
    ``out_dtype``, when given, must be that dtype. Accumulation is f32; bf16
    planes give the f32 warp of the same planes upcast, cast afterwards, bit
    for bit. Differentiable in the planes, u and v.

    ``rows``, a row window (``parallel.halo.RowWindow``), warps a block of
    rows of a taller frame against planes that hold other rows of it (height
    sharding); the planes' gradient then covers the planes' rows."""
    if out_dtype is not None and out_dtype != planes.dtype:
        raise ValueError(f"the warp stores the planes' dtype {planes.dtype}, not {out_dtype}")
    u, v = u.to(torch.float32), v.to(torch.float32)
    if planes.device.type == "cuda":
        return _WarpMultiflow.apply(planes, u, v, rows)  # any strides: views are read in place
    if planes.device.type == "cpu":
        return warp_multiflow_planar_reference(planes, u, v, planes.dtype, rows=rows)
    raise ValueError(f"no warp for device {planes.device}")


class _WarpMultiflow(torch.autograd.Function):
    """The multi-flow warp on the card, under a row window or not: the
    multi-flow kernel forward, and one call of the backward kernel for
    whichever gradients autograd asks for. As in the JAX package's VJP
    (``_mfu_p_bwd``), bf16 planes are differentiated as the f32 warp of the
    planes upcast, for the output gradient upcast: the kernel reads both as
    bf16, sums in f32 and rounds the planes' gradient once. ``launches``
    counts the device operations its backward launches: 3 with the planes'
    gradient, else 1, whatever n."""

    launches = 0  # device operations of the backward since the last reset

    @staticmethod
    def forward(ctx, planes, u, v, rows=None):
        ctx.save_for_backward(planes, u, v)
        ctx.rows = rows
        return warp_multiflow_planar_cuda(planes, u, v) if rows is None else warp_multiflow_planar_cuda(
            planes, u, v, rows=rows)

    @staticmethod
    def backward(ctx, grad_out):
        planes, u, v = ctx.saved_tensors
        need_planes, need_u, need_v = ctx.needs_input_grad[:3]
        before = warp_multiflow_backward_cuda.operations
        args = (planes, u, v, grad_out, need_planes, need_u or need_v)
        grads = warp_multiflow_backward_cuda(*args) if ctx.rows is None else warp_multiflow_backward_cuda(
            *args, rows=ctx.rows)
        _WarpMultiflow.launches += warp_multiflow_backward_cuda.operations - before
        grad_planes, grad_u, grad_v = grads
        return grad_planes, grad_u if need_u else None, grad_v if need_v else None, None


class _WarpSingle(torch.autograd.Function):
    """The single-flow warp on the card, under a row window or not: the
    forward kernel, and the backward kernels for whichever of the two
    gradients autograd asks for."""

    @staticmethod
    def forward(ctx, img, flow, rows=None):
        ctx.save_for_backward(img, flow)
        ctx.rows = rows
        return warp_single_cuda(img, flow) if rows is None else warp_single_cuda(img, flow, rows=rows)

    @staticmethod
    def backward(ctx, grad_out):
        img, flow = ctx.saved_tensors
        need_img, need_flow = ctx.needs_input_grad[:2]
        if ctx.rows is None:
            return (*warp_single_backward_cuda(img, flow, grad_out, need_img, need_flow), None)
        return (*warp_single_backward_cuda(img, flow, grad_out, need_img, need_flow, rows=ctx.rows), None)


def warp_auto(img, flow, rows=None):
    """Single-flow backward warp, NCHW: (B, C, H, W) f32 or bf16 image x
    (B, 2, H, W) flow (u, v) → (B, C, H, W) in the image dtype, with f32
    position math and accumulation. Differentiable in both arguments. Strided
    views (channels_last slices) are read in place on the card.

    ``rows``, a row window (``parallel.halo.RowWindow``), warps a block of
    rows of a taller frame (the flow's, (B, 2, h, W)) against an image that
    holds other rows of it, positions in frame rows: one process's rows of
    the warp and of its flow gradient, and the image's gradient over the
    image's rows. Without ``rows`` under ``parallel.halo.spatial`` (2 or more
    spatial ranks), the image and the flow are this rank's rows of the frame
    and the warp is ``parallel.warp_spmd.warp_sharded``, guarded."""
    if rows is None and halo.active() is not None:
        from superslomo_tpu_torch.parallel import warp_spmd  # it calls back into this module

        return warp_spmd.warp_sharded(img, flow)
    flow = flow.to(torch.float32)
    if img.device.type == "cuda":
        return _WarpSingle.apply(img, flow) if rows is None else _WarpSingle.apply(img, flow, rows)
    if img.device.type == "cpu":
        return warp_single_reference(img, flow, rows=rows)
    raise ValueError(f"no warp for device {img.device}")
