"""Tensor ops of the port: the warps, pooling and resize.

The warps are the ops with hand-written kernels. A CUDA tensor goes to the
kernel (ops/warp_cuda.py, ops/warp_single_cuda.py), which launches or raises;
a CPU tensor goes to the plain PyTorch version (ops/warp.py). Nothing falls
back from one to the other. Both warps are differentiable on the card: their
``torch.autograd.Function``s compute the gradients with their own backward
kernels (the multi-flow warp's one kernel over all n flows, the single-flow
warp's two gradient kernels).
"""

from __future__ import annotations

import torch

from superslomo_tpu_torch.ops.pooling import avg_pool_2x2, max_pool_2x2  # noqa: F401
from superslomo_tpu_torch.ops.resize import upsample_2x_bilinear  # noqa: F401
from superslomo_tpu_torch.ops.warp import (  # noqa: F401
    warp_multiflow_backward_reference, warp_multiflow_planar_reference, warp_single_reference)
from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda, warp_multiflow_planar_cuda
from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda, warp_single_cuda


def warp_multiflow_planar(planes, u, v, out_dtype=None):
    """Planar multi-flow warp: (B, C, H, W) f32 or bf16 image planes x
    (B, n, H, W) f32 u/v → (B, C, n, H, W), stored in the planes' dtype (the
    only pairs the step uses: bf16 stage-2 input warps, f32 final warps).
    ``out_dtype``, when given, must be that dtype. Accumulation is f32; bf16
    planes give the f32 warp of the same planes upcast, cast afterwards, bit
    for bit."""
    if out_dtype is not None and out_dtype != planes.dtype:
        raise ValueError(f"the warp stores the planes' dtype {planes.dtype}, not {out_dtype}")
    u, v = u.to(torch.float32), v.to(torch.float32)
    if planes.device.type == "cuda":
        return _WarpMultiflow.apply(planes, u, v)  # any strides: views are read in place
    if planes.device.type == "cpu":
        return warp_multiflow_planar_reference(planes, u, v, planes.dtype)
    raise ValueError(f"no warp for device {planes.device}")


class _WarpMultiflow(torch.autograd.Function):
    """The multi-flow warp on the card: the multi-flow kernel forward, and one
    call of the backward kernel for whichever gradients autograd asks for.
    As in the JAX package's VJP (``_mfu_p_bwd``), bf16 planes are
    differentiated as the f32 warp of the planes upcast, for the output
    gradient upcast: the kernel reads both as bf16, sums in f32 and rounds the
    planes' gradient once. ``launches`` counts the device operations its
    backward launches: 3 with the planes' gradient, else 1, whatever n."""

    launches = 0  # device operations of the backward since the last reset

    @staticmethod
    def forward(ctx, planes, u, v):
        ctx.save_for_backward(planes, u, v)
        return warp_multiflow_planar_cuda(planes, u, v)

    @staticmethod
    def backward(ctx, grad_out):
        planes, u, v = ctx.saved_tensors
        need_planes, need_u, need_v = ctx.needs_input_grad
        before = warp_multiflow_backward_cuda.operations
        grads = warp_multiflow_backward_cuda(planes, u, v, grad_out, need_planes, need_u or need_v)
        _WarpMultiflow.launches += warp_multiflow_backward_cuda.operations - before
        grad_planes, grad_u, grad_v = grads
        return grad_planes, grad_u if need_u else None, grad_v if need_v else None


class _WarpSingle(torch.autograd.Function):
    """The single-flow warp on the card: the forward kernel, and the backward
    kernel for whichever of the two gradients autograd asks for."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return warp_single_cuda(img, flow)

    @staticmethod
    def backward(ctx, grad_out):
        img, flow = ctx.saved_tensors
        need_img, need_flow = ctx.needs_input_grad
        return warp_single_backward_cuda(img, flow, grad_out, need_img, need_flow)


def warp_auto(img, flow):
    """Single-flow backward warp, NCHW: (B, C, H, W) f32 or bf16 image x
    (B, 2, H, W) flow (u, v) → (B, C, H, W) in the image dtype, with f32
    position math and accumulation. Differentiable in both arguments. Strided
    views (channels_last slices) are read in place on the card."""
    flow = flow.to(torch.float32)
    if img.device.type == "cuda":
        return _WarpSingle.apply(img, flow)
    if img.device.type == "cpu":
        return warp_single_reference(img, flow)
    raise ValueError(f"no warp for device {img.device}")
