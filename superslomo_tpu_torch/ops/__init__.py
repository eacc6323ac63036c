"""Tensor ops of the port: the warps, pooling and resize.

``warp_multiflow_planar`` is the one op with a hand-written kernel. A CUDA
tensor goes to the kernel (ops/warp_cuda.py), which launches or raises; a CPU
tensor goes to the plain PyTorch version (ops/warp.py). Nothing falls back
from one to the other.
"""

from __future__ import annotations

import torch

from superslomo_tpu_torch.ops.pooling import avg_pool_2x2  # noqa: F401
from superslomo_tpu_torch.ops.resize import upsample_2x_bilinear  # noqa: F401
from superslomo_tpu_torch.ops.warp import (  # noqa: F401
    backward_warp,
    warp_multiflow_planar_reference,
)
from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda


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
        return warp_multiflow_planar_cuda(planes.contiguous(), u.contiguous(), v.contiguous())
    if planes.device.type == "cpu":
        return warp_multiflow_planar_reference(planes, u, v, planes.dtype)
    raise ValueError(f"no warp for device {planes.device}")
