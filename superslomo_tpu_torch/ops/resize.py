"""Bilinear 2x upsampling with half-pixel centres (align_corners=False), the
decoder's upsample: output pixel i samples source coordinate (i + 0.5) / 2 -
0.5, clamped at the borders."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# PyTorch's CUDA upsample kernels index their output with 32 bits: a larger
# output (the stage-2 decoder's last upsample at 720p from a batch of 18 up,
# e.g. SuperSloMo-R's fused step) is computed a batch slice at a time
_MAX_ELEMENTS = 2**31 - 1


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of an NCHW tensor (align_corners=False), in the
    memory format ``F.interpolate`` gives a dense input. Without autograd the output is written a batch
    slice at a time, each slice within the CUDA kernels' 32-bit indexing (one
    slice where the whole output fits). ``out=`` has no autograd, so under
    autograd (training) it is one call."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    N, C, H, W = x.shape
    channels_last = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((N, C, 2 * H, 2 * W), dtype=x.dtype, device=x.device, memory_format=fmt)
    step = max(1, _MAX_ELEMENTS // (C * 4 * H * W))
    for i in range(0, N, step):  # the scales F.interpolate passes for scale_factor=2
        torch.ops.aten.upsample_bilinear2d.out(x[i : i + step], [2 * H, 2 * W], False, 2.0, 2.0,
                                               out=out[i : i + step])
    return out
