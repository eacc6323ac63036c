"""Bilinear 2x upsampling with half-pixel centres (align_corners=False), the
decoder's upsample: output pixel i samples source coordinate (i + 0.5) / 2 -
0.5, clamped at the borders.

Under a spatial grid (``parallel.halo.spatial``) the input is a block of the
frame's rows: it receives 1 row from each neighbouring rank (the frame's
edge row repeated past its edges) and the 2 output rows at each end are
dropped. Output row i of the extended input samples its row (i + 0.5) / 2 -
0.5, so the block's row i lies at extended output row i + 2 with the same
weights, and at the frame's edges the repeated row gives the clamp's value.
The frame's first output row is one process's bit for bit only from the
first row alone (one process's clamp weighs it by 1 and its neighbour by 0;
the repeated row weighs two equal rows by 0.25 and 0.75), so it is taken so:
written in place over the output's first row, a copy into a view that
autograd follows (the overwritten row's gradient goes to the first row alone,
none to the extended upsample), so under autograd the gradient is one
process's, the exchange's backward (``parallel.halo``) summing the repeated
rows' gradient into the edge rows. (A ``torch.cat`` of the row and the rest
would copy the whole output on the first rank, which the other ranks wait
for at every exchange.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from superslomo_tpu_torch.parallel import halo

# PyTorch's CUDA upsample kernels index their output with 32 bits: a larger
# output (the stage-2 decoder's last upsample at 720p from a batch of 18 up,
# e.g. SuperSloMo-R's fused step) is computed a batch slice at a time
_MAX_ELEMENTS = 2**31 - 1


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of an NCHW tensor (align_corners=False), in the
    memory format ``F.interpolate`` gives a dense input. The output is
    computed a batch slice at a time, each slice within the CUDA kernels'
    32-bit indexing (one slice where the whole output fits): without
    autograd written into one output, under autograd (``out=`` has none)
    one ``F.interpolate`` a slice, joined by ``torch.cat``."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    grid = halo.active()
    if grid is None:
        return _upsample(x)
    out = _upsample(halo.exchange_rows(x, 1, 1, "replicate"))[:, :, 2:-2]  # a view: the next conv copies it
    if grid.spatial_index == 0:  # the frame's first row: one process weighs the edge row by exactly 1
        out[:, :, :1] = _upsample(x[:, :, :1])[:, :, :1]
    return out


def _upsample(x: torch.Tensor) -> torch.Tensor:
    N, C, H, W = x.shape
    step = max(1, _MAX_ELEMENTS // max(1, C * 4 * H * W))  # samples a slice
    if torch.is_grad_enabled() and x.requires_grad:
        if step >= N:
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return torch.cat([F.interpolate(x[i : i + step], scale_factor=2, mode="bilinear", align_corners=False)
                          for i in range(0, N, step)])
    channels_last = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((N, C, 2 * H, 2 * W), dtype=x.dtype, device=x.device, memory_format=fmt)
    for i in range(0, N, step):  # the scales F.interpolate passes for scale_factor=2
        torch.ops.aten.upsample_bilinear2d.out(x[i : i + step], [2 * H, 2 * W], False, 2.0, 2.0,
                                               out=out[i : i + step])
    return out
