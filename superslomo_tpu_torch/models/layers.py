"""Primitive network blocks, NCHW.

``Conv2d`` computes in its input's dtype, as a flax ``nn.Conv(dtype=...)``
does: its weight and bias are cast to the input's dtype at each call, so a
bf16 input runs a bf16 convolution on float32 master weights (bf16 training),
and on weights already in bf16 (serving) the casts are no-ops.

The conv block is Conv2d with bias + LeakyReLU(0.1), as a two-entry
``nn.Sequential`` so its weights are named ``<block>.0.weight`` /
``<block>.0.bias`` as in the reference state dict. The head is a plain 3x3
conv with bias and no activation.

Under a spatial grid (``parallel.halo.spatial``) a conv of kernel k holds a
block of the frame's rows: it first receives k // 2 rows from each
neighbouring rank (zeros past the frame's edges, its own zero padding) and
then convolves with no row padding.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from superslomo_tpu_torch.parallel import halo


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (stride 1, zero
    padding), with halo rows under a spatial grid."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        rows, cols = self.padding
        if rows and halo.active() is not None:
            return F.conv2d(halo.exchange_rows(x, rows, rows, "zeros"), weight, bias, padding=(0, cols))
        return self._conv_forward(x, weight, bias)


def conv_lrelu(in_channels: int, out_channels: int, kernel: int) -> nn.Sequential:
    """Same-padding ``kernel``x``kernel`` conv with bias + LeakyReLU(0.1)."""
    return nn.Sequential(
        Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=True),
        nn.LeakyReLU(0.1, inplace=True),
    )


def final_conv(in_channels: int, out_channels: int) -> Conv2d:
    """Linear 3x3 head with bias."""
    return Conv2d(in_channels, out_channels, 3, padding=1, bias=True)
