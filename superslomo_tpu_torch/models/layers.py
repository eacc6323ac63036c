"""Primitive network blocks, NCHW.

``Conv2d`` computes in its input's dtype, as a flax ``nn.Conv(dtype=...)``
does: its weight and bias are cast to the input's dtype at each call, so a
bf16 input runs a bf16 convolution on float32 master weights (bf16 training),
and on weights already in bf16 (serving) the casts are no-ops.

The conv block is Conv2d with bias + LeakyReLU(0.1), as a two-entry
``nn.Sequential`` so its weights are named ``<block>.0.weight`` /
``<block>.0.bias`` as in the reference state dict. The head is a plain 3x3
conv with bias and no activation.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv_lrelu(in_channels: int, out_channels: int, kernel: int) -> nn.Sequential:
    """Same-padding ``kernel``x``kernel`` conv with bias + LeakyReLU(0.1)."""
    return nn.Sequential(
        Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=True),
        nn.LeakyReLU(0.1, inplace=True),
    )


def final_conv(in_channels: int, out_channels: int) -> Conv2d:
    """Linear 3x3 head with bias."""
    return Conv2d(in_channels, out_channels, 3, padding=1, bias=True)
