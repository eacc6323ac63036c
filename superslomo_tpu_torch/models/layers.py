"""Primitive network blocks, NCHW.

The conv block is Conv2d with bias + LeakyReLU(0.1), as a two-entry
``nn.Sequential`` so its weights are named ``<block>.0.weight`` /
``<block>.0.bias`` as in the reference state dict. The head is a plain 3x3
conv with bias and no activation.
"""

from __future__ import annotations

import torch.nn as nn


def conv_lrelu(in_channels: int, out_channels: int, kernel: int) -> nn.Sequential:
    """Same-padding ``kernel``x``kernel`` conv with bias + LeakyReLU(0.1)."""
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=True),
        nn.LeakyReLU(0.1, inplace=True),
    )


def final_conv(in_channels: int, out_channels: int) -> nn.Conv2d:
    """Linear 3x3 head with bias."""
    return nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=True)
