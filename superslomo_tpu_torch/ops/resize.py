"""Bilinear 2x upsampling with half-pixel centres (align_corners=False), the
decoder's upsample: output pixel i samples source coordinate (i + 0.5) / 2 -
0.5, clamped at the borders."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of an NCHW tensor (align_corners=False)."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
