"""Average pooling, the encoder's AvgPool2d(2) blocks (plain non-overlapping
2x2 mean), over NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over NCHW. H and W must be even (the model
    only ever sees /32-divisible inputs)."""
    H, W = x.shape[-2:]
    if H % 2 or W % 2:
        raise ValueError(f"avg_pool_2x2 needs even H, W; got {H}x{W}")
    return F.avg_pool2d(x, 2)
