"""VGG-16 up to conv4_3 (+ReLU), the feature extractor of the perceptual loss.

The reference uses frozen torchvision ``vgg16(pretrained=True).features[:23]``:
ten 3x3 convs with ReLU and three 2x2 max pools. The convs keep torchvision's
indices (``features.{0,2,5,7,10,12,14,17,19,21}``), so a torchvision state
dict, or the ``.npz`` of one that the JAX package reads, loads 1:1. The network
is frozen: its parameters never take a gradient; the perceptual loss only
differentiates through it to its input.

No weights ship with the repo and there is no download. Without a weights
file the features come from seeded numpy weights (normal, std sqrt(1/fan_in),
zero bias), which the trainer allows only under ``[TRAIN] ALLOW_RANDOM_VGG``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from superslomo_tpu_torch.ops import max_pool_2x2

# torchvision features index → (in, out) channels; a pool follows the ReLU of
# the convs at indices 2, 7 and 14
_VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
              (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512))
_POOL_AFTER = {2, 7, 14}


class VGG16Features(nn.Module):
    """conv1_1 .. conv4_3 (+ReLU) of VGG-16 over (N, 3, H, W); H, W even
    three times over. Built frozen (``requires_grad=False``)."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict(OrderedDict(
            (str(idx), nn.Conv2d(cin, cout, 3, padding=1)) for idx, cin, cout in _VGG_CONVS
        ))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for idx, conv in self.features.items():
            x = F.relu(conv(x), inplace=True)
            if int(idx) in _POOL_AFTER:
                x = max_pool_2x2(x)
        return x


def vgg_state(weights_path: str | None = None, seed: int = 0) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of ``VGG16Features``: from a ``.npz`` of torchvision's
    ``features.{idx}.weight`` (OIHW) / ``.bias`` when given, else seeded
    numpy weights."""
    sd = OrderedDict()
    if weights_path:
        data = np.load(weights_path)
        for idx, _, _ in _VGG_CONVS:
            for name in ("weight", "bias"):
                sd[f"features.{idx}.{name}"] = torch.from_numpy(np.asarray(data[f"features.{idx}.{name}"], np.float32))
        return sd
    rng = np.random.default_rng(seed)
    for idx, cin, cout in _VGG_CONVS:
        w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(1.0 / (cin * 9))
        sd[f"features.{idx}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.zeros(cout)
    return sd
