"""Sample transforms, NHWC numpy: a copy of the JAX package's ``Compose``,
``RandomCrop``, ``Normalize``, ``EvalPad``, ``ToFloatArray`` and
``eval_padding_for``. Samples stay (N, H, W, C); ``ToFloatArray`` makes them
contiguous float32. ``RandomMirrorRotate``, ``ResizeCrop`` and ``Binarize``
(cv2 warps, resizes and colour conversions, used by no shipped pipeline) are
not ported yet.
"""

from __future__ import annotations

import numbers
from typing import Sequence

import numpy as np


class Compose:
    """Transform pipeline. Stochastic transforms (``stochastic = True``)
    receive the per-item ``rng``, so concurrent loader threads never share a
    generator (NumPy Generators are not thread-safe)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, rng: np.random.Generator | None = None):
        for t in self.transforms:
            x = t(x, rng=rng) if getattr(t, "stochastic", False) else t(x)
        return x


class RandomCrop:
    """The same random crop across all frames of the sample."""

    stochastic = True

    def __init__(self, size, rng: np.random.Generator | None = None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        n, h, w, c = frames.shape
        th, tw = self.size
        if (h, w) == (th, tw):
            return frames
        y = int(rng.integers(0, h - th))
        x = int(rng.integers(0, w - tw))
        return frames[:, y : y + th, x : x + tw, :]


class Normalize:
    """(x / 255 - mean) / std.

    Numerics match the reference bit for bit, because the evaluator's
    unclipped uint8 cast truncates and even a 1-ulp drift can flip a pixel:
    the forward pass normalizes in float64 with float64 mean/std and casts to
    float32 once, at the end; the inverse denormalizes in float32 (float32
    constants; the python-float ``* divisor`` stays float32 under numpy's
    weak scalar promotion).
    """

    def __init__(self, pix_mean, pix_std, divisor: float = 255.0):
        self.mean = np.asarray(pix_mean, dtype=np.float64)
        self.std = np.asarray(pix_std, dtype=np.float64)
        self.mean_f32 = self.mean.astype(np.float32)
        self.std_f32 = self.std.astype(np.float32)
        self.divisor = divisor

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        return (
            (frames.astype(np.float64) / self.divisor - self.mean) / self.std
        ).astype(np.float32)

    def inverse(self, frames: np.ndarray) -> np.ndarray:
        """Denormalize back to 0-255."""
        return (
            frames.astype(np.float32) * self.std_f32 + self.mean_f32
        ) * self.divisor


class EvalPad:
    """Zero-pad (N, H, W, C) frames: a fixed (left, right, top, bottom)
    padding (torch.nn.ZeroPad2d's argument order), or to target (H, W) dims
    split centre-aligned."""

    def __init__(self, padding=None, target_dims=None):
        self.padding = padding
        self.target_dims = target_dims

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        n, h, w, c = frames.shape
        if self.target_dims is not None:
            ho, wo = self.target_dims
            hp, wp = ho - h, wo - w
            top, left = hp // 2, wp // 2
            bottom, right = hp - top, wp - left
        elif self.padding is not None:
            left, right, top, bottom = self.padding
        else:
            return frames
        return np.pad(frames, ((0, 0), (top, bottom), (left, right), (0, 0)), mode="constant")


class ToFloatArray:
    """Frames → contiguous float32, staying NHWC."""

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(frames, dtype=np.float32)


def eval_padding_for(h_in: int, w_in: int) -> tuple[int, int, int, int]:
    """Centre-aligned (left, right, top, bottom) zero padding to the next
    /32-divisible dims."""
    h_ref = int(np.ceil(h_in / 32) * 32)
    w_ref = int(np.ceil(w_in / 32) * 32)
    top = (h_ref - h_in) // 2
    left = (w_ref - w_in) // 2
    return (left, w_ref - w_in - left, top, h_ref - h_in - top)
