"""Sample transforms the evaluator needs, NHWC numpy (a copy of the JAX
package's ``Normalize`` and ``eval_padding_for``; the readers and the other
transforms are not ported yet)."""

from __future__ import annotations

import numpy as np


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


def eval_padding_for(h_in: int, w_in: int) -> tuple[int, int, int, int]:
    """Centre-aligned (left, right, top, bottom) zero padding to the next
    /32-divisible dims."""
    h_ref = int(np.ceil(h_in / 32) * 32)
    w_ref = int(np.ceil(w_in / 32) * 32)
    top = (h_ref - h_in) // 2
    left = (w_ref - w_in) // 2
    return (left, w_ref - w_in - left, top, h_ref - h_in - top)
