"""Sample transforms, NHWC numpy: a copy of the JAX package's ``Compose``,
``RandomCrop``, ``RandomMirrorRotate``, ``ResizeCrop``, ``Binarize``,
``Normalize``, ``EvalPad``, ``ToFloatArray`` and ``eval_padding_for``.
Samples stay (N, H, W, C); ``ToFloatArray`` makes them contiguous float32.

The JAX package's ``RandomMirrorRotate``, ``ResizeCrop`` and ``Binarize``
(used by no shipped pipeline) call cv2; here numpy computes what the cv2 5.0
that the reference runs computes, bit for bit on the frames a reader gives
them (float64, three channels), and for ``resize_linear`` and ``Binarize``
on uint8 frames too (``warp_affine`` refuses them):

* ``warp_affine``: ``cv2.warpAffine`` (bilinear, constant-zero border) of
  the matrix of ``rotation_matrix`` (``cv2.getRotationMatrix2D``): the
  inverted matrix stepped in fixed point (10 fractional bits), each source
  position on a grid of 1/32 pixel, the four weights float32 products
  summed in float64;
* ``resize_linear``: ``cv2.resize`` (bilinear): on float64, each source
  position (d + 0.5) * src / dst - 0.5 and each interpolation a fused
  multiply-add (``fma``, emulated exactly), rows first; on uint8, weights in
  1/2048 and the fixed-point rounding of OpenCV's ``VResizeLinear``;
* ``Binarize``: ``cv2.cvtColor(BGR2GRAY)`` on uint8 in OpenCV 5's 15-bit
  fixed point (3735, 19235, 9798, rounded), then ``threshold(1, 255)``.
"""

from __future__ import annotations

import math
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


# --------------------------------------------------------------------------- #
# what cv2 computes, in numpy

_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's split of a float64 into two 26-bit halves


def _two_sum(a, b):
    """(s, e): s = a + b rounded, e its exact error."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_product(a, b):
    """(p, e): p = a * b rounded, e its exact error (Dekker)."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    t = _SPLIT * b
    bh = t - (t - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add rounds it, for finite
    float64 arrays: the exact product and sum of error-free transformations,
    their tail rounded to odd and the whole rounded to nearest (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums", 2008)."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    uh, ul = _two_product(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    odd = (v.view(np.int64) & 1) == 1
    v = np.where((e != 0) & ~odd, np.nextafter(v, np.where(e > 0, np.inf, -np.inf)), v)  # round to odd
    return th + v


def _resize_taps(src: int, dst: int, fixed: bool):
    """cv2.resize's bilinear taps along one axis: the two source indices of
    each output (clamped to the edge) and the weight of the second, float64
    (``fixed``: float32 positions, the weight in 1/2048)."""
    d = np.arange(dst, dtype=np.float64)
    if fixed:
        pos = ((d + 0.5) * (src / dst) - 0.5).astype(np.float32)
        s = np.floor(pos)
        w = np.round((pos - s) * np.float32(2048)).astype(np.int64)
    else:
        pos = fma(d + 0.5, src / dst, -0.5)
        s = np.floor(pos)
        w = pos - s
    s = s.astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (bilinear) of a (H, W, C) float64
    or uint8 image with one or three channels, bit for bit."""
    img = np.asarray(img)
    if img.dtype not in (np.float64, np.uint8):
        raise NotImplementedError(f"resize_linear reads float64 or uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    fixed = img.dtype == np.uint8
    x0, x1, wx = _resize_taps(w, width, fixed)
    y0, y1, wy = _resize_taps(h, height, fixed)
    if not fixed:  # rows first, each a fused multiply-add
        rows = fma(img[:, x1] - img[:, x0], wx[None, :, None], img[:, x0])
        return fma(rows[y1] - rows[y0], wy[:, None, None], rows[y0])
    x = img.astype(np.int64)
    rows = x[:, x0] * (2048 - wx)[None, :, None] + x[:, x1] * wx[None, :, None]  # 11 fractional bits
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = ((((2048 - wy)[:, None, None] * r0) >> 16) + ((wy[:, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def rotation_matrix(cx: float, cy: float, degrees: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D((cx, cy), degrees, 1)``: (2, 3) float64."""
    angle = degrees * (math.pi / 180)
    alpha, beta = math.cos(angle), math.sin(angle)
    cx, cy = float(np.float32(cx)), float(np.float32(cy))  # cv2 takes the centre as a float32 point
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: np.ndarray, m: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height))`` (bilinear, constant-zero
    border) of a (H, W, C) float64 image, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.float64:
        raise NotImplementedError(f"warp_affine reads float64 images, not {img.dtype}")
    h, w = img.shape[:2]
    (m0, m1, m2), (m3, m4, m5) = np.asarray(m, np.float64)
    det = m0 * m4 - m1 * m3  # cv2.invertAffineTransform
    det = 1.0 / det if det != 0 else 0.0
    i0, i1, i3, i4 = m4 * det, m1 * -det, m3 * -det, m0 * det
    i2, i5 = -i0 * m2 - i1 * m5, -i3 * m2 - i4 * m5
    xs, ys = np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64)
    # the source position of each pixel in 1/1024, with a half step of the 1/32 grid, then on that grid
    x = (np.rint((i1 * ys + i2) * 1024).astype(np.int64)[:, None] + 16 + np.rint(i0 * xs * 1024).astype(np.int64)) >> 5
    y = (np.rint((i4 * ys + i5) * 1024).astype(np.int64)[:, None] + 16 + np.rint(i3 * xs * 1024).astype(np.int64)) >> 5
    sx, sy = x >> 5, y >> 5
    tx, ty = (x & 31).astype(np.float32) / np.float32(32), (y & 31).astype(np.float32) / np.float32(32)

    def tap(dy, dx, weight):
        yy, xx = sy + dy, sx + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        px = np.where(inside[..., None], img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0.0)
        return px * weight.astype(np.float32).astype(np.float64)[..., None]

    one = np.float32(1)
    return (tap(0, 0, (one - ty) * (one - tx)) + tap(0, 1, (one - ty) * tx) + tap(1, 0, ty * (one - tx))
            + tap(1, 1, ty * tx))


class RandomMirrorRotate:
    """A 50% horizontal flip, then a rotation by up to ``max_degrees`` about a
    random centre, the same for every frame of the sample (``warp_affine``).
    It takes float64 frames, as the readers give them; other dtypes raise
    NotImplementedError, where the JAX class would pass them to cv2."""

    stochastic = True

    def __init__(self, max_degrees: float = 5.0, rng: np.random.Generator | None = None):
        self.max_degrees = max_degrees
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        if rng.integers(0, 2) == 1:
            frames = frames[:, :, ::-1, :]
        n, h, w, _ = frames.shape
        cx = int(rng.integers(0, w))
        cy = int(rng.integers(0, h))
        theta = float(rng.uniform(-self.max_degrees, self.max_degrees))
        m = rotation_matrix(cx, cy, theta)
        out = np.empty_like(frames)
        for i in range(n):
            out[i] = warp_affine(frames[i], m, w, h)
        return out


class ResizeCrop:
    """Resize by ``resize_ratio`` (at least to the crop), then the same random
    crop across the frames (``resize_linear``)."""

    stochastic = True

    def __init__(self, crop_imh, crop_imw, resize_ratio=0.5, rng: np.random.Generator | None = None):
        self.crop_imh = crop_imh
        self.crop_imw = crop_imw
        self.ratio = resize_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        n, h, w, c = frames.shape
        nh, nw = int(h * self.ratio), int(w * self.ratio)
        if nh < self.crop_imh or nw < self.crop_imw:
            scale = max(self.crop_imh / nh, self.crop_imw / nw)
            nh, nw = max(int(nh * scale), self.crop_imh), max(int(nw * scale), self.crop_imw)
        out = np.empty((n, nh, nw, c), dtype=frames.dtype)
        for i in range(n):
            out[i] = resize_linear(frames[i], nw, nh)
        y = int(rng.integers(0, nh - self.crop_imh + 1))
        x = int(rng.integers(0, nw - self.crop_imw + 1))
        return out[:, y : y + self.crop_imh, x : x + self.crop_imw]


class Binarize:
    """Ground-truth frames to (N, H, W, 1) masks of 0.0 / 1.0: grey (channel
    0 weighted as blue, as cv2's BGR2GRAY weighs it) above 1."""

    def __call__(self, buffers):
        img_buffer, gt_buffer = buffers
        x = gt_buffer.astype(np.uint8).astype(np.int32)
        grey = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
        out = np.zeros(gt_buffer.shape[:3] + (1,))
        out[..., 0] = np.where(grey > 1, 255, 0)
        return [img_buffer, out / 255.0]


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
