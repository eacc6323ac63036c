"""Backward warping (bilinear gather), plain PyTorch.

Semantics of the reference warp (``grid_sample(align_corners=True,
padding_mode='zeros')``): output pixel (y, x) is the bilinear sample of the
image at (y + v, x + u) in pixel coordinates, and taps outside the image
count zero. Position and weight math is f32, the sum is f32, and only the
result is rounded to the output dtype. That is the contract of the multi-flow
CUDA kernel (ops/warp_cuda.py), which this module's plain version is held
against on the card and which the CPU path runs.
"""

from __future__ import annotations

import torch


def warp_multiflow_planar_reference(
    planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """(B, C, H, W) planes x (B, n, H, W) u/v → (B, C, n, H, W) ``out_dtype``.

    Sums the four taps in the kernel's order, (((v00·w00) + v01·w01) +
    v10·w10) + v11·w11, in f32."""
    B, C, H, W = planes.shape
    if u.shape != v.shape or u.dim() != 4 or u.shape[0] != B or u.shape[2:] != (H, W):
        raise ValueError(f"bad shapes planes={tuple(planes.shape)} u={tuple(u.shape)} v={tuple(v.shape)}")
    n = u.shape[1]
    dev = planes.device
    f32 = torch.float32
    sx = torch.arange(W, device=dev, dtype=f32) + u.to(f32)
    sy = torch.arange(H, device=dev, dtype=f32)[:, None] + v.to(f32)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    # clamp before the int conversion, as the kernel does: every tap of a
    # clamped position lies outside the image and is masked
    x0 = x0f.clamp(-2, W + 1).to(torch.int64)
    y0 = y0f.clamp(-2, H + 1).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1

    flat = planes.to(f32).reshape(B, C, 1, H * W).expand(B, C, n, H * W)
    zero = torch.zeros((), device=dev, dtype=f32)

    def tap(iy, ix, w):
        inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, n, H * W)
        vals = torch.gather(flat, 3, idx.expand(B, C, n, H * W)).reshape(B, C, n, H, W)
        return vals * torch.where(inside, w, zero)[:, None]

    acc = tap(y0, x0, (1 - wy) * (1 - wx))
    acc = acc + tap(y0, x1, (1 - wy) * wx)
    acc = acc + tap(y1, x0, wy * (1 - wx))
    acc = acc + tap(y1, x1, wy * wx)
    return acc.to(out_dtype)


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp a batch of images by one flow each.

    :param img: (B, H, W, C) source images.
    :param flow: (B, H, W, 2) flow, channel 0 = u (x displacement), channel
        1 = v (y displacement).
    :returns: (B, H, W, C) in the image dtype.
    """
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"bad shapes img={tuple(img.shape)} flow={tuple(flow.shape)}")
    out = warp_multiflow_planar_reference(
        img.permute(0, 3, 1, 2), flow[..., 0:1].permute(0, 3, 1, 2),
        flow[..., 1:2].permute(0, 3, 1, 2), out_dtype=img.dtype,
    )
    return out[:, :, 0].permute(0, 2, 3, 1)
