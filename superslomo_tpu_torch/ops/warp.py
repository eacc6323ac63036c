"""Backward warping (bilinear gather), plain PyTorch.

Semantics of the reference warp (``grid_sample(align_corners=True,
padding_mode='zeros')``): output pixel (y, x) is the bilinear sample of the
image at (y + v, x + u) in pixel coordinates, and taps outside the image
count zero. Position and weight math is f32, the sum is f32, and only the
result is rounded to the output dtype. That is the contract of the CUDA
kernels (ops/warp_cuda.py, ops/warp_single_cuda.py), which this module's plain
versions are held against on the card and which the CPU path runs; on the CPU
their gradients come from PyTorch's autograd of these functions.
"""

from __future__ import annotations

import torch


def warp_multiflow_planar_reference(
    planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor, out_dtype=torch.float32, rows=None
) -> torch.Tensor:
    """(B, C, H, W) planes x (B, n, H, W) u/v → (B, C, n, H, W) ``out_dtype``.

    Sums the four taps in the kernel's order, (((v00·w00) + v01·w01) +
    v10·w10) + v11·w11, in f32.

    ``rows``, a ``(y_base, p_base, p_rows, frame_rows)`` row window
    (``parallel.halo.RowWindow``), warps rows of a taller frame: u, v and the
    output are frame rows [y_base, y_base + h), the planes (B, C, p_rows, W)
    frame rows [p_base, p_base + p_rows); positions are taken in frame rows,
    and a tap outside the frame or outside the planes' rows reads 0."""
    B, C, Hp, W = planes.shape
    H = u.shape[2]
    y_base, p_base, p_rows, frame_rows = (0, 0, Hp, Hp) if rows is None else rows
    if u.shape != v.shape or u.dim() != 4 or u.shape[0] != B or u.shape[3] != W or p_rows != Hp or (
            rows is None and H != Hp):
        raise ValueError(f"bad shapes planes={tuple(planes.shape)} u={tuple(u.shape)} v={tuple(v.shape)} rows={rows}")
    n = u.shape[1]
    dev = planes.device
    f32 = torch.float32
    sx = torch.arange(W, device=dev, dtype=f32) + u.to(f32)
    sy = torch.arange(y_base, y_base + H, device=dev, dtype=f32)[:, None] + v.to(f32)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    # clamp before the int conversion, as the kernel does: every tap of a
    # clamped position lies outside the image and is masked
    x0 = x0f.clamp(-2, W + 1).to(torch.int64)
    y0 = y0f.clamp(-2, frame_rows + 1).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1

    flat = planes.to(f32).reshape(B, C, 1, Hp * W).expand(B, C, n, Hp * W)
    zero = torch.zeros((), device=dev, dtype=f32)

    def tap(iy, ix, w):
        inside = ((iy >= 0) & (iy < frame_rows) & (iy >= p_base) & (iy < p_base + p_rows)
                  & (ix >= 0) & (ix < W))
        idx = ((iy - p_base).clamp(0, Hp - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, n, H * W)
        vals = torch.gather(flat, 3, idx.expand(B, C, n, H * W)).reshape(B, C, n, H, W)
        return vals * torch.where(inside, w, zero)[:, None]

    acc = tap(y0, x0, (1 - wy) * (1 - wx))
    acc = acc + tap(y0, x1, (1 - wy) * wx)
    acc = acc + tap(y1, x0, wy * (1 - wx))
    acc = acc + tap(y1, x1, wy * wx)
    return acc.to(out_dtype)


def warp_multiflow_backward_reference(planes, u, v, grad_out, need_planes: bool, need_flow: bool, rows=None):
    """The plain version of the multi-flow backward kernel, with its arguments:
    the gradients of ``warp_multiflow_planar_reference`` for the output
    gradient ``grad_out`` (B, C, n, H, W), as ``(grad_planes, grad_u,
    grad_v)``, each None unless asked for; grad_planes the planes' shape in
    their dtype, grad_u and grad_v (B, n, H, W) f32. The taps written out:
    floor() carries no gradient and a masked tap contributes nothing; bf16
    planes and grad_out are upcast (exact), the planes' gradient is summed in
    f32 with ``scatter_add_`` and rounded once.

    ``rows``, a row window as for ``warp_multiflow_planar_reference``: u, v
    and grad_out hold the block's H rows, the planes and their gradient the
    planes' p_rows; positions are taken in frame rows, and a tap outside the
    frame or outside the planes' rows contributes nothing."""
    B, C, Hp, W = planes.shape
    n, H = u.shape[1], u.shape[2]
    y_base, p_base, p_rows, frame_rows = (0, 0, Hp, Hp) if rows is None else rows
    if p_rows != Hp or (rows is None and H != Hp):
        raise ValueError(f"bad shapes planes={tuple(planes.shape)} u={tuple(u.shape)} rows={rows}")
    dev, f32 = planes.device, torch.float32
    img, g = planes.to(f32), grad_out.to(f32)
    sx = (torch.arange(W, device=dev, dtype=f32) + u.to(f32)).clamp(-2, W + 1)
    sy = (torch.arange(y_base, y_base + H, device=dev, dtype=f32)[:, None] + v.to(f32)).clamp(-2, frame_rows + 1)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    ax, ay = 1 - wx, 1 - wy
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    zero = torch.zeros((), device=dev, dtype=f32)
    taps = {}  # (dy, dx) → (flat index into the planes, in-image mask), each (B, n, H, W)
    for dy in (0, 1):
        for dx in (0, 1):
            iy, ix = y0 + dy, x0 + dx
            inside = ((iy >= 0) & (iy < frame_rows) & (iy >= p_base) & (iy < p_base + p_rows)
                      & (ix >= 0) & (ix < W))
            taps[dy, dx] = ((iy - p_base).clamp(0, Hp - 1) * W + ix.clamp(0, W - 1), inside)
    grad_planes = grad_u = grad_v = None
    if need_flow:
        flat = img.reshape(B, C, 1, Hp * W).expand(B, C, n, Hp * W)

        def value(dy, dx):  # (B, C, n, H, W): the tap's value, 0 where masked
            idx, inside = taps[dy, dx]
            vals = torch.gather(flat, 3, idx.reshape(B, 1, n, H * W).expand(B, C, n, H * W))
            return torch.where(inside[:, None], vals.reshape(B, C, n, H, W), zero)

        v00, v01, v10, v11 = value(0, 0), value(0, 1), value(1, 0), value(1, 1)
        grad_u = (g * (ay[:, None] * (v01 - v00) + wy[:, None] * (v11 - v10))).sum(1)
        grad_v = (g * (ax[:, None] * (v10 - v00) + wx[:, None] * (v11 - v01))).sum(1)
    if need_planes:
        acc = torch.zeros((B, C, Hp * W), device=dev, dtype=f32)
        for (dy, dx), wt in (((0, 0), ay * ax), ((0, 1), ay * wx), ((1, 0), wy * ax), ((1, 1), wy * wx)):
            idx, inside = taps[dy, dx]
            src = g * torch.where(inside, wt, zero)[:, None]
            acc.scatter_add_(2, idx.reshape(B, 1, n * H * W).expand(B, C, n * H * W), src.reshape(B, C, n * H * W))
        grad_planes = acc.reshape(B, C, Hp, W).to(planes.dtype)
    return grad_planes, grad_u, grad_v


def warp_single_reference(img: torch.Tensor, flow: torch.Tensor, rows=None) -> torch.Tensor:
    """(B, C, H, W) image x (B, 2, H, W) flow (u, v) → (B, C, H, W) in the
    image dtype: the plain version of the single-flow kernel, NCHW.

    ``rows``, a row window (``parallel.halo.RowWindow``), warps frame rows
    [y_base, y_base + h) of the flow (B, 2, h, W) against an image (B, C,
    p_rows, W) of frame rows [p_base, p_base + p_rows), as
    ``warp_multiflow_planar_reference`` does: positions in frame rows, so the
    result and the flow's gradient are one process's rows of them, and
    autograd gives the image's gradient over the image's rows (the plain
    version the windowed image-gradient kernel is held against)."""
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"bad shapes img={tuple(img.shape)} flow={tuple(flow.shape)}")
    out = warp_multiflow_planar_reference(img, flow[:, 0:1], flow[:, 1:2], out_dtype=img.dtype, rows=rows)
    return out[:, :, 0]
