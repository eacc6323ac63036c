"""The single-flow warp's CUDA kernels (csrc/warp_single.cu): their ctypes
binding and launch counts. ops/cuda_build.py compiles them with nvcc for
``sm_90a`` at first use; a failed build raises, and nothing falls back to the
plain version.

Both wrappers take any strides: the NCHW ``channels_last`` slices of the
training step (the frames of a pair, the flows of a stage head) are read in
place. They raise on anything the kernels do not take: a tensor off the card,
another dtype or a bad shape.

Both take a row window (``rows``, ``parallel.halo.RowWindow``): the flows,
the output and its gradient are a block of a taller frame's rows, and the
image holds other rows of it (in the train step under a spatial grid, the
whole frame; in ``parallel.warp_spmd.warp_sharded``, the halo rows or the
whole frame). The image gradient then has the image's rows. The windowed
launches count with the rest, and apart in ``windowed`` (the forward),
``windowed_flow_grad_launches`` and ``windowed_img_grad_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from superslomo_tpu_torch.ops import cuda_build, warp_plan

SOURCE = cuda_build.CSRC / "warp_single.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_int64)
    ints = ctypes.POINTER(i)
    lib.warp_single_forward.argtypes = [p, p, p, i, i, i, i, i, strides, ints, ints, p]
    lib.warp_single_forward.restype = i
    lib.warp_single_flow_grad.argtypes = [p, p, p, p, i, i, i, i, i, strides, ints, ints, p]
    lib.warp_single_flow_grad.restype = i
    lib.warp_single_img_grad.argtypes = [p, p, p, p, i, i, i, i, i, strides, ints, ints, p]
    lib.warp_single_img_grad.restype = i


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    return cuda_build.load_library(SOURCE, _declare)


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in (t.stride() if t is not None else (0, 0, 0, 0))]
    return (ctypes.c_int64 * len(flat))(*flat)


def _like(t: torch.Tensor, channels: int, dtype: torch.dtype, rows: int | None = None) -> torch.Tensor:
    """A dense (B, channels, H, W) tensor in ``t``'s memory format:
    channels_last when ``t``'s channel stride is its smallest; ``rows`` rows
    in place of ``t``'s H when given."""
    B, _, H, W = t.shape
    fmt = torch.channels_last if t.stride(1) < t.stride(3) else torch.contiguous_format
    return torch.empty((B, channels, H if rows is None else rows, W), device=t.device, dtype=dtype, memory_format=fmt)


def _window(rows, img: torch.Tensor, h: int):
    """The row window as the kernels' 4 ints (None for the whole frame),
    checked against the image's and the flow's rows."""
    if rows is None:
        return None
    y_base, p_base, p_rows, frame_rows = rows
    if p_rows != img.shape[2] or y_base < 0 or y_base + h > frame_rows:
        raise ValueError(f"an image of {img.shape[2]} rows and flows of {h} under the row window {tuple(rows)}")
    return (ctypes.c_int * 4)(*rows)


def _check(img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor | None = None, rows=None) -> None:
    for name, t in (("img", img), ("flow", flow), ("grad_out", grad_out)):
        if t is not None and (t.device.type != "cuda" or t.device != img.device):
            raise ValueError(f"{name} must lie on the image's CUDA device, got {t.device}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    if flow.dtype != torch.float32:
        raise TypeError(f"flow must be float32, got {flow.dtype}")
    if img.dim() != 4:
        raise ValueError(f"img must be (B, C, H, W), got {tuple(img.shape)}")
    B, C, H, W = img.shape
    if rows is not None:  # the image holds rows.p_rows frame rows, the flow its own
        H = flow.shape[2] if flow.dim() == 4 else -1
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"flow must be (B, 2, H, W) = ({B}, 2, {H}, {W}), got {tuple(flow.shape)}")
    if grad_out is not None and (tuple(grad_out.shape) != (B, C, H, W) or grad_out.dtype != img.dtype):
        raise ValueError(
            f"grad_out must be {(B, C, H, W)} {img.dtype}, got {tuple(grad_out.shape)} {grad_out.dtype}")


def warp_single_cuda(img: torch.Tensor, flow: torch.Tensor, rows=None) -> torch.Tensor:
    """Launch the forward kernel: (B, C, H, W) f32/bf16 image x (B, 2, H, W)
    f32 flow (u, v) → (B, C, H, W) in the image's dtype and memory format, on
    the current stream. ``rows``, a row window ``(y_base, p_base, p_rows,
    frame_rows)``, warps frame rows [y_base, y_base + h) of the flow (B, 2,
    h, W) against an image (B, C, p_rows, W) of frame rows [p_base, p_base +
    p_rows): (B, C, h, W) out, positions in frame rows."""
    _check(img, flow, rows=rows)
    B, C, H, W = flow.shape[0], img.shape[1], flow.shape[2], img.shape[3]
    window = _window(rows, img, H)
    out = _like(img, C, img.dtype, rows=H)
    if out.numel() == 0:
        return out
    plan = warp_plan.plan_single(warp_plan.layout(flow), warp_plan.layout(out), C, W)
    lib = load_library()
    with torch.cuda.device(img.device):
        err = lib.warp_single_forward(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), int(img.dtype == torch.bfloat16),
            B, C, H, W, _strides(img, flow, out), warp_plan.as_ints(plan), window,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_single_forward launch failed: CUDA error {err}")
    warp_single_cuda.launches += 1
    warp_single_cuda.windowed += window is not None
    return out


def warp_single_backward_cuda(img, flow, grad_out, need_img: bool, need_flow: bool, rows=None):
    """The warp's gradients for the output gradient ``grad_out`` (the
    output's shape, the image's dtype), on the current stream: ``(grad_img,
    grad_flow)``, each None unless asked for. The flow gradient (the flow's
    shape, f32, in its memory format) comes from the flow-gradient kernel; the
    image gradient (the image's shape, dtype and memory format) from the
    image-gradient kernel, which sums in f32 with atomics. Each kernel is
    launched only when its gradient is asked for. ``rows``, as for
    ``warp_single_cuda``: both kernels take the window, and the image
    gradient covers the image's p_rows rows."""
    _check(img, flow, grad_out, rows=rows)
    B, C, H, W = flow.shape[0], img.shape[1], flow.shape[2], img.shape[3]
    window = _window(rows, img, H)
    grad_flow = _like(flow, 2, torch.float32) if need_flow else None
    grad_img = _like(img, C, img.dtype) if need_img else None
    if img.numel() == 0 or flow.numel() == 0 or not (need_img or need_flow):  # no taps: nothing to launch
        return tuple(None if t is None else t.zero_() for t in (grad_img, grad_flow))
    lib = load_library()
    bf16 = int(img.dtype == torch.bfloat16)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if need_flow:
            if not warp_plan.offsets_fit_int32(img.stride(), C, img.shape[2], W):
                raise ValueError(f"an image of strides {img.stride()} is too large for the flow-gradient kernel")
            plan = warp_plan.plan_flow_grad(warp_plan.layout(flow), warp_plan.layout(grad_flow))
            err = lib.warp_single_flow_grad(
                img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), grad_flow.data_ptr(), bf16, B, C, H, W,
                _strides(img, flow, grad_out, grad_flow), warp_plan.as_ints(plan), window, stream)
            if err != 0:
                raise RuntimeError(f"warp_single_flow_grad launch failed: CUDA error {err}")
            warp_single_backward_cuda.flow_grad_launches += 1
            warp_single_backward_cuda.windowed_flow_grad_launches += window is not None
            warp_single_backward_cuda.launches += 1
        if need_img:
            scratch = torch.empty((B, (C + 3) // 4, img.shape[2], W, 4), device=img.device, dtype=torch.float32)
            plan = warp_plan.plan_img_grad(warp_plan.layout(flow), warp_plan.layout(grad_out), W)
            err = lib.warp_single_img_grad(
                flow.data_ptr(), grad_out.data_ptr(), scratch.data_ptr(), grad_img.data_ptr(), bf16, B, C, H, W,
                _strides(flow, grad_out, grad_img), warp_plan.as_ints(plan), window, stream)
            if err != 0:
                raise RuntimeError(f"warp_single_img_grad launch failed: CUDA error {err}")
            warp_single_backward_cuda.img_grad_launches += 1
            warp_single_backward_cuda.windowed_img_grad_launches += window is not None
            warp_single_backward_cuda.launches += 1
    return grad_img, grad_flow


# launch counts since the last reset
warp_single_cuda.launches = 0
warp_single_cuda.windowed = 0  # of them, under a row window
warp_single_backward_cuda.launches = 0  # kernel launches of both gradient kernels together
warp_single_backward_cuda.flow_grad_launches = 0  # launches of the flow-gradient kernel
warp_single_backward_cuda.windowed_flow_grad_launches = 0  # of them, under a row window
warp_single_backward_cuda.img_grad_launches = 0  # launches of the image-gradient kernel
warp_single_backward_cuda.windowed_img_grad_launches = 0  # of them, under a row window
