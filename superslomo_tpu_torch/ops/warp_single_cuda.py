"""The single-flow warp's CUDA kernels (csrc/warp_single.cu): their ctypes
binding and launch counts. ops/cuda_build.py compiles them with nvcc for
``sm_90a`` at first use; a failed build raises, and nothing falls back to the
plain version.

Both wrappers take any strides: the NCHW ``channels_last`` slices of the
training step (the frames of a pair, the flows of a stage head) are read in
place. They raise on anything the kernels do not take: a tensor off the card,
another dtype or a bad shape.
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
    lib.warp_single_forward.argtypes = [p, p, p, i, i, i, i, i, strides, ctypes.POINTER(i), p]
    lib.warp_single_forward.restype = i
    lib.warp_single_flow_grad.argtypes = [p, p, p, p, i, i, i, i, i, strides, ctypes.POINTER(i), p]
    lib.warp_single_flow_grad.restype = i
    lib.warp_single_img_grad.argtypes = [p, p, p, p, i, i, i, i, i, strides, ctypes.POINTER(i), p]
    lib.warp_single_img_grad.restype = i


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    return cuda_build.load_library(SOURCE, _declare)


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in (t.stride() if t is not None else (0, 0, 0, 0))]
    return (ctypes.c_int64 * len(flat))(*flat)


def _like(t: torch.Tensor, channels: int, dtype: torch.dtype) -> torch.Tensor:
    """A dense (B, channels, H, W) tensor in ``t``'s memory format:
    channels_last when ``t``'s channel stride is its smallest."""
    B, _, H, W = t.shape
    fmt = torch.channels_last if t.stride(1) < t.stride(3) else torch.contiguous_format
    return torch.empty((B, channels, H, W), device=t.device, dtype=dtype, memory_format=fmt)


def _check(img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor | None = None) -> None:
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
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"flow must be (B, 2, H, W) = ({B}, 2, {H}, {W}), got {tuple(flow.shape)}")
    if grad_out is not None and (grad_out.shape != img.shape or grad_out.dtype != img.dtype):
        raise ValueError(
            f"grad_out must be {tuple(img.shape)} {img.dtype}, got {tuple(grad_out.shape)} {grad_out.dtype}")


def warp_single_cuda(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: (B, C, H, W) f32/bf16 image x (B, 2, H, W)
    f32 flow (u, v) → (B, C, H, W) in the image's dtype and memory format, on
    the current stream."""
    _check(img, flow)
    B, C, H, W = img.shape
    out = _like(img, C, img.dtype)
    if out.numel() == 0:
        return out
    plan = warp_plan.plan_single(warp_plan.layout(flow), warp_plan.layout(out), C, W)
    lib = load_library()
    with torch.cuda.device(img.device):
        err = lib.warp_single_forward(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), int(img.dtype == torch.bfloat16),
            B, C, H, W, _strides(img, flow, out), warp_plan.as_ints(plan),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_single_forward launch failed: CUDA error {err}")
    warp_single_cuda.launches += 1
    return out


def warp_single_backward_cuda(img, flow, grad_out, need_img: bool, need_flow: bool):
    """The warp's gradients for the output gradient ``grad_out`` (the image's
    shape and dtype), on the current stream: ``(grad_img, grad_flow)``, each
    None unless asked for. The flow gradient (B, 2, H, W) f32, in the flow's
    memory format, comes from the flow-gradient kernel; the image gradient, in
    the image's dtype and memory format, from the image-gradient kernel, which
    sums in f32 with atomics. Each kernel is launched only when its gradient
    is asked for."""
    _check(img, flow, grad_out)
    B, C, H, W = img.shape
    grad_flow = _like(flow, 2, torch.float32) if need_flow else None
    grad_img = _like(img, C, img.dtype) if need_img else None
    if img.numel() == 0 or not (need_img or need_flow):  # an empty image: nothing to launch
        return grad_img, None if grad_flow is None else grad_flow.zero_()
    lib = load_library()
    bf16 = int(img.dtype == torch.bfloat16)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if need_flow:
            if not warp_plan.offsets_fit_int32(img.stride(), C, H, W):
                raise ValueError(f"an image of strides {img.stride()} is too large for the flow-gradient kernel")
            plan = warp_plan.plan_flow_grad(warp_plan.layout(flow), warp_plan.layout(grad_flow))
            err = lib.warp_single_flow_grad(
                img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), grad_flow.data_ptr(), bf16, B, C, H, W,
                _strides(img, flow, grad_out, grad_flow), warp_plan.as_ints(plan), stream)
            if err != 0:
                raise RuntimeError(f"warp_single_flow_grad launch failed: CUDA error {err}")
            warp_single_backward_cuda.flow_grad_launches += 1
            warp_single_backward_cuda.launches += 1
        if need_img:
            scratch = torch.empty((B, (C + 3) // 4, H, W, 4), device=img.device, dtype=torch.float32)
            plan = warp_plan.plan_img_grad(warp_plan.layout(flow), warp_plan.layout(grad_out), W)
            err = lib.warp_single_img_grad(
                flow.data_ptr(), grad_out.data_ptr(), scratch.data_ptr(), grad_img.data_ptr(), bf16, B, C, H, W,
                _strides(flow, grad_out, grad_img), warp_plan.as_ints(plan), stream)
            if err != 0:
                raise RuntimeError(f"warp_single_img_grad launch failed: CUDA error {err}")
            warp_single_backward_cuda.img_grad_launches += 1
            warp_single_backward_cuda.launches += 1
    return grad_img, grad_flow


# launch counts since the last reset
warp_single_cuda.launches = 0
warp_single_backward_cuda.launches = 0  # kernel launches of both gradient kernels together
warp_single_backward_cuda.flow_grad_launches = 0  # launches of the flow-gradient kernel
warp_single_backward_cuda.img_grad_launches = 0  # launches of the image-gradient kernel
