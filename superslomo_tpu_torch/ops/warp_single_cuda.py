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

from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "warp_single.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_int64)
    lib.warp_single_forward.argtypes = [p, p, p, i, i, i, i, i, strides, p]
    lib.warp_single_forward.restype = i
    lib.warp_single_backward.argtypes = [p, p, p, p, p, i, i, i, i, i, strides, p]
    lib.warp_single_backward.restype = i


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    return cuda_build.load_library(SOURCE, _declare)


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in (t.stride() if t is not None else (0, 0, 0, 0))]
    return (ctypes.c_int64 * len(flat))(*flat)


def _like(t: torch.Tensor, channels: int, dtype: torch.dtype, zero: bool = False) -> torch.Tensor:
    """A dense (B, channels, H, W) tensor in ``t``'s memory format:
    channels_last when ``t``'s channel stride is its smallest."""
    B, _, H, W = t.shape
    fmt = torch.channels_last if t.stride(1) < t.stride(3) else torch.contiguous_format
    out = torch.empty((B, channels, H, W), device=t.device, dtype=dtype, memory_format=fmt)
    return out.zero_() if zero else out


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
    lib = load_library()
    with torch.cuda.device(img.device):
        err = lib.warp_single_forward(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), int(img.dtype == torch.bfloat16),
            B, C, H, W, _strides(img, flow, out), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_single_forward launch failed: CUDA error {err}")
    warp_single_cuda.launches += 1
    return out


def warp_single_backward_cuda(img, flow, grad_out, need_img: bool, need_flow: bool):
    """Launch the backward kernel once: ``(grad_img, grad_flow)`` of the warp
    for the output gradient ``grad_out`` (the image's shape and dtype), each
    None unless asked for. The flow gradient is (B, 2, H, W) f32 in the flow's
    memory format; the image gradient is summed in f32 with atomics and
    returned in the image's dtype and memory format."""
    _check(img, flow, grad_out)
    if not (need_img or need_flow):
        return None, None
    B, C, H, W = img.shape
    grad_flow = _like(flow, 2, torch.float32) if need_flow else None
    grad_img = _like(img, C, torch.float32, zero=True) if need_img else None
    if img.numel() == 0:
        return (None if grad_img is None else grad_img.to(img.dtype)), grad_flow
    lib = load_library()
    with torch.cuda.device(img.device):
        err = lib.warp_single_backward(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(),
            None if grad_flow is None else grad_flow.data_ptr(),
            None if grad_img is None else grad_img.data_ptr(),
            int(img.dtype == torch.bfloat16), B, C, H, W,
            _strides(img, flow, grad_out, grad_flow, grad_img), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_single_backward launch failed: CUDA error {err}")
    warp_single_backward_cuda.launches += 1
    warp_single_backward_cuda.flow_grad_launches += int(need_flow)
    warp_single_backward_cuda.img_grad_launches += int(need_img)
    if grad_img is not None:
        grad_img = grad_img.to(img.dtype)
    return grad_img, grad_flow


# launch counts since the last reset
warp_single_cuda.launches = 0
warp_single_backward_cuda.launches = 0  # backward kernel launches, whatever they computed
warp_single_backward_cuda.flow_grad_launches = 0  # of those, launches that computed the flow gradient
warp_single_backward_cuda.img_grad_launches = 0  # and launches that computed the image gradient
