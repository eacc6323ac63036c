"""The multi-flow warp's CUDA kernel (csrc/warp_multiflow.cu): its ctypes
binding and its launch count. ops/cuda_build.py compiles it with nvcc for
``sm_90a`` at first use; a failed build raises, and nothing falls back to the
plain version.

The planes, u and v are read through their strides, so the channels_last
slices of the step's 6-channel pairs are read in place, with no copy.
"""

from __future__ import annotations

import ctypes

import torch

from superslomo_tpu_torch.ops import cuda_build, warp_plan

SOURCE = cuda_build.CSRC / "warp_multiflow.cu"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.warp_multiflow_planar
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i), p]
    fn.restype = i


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    return cuda_build.load_library(SOURCE, _declare)


_DTYPES = (torch.float32, torch.bfloat16)


def warp_multiflow_planar_cuda(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, C, H, W) f32/bf16 planes x (B, n, H, W) f32 u/v →
    (B, C, n, H, W) contiguous in the planes' dtype, on the current stream.
    Any strides.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype or a bad shape."""
    for name, t in (("planes", planes), ("u", u), ("v", v)):
        if t.device.type != "cuda" or t.device != planes.device:
            raise ValueError(f"{name} must lie on the planes' CUDA device, got {t.device}")
    if planes.dtype not in _DTYPES:
        raise TypeError(f"planes must be float32 or bfloat16, got {planes.dtype}")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"u, v must be float32, got {u.dtype}/{v.dtype}")
    if planes.dim() != 4:
        raise ValueError(f"planes must be (B, C, H, W), got {tuple(planes.shape)}")
    B, C, H, W = planes.shape
    if u.shape != v.shape or u.dim() != 4 or u.shape[0] != B or u.shape[2:] != (H, W):
        raise ValueError(f"u, v must be (B, n, H, W) = ({B}, n, {H}, {W}), got {tuple(u.shape)}")
    n = u.shape[1]
    out = torch.empty((B, C, n, H, W), device=planes.device, dtype=planes.dtype)
    if out.numel() == 0:
        return out
    # the contiguous (B, C, n, H, W) output as (B, C·n, H, W) planes
    out_layout = warp_plan.Layout((C * n * H * W, H * W, W, 1), out.data_ptr() % 16, out.element_size())
    plan = warp_plan.plan_multiflow(warp_plan.layout(u), warp_plan.layout(v), out_layout, W)
    strides = (ctypes.c_int64 * 12)(*planes.stride(), *u.stride(), *v.stride())
    lib = load_library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.warp_multiflow_planar(
            planes.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(planes.dtype == torch.bfloat16), B, C, n, H, W, strides, warp_plan.as_ints(plan), stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_multiflow_planar launch failed: CUDA error {err}")
    warp_multiflow_planar_cuda.launches += 1
    return out


warp_multiflow_planar_cuda.launches = 0  # kernel launches since the last reset
