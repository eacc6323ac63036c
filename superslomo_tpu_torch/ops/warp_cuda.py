"""The multi-flow warp's CUDA kernel (csrc/warp_multiflow.cu): its ctypes
binding and its launch count. ops/cuda_build.py compiles it with nvcc for
``sm_90a`` at first use; a failed build raises, and nothing falls back to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "warp_multiflow.cu"


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.warp_multiflow_planar
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    return cuda_build.load_library(SOURCE, _declare)


_DTYPES = (torch.float32, torch.bfloat16)


def warp_multiflow_planar_cuda(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, C, H, W) f32/bf16 planes x (B, n, H, W) f32 u/v →
    (B, C, n, H, W) in the planes' dtype, on the current stream.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype, a bad shape or a non-contiguous tensor."""
    for name, t in (("planes", planes), ("u", u), ("v", v)):
        if t.device.type != "cuda" or t.device != planes.device:
            raise ValueError(f"{name} must lie on the planes' CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    lib = load_library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.warp_multiflow_planar(
            planes.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(planes.dtype == torch.bfloat16), B, C, n, H, W, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_multiflow_planar launch failed: CUDA error {err}")
    warp_multiflow_planar_cuda.launches += 1
    return out


warp_multiflow_planar_cuda.launches = 0  # kernel launches since the last reset
