"""The multi-flow warp's CUDA kernel (csrc/warp_multiflow.cu): its build, its
ctypes binding and its launch count.

The shared library is compiled by ``nvcc`` for ``sm_90a`` at first use, from
the source in this package only, into ``superslomo_tpu_torch/_build/``. Its
file name carries a hash of the source, so an edited source is rebuilt. A
failed build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "warp_multiflow.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc's output (register and spill counts) from this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"warp_multiflow_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{build_log}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    fn = lib.warp_multiflow_planar
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


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
