"""The multi-flow warp's CUDA kernels (csrc/warp_multiflow.cu), the forward
and the backward: their ctypes bindings and launch counts. ops/cuda_build.py
compiles them with nvcc for ``sm_90a`` at first use; a failed build raises,
and nothing falls back to the plain version.

The planes, u, v and the output gradient are read through their strides, so
the channels_last slices of the step's 6-channel pairs are read in place,
with no copy.
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
    fn = lib.warp_multiflow_grad
    fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i), p]
    fn.restype = i


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    return cuda_build.load_library(SOURCE, _declare)


_DTYPES = (torch.float32, torch.bfloat16)


def _check(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor, grad_out: torch.Tensor | None = None) -> None:
    for name, t in (("planes", planes), ("u", u), ("v", v), ("grad_out", grad_out)):
        if t is not None and (t.device.type != "cuda" or t.device != planes.device):
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
    want = (B, C, u.shape[1], H, W)
    if grad_out is not None and (tuple(grad_out.shape) != want or grad_out.dtype != planes.dtype):
        raise ValueError(f"grad_out must be {want} {planes.dtype}, got {tuple(grad_out.shape)} {grad_out.dtype}")


def warp_multiflow_planar_cuda(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, C, H, W) f32/bf16 planes x (B, n, H, W) f32 u/v →
    (B, C, n, H, W) contiguous in the planes' dtype, on the current stream.
    Any strides.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype or a bad shape."""
    _check(planes, u, v)
    B, C, H, W = planes.shape
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


def warp_multiflow_backward_cuda(planes, u, v, grad_out, need_planes: bool, need_flow: bool):
    """The multi-flow warp's gradients for the output gradient ``grad_out``
    (B, C, n, H, W) in the planes' dtype, on the current stream: ``(grad_planes,
    grad_u, grad_v)``, each None unless asked for. grad_planes is (B, C, H, W)
    in the planes' dtype and memory format; grad_u and grad_v (B, n, H, W) f32
    contiguous. Any strides. One call of the backward kernel, which sums the
    planes' gradient over the n flows in f32 (with atomics, so the order of
    the sum varies from run to run) and rounds it once; with the planes'
    gradient, 3 device operations (zero the scratch, the kernel, the store
    pass), else 1, whatever n.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype, a bad shape, or planes too large for 32-bit tap offsets."""
    _check(planes, u, v, grad_out)
    B, C, H, W = planes.shape
    n = u.shape[1]
    dev = planes.device
    grad_planes = None
    if need_planes:
        fmt = torch.channels_last if planes.stride(1) < planes.stride(3) else torch.contiguous_format
        grad_planes = torch.empty((B, C, H, W), device=dev, dtype=planes.dtype, memory_format=fmt)
    grad_u = torch.empty((B, n, H, W), device=dev, dtype=torch.float32) if need_flow else None
    grad_v = torch.empty_like(grad_u) if need_flow else None
    if planes.numel() == 0 or n == 0 or not (need_planes or need_flow):  # nothing to launch: no taps
        return tuple(None if t is None else t.zero_() for t in (grad_planes, grad_u, grad_v))
    if not warp_plan.offsets_fit_int32(planes.stride(), C, H, W):
        raise ValueError(f"planes of strides {planes.stride()} are too large for the backward kernel")
    plan = warp_plan.plan_multiflow_grad(C)
    scratch = torch.empty((B, (C + 3) // 4, H, W, 4), device=dev, dtype=torch.float32) if need_planes else None
    dummy = (0, 0, 0, 0)
    strides = (ctypes.c_int64 * 21)(*planes.stride(), *u.stride(), *v.stride(), *grad_out.stride(),
                                    *(grad_planes.stride() if need_planes else dummy))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.warp_multiflow_grad(
            planes.data_ptr(), u.data_ptr(), v.data_ptr(), grad_out.data_ptr(), ptr(grad_planes), ptr(grad_u),
            ptr(grad_v), ptr(scratch), int(planes.dtype == torch.bfloat16), int(need_planes),
            int(need_flow), B, C, n, H, W, strides, warp_plan.as_ints(plan), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_multiflow_grad launch failed: CUDA error {err}")
    warp_multiflow_backward_cuda.launches += 1
    warp_multiflow_backward_cuda.operations += 3 if need_planes else 1
    return grad_planes, grad_u, grad_v


warp_multiflow_backward_cuda.launches = 0  # backward kernel launches since the last reset
# device operations of those calls: the scratch's zero fill, the kernel and the store pass
warp_multiflow_backward_cuda.operations = 0
