#!/usr/bin/env python3
"""Smoke run of the PyTorch port (superslomo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3: build, kernels against plain

Phases, each of which raises on failure:
  1. device: the card's name and power limit, the CUDA version, and the nvcc
     build of every kernel source in csrc/ of this checkout (one nvcc per
     source, all started together);
  2. multi-flow kernel against plain: the multi-flow warp kernel against its
     plain PyTorch version at the serving path's shapes (736x1280, C=3, n=7,
     B=2), in f32 and with bf16 planes and store: on noise flows beyond the
     Pallas kernel's +-128 px band, and on the step's kind of flows (smooth,
     up to ~30 px) with contiguous planes and with the channels_last slices of
     a 6-channel pair that the step passes (timed through ops.warp_multiflow_planar,
     the op the step calls), and an odd shape with ragged tiles; each timed
     beside grid_sample and the memory bound;
  3. single-flow kernels against plain: the forward kernel at the training
     shape (B=32, C=3, 224x224) through the strided channels_last views the
     step passes (the flow of a 4-channel head on noise flows and on the
     step's kind of smooth flows, and a dense 2-channel flow), at 736x1280
     B=2 with flows beyond +-128 px in f32 and bf16, and at odd shapes; the
     flow-gradient and image-gradient kernels against autograd of the plain
     version, each alone and launched together, at the training shape in
     each layout the train step's backward launches receive (phase 8 records
     them and the run fails if one has no case here), on smooth flows, with a
     bf16 image, at an odd shape (ragged tiles) and, for the flow gradient,
     at 720p; each kernel timed beside its memory bound and grid_sample
     (the forward; grid_sample's backward computing the same gradient alone,
     and forward + backward). The card's SM clock is read before phase 2 and
     after phase 3. Every kernel time is given three ways: ``ms``, CUDA
     events around each call as the host launches it (where the host takes
     longer to launch a call than the device takes to run it, this holds the
     host's time too); ``device_ms``, the same calls queued behind a
     device-side sleep, so each interval holds only device work; and
     ``host_ms``, the host's time to launch one call;
  4. serving slice on the card against the same slice on the CPU: the
     full-width model with seeded weights at 128x224, f32 with TF32 off;
  5. serving main path: the Evaluator at 720p (padded to 736), 8x, B=2, over
     three synthetic batches, in f32 and bf16, with the step's time, frames/s
     and peak memory, and the multi-flow kernel's launches counted per step;
  6. train step on the card against the same step on the CPU (64x64, B=2,
     f32, panning-texture frames): the loss vector, and the gradient of all
     parameters together;
  7. convergence: 30 steps on an exactly solvable translating scene at 32x32;
  8. training main path: the Trainer at configs/superslomo_original.ini
     (B=32, 224x224, f32, TF32 off) with seeded weights and random VGG
     features, over synthetic panning-texture batches: 2 warm-up and 10 timed
     steps, then 2 steps of the training loop, which saves a checkpoint; the
     single-flow kernels' launches counted per step and the strides that
     each backward launch of the first step receives recorded; the
     checkpoint reloaded and resumed to identical weights and Adam moments.
One JSON object per line; the last line is the run's verdict. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result. Phases 2 and 3 use only wrapper calls that earlier versions
of the package have too, so a copy of this script placed in an older
checkout runs them there (``--kernels-only``) for a same-card comparison.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-5
# backward kernels against autograd of the plain version, as a share of the
# reference's max |g|: both sum a few f32 products per tap in another order
# (the image gradient with atomics, in an order that varies run to run), so
# they differ by a few f32 ulps of the largest terms
GRAD_KERNEL_REL = 1e-5
SLICE_ATOL, SLICE_RTOL = 5e-4, 1e-3  # the full-model bar of the JAX package
# a train step on the card against the CPU: the loss bar of
# tests/test_torch_train.py, and its gradient bar over all parameters together
LOSS_RTOL, GRAD_REL = 1e-4, 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=25, warmup=3, queued=False):
    """Median time of ``fn`` in ms, from CUDA events around each call, timed
    as the host launches it (``ms`` in the results): where the host takes
    longer to launch a call than the device takes to run it, the interval
    holds the host's launch time too.

    ``queued``: the calls and their events are queued behind a device-side
    sleep, so each interval holds only device work (``device_ms``)."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)  # ~25 ms at 1.98 GHz: longer than the host takes to queue the calls
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, reps=200, warmup=3):
    """The host's time to launch one call of ``fn`` in ms: the mean over
    ``reps`` calls made back to back with no synchronisation, fewer than the
    device's launch queue holds, so the host never waits for the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def timings(fn):
    """``ms``, ``device_ms`` and ``host_ms`` of ``fn`` (see cuda_ms, host_ms)."""
    return {"ms": cuda_ms(fn), "device_ms": cuda_ms(fn, queued=True), "host_ms": host_ms(fn)}


def warp_bound(B, C, n, H, W, in_bytes, out_bytes):
    """Least time of one multi-flow warp: each input read once and each output
    written once, against 12 f32 operations per (pixel, flow) for the
    position and weights and 7 per channel for the taps."""
    nbytes = B * C * H * W * in_bytes + 2 * B * n * H * W * 4 + B * C * n * H * W * out_bytes
    ops = B * n * H * W * (12 + 7 * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def smooth_flows(rng, B, H, W, amp):
    """(B, 2, H, W) f32 smooth, low-frequency flows, as a flow network gives
    them: per component a sum of four sinusoids with wavelengths of 1/4 to 1
    frame, scaled so that the largest |component| is ``amp`` px."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / max(H, W)
    f = np.zeros((B, 2, H, W), np.float32)
    for b in range(B):
        for c in range(2):
            for _ in range(4):
                fy, fx = rng.uniform(-4, 4, 2)
                f[b, c] += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
    return f * (amp / np.abs(f).max())


def step_flows(rng, B, n, H, W, dev, amp=30.0):
    """u, v (B, n, H, W) f32 on ``dev`` as the fused step makes them: the n
    intermediate flows F_t1 = (1-t)^2 F_01 - t(1-t) F_10 at t = k/(n+1) of
    smooth bidirectional flows up to ``amp`` px."""
    f01, f10 = (torch.from_numpy(smooth_flows(rng, B, H, W, amp)).to(dev) for _ in range(2))
    t = (torch.arange(1, n + 1, device=dev, dtype=torch.float32) / (n + 1)).reshape(1, n, 1, 1)
    ft1 = (1 - t)[:, :, None] ** 2 * f01[:, None] - (t * (1 - t))[:, :, None] * f10[:, None]  # (B, n, 2, H, W)
    return ft1[:, :, 0].contiguous(), ft1[:, :, 1].contiguous()


def _mf_library(p, u, v):
    """grid_sample over the planes tiled n times: one f32 call computing the
    same warp (a bf16 grid could not address 1280 columns; for bf16 planes it
    samples the same bf16 values in f32, as the kernel does)."""
    B, n, H, W = u.shape
    C = p.shape[1]
    xs = torch.arange(W, device=u.device, dtype=torch.float32)
    ys = torch.arange(H, device=u.device, dtype=torch.float32)[:, None]
    grid = torch.stack([2 * (xs + u) / (W - 1) - 1, 2 * (ys + v) / (H - 1) - 1], dim=-1).reshape(B * n, H, W, 2)
    tiled = p.float()[:, None].expand(B, n, C, H, W).reshape(B * n, C, H, W)
    return lambda: F.grid_sample(tiled, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def check_mf(tag, p, u, v, got, want, f32_of):
    """Raise unless a multi-flow result is exact: 0.0 from the plain version
    in f32; in bf16 the f32 result (``f32_of()``) cast, bit for bit, and
    within one bf16 ulp of the plain version."""
    err = (got.float() - want.float()).abs().max().item()
    if p.dtype == torch.float32:
        if err > KERNEL_ATOL:
            raise AssertionError(f"{tag}: f32 kernel differs from the plain warp by {err}")
        return err, None
    same = torch.equal(got.view(torch.int16), f32_of().bfloat16().view(torch.int16))
    if not same:
        raise AssertionError(f"{tag}: bf16 store is not the f32 result cast")
    if err > 2.0**-7 * want.float().abs().max().item():  # one bf16 ulp
        raise AssertionError(f"{tag}: bf16 kernel differs from the plain warp by {err}")
    return err, same


def multiflow_cases():
    """(case, dtype tag, planes, u, v) at the serving path's shapes: noise
    flows with contiguous planes, and the step's kind of flows with
    contiguous planes and with the step's channels_last pair slices (a view
    of the 6-channel pair in the dtype, pixel stride 6, as
    models/superslomo.py passes them); and a pair slice at an odd shape
    (37x53: ragged tiles, no vector access) with flows up to ~90 px."""
    B, C, n, H, W = 2, 3, 7, 736, 1280
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    planes = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    u = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    v = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    u[:, :, 200:400, 300:600] += 150.0  # a patch shifted beyond the Pallas band
    v[:, :, 400:600, 100:400] -= 140.0
    u, v = torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)
    su, sv = step_flows(np.random.default_rng(11), B, n, H, W, dev)
    pair = torch.from_numpy(rng.standard_normal((B, H, W, 6), dtype=np.float32)).to(dev).permute(0, 3, 1, 2)
    ou, ov = step_flows(np.random.default_rng(12), 1, 3, 37, 53, dev, amp=90.0)
    odd_pair = torch.from_numpy(rng.standard_normal((1, 37, 53, 6), dtype=np.float32)).to(dev).permute(0, 3, 1, 2)
    cases = []
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cases.append(("noise", tag, planes.to(dt).contiguous(), u, v))
        cases.append(("step_flows", tag, planes.to(dt).contiguous(), su, sv))
        cases.append(("step_flows_strided", tag, pair.to(dt)[:, 3:6], su, sv))
        cases.append(("odd_strided", tag, odd_pair.to(dt)[:, 0:3], ou, ov))
    return cases


def phase_kernel():
    """The multi-flow warp kernel against its plain version at the serving
    path's shapes, on noise flows and on the step's kind of flows."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops import warp_cuda

    kernel, plain = warp_cuda.warp_multiflow_planar_cuda, ops.warp_multiflow_planar_reference
    out = {}
    for case, tag, p, u, v in multiflow_cases():
        B, C, H, W = p.shape
        n = u.shape[1]
        # strided planes go through the op the step calls (earlier versions of
        # the package copied them there first)
        call = (lambda: kernel(p, u, v)) if p.is_contiguous() else (lambda: ops.warp_multiflow_planar(p, u, v))
        got, want, lib = call(), plain(p, u, v, p.dtype), _mf_library(p, u, v)()
        torch.cuda.synchronize()
        err, same = check_mf(f"{case} {tag}", p, u, v, got, want, lambda: ops.warp_multiflow_planar(p.float(), u, v))
        res = {
            "shape": [B, C, n, H, W], "planes_strides": list(p.stride()), "max_abs_err": err,
            "library_max_abs_diff": (lib.reshape(B, n, C, H, W).transpose(1, 2) - got.float()).abs().max().item(),
            **timings(call),
            "plain_ms": cuda_ms(lambda: plain(p, u, v, p.dtype), reps=20, warmup=1),
            "library_ms": cuda_ms(_mf_library(p, u, v)),
            "max_abs_flow": max(u.abs().max().item(), v.abs().max().item()),
        }
        if same is not None:
            res["bit_identical_to_f32_cast"] = same
        res["bound_ms"], res["bound_by"] = warp_bound(B, C, n, H, W, p.element_size(), got.element_size())
        out[(case, tag)] = res
        emit({"phase": "kernel_vs_plain", "case": case, "dtype": tag, **res})
    return out


def single_bounds(B, C, H, W, esize):
    """Least times of the single-flow kernels, as (ms, bound_by) each: every
    input read once and every output written once, against the f32
    operations per pixel (12 for the position and weights; per channel 7 for
    the forward's taps, 12 for the flow gradient's, 8 for the image
    gradient's scatter)."""
    img, flow, px = B * C * H * W * esize, B * 2 * H * W * 4, B * H * W

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    return {
        "forward": bound(2 * img + flow, px * (12 + 7 * C)),
        "flow_grad": bound(2 * img + 2 * flow, px * (12 + 12 * C)),  # img, g, flow in; grad_flow out
        "img_grad": bound(2 * img + flow, px * (12 + 8 * C)),  # g, flow in; grad_img out in the image's dtype
    }


def _flow_field(rng, B, H, W, std, shift):
    """(B, H, W, 2) f32 flows of std ``std`` px with two patches shifted by
    ``shift`` px (beyond the Pallas band when shift > 128)."""
    f = rng.normal(0.0, std, (B, H, W, 2)).astype(np.float32)
    f[:, H // 4 : H // 2, W // 4 : W // 2, 0] += shift
    f[:, H // 2 : 3 * H // 4, : W // 3, 1] -= shift
    return f


def _channels_last(rng, B, C, H, W, dev, dtype=torch.float32):
    """(B, C, H, W) standard normal values as a channels_last view of a
    (B, H, W, C) tensor."""
    x = torch.from_numpy(rng.standard_normal((B, H, W, C), dtype=np.float32)).to(dev, dtype)
    return x.permute(0, 3, 1, 2)


def _grid_for(flow):
    """grid_sample's normalised sample positions of a (B, 2, H, W) flow."""
    H, W = flow.shape[-2:]
    xs = torch.arange(W, device=flow.device, dtype=torch.float32)
    ys = torch.arange(H, device=flow.device, dtype=torch.float32)[:, None]
    return torch.stack([2 * (xs + flow[:, 0]) / (W - 1) - 1, 2 * (ys + flow[:, 1]) / (H - 1) - 1], dim=-1)


def _grid_sample(img, grid):
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def _library_grads(img, grid, g, mask):
    """One library call computing the warp's image gradient (mask [True,
    False]) or grid gradient ([False, True]) alone: grid_sample's backward."""
    return torch.ops.aten.grid_sampler_2d_backward(g, img, grid, 0, 0, True, mask)


def plain_grads(img, flow, g):
    """(image gradient, flow gradient) by autograd of the plain warp, in f32:
    for a bf16 image, of the image and output gradient upcast (exact), which
    gives the plain bf16 warp's flow gradient and its image gradient before
    the one rounding to bf16."""
    from superslomo_tpu_torch import ops

    im = img.detach().float().requires_grad_(True)
    fl = flow.detach().clone().requires_grad_(True)
    return torch.autograd.grad(ops.warp_single_reference(im, fl), (im, fl), g.float())


def check_grads(tag, img, flow, g):
    """Both gradient kernels against autograd of the plain warp, each alone
    and launched together (one backward that asks for both). The flow
    gradient within GRAD_KERNEL_REL of the reference's max |g|, and the
    both-gradients launch's bit for bit equal to the single one (a gather, no
    atomics). The image gradient within GRAD_KERNEL_REL of its max, plus, for
    a bf16 image, the one rounding of the f32 sum to bf16 (half a bf16 ulp,
    at most 2^-8 of the value)."""
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd

    want_gi, want_gf = plain_grads(img, flow, g)
    _, got_gf = bwd(img, flow, g, False, True)
    got_gi, _ = bwd(img, flow, g, True, False)
    both_gi, both_gf = bwd(img, flow, g, True, True)
    torch.cuda.synchronize()
    gf_bar = GRAD_KERNEL_REL * want_gf.abs().max().item()
    gi_bar = GRAD_KERNEL_REL * want_gi.abs().max().item()
    gi_tol = gi_bar + (2.0**-8 * want_gi.abs() if img.dtype == torch.bfloat16 else 0.0)
    gf_err = (got_gf - want_gf).abs().max().item()
    res = {
        "shape": list(img.shape), "dtype": str(img.dtype).replace("torch.", ""),
        "strides": {"img": list(img.stride()), "flow": list(flow.stride()), "grad_out": list(g.stride())},
        "flow_grad": {"max_abs_err": gf_err, "bar": gf_bar},
        "img_grad": {"max_abs_err": (got_gi.float() - want_gi).abs().max().item(), "bar": gi_bar,
                     "bf16_rounding_allowed": img.dtype == torch.bfloat16},
        "both_launch_equal": bool(torch.equal(both_gf, got_gf)
                                  and ((both_gi.float() - want_gi).abs() <= gi_tol).all()),
    }
    ok = (gf_err <= gf_bar and bool(((got_gi.float() - want_gi).abs() <= gi_tol).all())
          and res["both_launch_equal"] and got_gi.dtype == img.dtype and got_gf.dtype == torch.float32)
    if not ok:
        raise AssertionError(f"gradient kernels, {tag}: {res}")
    return res


def time_grads(img, flow, g, bounds, library=True):
    """Each gradient kernel's ms / device_ms / host_ms beside its bound and,
    for an f32 image, grid_sample's backward computing the same gradient
    alone (``library_ms``) and grid_sample forward + backward
    (``library_fwd_bwd_ms``)."""
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd

    out = {}
    for key, need_img, mask in (("flow_grad", False, [False, True]), ("img_grad", True, [True, False])):
        r = {**timings(lambda: bwd(img, flow, g, need_img, not need_img)),
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1]}
        if library:
            grid = _grid_for(flow)
            r["library_ms"] = cuda_ms(lambda: _library_grads(img, grid, g, mask))

            def fwd_bwd():
                x = (img if need_img else grid).detach().requires_grad_(True)
                out_ = _grid_sample(x, grid) if need_img else _grid_sample(img, x)
                torch.autograd.grad(out_, x, g)

            r["library_fwd_bwd_ms"] = cuda_ms(fwd_bwd)
        out[key] = r
    return out


def phase_single_kernels():
    """The single-flow forward and gradient kernels against the plain warp
    and its autograd, at the training shape and at 720p."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda, warp_single_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    res = {}

    # the training shape, through the views the step passes: the second frame
    # of a 6-channel pair and the first flow of a 4-channel head, channels_last
    B, C, H, W = 32, 3, 224, 224
    pairs = _channels_last(rng, B, 6, H, W, dev)
    head = np.concatenate([_flow_field(rng, B, H, W, 4.0, 150.0), rng.normal(0, 4, (B, H, W, 2))], -1)
    head = torch.from_numpy(head.astype(np.float32)).to(dev).permute(0, 3, 1, 2)
    img, flow = pairs[:, 3:6], head[:, 0:2]
    if (img.stride(1), img.stride(3), flow.stride(1), flow.stride(3)) != (1, 6, 1, 4):
        raise AssertionError(f"not the step's strided views: {img.stride()} {flow.stride()}")
    got = warp_single_cuda(img, flow)
    want = ops.warp_single_reference(img, flow)
    grid = _grid_for(flow)
    lib = _grid_sample(img, grid)
    torch.cuda.synchronize()
    fwd_err = (got - want).abs().max().item()
    if fwd_err > KERNEL_ATOL:
        raise AssertionError(f"single-flow forward kernel differs from the plain warp by {fwd_err}")
    bounds = single_bounds(B, C, H, W, 4)
    res["train_shape"] = {
        "shape": [B, C, H, W], "max_abs_err": fwd_err,
        "library_max_abs_diff": (lib - got).abs().max().item(),
        **timings(lambda: warp_single_cuda(img, flow)),
        "plain_ms": cuda_ms(lambda: ops.warp_single_reference(img, flow), reps=10, warmup=1),
        "library_ms": cuda_ms(lambda: _grid_sample(img, grid)),
        "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
    }
    emit({"phase": "single_kernels_vs_plain", "case": "train_shape", **res["train_shape"]})

    # the same image with a dense 2-channel channels_last flow, as the
    # refined flows (est + residual) of models/physics.py reach the warp
    flow2 = head[:, 0:2].contiguous(memory_format=torch.channels_last)
    if flow2.stride(1) != 1 or flow2.stride(3) != 2:
        raise AssertionError(f"not a dense 2-channel channels_last flow: {flow2.stride()}")
    got2 = warp_single_cuda(img, flow2)
    torch.cuda.synchronize()
    err2 = (got2 - want).abs().max().item()
    if err2 > KERNEL_ATOL:
        raise AssertionError(f"single-flow forward kernel with a dense flow differs from the plain warp by {err2}")
    res["dense_flow"] = {
        "shape": [B, C, H, W], "flow_strides": list(flow2.stride()), "max_abs_err": err2,
        **timings(lambda: warp_single_cuda(img, flow2)),
        "library_ms": cuda_ms(lambda: _grid_sample(img, grid)),
        "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
    }
    emit({"phase": "single_kernels_vs_plain", "case": "dense_flow", **res["dense_flow"]})

    # the train step's kind of flows: smooth, up to 10 px, through the head's
    # view (pixel stride 4)
    smooth = torch.from_numpy(smooth_flows(rng, B, H, W, 10.0)).to(dev)
    flow_s = torch.cat([smooth, smooth], 1).permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)[:, 0:2]
    got_s = warp_single_cuda(img, flow_s)
    want_s = ops.warp_single_reference(img, flow_s)
    grid_s = _grid_for(flow_s)
    torch.cuda.synchronize()
    err_s = (got_s - want_s).abs().max().item()
    if err_s > KERNEL_ATOL:
        raise AssertionError(f"single-flow forward kernel on smooth flows differs by {err_s}")
    res["smooth_flow"] = {
        "shape": [B, C, H, W], "flow_strides": list(flow_s.stride()), "max_abs_err": err_s,
        "max_abs_flow": smooth.abs().max().item(),
        **timings(lambda: warp_single_cuda(img, flow_s)),
        "library_ms": cuda_ms(lambda: _grid_sample(img, grid_s)),
        "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
    }
    emit({"phase": "single_kernels_vs_plain", "case": "smooth_flow", **res["smooth_flow"]})

    # the gradient kernels in the layouts the train step's 8 backward launches
    # receive (phase train_main_path records them, and main() checks that
    # each is a case here): the image a frame of the pair (pixel stride 6);
    # the flow a head's (stride 4: the stage-1 warp loss) or a dense
    # channels_last sum (stride 2: the interpolated and refined flows); the
    # output gradient NCHW (the warp losses), a slice of the NCHW gradient of
    # the 16-channel stage-2 input, or dense channels_last (the final warps'
    # blend)
    g3 = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    g16 = torch.from_numpy(rng.standard_normal((B, 16, H, W), dtype=np.float32)).to(dev)[:, 3:6]
    g3_cl = _channels_last(rng, B, C, H, W, dev)
    grad_cases = {
        "loss_head": (img, flow, g3), "loss_refined": (img, flow2, g3), "final": (img, flow2, g3_cl),
        "stage2_input": (img, flow2, g16), "smooth_loss_head": (img, flow_s, g3),
        "bf16_loss_head": (pairs.bfloat16()[:, 3:6], flow, g3.bfloat16()),
    }
    for case, (im, fl, g) in grad_cases.items():
        r = check_grads(case, im, fl, g)
        r.update({k: dict(r[k], **v) for k, v in time_grads(
            im, fl, g, single_bounds(B, C, H, W, im.element_size()), library=im.dtype == torch.float32).items()})
        res[f"grad_{case}"] = r
        emit({"phase": "single_grad_kernels_vs_plain", "case": case, **r})
    # the main case's grid gradient from grid_sample's backward, in pixels
    lib_gg = _library_grads(img, grid, g3, [False, True])[1]
    lib_gf = torch.stack([lib_gg[..., 0] * 2 / (W - 1), lib_gg[..., 1] * 2 / (H - 1)], dim=1)
    _, got_gf = warp_single_backward_cuda(img, flow, g3, False, True)
    res["grad_loss_head"]["flow_grad"]["library_max_abs_diff"] = (lib_gf - got_gf).abs().max().item()

    # the plain version has no backward alone: its forward + backward to one input
    for key, idx in (("img_grad", 0), ("flow_grad", 1)):
        def plain_fwd_bwd():
            x = [img.detach(), flow.detach()]
            x[idx].requires_grad_(True)
            torch.autograd.grad(ops.warp_single_reference(*x), x[idx], g3)

        res["grad_loss_head"][key]["plain_ms"] = cuda_ms(plain_fwd_bwd, reps=10, warmup=1)
    res["layouts"] = sorted({(tuple(im.stride()), tuple(fl.stride()), tuple(g.stride()))
                             for im, fl, g in grad_cases.values() if im.dtype == torch.float32})

    # odd shapes (ragged tiles, no vector access): a pair slice with a head
    # flow in f32, and NCHW bf16 against the f32 result cast; both gradients
    odd = _channels_last(rng, 3, 6, 37, 53, dev)
    odd_flow = torch.from_numpy(_flow_field(rng, 3, 37, 53, 5.0, 20.0)).to(dev).permute(0, 3, 1, 2)
    odd_err = (warp_single_cuda(odd[:, 3:6], odd_flow) - ops.warp_single_reference(odd[:, 3:6], odd_flow)).abs().max().item()
    odd_bf16 = odd[:, 3:6].contiguous().bfloat16()
    odd_flow_nchw = odd_flow.contiguous()
    odd_same = torch.equal(warp_single_cuda(odd_bf16, odd_flow_nchw).view(torch.int16),
                           warp_single_cuda(odd_bf16.float(), odd_flow_nchw).bfloat16().view(torch.int16))
    odd_g = torch.from_numpy(rng.standard_normal((3, 16, 37, 53), dtype=np.float32)).to(dev)
    odd_grads = {
        "f32_strided": check_grads("odd f32", odd[:, 3:6], odd_flow, odd_g[:, 10:13]),
        "bf16_nchw": check_grads("odd bf16", odd_bf16, odd_flow_nchw, odd_g[:, 0:3].bfloat16()),
    }
    res["odd"] = {"shape": [3, 3, 37, 53], "max_abs_err": odd_err, "bf16_bit_identical_to_f32_cast": odd_same,
                  "grads": odd_grads}
    emit({"phase": "single_kernels_vs_plain", "case": "odd", **res["odd"]})
    if odd_err > KERNEL_ATOL or not odd_same:
        raise AssertionError(f"single-flow forward kernel at an odd shape: {res['odd']}")

    # 720p, flows beyond the band, f32 and bf16: the forward and the flow
    # gradient, each beside its bound and grid_sample
    B, C, H, W = 2, 3, 736, 1280
    img = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    flow = torch.from_numpy(_flow_field(rng, B, H, W, 7.0, 150.0)).to(dev).permute(0, 3, 1, 2).contiguous()
    g = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    grid = _grid_for(flow)
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        im, gd = img.to(dt), g.to(dt)
        im32, gd32 = im.float(), gd.float()  # grid_sample's inputs: f32 (a bf16 grid cannot address 1280 columns)
        got = warp_single_cuda(im, flow)
        want = ops.warp_single_reference(im, flow)
        _, want_gf = plain_grads(im, flow, gd)
        _, got_gf = warp_single_backward_cuda(im, flow, gd, False, True)
        torch.cuda.synchronize()
        bounds = single_bounds(B, C, H, W, im.element_size())
        case = {
            "shape": [B, C, H, W], "max_abs_err": (got.float() - want.float()).abs().max().item(),
            **timings(lambda: warp_single_cuda(im, flow)),
            # for a bf16 image grid_sample samples the same values in f32, as the kernel does
            "library_ms": cuda_ms(lambda: _grid_sample(im32, grid)),
            "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
            "flow_grad": {
                "max_abs_err": (got_gf - want_gf).abs().max().item(),
                "bar": GRAD_KERNEL_REL * want_gf.abs().max().item(),
                **timings(lambda: warp_single_backward_cuda(im, flow, gd, False, True)),
                "library_ms": cuda_ms(lambda: _library_grads(im32, grid, gd32, [False, True])),
                "bound_ms": bounds["flow_grad"][0], "bound_by": bounds["flow_grad"][1],
            },
        }
        if case["flow_grad"]["max_abs_err"] > case["flow_grad"]["bar"]:
            raise AssertionError(f"{tag} flow gradient at 720p differs from autograd of the plain warp: {case}")
        if tag == "f32":
            if case["max_abs_err"] > KERNEL_ATOL:
                raise AssertionError(f"f32 forward kernel at 720p differs from the plain warp by {case['max_abs_err']}")
        else:
            case["bit_identical_to_f32_cast"] = torch.equal(
                got.view(torch.int16), warp_single_cuda(im.float(), flow).bfloat16().view(torch.int16))
            if not case["bit_identical_to_f32_cast"]:
                raise AssertionError("bf16 store of the single-flow kernel is not the f32 result cast")
            if case["max_abs_err"] > 2.0**-7 * want.float().abs().max().item():  # one bf16 ulp
                raise AssertionError(f"bf16 single-flow kernel differs from the plain warp by {case['max_abs_err']}")
        res[f"720p_{tag}"] = case
        emit({"phase": "single_kernels_vs_plain", "case": f"720p_{tag}", **case})
    return res


def phase_slice():
    """The full-width slice on the card against the same slice on the CPU."""
    from superslomo_tpu_torch import ModelSpec, SuperSloMo, weights

    spec = ModelSpec()
    state = weights.seeded_state(spec, seed=0)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((1, 2, 128, 224, 3), dtype=np.float32)
    t_values = np.arange(1, 8, dtype=np.float32) / 8
    pred, bound = SuperSloMo(spec).load_state(state).interpolate_multi_t(frames, t_values, with_bounds=True)
    pred_cpu, bound_cpu = SuperSloMo(spec, device="cpu").load_state(state).interpolate_multi_t(
        frames, t_values, with_bounds=True)
    pred = pred.cpu()
    res = {
        "phase": "slice_card_vs_cpu", "shape": list(pred.shape),
        "max_abs_err": (pred - pred_cpu).abs().max().item(),
        "bound": float(bound), "bound_rel_err": abs(float(bound) - float(bound_cpu)) / float(bound_cpu),
        "finite": bool(torch.isfinite(pred).all()),
    }
    emit(res)
    if not (res["finite"] and torch.allclose(pred, pred_cpu, atol=SLICE_ATOL, rtol=SLICE_RTOL)
            and res["bound_rel_err"] <= 1e-4):
        raise AssertionError(f"card and CPU disagree: {res}")


def panning_clips(rng, B, H, W):
    """(B, 9, H, W, 3) uint8 clips: a smooth random texture panning 3 px a frame."""
    yy, xx = np.mgrid[0:H, 0 : W + 32].astype(np.float32)
    clips = []
    for _ in range(B):
        tex = np.zeros((H, W + 32, 3), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.005, 0.05, 2)
            tex += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None] * rng.uniform(10, 40, 3)
        tex = np.clip(tex + 128, 0, 255).astype(np.uint8)
        clips.append(np.stack([tex[:, 3 * i : 3 * i + W] for i in range(9)]))
    return np.stack(clips)


def synthetic_batches(norm, padding, n_batches, B, H, W, seed):
    """Reader-shaped evaluation batches of panning clips: the ends are the
    inputs, the 7 inner frames the targets."""
    rng = np.random.default_rng(seed)
    left, right, top, bottom = padding
    pad = ((0, 0), (0, 0), (top, bottom), (left, right), (0, 0))
    out = []
    for _ in range(n_batches):
        x = np.pad(norm(panning_clips(rng, B, H, W)), pad)
        out.append((x[:, [0, 8]], x[:, 1:8], np.full(B, 7)))
    return out


def synthetic_train_batches(norm, n_batches, B, H, W, seed):
    """Training batches of panning clips: frames (B, 2, H, W, 3) = the ends,
    one inner frame per sample as the target (B, 1, H, W, 3), and its
    instant t = i/8 (B, 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = norm(panning_clips(rng, B, H, W))
        i = rng.integers(1, 8, B)
        out.append((x[:, [0, 8]], x[np.arange(B), i][:, None], (i / 8).astype(np.float32)[:, None]))
    return out


def phase_main_path(dtype, batches, steps=8):
    """The Evaluator at 720p 8x over ``batches``, after timing the step."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, default_config, weights
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter

    cfg = default_config(DATA_DATASET="ADOBE", TPU_COMPUTE_DTYPE=dtype)
    cfg.set("ADOBE_DATA", "H_IN", 720)
    cfg.set("ADOBE_DATA", "W_IN", 1280)
    spec = cfg.model_spec()
    model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
    frames = torch.from_numpy(batches[0][0]).cuda()
    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    for _ in range(2):  # cuDNN autotuning happens here
        model.interpolate_multi_t(frames, t_values, with_bounds=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        model.interpolate_multi_t(frames, t_values, with_bounds=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    B, n_t = frames.shape[0], t_values.shape[0]

    counter.launches = 0
    t0 = time.perf_counter()
    results = Evaluator(cfg, model).run(batches)
    wall = time.perf_counter() - t0
    launches = counter.launches
    res = {
        "phase": "main_path", "compute_dtype": dtype, "batch": B, "n_t": n_t,
        "frame_hw": list(frames.shape[2:4]), "step_ms_median": statistics.median(times),
        "step_ms": times, "frames_per_s": B * n_t / (statistics.median(times) / 1e3),
        "peak_mem_gib": peak / 2**30, "eval_batches": len(batches), "eval_wall_s": wall,
        "warp_launches": launches, **results,
    }
    emit(res)
    if launches != 4 * len(batches):
        raise AssertionError(f"{launches} warp launches over {len(batches)} steps, expected 4 per step")
    if not all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"], results["max_flow_bound"]])):
        raise AssertionError(f"non-finite metrics: {results}")
    return res


def _train_config(ckpt_dir, path=None, **overrides):
    from superslomo_tpu_torch import default_config, load_config

    cfg = load_config(path) if path else default_config()
    cfg.set("TRAIN", "ALLOW_RANDOM_VGG", "TRUE")  # no VGG-16 file ships with the repo
    cfg.set("TRAIN", "CKPT_DIR", ckpt_dir)
    for key, value in overrides.items():
        section, _, k = key.partition("_")
        cfg.set(section, k, value)
    return cfg


def phase_train_vs_cpu(ckpt_dir, norm):
    """One train step on the card against the same step on the CPU (64x64,
    B=2, f32, panning-texture frames): the loss vector within the CPU test's
    1e-4, and the gradient of all parameters together within its 1e-3, as a
    relative L2 error. Per tensor the max-relative error is reported beside
    the same quantity between two CPU steps whose frames differ by 1e-5: the
    step's gradient is discontinuous (the warp's floor, the leaky ReLU's and
    max pool's switches, the L1 kinks), and in the deep layers, which see few
    positions at 64x64, one switch moves a tensor's gradient by a visible
    share of its max, on the CPU alone as much as between two devices."""
    from superslomo_tpu_torch import Trainer

    frames, targets, t = synthetic_train_batches(norm, n_batches=1, B=2, H=64, W=64, seed=4)[0]
    cfg = _train_config(ckpt_dir, TRAIN_BATCH_SIZE=2, TRAIN_CROP_IMH=64, TRAIN_CROP_IMW=64)

    def step(device, f):
        tr = Trainer(cfg, device=device)
        loss = tr.train_step(f, targets, t).cpu().numpy()
        return loss, {f"{stage}.{n}": p.grad.cpu() for stage in ("stage1", "stage2")
                      for n, p in getattr(tr.model, stage).named_parameters()}

    def compare(got, want):
        per_tensor = {k: ((got[k] - w).abs().max() / w.abs().max()).item() for k, w in want.items()}
        worst = max(per_tensor, key=per_tensor.get)
        num = sum(((got[k] - w) ** 2).sum() for k, w in want.items())
        den = sum((w ** 2).sum() for w in want.values())
        return (num / den).sqrt().item(), worst, per_tensor[worst]

    loss_card, grads_card = step(None, frames)
    loss_cpu, grads_cpu = step("cpu", frames)
    nudge = np.random.default_rng(9).standard_normal(frames.shape).astype(np.float32) * 1e-5
    _, grads_nudged = step("cpu", frames + nudge)
    rel, worst, worst_rel = compare(grads_card, grads_cpu)
    cpu_rel, cpu_worst, cpu_worst_rel = compare(grads_nudged, grads_cpu)
    res = {
        "phase": "train_step_card_vs_cpu", "shape": [2, 2, 64, 64, 3],
        "loss_card": loss_card.tolist(), "loss_cpu": loss_cpu.tolist(),
        "loss_max_rel_err": float(np.max(np.abs(loss_card - loss_cpu) / np.abs(loss_cpu))),
        "grad_rel_l2_err": rel, "grad_worst_tensor": worst, "grad_worst_tensor_max_rel_err": worst_rel,
        "cpu_nudged_1e-5": {"grad_rel_l2_err": cpu_rel, "grad_worst_tensor": cpu_worst,
                            "grad_worst_tensor_max_rel_err": cpu_worst_rel},
        "grad_tensors": len(grads_cpu),
    }
    emit(res)
    if not (np.isfinite(loss_card).all() and res["loss_max_rel_err"] <= LOSS_RTOL and rel <= GRAD_REL):
        raise AssertionError(f"train step on the card and the CPU disagree: {res}")


def translating_pattern(shift, H=32, W=32):
    """A smooth 3-channel pattern translated by ``shift`` px in x and
    ``shift/2`` in y: a constant-flow scene with an exact interpolation."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u = 2 * np.pi * (xs - shift) / 16.0
    v = 2 * np.pi * (ys - 0.5 * shift) / 16.0
    return np.stack([np.sin(u) * np.cos(v), np.cos(u + v), np.sin(v) * np.sin(u + 1.0)], axis=-1)


def phase_convergence(ckpt_dir):
    """30 steps on the card on an exactly solvable scene at 32x32: the mean
    of the last 5 losses must be below 0.7 of the first."""
    from superslomo_tpu_torch import Trainer

    cfg = _train_config(ckpt_dir, TRAIN_BATCH_SIZE=1, TRAIN_CROP_IMH=32, TRAIN_CROP_IMW=32)
    tr = Trainer(cfg)
    frames = np.stack([translating_pattern(0.0), translating_pattern(2.0)])[None].astype(np.float32)
    targets = translating_pattern(1.0)[None, None].astype(np.float32)
    t = np.full((1, 1), 0.5, np.float32)
    losses = [float(tr.train_step(frames, targets, t)[0]) for _ in range(30)]
    res = {"phase": "train_convergence", "first": losses[0], "last5_mean": float(np.mean(losses[-5:])),
           "last": losses[-1], "losses": losses}
    emit(res)
    if not (np.isfinite(losses).all() and res["last5_mean"] < 0.7 * losses[0] and losses[-1] < losses[0]):
        raise AssertionError(f"training did not converge on the translating scene: {res}")


def phase_train_main(ckpt_dir, norm, timed=10):
    """The Trainer at the shipped training config over synthetic batches:
    2 warm-up and ``timed`` timed steps, then 2 steps of ``train``, which
    saves a checkpoint; the checkpoint reloaded and resumed."""
    from superslomo_tpu_torch import Trainer, ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as fwd

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = _train_config(ckpt_dir, os.path.join(root, "configs", "superslomo_original.ini"))
    B, H, W = cfg.getint("TRAIN", "BATCH_SIZE"), cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")
    batches = synthetic_train_batches(norm, n_batches=3, B=B, H=H, W=W, seed=5)
    tr = Trainer(cfg, expt_name="chip_smoke")

    # the strides that each backward launch of the first step receives
    layouts = []

    def recording_bwd(img, flow, grad_out, need_img, need_flow):
        layouts.append({"img": list(img.stride()), "flow": list(flow.stride()), "grad_out": list(grad_out.stride()),
                        "grad_out_offset": grad_out.storage_offset(), "need_img": need_img, "need_flow": need_flow})
        return bwd(img, flow, grad_out, need_img, need_flow)

    fwd.launches = bwd.launches = bwd.flow_grad_launches = bwd.img_grad_launches = 0
    losses, times = [], []
    for i in range(2 + timed):
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.warp_single_backward_cuda = recording_bwd if i == 0 else bwd  # the name _WarpSingle.backward calls
        t0 = time.perf_counter()
        losses.append(tr.train_step(*batches[i % len(batches)]))
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    last = tr.train(batches[:1], max_steps=tr.step + 2)  # two epochs of one batch; saves at the end
    steps = 2 + timed + 2
    launches = {"forward": fwd.launches, "backward": bwd.launches,
                "flow_grad": bwd.flow_grad_launches, "img_grad": bwd.img_grad_launches}
    losses = torch.stack(losses).cpu().numpy()

    path = tr.checkpoint_path(tr.epoch)
    resumed = Trainer(_train_config(
        ckpt_dir, os.path.join(root, "configs", "superslomo_original.ini"), STAGE1_LOADPREV="TRUE",
        STAGE1_WEIGHTS=path, STAGE2_LOADPREV="TRUE", STAGE2_WEIGHTS=path), expt_name="chip_smoke_resumed")
    same_weights = all(
        torch.equal(a, b) for stage in ("stage1", "stage2")
        for a, b in zip(getattr(tr.model, stage).state_dict().values(),
                        getattr(resumed.model, stage).state_dict().values()))
    same_moments = all(
        torch.equal(tr.optimizer.state[p][key], resumed.optimizer.state[q][key])
        for p, q in zip(tr.optimizer.param_groups[0]["params"], resumed.optimizer.param_groups[0]["params"])
        for key in ("exp_avg", "exp_avg_sq"))
    med = statistics.median(times)
    res = {
        "phase": "train_main_path", "config": "configs/superslomo_original.ini", "batch": B, "crop_hw": [H, W],
        "compute_dtype": "float32", "steps": steps, "step_ms_median": med, "step_ms": times,
        "samples_per_s": B / (med / 1e3), "peak_mem_gib": peak / 2**30,
        "loss_first": losses[0].tolist(), "loss_last": last.tolist(), "launches": launches,
        "backward_layouts_first_step": layouts,
        "checkpoint_mib": os.path.getsize(path) / 2**20, "resumed_epoch_step": [resumed.epoch, resumed.step],
        "resumed_identical_weights": same_weights, "resumed_identical_moments": same_moments,
    }
    emit(res)
    if not (np.isfinite(losses).all() and np.isfinite(last).all()):
        raise AssertionError(f"non-finite training losses: {res}")
    if len(layouts) != 8:
        raise AssertionError(f"{len(layouts)} backward launches recorded in the first step, expected 8")
    want = {"forward": 8 * steps, "backward": 8 * steps, "flow_grad": 8 * steps, "img_grad": 0}
    if launches != want:
        raise AssertionError(f"single-flow kernel launches {launches} over {steps} steps, expected {want}")
    if not (same_weights and same_moments and (resumed.epoch, resumed.step) == (tr.epoch, tr.step)):
        raise AssertionError(f"the resumed trainer differs from the one that saved: {res}")
    return res


def ptxas_usage(log):
    """{kernel instance: ptxas's register, stack and shared-memory line} from
    an nvcc -Xptxas -v log; instances named by kernel and dtype."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"warp_(?:multiflow|single_forward|single_flow_grad|single_img_grad(?:_store)?)_kernel",
                               mangled)
            dtype = "bf16" if "bfloat16" in mangled else "f32"
            name = f"{kernel.group(0) if kernel else mangled} {dtype}"
        elif name and "registers" in line:
            out[name] = line.split(":", 1)[1].strip()
            name = None
    return out


def check_backward_layouts(cases, recorded):
    """Raise unless the (img, flow, grad_out) strides of every backward
    launch recorded in a train step are those of a gradient kernel case."""
    seen = {(tuple(r["img"]), tuple(r["flow"]), tuple(r["grad_out"])) for r in recorded}
    missing = seen - {tuple(map(tuple, c)) for c in cases}
    emit({"phase": "train_backward_layouts_covered", "layouts": sorted(seen), "missing": sorted(missing)})
    if missing:
        raise AssertionError(f"backward layouts of the train step with no gradient kernel case: {sorted(missing)}")


def kernels_line(kern, single, main_f32, main_bf16, train):
    """Every kernel of the paths with its launches on the main paths, error,
    times, bound, plain and library times."""
    f32, bf16 = kern[("noise", "f32")], kern[("noise", "bf16")]
    mf = {
        "name": "warp_multiflow_planar", "route": "cuda",
        "source": "superslomo_tpu_torch/csrc/warp_multiflow.cu",
        "replaces": "superslomo_tpu/ops/warp_pallas.py:216",
        "launches": main_f32["warp_launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "device_ms": f32["device_ms"], "host_ms": f32["host_ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": f32["library_ms"], "shape": f32["shape"],
        "bf16": {
            "launches": main_bf16["warp_launches"], "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"], "device_ms": bf16["device_ms"], "host_ms": bf16["host_ms"],
            "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "bit_identical_to_f32_cast": bf16["bit_identical_to_f32_cast"],
        },
        "flows": "noise (std 7 px, patches shifted 150 px); the cases below at the same shape",
        "cases": {f"{case}_{tag}": {k: r[k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                      "bound_ms", "planes_strides")}
                  for (case, tag), r in kern.items()},
    }
    ts = single["train_shape"]
    fwd = {
        "name": "warp_single", "route": "cuda", "source": "superslomo_tpu_torch/csrc/warp_single.cu",
        "replaces": "superslomo_tpu/ops/warp_pallas.py:70", "launches": train["launches"]["forward"],
        "max_abs_err": ts["max_abs_err"], "ms": ts["ms"], "device_ms": ts["device_ms"], "host_ms": ts["host_ms"],
        "plain_ms": ts["plain_ms"], "bound_ms": ts["bound_ms"], "bound_by": ts["bound_by"],
        "library_ms": ts["library_ms"], "shape": ts["shape"],
        **{case: {k: single[case][k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms", "bound_ms")}
           for case in ("dense_flow", "smooth_flow", "720p_f32", "720p_bf16")},
    }
    grad_cases = {k[len("grad_"):]: v for k, v in single.items() if k.startswith("grad_")}
    main_case = grad_cases["loss_head"]
    grads = []
    for key, name, launches in (("flow_grad", "warp_single_flow_grad", train["launches"]["flow_grad"]),
                                ("img_grad", "warp_single_img_grad", train["launches"]["img_grad"])):
        r = main_case[key]
        entry = {
            "name": name, "route": "cuda", "source": "superslomo_tpu_torch/csrc/warp_single.cu",
            "replaces": "superslomo_tpu/ops/warp_pallas.py:663", "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_fwd_bwd_ms": r["library_fwd_bwd_ms"], "shape": main_case["shape"],
            "library": "aten.grid_sampler_2d_backward computing this gradient alone",
            "plain": "the plain warp's forward + backward to this input",
            "cases": {case: {k: c[key].get(k) for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                        "bound_ms")}
                      for case, c in grad_cases.items()},
        }
        if key == "flow_grad":
            entry["cases"].update({f"720p_{tag}": {k: single[f"720p_{tag}"]["flow_grad"][k] for k in (
                "max_abs_err", "ms", "device_ms", "host_ms", "library_ms", "bound_ms")} for tag in ("f32", "bf16")})
        grads.append(entry)
    return [mf, fwd, *grads]


def nvidia_smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--kernels-only", action="store_true", help="build, then only the kernel phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "superslomo_tpu_torch")):
        print("chip_smoke: superslomo_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from superslomo_tpu_torch import default_config
    from superslomo_tpu_torch.data.augmentations import Normalize, eval_padding_for
    from superslomo_tpu_torch.ops import cuda_build

    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    cuda_build.build()  # one nvcc per source in csrc/, all at once
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernel_build_s": time.perf_counter() - t0,
        "nvcc_ptxas": {name: ptxas_usage(log) for name, log in cuda_build.build_logs.items()},
    })

    clock_before = nvidia_smi("clocks.sm,clocks.max.sm")
    kern = phase_kernel()
    single = phase_single_kernels()
    emit({"phase": "sm_clock", "before_kernel_phases": clock_before, "after_kernel_phases": nvidia_smi(
        "clocks.sm,clocks.max.sm"), "query": "clocks.sm,clocks.max.sm"})
    if args.kernels_only:
        print(smi, flush=True)
        emit({"kernels_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0
    phase_slice()
    cfg = default_config()
    norm = Normalize(cfg.pixel_mean(), cfg.pixel_std())
    batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=3, B=2, H=720, W=1280, seed=2)
    main_f32 = phase_main_path("float32", batches)
    main_bf16 = phase_main_path("bfloat16", batches)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        phase_train_vs_cpu(ckpt_dir, norm)
        phase_convergence(ckpt_dir)
        train = phase_train_main(ckpt_dir, norm)
    check_backward_layouts(single["layouts"], train["backward_layouts_first_step"])

    kernels = kernels_line(kern, single, main_f32, main_bf16, train)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
