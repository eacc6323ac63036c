#!/usr/bin/env python3
"""Smoke run of the PyTorch port (superslomo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3: build, kernels against plain
    python3 chip_smoke.py --data-only      # phases 1 and 15-17: build, the data path and the CLIs
    python3 chip_smoke.py --render-only    # phases 1 and 18-21: build, the renderer and flow-EPE CLIs
    python3 chip_smoke.py --scale-only     # phases 1 and 22-23: build, native checkpoints, data parallel
    python3 chip_smoke.py --ddp-ranks 4    # phases 1 and 23b-c at 4 ranks (a card a rank on 4 cards)

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
     B=2 with flows beyond +-128 px in f32 and bf16, at odd shapes, and in
     the layouts of a 720p SuperSloMo-R window (B=3: a frame of the f32
     pair, and that frame cast to bf16; phase 7 records the stream's launches
     and the run fails if one has no case here); the
     flow-gradient and image-gradient kernels against autograd of the plain
     version, each alone and launched together, at the training shape in
     each layout the train step's backward launches receive (phase 11 records
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
     ``host_ms``, the host's time to launch one call; then the multi-flow
     warp's backward kernel (csrc/warp_multiflow.cu, through its
     autograd.Function) against its plain version at the serving path's
     shapes: the step's flows with f32 and bf16 planes, noise flows, large
     flows (+-200 px, beyond every block's shared window) and an odd
     strided shape of two channel groups; one kernel call and 3 device
     operations a backward for any n, each gradient alone too; timed beside
     its bound and grid_sample's backward and forward + backward;
  4. serving slice on the card against the same slice on the CPU: the
     full-width model with seeded weights at 128x224, f32 with TF32 off;
  5. serving main path: the Evaluator at 720p (padded to 736), 8x, B=2, over
     two synthetic batches, in f32 and bf16, with the step's time, frames/s
     and peak memory, and the multi-flow kernel's launches counted per step;
  6. the decoder's last upsample of the 720p SuperSloMo-R step (batch 21,
     beyond the CUDA kernel's 32-bit indexing, so written in batch slices)
     bit for bit F.interpolate on the same slices, f32 and bf16; then the
     SuperSloMo-R slice on the card against the CPU
     (configs/superslomo_recurrent.ini's model at 128x224, f32, TF32 off,
     with the CLSTM / CONCAT and the CGRU / SUM bottleneck): two streamed
     windows of a 7-frame clip, each from the last one's state, and the
     fused 7-t step from the first window's state; the predictions and
     every state leaf;
  7. SuperSloMo-R stream: a 30-frame 720p clip as 9 windows at t=0.5 with
     the state carried on the card, bf16 and f32, after 2 warm-up windows:
     window ms, frames/s, peak memory, 4 single-flow launches a window, and
     the layouts those of the first window receive;
  8. SuperSloMo-R main path: the fused 8x step at 720p with a streamed-in
     state, f32 at B=1 and bf16 at B=1 and B=2 (step ms, frames/s, peak
     memory, 4 multi-flow launches a step), bf16 against f32, and the
     Evaluator with the shipped recurrent config over two 4-frame batches;
  9. train step on the card against the same step on the CPU (64x64, B=2,
     f32, panning-texture frames): the loss vector, and the gradient of all
     parameters together;
  10. convergence: 30 steps on an exactly solvable translating scene at
      32x32;
  11. training main path: the Trainer at configs/superslomo_original.ini
      (B=32, 224x224, f32, TF32 off) with seeded weights and random VGG
      features, over synthetic panning-texture batches: 2 warm-up and 10
      timed steps, then 2 steps of the training loop, which saves a
      checkpoint; the single-flow kernels' launches counted per step and the
      strides that each backward launch of the first step receives recorded;
      the checkpoint reloaded and resumed to identical weights and Adam
      moments;
  12. SuperSloMo-R's train step on the card against the CPU
      (configs/superslomo_recurrent.ini's model, CLSTM / CONCAT and CGRU /
      SUM, 64x64, B=2, N_FRAMES=4), with the bars of phase 9;
  13. SuperSloMo-R's training main path: the Trainer at
      configs/superslomo_recurrent.ini as shipped (B=32, 224x224, N_FRAMES=4,
      f32) as in phase 11 but on cuDNN's heuristics (its autotuning at this
      shape takes minutes), then with [TPU] REMAT (a lower peak, the same
      first loss);
  14. bf16 training: the Trainer at configs/superslomo_original.ini with
      [TPU] COMPUTE_DTYPE = bfloat16 as in phase 11: every parameter,
      gradient and Adam moment f32, the first loss beside the f32 one. The
      backward launches' layouts of phases 11, 13 and 14 must each be a
      gradient case of phase 3;
  15. the PNG unfilter (csrc/png_unfilter.cpp, host C++) against its plain
      version on 720p frames that the script encodes itself (zlib and numpy),
      one file per filter type: both equal the written pixels bit for bit;
      the unfilter's and a whole decode's ms, compiled and plain, and a
      decode's on 12 threads;
  16. the eval CLI's main path: ``cli.evaluate_interpolation`` at
      configs/superslomo_eval.ini as shipped (720p padded to 736, B=8, 12
      loader threads, f32) over a made-up dataset of 720p PNGs in a
      temporary directory (one 57-frame clip: 7 sliding windows, one
      batch, fused steps of 2, 2, 2 and 1 samples): its metrics equal
      Evaluator.run on the same batches given explicitly, 4 multi-flow
      launches a fused step, the wall time a batch
      beside the prepared run's and the Loader's; the CLI on the card
      against the CLI on the CPU over a 48x96 clip within the serving bar;
  17. the train CLI's main path: ``cli.train`` at
      configs/superslomo_original.ini as shipped (ALL: ADOBE and NFS clip
      lists naming the 57 frames 280 times each, 80 Vimeo septuplets: 20
      batches, so the Loader keeps decoding through every step; B=32,
      224x224 crops, 12 loader threads), in f32 and bf16, 10 steps through
      the pinned side-stream feed: step ms, the wait for the feed before each
      step, the same Trainer's step on in-memory batches, the Loader's ms a
      batch, 8 single-flow forward and 8 flow-gradient launches a step.
  18. the render CLI's main path: ``cli.visualize`` at
      configs/superslomo_eval.ini's model (CONV, f32, TF32 off) over a
      9-frame 720p panning clip at 8x (8 windows, 65 frames written), and in
      bf16 over 4 windows; the file names and count, every file decoded to
      720x1280, the originals equal to the input frames bit for bit, 4
      multi-flow and no single-flow launch a window; wall s, frames written
      a second, and the ms a window split into decode, fused step (CUDA
      events) and encode;
  19. the same at configs/superslomo_recurrent.ini's model (CLSTM,
      N_FRAMES=4, each window from a zero state) over 3 windows; then
      ``--dump-intermediates`` over 2 windows: the visibility (grey) and
      flow PNGs at the padded 736x1280, 4 single-flow launches a window (the
      forward at t=0.5), their layouts each a case of phase 3's
      ``render_forward_kernel_vs_plain`` (B=1 at 736x1280);
  20. the flow-EPE CLI's main path: ``cli.evaluate_flow`` at
      configs/superslomo_eval.ini over a made-up Sintel clip (8 frames of
      1024x436, padded to 448; 7 .flo ground truths of the panning motion):
      the JSON, 4 single-flow launches a sample, their layouts each a case
      of ``flow_eval_forward_kernel_vs_plain`` (B=1 at 448x1024), the ms a
      sample split into the read and the forward (CUDA events);
  21. both CLIs on the card against ``--device cpu``: the renderer over a
      3-frame 64x96 clip (renders within one level, originals equal), the
      flow evaluator over 2 samples at 52x96 (EPE within 1e-3 px, the >3 px
      share within one pixel's share);
  22. (run after phase 14, on phase 11's Trainer and .pt) the JAX package's
      native checkpoint directory: the Trainer writes one with its Adam state
      and a fresh Trainer resumes from it to the writer's weights, Adam
      moments and steps, epoch and step, bit for bit, and to its next
      step's loss (8 + 8 single-flow launches); ``cli.convert_checkpoint``
      turns the .pt into a directory that loads to the .pt's tensors, bit for
      bit; the write and read seconds of the stage and optimizer files;
  23. (run after phase 17, over its datasets) data parallel across ranks:
      (a) ``python -m torch.distributed.run --nproc-per-node 1 -m
      superslomo_tpu_torch.cli.train`` over NCCL, world 1, 3 steps at B=4,
      its losses against the single-process CLI's; (b) 2 ranks at B=8 (4 a
      rank), 224x224, 2 steps on cuDNN's heuristics, one card a rank over
      NCCL where there are two, else both on the one card over gloo: the
      first step's all-reduced gradients and the losses against the
      single-process Trainer, the ranks' weights bit-identical, 8 + 8
      single-flow launches a step a rank, the step and backward ms; (c)
      ``cli.evaluate_interpolation`` at 2 ranks over phase 16's 48x96 clip
      against the single-process CLI, 4 multi-flow launches a fused step a
      rank.
One JSON object per line; the last line is the run's verdict. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result. Phases 2 and 3, up to the multi-flow warp's gradients,
use only wrapper calls that earlier versions of the package have too, so a
copy of this script placed in an older checkout runs them there
(``--kernels-only``) for a same-card comparison.
"""

import argparse
import configparser
import contextlib
import json
import os
import pickle
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

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
# the bf16 train step's total loss against the f32 step's on the same weights
# and batch: a sanity bar (bf16 keeps 8 bits; the losses average 150k pixels)
BF16_LOSS_REL = 1e-2


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


def multiflow_grad_bound(B, C, n, H, W, esize):
    """Least time of the multi-flow warp's backward, as (ms, bound_by): the
    planes, u, v and the output gradient read once, the three gradients
    written once, against the f32 operations per (pixel, flow): 12 for the
    position and weights, per channel 12 for the flow gradient's taps and 8
    for the image gradient's scatter."""
    nbytes = 2 * B * C * H * W * esize + 4 * B * n * H * W * 4 + B * C * n * H * W * esize
    ops = B * n * H * W * (12 + 20 * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def multiflow_grad_cases():
    """(case, dtype tag, planes, u, v, output gradient) of the multi-flow
    backward at the serving path's shapes (736x1280, B=2, C=3, n=7): the
    step's kind of flows with f32 and bf16 planes; noise flows (std 7 px,
    patches shifted 150 px, as phase 2's); large flows (uniform within +-200
    px: most taps beyond any block's shared window); and an odd case (37x53,
    n=3: ragged tiles, no vector access) on a channels_last view of all six
    channels of a pair (two channel groups) with flows up to ~90 px."""
    B, C, n, H, W = 2, 3, 7, 736, 1280
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    su, sv = step_flows(np.random.default_rng(22), B, n, H, W, dev)
    planes = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, C, n, H, W), dtype=np.float32)).to(dev)
    nu = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    nv = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    nu[:, :, 200:400, 300:600] += 150.0
    nv[:, :, 400:600, 100:400] -= 140.0
    lu, lv = (rng.uniform(-200.0, 200.0, (B, n, H, W)).astype(np.float32) for _ in range(2))
    ou, ov = step_flows(np.random.default_rng(23), 1, 3, 37, 53, dev, amp=90.0)
    pair = torch.from_numpy(rng.standard_normal((1, 37, 53, 6), dtype=np.float32)).to(dev).permute(0, 3, 1, 2)
    og = torch.from_numpy(rng.standard_normal((1, 6, 3, 37, 53), dtype=np.float32)).to(dev)
    gpu = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return [
        ("step_flows", "f32", planes, su, sv, g),
        ("step_flows", "bf16", planes.bfloat16(), su, sv, g.bfloat16()),
        ("noise", "f32", planes, gpu(nu), gpu(nv), g),
        ("large_flows", "f32", planes, gpu(lu), gpu(lv), g),
        ("odd_strided", "f32", pair, ou, ov, og),
        ("odd_strided", "bf16", pair.bfloat16(), ou, ov, og.bfloat16()),
    ]


def check_mf_grads(got, want, dtype):
    """{name: max |err|, bar} of the multi-flow gradients ``got`` (planes, u, v;
    None where not asked for) against the plain version's f32 ``want``, and
    whether all are within GRAD_KERNEL_REL of each reference's max |g| (the
    planes' gradient of bf16 planes: plus its one rounding to bf16, half a
    bf16 ulp, at most 2^-8 of the value)."""
    errs, ok = {}, True
    for name, a, w in zip(("planes", "u", "v"), got, want):
        if a is None:
            continue
        bar = GRAD_KERNEL_REL * w.abs().max().item()
        tol = bar + (2.0**-8 * w.abs() if name == "planes" and dtype == torch.bfloat16 else 0.0)
        errs[name] = {"max_abs_err": (a.float() - w).abs().max().item(), "bar": bar}
        ok &= bool(((a.float() - w).abs() <= tol).all())
    return errs, ok


def phase_multiflow_grad():
    """The multi-flow warp's backward kernel (through its autograd.Function,
    as a caller differentiates the warp) against its plain version, in the
    cases of ``multiflow_grad_cases``: the planes', u's and v's gradients
    each within GRAD_KERNEL_REL of the plain f32 gradient's max |g| (bf16
    planes: plus the one rounding to bf16); one kernel call and 3 device
    operations a backward, no single-flow gradient launch; the planes' or
    the flows' gradients alone (the step's flows and the odd case). The
    720p cases timed: the backward through autograd and the wrapper alone
    (``kernel``: ms, device_ms, host_ms), forward + backward, each beside the
    plain version's and the library's: grid_sample with the n flows folded
    into the batch, whose backward (``aten.grid_sampler_2d_backward``, both
    gradients) computes the same gradients but the planes' sum over the
    flows; and the bound."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda as kernel
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as single

    plain = ops.warp_multiflow_backward_reference
    out = {}
    for case, tag, p, u, v, g in multiflow_grad_cases():
        B, C, H, W = p.shape
        n = u.shape[1]
        leaves = [x.detach().requires_grad_(True) for x in (p, u, v)]
        result = ops.warp_multiflow_planar(*leaves)
        single.flow_grad_launches = single.img_grad_launches = kernel.launches = ops._WarpMultiflow.launches = 0
        got = torch.autograd.grad(result, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        launches = {"kernel": kernel.launches, "multiflow_backward": ops._WarpMultiflow.launches,
                    "flow_grad": single.flow_grad_launches, "img_grad": single.img_grad_launches}
        # the plain version in f32 (for bf16 planes, of their exact values)
        want = plain(p.float(), u, v, g.float(), True, True)
        errs, ok = check_mf_grads(got, want, p.dtype)
        ok &= result.grad_fn is not None and all(a.dtype == x.dtype for a, x in zip(got, leaves))
        ok &= launches == {"kernel": 1, "multiflow_backward": 3, "flow_grad": 0, "img_grad": 0}
        res = {"shape": [B, C, n, H, W], "planes_strides": list(p.stride()), "launches": launches,
               "grad_fn": type(result.grad_fn).__name__, "grads": errs,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "max_abs_flow": max(u.abs().max().item(), v.abs().max().item())}
        if case in ("step_flows", "odd_strided"):  # each gradient alone: one kernel launch, 3 or 1 operations
            subsets = {}
            for need_planes, need_flow in ((True, False), (False, True)):
                kernel.launches = kernel.operations = 0
                sub = kernel(p, u, v, g, need_planes, need_flow)
                torch.cuda.synchronize()
                e, sub_ok = check_mf_grads(sub, want, p.dtype)
                sub_ok &= (kernel.launches, kernel.operations) == (1, 3 if need_planes else 1)
                sub_ok &= all((a is None) == (not need) for a, need in zip(sub, (need_planes, need_flow, need_flow)))
                subsets["planes" if need_planes else "flows"] = {"grads": e, "ok": sub_ok,
                                                                  "operations": kernel.operations}
                ok &= sub_ok
            res["alone"] = subsets
        if H == 736:
            res.update(time_mf_grad(p, u, v, g, result, leaves))
        out[(case, tag)] = res
        emit({"phase": "multiflow_grad_vs_plain", "case": case, "dtype": tag, **res})
        if not ok:
            raise AssertionError(f"multi-flow warp gradients on the card, {case} {tag}: {res}")
        del result, got, want, leaves
        torch.cuda.empty_cache()
    return out


def time_mf_grad(p, u, v, g, result, leaves):
    """The multi-flow backward's times (see phase_multiflow_grad) beside its
    bound, the plain version's and the library's."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda as kernel

    B, C, H, W = p.shape
    n = u.shape[1]

    def fwd_bwd():
        xs = [x.detach().requires_grad_(True) for x in (p, u, v)]
        torch.autograd.grad(ops.warp_multiflow_planar(*xs), xs, g)

    def plain_fwd_bwd():
        xs = [x.detach().float().requires_grad_(True) for x in (p, u, v)]
        torch.autograd.grad(ops.warp_multiflow_planar_reference(*xs, torch.float32), xs, g.float())

    gx = 2 * (torch.arange(W, device=p.device) + u) / (W - 1) - 1
    gy = 2 * (torch.arange(H, device=p.device)[:, None] + v) / (H - 1) - 1
    grid = torch.stack([gx, gy], dim=-1).reshape(B * n, H, W, 2)
    tiled = p.float()[:, None].expand(B, n, C, H, W).reshape(B * n, C, H, W)
    g_lib = g.float().transpose(1, 2).reshape(B * n, C, H, W)

    def library():  # f32: a bf16 grid could not address 1280 columns
        xs = [tiled.detach().requires_grad_(True), grid.detach().requires_grad_(True)]
        torch.autograd.grad(_grid_sample(*xs), xs, g_lib)

    def library_bwd():
        torch.ops.aten.grid_sampler_2d_backward(g_lib, tiled, grid, 0, 0, True, [True, True])

    bound = multiflow_grad_bound(B, C, n, H, W, p.element_size())
    return {
        "backward": timings(lambda: torch.autograd.grad(result, leaves, g, retain_graph=True)),
        "kernel": timings(lambda: kernel(p, u, v, g, True, True)),
        "fwd_bwd": timings(fwd_bwd), "plain_fwd_bwd_ms": cuda_ms(plain_fwd_bwd, reps=5, warmup=1),
        "plain_backward_ms": cuda_ms(lambda: ops.warp_multiflow_backward_reference(p, u, v, g, True, True),
                                     reps=5, warmup=1),
        "library_fwd_bwd_ms": cuda_ms(library), "library_backward_ms": cuda_ms(library_bwd),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library": "grid_sample on the planes tiled n times, f32: its backward to the tiles and the grid",
    }


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


def time_grads(img, flow, g, bounds):
    """Each gradient kernel's ms / device_ms / host_ms beside its bound,
    grid_sample's backward computing the same gradient alone
    (``library_ms``) and grid_sample forward + backward
    (``library_fwd_bwd_ms``). The library runs in the image's dtype: for a
    bf16 image its grid is bf16 too (grid_sample takes one dtype), which
    rounds the sample positions, so its time is that of a nearby function."""
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd

    out = {}
    grid = _grid_for(flow).to(img.dtype)
    for key, need_img, mask in (("flow_grad", False, [False, True]), ("img_grad", True, [True, False])):
        r = {**timings(lambda: bwd(img, flow, g, need_img, not need_img)),
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
             "library_ms": cuda_ms(lambda: _library_grads(img, grid, g, mask)),
             "library_dtype": str(img.dtype).replace("torch.", "")}

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

    # the gradient kernels in the layouts the train steps' 8 backward
    # launches receive (the train phases record them, and main() checks that
    # each is a case here): the image a frame of the pair (pixel stride 6);
    # the flow a head's (stride 4: the stage-1 warp loss) or a dense
    # channels_last sum (stride 2: the interpolated and refined flows); the
    # output gradient NCHW (the warp losses), a slice of the NCHW gradient of
    # the 16-channel stage-2 input, or dense channels_last (the final warps'
    # blend). Under bf16 compute the stage-2 input's warps take the frame
    # cast to bf16 (dense channels_last) and their output gradient cast to
    # bf16 (dense, NCHW or channels_last)
    g3 = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    g16 = torch.from_numpy(rng.standard_normal((B, 16, H, W), dtype=np.float32)).to(dev)[:, 3:6]
    g3_cl = _channels_last(rng, B, C, H, W, dev)
    img_bf16 = img.to(torch.bfloat16)
    if img_bf16.stride() != (3 * H * W, 1, 3 * W, 3):
        raise AssertionError(f"the pair's frame cast to bf16 is not dense channels_last: {img_bf16.stride()}")
    grad_cases = {
        "loss_head": (img, flow, g3), "loss_refined": (img, flow2, g3), "final": (img, flow2, g3_cl),
        "stage2_input": (img, flow2, g16), "smooth_loss_head": (img, flow_s, g3),
        "bf16_loss_head": (pairs.bfloat16()[:, 3:6], flow, g3.bfloat16()),
        "bf16_stage2_input_nchw": (img_bf16, flow2, g16.bfloat16()),
        "bf16_stage2_input_channels_last": (img_bf16, flow2, g3_cl.bfloat16()),
    }
    for case, (im, fl, g) in grad_cases.items():
        r = check_grads(case, im, fl, g)
        r.update({k: dict(r[k], **v) for k, v in time_grads(
            im, fl, g, single_bounds(B, C, H, W, im.element_size())).items()})
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
    res["layouts"] = sorted({backward_layout(im, fl, g) for im, fl, g in grad_cases.values()})

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


def forward_layout(img, flow):
    """What a single-flow forward launch's plan and reads depend on: the
    image's dtype, shape, strides and address mod 16, the flow's strides and
    address mod 16."""
    return (str(img.dtype), tuple(img.shape), tuple(img.stride()), img.data_ptr() % 16,
            tuple(flow.stride()), flow.data_ptr() % 16)


class _RecordForwardLayouts:
    """For the ``with`` block, the single-flow forward's launches through
    ``ops._WarpSingle`` record their layouts (``forward_layout``) in
    ``layouts``."""

    def __enter__(self):
        from superslomo_tpu_torch import ops

        self.ops, self.inner, self.layouts = ops, ops.warp_single_cuda, []

        def recording(img, flow):
            self.layouts.append(forward_layout(img, flow))
            return self.inner(img, flow)

        ops.warp_single_cuda = recording  # the name _WarpSingle.forward calls
        return self

    def __exit__(self, *exc):
        self.ops.warp_single_cuda = self.inner


def single_forward_cases(phase, B, H, W, tags=("f32", "bf16")):
    """The single-flow forward in the layouts of a window's forward at
    (B, 3, H, W): a frame of the f32 pair (pixel stride 6, at channel 0 or
    3) and, with the tag ``bf16``, the same frame cast to bf16 (dense
    channels_last, the stage-2 input's warps under bf16), with a dense
    2-channel channels_last flow. f32 against the plain warp; bf16 bit for
    bit the f32 result cast, and within one bf16 ulp of the plain warp.
    Returns the cases and their layouts (``forward_layout``), which main()
    holds a path's launches to."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    C = 3
    pairs = _channels_last(rng, B, 6, H, W, dev)
    flow = torch.from_numpy(_flow_field(rng, B, H, W, 7.0, 150.0)).to(dev).permute(0, 3, 1, 2)
    grid = _grid_for(flow)
    cases, layouts = {}, set()
    for frame, sl in (("img0", slice(0, 3)), ("img1", slice(3, 6))):
        for tag in tags:
            im = pairs[:, sl] if tag == "f32" else pairs[:, sl].to(torch.bfloat16)
            got = warp_single_cuda(im, flow)
            want = ops.warp_single_reference(im, flow)
            torch.cuda.synchronize()
            bounds = single_bounds(B, C, H, W, im.element_size())
            case = {
                "shape": [B, C, H, W], "img_strides": list(im.stride()), "img_offset": im.storage_offset(),
                "flow_strides": list(flow.stride()), "max_abs_err": (got.float() - want.float()).abs().max().item(),
                **timings(lambda: warp_single_cuda(im, flow)),
                "library_ms": cuda_ms(lambda: _grid_sample(im.float(), grid)),
                "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
            }
            if tag == "f32":
                ok = case["max_abs_err"] <= KERNEL_ATOL
            else:
                case["bit_identical_to_f32_cast"] = torch.equal(
                    got.view(torch.int16), warp_single_cuda(im.float(), flow).bfloat16().view(torch.int16))
                ok = case["bit_identical_to_f32_cast"] and (
                    case["max_abs_err"] <= 2.0**-7 * want.float().abs().max().item())  # one bf16 ulp
            cases[f"{frame}_{tag}"] = case
            layouts.add(forward_layout(im, flow))
            emit({"phase": phase, "case": f"{frame}_{tag}", **case})
            if not ok:
                raise AssertionError(f"single-flow forward in a {B}x{H}x{W} window's layout ({frame} {tag}): {case}")
    return {"cases": cases, "layouts": layouts}


def phase_ssmr_forward_cases():
    """The single-flow forward in the layouts of a 720p SuperSloMo-R window
    (B=1, 3 windows: a batch of 3), f32 and bf16 (``single_forward_cases``);
    main() holds the stream's launches to them."""
    return single_forward_cases("ssmr_forward_kernel_vs_plain", 3, 736, 1280)


def phase_render_forward_cases():
    """The single-flow forward in the f32 layouts of the two paths that
    launch it at B=1 (``single_forward_cases``): the renderer's
    intermediates dump at 736x1280 and the flow evaluator at 448x1024 (a
    Sintel frame padded); main() holds those paths' launches to them."""
    render = single_forward_cases("render_forward_kernel_vs_plain", 1, 736, 1280, tags=("f32",))
    flow = single_forward_cases("flow_eval_forward_kernel_vs_plain", 1, 448, 1024, tags=("f32",))
    return {"cases": {**{f"render_dump_{k}": v for k, v in render["cases"].items()},
                      **{f"flow_eval_{k}": v for k, v in flow["cases"].items()}},
            "layouts": render["layouts"] | flow["layouts"]}


def phase_upsample_slices():
    """The decoder's last upsample in SuperSloMo-R's fused 720p step at B=1
    (stage-2 batch 21, 128 channels, channels_last), an output beyond the
    CUDA kernel's 32-bit indexing that ops/resize.py writes a batch slice at
    a time: f32 and bf16, bit for bit ``F.interpolate`` on the same slices."""
    from superslomo_tpu_torch.ops import resize

    N, C, H, W = 21, 128, 368, 640
    step = resize._MAX_ELEMENTS // (C * 4 * H * W)
    if step >= N:
        raise AssertionError(f"a ({N}, {C}, {2 * H}, {2 * W}) output fits one call: no slices to check")
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"phase": "upsample_batch_slices", "shape": [N, C, H, W], "slice_batch": step}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.randn((N, H, W, C), generator=gen, device="cuda").to(dt).permute(0, 3, 1, 2)
        with torch.inference_mode():
            got = resize.upsample_2x_bilinear(x)
            same = all(torch.equal(got[i : i + step], F.interpolate(
                x[i : i + step], scale_factor=2, mode="bilinear", align_corners=False)) for i in range(0, N, step))
        res[tag] = {"bit_identical": same, "channels_last": got.is_contiguous(memory_format=torch.channels_last)}
        del x, got
        torch.cuda.empty_cache()
    emit(res)
    if not all(res[tag]["bit_identical"] and res[tag]["channels_last"] for tag in ("f32", "bf16")):
        raise AssertionError(f"the batch-sliced upsample differs from F.interpolate on its slices: {res}")
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


def panning_clips(rng, B, H, W, n=9):
    """(B, n, H, W, 3) uint8 clips: a smooth random texture panning 3 px a frame."""
    yy, xx = np.mgrid[0:H, 0 : W + 3 * n + 5].astype(np.float32)
    clips = []
    for _ in range(B):
        tex = np.zeros(xx.shape + (3,), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.005, 0.05, 2)
            tex += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None] * rng.uniform(10, 40, 3)
        tex = np.clip(tex + 128, 0, 255).astype(np.uint8)
        clips.append(np.stack([tex[:, 3 * i : 3 * i + W] for i in range(n)]))
    return np.stack(clips)


def synthetic_batches(norm, padding, n_batches, B, H, W, seed, n_frames=2):
    """Reader-shaped evaluation batches of panning clips at 8x: every 8th
    frame of a clip of 8 (n_frames - 1) + 1 is an input (the ends of each
    window), the 7 inner frames of the mid window the targets."""
    rng = np.random.default_rng(seed)
    left, right, top, bottom = padding
    pad = ((0, 0), (0, 0), (top, bottom), (left, right), (0, 0))
    mid = 8 * ((n_frames - 1) // 2)
    out = []
    for _ in range(n_batches):
        x = np.pad(norm(panning_clips(rng, B, H, W, 8 * (n_frames - 1) + 1)), pad)
        out.append((x[:, ::8], x[:, mid + 1 : mid + 8], np.full(B, 7)))
    return out


def synthetic_train_batches(norm, n_batches, B, H, W, seed, n_frames=2):
    """Training batches of panning clips of 8 (n_frames - 1) + 1 frames:
    frames (B, n_frames, H, W, 3), every 8th frame of the clip; per window
    one inner frame as the target (B, n_frames - 1, H, W, 3), and its instant
    t = i/8 (B, n_frames - 1)."""
    rng = np.random.default_rng(seed)
    W_n = n_frames - 1
    out = []
    for _ in range(n_batches):
        x = norm(panning_clips(rng, B, H, W, 8 * W_n + 1))
        i = rng.integers(1, 8, (B, W_n))
        out.append((x[:, ::8], x[np.arange(B)[:, None], 8 * np.arange(W_n) + i], (i / 8).astype(np.float32)))
    return out


def phase_main_path(dtype, batches, steps=8):
    """The Evaluator at 720p 8x over ``batches``, after timing the step."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, default_config, ops, weights
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

    counter.launches = ops._WarpMultiflow.launches = 0
    t0 = time.perf_counter()
    results = Evaluator(cfg, model).run(batches)
    wall = time.perf_counter() - t0
    launches, bwd_launches = counter.launches, ops._WarpMultiflow.launches
    res = {
        "phase": "main_path", "compute_dtype": dtype, "batch": B, "n_t": n_t,
        "frame_hw": list(frames.shape[2:4]), "step_ms_median": statistics.median(times),
        "step_ms": times, "frames_per_s": B * n_t / (statistics.median(times) / 1e3),
        "peak_mem_gib": peak / 2**30, "eval_batches": len(batches), "eval_wall_s": wall,
        "warp_launches": launches, "warp_multiflow_backward_launches": bwd_launches, **results,
    }
    emit(res)
    if launches != 4 * len(batches) or bwd_launches != 0:
        raise AssertionError(f"{launches} warp launches ({bwd_launches} of its backward) over {len(batches)} "
                             "steps, expected 4 per step (none)")
    if not all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"], results["max_flow_bound"]])):
        raise AssertionError(f"non-finite metrics: {results}")
    return res


def ssmr_spec(cell="CLSTM", merge="CONCAT", dtype="float32"):
    """configs/superslomo_recurrent.ini's model (both stages recurrent,
    N_FRAMES=4, cross-stage skip), with ``cell`` in both stages, ``merge``
    and ``dtype``."""
    from superslomo_tpu_torch import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "superslomo_recurrent.ini"))
    cfg.set("DATA", "DATASET", "ADOBE")
    for stage in ("STAGE1", "STAGE2"):
        cfg.set(stage, "BOTTLENECK", cell)
    cfg.set("TPU", "CLSTM_MERGE", merge)
    cfg.set("TPU", "COMPUTE_DTYPE", dtype)
    cfg.validate()
    return cfg


def _carry_leaves(carry):
    return [(f"{stage}/{name}/{i}", leaf) for stage in ("stage1", "stage2")
            for name, state in sorted(carry[stage].items()) for i, leaf in enumerate(state)]


def phase_ssmr_slice():
    """SuperSloMo-R at full width on the card against the CPU, 128x224, f32
    with TF32 off: two streamed windows of a 7-frame clip, each from the
    state the last one left, then the fused 7-t step on the second window
    from the first one's state; the CLSTM / CONCAT and the CGRU / SUM models."""
    from superslomo_tpu_torch import SuperSloMo, weights

    rng = np.random.default_rng(6)
    clip = rng.standard_normal((1, 7, 128, 224, 3), dtype=np.float32)
    windows = (clip[:, 0:4], clip[:, 3:7])
    t = np.full((1, 3), 0.5, np.float32)
    t_values = np.arange(1, 8, dtype=np.float32) / 8
    for cell, merge in (("CLSTM", "CONCAT"), ("CGRU", "SUM")):
        spec = ssmr_spec(cell, merge).model_spec()
        state = weights.seeded_state(spec, seed=0)

        def run(device):
            model = SuperSloMo(spec, device=device).load_state(state)
            mid0, _, carry0 = model.forward_inference(windows[0], t)
            mid1, _, carry1 = model.forward_inference(windows[1], t, carry0)
            pred, bound = model.interpolate_multi_t(windows[1], t_values, rnn_carry=carry0, with_bounds=True)
            leaves = [[(k, v.cpu()) for k, v in _carry_leaves(c)] for c in (carry0, carry1)]
            return [mid0.cpu(), mid1.cpu()], leaves, pred.cpu(), float(bound)

        card, cpu = run(None), run("cpu")
        errs = {f"window{i}_mid": (a - b).abs().max().item() for i, (a, b) in enumerate(zip(card[0], cpu[0]))}
        errs["fused_step"] = (card[2] - cpu[2]).abs().max().item()
        close = all(torch.allclose(a, b, atol=SLICE_ATOL, rtol=SLICE_RTOL) for a, b in zip(card[0], cpu[0]))
        close &= torch.allclose(card[2], cpu[2], atol=SLICE_ATOL, rtol=SLICE_RTOL)
        leaf_err = 0.0
        for got, want in zip(card[1], cpu[1]):
            for (name, a), (_, b) in zip(got, want):
                leaf_err = max(leaf_err, (a.float() - b.float()).abs().max().item())
                close &= torch.allclose(a, b, atol=SLICE_ATOL, rtol=SLICE_RTOL)
        res = {
            "phase": "ssmr_slice_card_vs_cpu", "cell": cell, "merge": merge, "shape": [1, 7, 128, 224, 3],
            "max_abs_err": errs, "carry_leaves": len(card[1][0]), "carry_max_abs_err": leaf_err,
            "bound": card[3], "bound_rel_err": abs(card[3] - cpu[3]) / cpu[3],
            "finite": bool(all(torch.isfinite(x).all() for x in card[0] + [card[2]])),
        }
        emit(res)
        if not (res["finite"] and close and res["bound_rel_err"] <= 1e-4):
            raise AssertionError(f"SSM-R on the card and the CPU disagree: {res}")


def phase_ssmr_stream(dtype, n_clip=30, warmup=2):
    """SuperSloMo-R streaming a 720p clip (736x1280, B=1, ``n_clip`` frames
    made on the card from a seed) as 4-frame windows 3 frames apart at
    t=0.5, each window's state carried on the card into the next
    (``forward_inference``), after ``warmup`` windows: window ms, frames/s
    as windows x 3 / s, peak memory, and the single-flow kernel's launches,
    4 a window; the layouts each launch of the first window receives."""
    from superslomo_tpu_torch import SuperSloMo, ops, weights
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as mf
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as single

    spec = ssmr_spec(dtype=dtype).model_spec()
    model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    clip = torch.randn((1, n_clip, 736, 1280, 3), generator=gen, device="cuda")
    t = torch.full((1, 3), 0.5, device="cuda")
    starts = range(0, n_clip - 3, 3)
    carry = None
    for start in starts[:warmup]:  # cuDNN autotuning happens here
        _, _, carry = model.forward_inference(clip[:, start : start + 4], t, carry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    first = _RecordForwardLayouts()  # the layouts the forward launches of the first window receive
    single.launches = mf.launches = ops._WarpMultiflow.launches = 0
    carry, times, mids = None, [], []
    for start in starts:
        with first if start == 0 else contextlib.nullcontext():
            t0 = time.perf_counter()
            mid, _, carry = model.forward_inference(clip[:, start : start + 4], t, carry)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        mids.append(mid)
    layouts = first.layouts
    launches = {"warp_single": single.launches, "warp_multiflow": mf.launches,
                "warp_multiflow_backward": ops._WarpMultiflow.launches}
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in mids + [leaf for _, leaf in _carry_leaves(carry)])
    n = len(starts)
    res = {
        "phase": "ssmr_stream", "config": "configs/superslomo_recurrent.ini", "compute_dtype": dtype,
        "batch": 1, "clip_frames": n_clip, "frame_hw": [736, 1280], "windows": n, "t": 0.5,
        "window_ms_median": statistics.median(times), "window_ms": times,
        "frames_per_s": n * 3 / (sum(times) / 1e3), "peak_mem_gib": peak / 2**30,
        "launches": launches, "finite": finite, "forward_layouts_first_window": layouts,
    }
    emit(res)
    if not finite:
        raise AssertionError(f"non-finite SSM-R stream output: {res}")
    if len(layouts) != 4:
        raise AssertionError(f"{len(layouts)} forward launches recorded in the first window, expected 4")
    if launches != {"warp_single": 4 * n, "warp_multiflow": 0, "warp_multiflow_backward": 0}:
        raise AssertionError(f"kernel launches {launches} over {n} windows, expected 4 single-flow a window")
    del model, clip
    torch.cuda.empty_cache()
    return res


def phase_ssmr_main_path(batches, steps=8):
    """The fused 8x step of SuperSloMo-R at 720p with a streamed-in state
    (from ``forward_inference`` of the window before): f32 at B=1, bf16 at
    B=1 and B=2; each step's ms (median of ``steps`` after 2 warm-up
    steps), frames/s, peak memory and the multi-flow kernel's launches, 4 a
    step. Then the Evaluator with the f32 model over ``batches`` at B=1,
    and bf16 against f32 on the same input."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, ops, weights
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as mf
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as single

    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    preds, out = {}, []
    for dtype, B in (("float32", 1), ("bfloat16", 1), ("bfloat16", 2)):
        cfg = ssmr_spec(dtype=dtype)
        spec = cfg.model_spec()
        model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
        frames = torch.from_numpy(batches[0][0][:B]).cuda()
        before = torch.from_numpy(batches[1][0][:B]).cuda()
        _, _, carry = model.forward_inference(before, torch.full((B, 3), 0.5, device="cuda"))

        def step():
            return model.interpolate_multi_t(frames, t_values, rnn_carry=carry, with_bounds=True)

        for _ in range(2):  # cuDNN autotuning happens here
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mf.launches = single.launches = ops._WarpMultiflow.launches = 0
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            pred, bound = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {"warp_multiflow": mf.launches, "warp_single": single.launches,
                    "warp_multiflow_backward": ops._WarpMultiflow.launches}
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        res = {
            "phase": "ssmr_main_path", "config": "configs/superslomo_recurrent.ini", "compute_dtype": dtype,
            "batch": B, "n_t": 7, "frame_hw": list(frames.shape[2:4]), "streamed_state": True,
            "step_ms_median": med, "step_ms": times, "frames_per_s": B * 7 / (med / 1e3),
            "peak_mem_gib": peak / 2**30, "launches": launches, "bound": float(bound),
            "finite": bool(torch.isfinite(pred).all()),
        }
        if not res["finite"]:
            raise AssertionError(f"non-finite SSM-R step output: {res}")
        if launches != {"warp_multiflow": 4 * steps, "warp_single": 0, "warp_multiflow_backward": 0}:
            raise AssertionError(f"kernel launches {launches} over {steps} steps, expected 4 multi-flow a step")
        if B == 1:
            preds[dtype] = pred
        if dtype == "float32":  # the shipped config's model under the Evaluator
            mf.launches = ops._WarpMultiflow.launches = 0
            t0 = time.perf_counter()
            results = Evaluator(cfg, model).run([(f[:1], g[:1], n[:1]) for f, g, n in batches])
            res.update(eval_batches=len(batches), eval_batch=1, eval_wall_s=time.perf_counter() - t0,
                       eval_warp_multiflow_launches=mf.launches,
                       eval_warp_multiflow_backward_launches=ops._WarpMultiflow.launches, **results)
            if not all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"]])):
                raise AssertionError(f"non-finite SSM-R metrics: {results}")
            if mf.launches != 4 * len(batches) or ops._WarpMultiflow.launches != 0:
                raise AssertionError(f"{mf.launches} multi-flow launches over {len(batches)} evaluator batches")
        emit(res)
        out.append(res)
        del model, frames, before, carry
        torch.cuda.empty_cache()
    diff = (preds["bfloat16"] - preds["float32"]).abs()
    res = {"phase": "ssmr_bf16_vs_f32", "batch": 1, "max_abs_diff": diff.max().item(),
           "mean_abs_diff": diff.mean().item(), "finite": bool(torch.isfinite(diff).all())}
    emit(res)
    if not (res["finite"] and res["mean_abs_diff"] <= 0.01):
        raise AssertionError(f"SSM-R bf16 and f32 steps disagree: {res}")
    return out


def _train_config(ckpt_dir, path=None, **overrides):
    from superslomo_tpu_torch import default_config, load_config

    cfg = load_config(path) if path else default_config()
    cfg.set("TRAIN", "ALLOW_RANDOM_VGG", "TRUE")  # no VGG-16 file ships with the repo
    cfg.set("TRAIN", "CKPT_DIR", ckpt_dir)
    for key, value in overrides.items():
        section, _, k = key.partition("_")
        cfg.set(section, k, value)
    return cfg


def train_step_card_vs_cpu(phase, cfg, batch, **facts):
    """One train step of the Trainer at ``cfg`` on the card against the same
    step on the CPU: the loss vector within the CPU test's 1e-4, and the
    gradient of all parameters together within its 1e-3, as a relative L2
    error. Per tensor the max-relative error is reported beside the same
    quantity between two CPU steps whose frames differ by 1e-5: the step's
    gradient is discontinuous (the warp's floor, the leaky ReLU's and max
    pool's switches, the L1 kinks), and in the deep layers, which see few
    positions at 64x64, one switch moves a tensor's gradient by a visible
    share of its max, on the CPU alone as much as between two devices."""
    from superslomo_tpu_torch import Trainer

    frames, targets, t = batch

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
        "phase": phase, **facts, "shape": list(frames.shape),
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
    return res


def phase_train_vs_cpu(ckpt_dir, norm):
    """The CONV train step on the card against the CPU (64x64, B=2, f32,
    panning-texture frames)."""
    batch = synthetic_train_batches(norm, n_batches=1, B=2, H=64, W=64, seed=4)[0]
    cfg = _train_config(ckpt_dir, TRAIN_BATCH_SIZE=2, TRAIN_CROP_IMH=64, TRAIN_CROP_IMW=64)
    return train_step_card_vs_cpu("train_step_card_vs_cpu", cfg, batch)


def phase_ssmr_train_vs_cpu(ckpt_dir, norm):
    """The SuperSloMo-R train step on the card against the CPU:
    configs/superslomo_recurrent.ini's model with the CLSTM / CONCAT and the
    CGRU / SUM bottleneck in both stages, 64x64, B=2, N_FRAMES=4 (3 windows,
    the recurrence from a zero state), f32, panning-texture frames."""
    batch = synthetic_train_batches(norm, n_batches=1, B=2, H=64, W=64, seed=14, n_frames=4)[0]
    out = []
    for cell, merge in (("CLSTM", "CONCAT"), ("CGRU", "SUM")):
        cfg = _train_config(ckpt_dir, _config_path("superslomo_recurrent.ini"), TRAIN_BATCH_SIZE=2,
                            TRAIN_CROP_IMH=64, TRAIN_CROP_IMW=64, STAGE1_BOTTLENECK=cell, STAGE2_BOTTLENECK=cell,
                            TPU_CLSTM_MERGE=merge)
        out.append(train_step_card_vs_cpu("ssmr_train_step_card_vs_cpu", cfg, batch, cell=cell, merge=merge))
    return out


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


def _config_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)


def backward_layout(img, flow, grad_out):
    """What a gradient launch's plans and reads depend on: the image's dtype
    and the strides of the image, the flow and the output gradient."""
    return (str(img.dtype).replace("torch.", ""), tuple(img.stride()), tuple(flow.stride()), tuple(grad_out.stride()))


def single_counts():
    """The single-flow kernels' launch counts, and the multi-flow backward's."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as fwd

    return {"forward": fwd.launches, "backward": bwd.launches, "flow_grad": bwd.flow_grad_launches,
            "img_grad": bwd.img_grad_launches, "multiflow_backward": ops._WarpMultiflow.launches}


def reset_single_counts():
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as fwd

    fwd.launches = bwd.launches = bwd.flow_grad_launches = bwd.img_grad_launches = ops._WarpMultiflow.launches = 0


def train_step_launches(steps):
    """What ``steps`` train steps launch: 8 single-flow forward and 8
    flow-gradient launches a step, no image gradient, no multi-flow
    backward."""
    return {"forward": 8 * steps, "backward": 8 * steps, "flow_grad": 8 * steps, "img_grad": 0,
            "multiflow_backward": 0}


def trainer_main_path(phase, ckpt_dir, config, norm, timed=10, resume=True, cudnn_benchmark=True,
                      keep_checkpoint=False, **overrides):
    """The Trainer at ``configs/<config>`` (with ``overrides``) over
    synthetic batches at its batch, crop and N_FRAMES: 2 warm-up and
    ``timed`` timed steps; with ``resume`` then 2 steps of ``train``, which
    saves a checkpoint, reloaded and resumed. Counts the single-flow
    kernels' launches over every step, records the layout that each backward
    launch of the first step receives and the (input, weight) dtypes each
    conv computes in, keeps the first step's gradients (on the host), and
    checks that the U-Net convs compute in the compute dtype on f32 weights,
    the VGG's in f32, and that the parameters, their gradients and Adam's
    moments are f32. ``cudnn_benchmark=False`` runs the steps on cuDNN's
    heuristics in place of the autotuning that building a model on the card
    switches on (restored at the end). ``keep_checkpoint`` leaves the saved
    ``.pt`` (``checkpoint`` in the result) on disk. Returns the result,
    the trainer and the first step's gradients (the optimizer's order)."""
    from superslomo_tpu_torch import Trainer, ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd

    t_setup = time.perf_counter()
    cfg = _train_config(ckpt_dir, _config_path(config), **overrides)
    B, H, W = cfg.getint("TRAIN", "BATCH_SIZE"), cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")
    n_frames = cfg.n_frames()
    batches = synthetic_train_batches(norm, n_batches=3, B=B, H=H, W=W, seed=5, n_frames=n_frames)
    tr = Trainer(cfg, expt_name=phase)
    torch.backends.cudnn.benchmark = cudnn_benchmark
    setup_s = time.perf_counter() - t_setup

    # the layout each backward launch of the first step receives
    layouts = []

    def recording_bwd(img, flow, grad_out, need_img, need_flow):
        layouts.append({"layout": backward_layout(img, flow, grad_out), "grad_out_offset": grad_out.storage_offset(),
                        "need_img": need_img, "need_flow": need_flow})
        return bwd(img, flow, grad_out, need_img, need_flow)

    # the (input, weight) dtypes each conv computes in, in the first step
    conv_dtypes = {}

    def recording_conv(name):
        def hook(module, args):
            conv_dtypes.setdefault(name, set()).add(tuple(str(x.dtype)[6:] for x in (args[0], module.weight)))
        return hook

    convs = {f"{stage}.{k}": m for stage in ("stage1", "stage2")
             for k, m in getattr(tr.model, stage).named_modules() if isinstance(m, torch.nn.Conv2d)}
    convs.update({f"vgg.{k}": m for k, m in tr.vgg.named_modules() if isinstance(m, torch.nn.Conv2d)})
    hooks = [m.register_forward_pre_hook(recording_conv(k)) for k, m in convs.items()]

    params = [p for g in tr.optimizer.param_groups for p in g["params"]]
    reset_single_counts()
    losses, times = [], []
    try:
        for i in range(2 + timed):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ops.warp_single_backward_cuda = recording_bwd if i == 0 else bwd  # the name _WarpSingle.backward calls
            t0 = time.perf_counter()
            losses.append(tr.train_step(*batches[i % len(batches)]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                for h in hooks:
                    h.remove()
                first_grads = [p.grad.to("cpu", copy=True) for p in params]  # off the card: not in its peak
    finally:
        ops.warp_single_backward_cuda = bwd
    warmup_ms, times = times[:2], times[2:]
    peak = torch.cuda.max_memory_allocated()
    steps = 2 + timed
    cdt = tr.spec.compute_dtype
    want_dtypes = {k: {("float32" if k.startswith("vgg.") else cdt, "float32")} for k in convs}
    conv_dtypes_ok = conv_dtypes == want_dtypes
    all_f32 = (all(p.dtype == p.grad.dtype == torch.float32 for p in params)
               and all(tr.optimizer.state[p][k].dtype == torch.float32 for p in params
                       for k in ("exp_avg", "exp_avg_sq")))
    res = {"phase": phase, "config": f"configs/{config}", "overrides": overrides, "batch": B, "crop_hw": [H, W],
           "n_frames": n_frames, "compute_dtype": tr.spec.compute_dtype, "remat": tr.spec.remat,
           "cudnn_benchmark": cudnn_benchmark}
    t_resume = time.perf_counter()
    if resume:
        last = tr.train(batches[:1], max_steps=tr.step + 2)  # two epochs of one batch; saves at the end
        steps += 2
        path = tr.checkpoint_path(tr.epoch)
        resumed = Trainer(_train_config(ckpt_dir, _config_path(config), STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=path,
                                        STAGE2_LOADPREV="TRUE", STAGE2_WEIGHTS=path, **overrides),
                          expt_name=f"{phase}_resumed")
        torch.backends.cudnn.benchmark = cudnn_benchmark
        same_weights = all(
            torch.equal(a, b) for stage in ("stage1", "stage2")
            for a, b in zip(getattr(tr.model, stage).state_dict().values(),
                            getattr(resumed.model, stage).state_dict().values()))
        same_moments = all(
            torch.equal(tr.optimizer.state[p][key], resumed.optimizer.state[q][key])
            for p, q in zip(tr.optimizer.param_groups[0]["params"], resumed.optimizer.param_groups[0]["params"])
            for key in ("exp_avg", "exp_avg_sq"))
        res.update(loss_last=last.tolist(), checkpoint_mib=os.path.getsize(path) / 2**20,
                   resumed_epoch_step=[resumed.epoch, resumed.step], resumed_identical_weights=same_weights,
                   resumed_identical_moments=same_moments, checkpoint=path)
        if not keep_checkpoint:
            os.remove(path)
        del resumed
        res["train_save_resume_s"] = time.perf_counter() - t_resume
    torch.backends.cudnn.benchmark = True
    launches = single_counts()
    losses = torch.stack(losses).cpu().numpy()
    med = statistics.median(times)
    res.update({
        "steps": steps, "step_ms_median": med, "step_ms": times, "samples_per_s": B / (med / 1e3),
        "setup_s": setup_s, "warmup_step_ms": warmup_ms,
        "peak_mem_gib": peak / 2**30, "loss_first": losses[0].tolist(), "loss_second": losses[1].tolist(),
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "params_grads_moments_f32": all_f32, "backward_layouts_first_step": layouts,
        "conv_input_weight_dtypes_first_step": sorted({f"{'vgg' if k.startswith('vgg.') else 'unet'}: {a}/{w}"
                                                       for k, v in conv_dtypes.items() for a, w in v}),
        "conv_dtypes_as_expected": conv_dtypes_ok, "convs_recorded": len(conv_dtypes),
    })
    emit(res)
    if not (np.isfinite(losses).all() and np.isfinite(res.get("loss_last", 0.0)).all()):
        raise AssertionError(f"non-finite training losses: {res}")
    if len(layouts) != 8:
        raise AssertionError(f"{len(layouts)} backward launches recorded in the first step, expected 8")
    if launches != train_step_launches(steps):
        raise AssertionError(f"single-flow kernel launches {launches} over {steps} steps, expected "
                             f"{train_step_launches(steps)}")
    if not all_f32:
        raise AssertionError(f"a parameter, gradient or Adam moment is not float32: {res}")
    if not conv_dtypes_ok:
        wrong = {k: sorted(v) for k, v in conv_dtypes.items() if v != want_dtypes.get(k)}
        raise AssertionError(f"convs computing in other dtypes than {cdt} (U-Net) and float32 (VGG) on float32 "
                             f"weights, or not run: {wrong}, {sorted(set(convs) - set(conv_dtypes))}")
    if resume and not (res["resumed_identical_weights"] and res["resumed_identical_moments"]
                       and res["resumed_epoch_step"] == [tr.epoch, tr.step]):
        raise AssertionError(f"the resumed trainer differs from the one that saved: {res}")
    return res, tr, first_grads


def phase_train_main(ckpt_dir, norm):
    """The Trainer at the shipped training config (configs/superslomo_original.ini,
    B=32, 224x224, f32); returns the result and the Trainer, whose ``.pt``
    stays for phase 22."""
    res, tr, _ = trainer_main_path("train_main_path", ckpt_dir, "superslomo_original.ini", norm,
                                   keep_checkpoint=True)
    return res, tr


def phase_ssmr_train_main(ckpt_dir, norm):
    """SuperSloMo-R's Trainer at configs/superslomo_recurrent.ini as shipped
    (B=32, 224x224, N_FRAMES=4: 96 windows a step, f32, CLSTM in both
    stages), then the same with ``[TPU] REMAT``: its peak memory below the
    run without it; its first step's gradients (the same weights and batch),
    which REMAT computes from the recomputed activations, each within
    GRAD_REL of that tensor's max |g| in the run without it; and its second
    step's loss, after an Adam update from those gradients, within
    LOSS_RTOL. On cuDNN's heuristics, which keep the
    run inside its time limit: at this shape cuDNN's autotuning took 354 s
    before the first step on an NVIDIA H100 80GB HBM3 at 700 W (the steps
    after it 18% faster; PERF.md)."""
    res, tr, grads = trainer_main_path("ssmr_train_main_path", ckpt_dir, "superslomo_recurrent.ini", norm,
                                       cudnn_benchmark=False)
    del tr
    torch.cuda.empty_cache()
    remat, tr, grads_remat = trainer_main_path("ssmr_train_main_path_remat", ckpt_dir, "superslomo_recurrent.ini",
                                               norm, timed=5, resume=False, cudnn_benchmark=False, TPU_REMAT="TRUE")
    del tr
    torch.cuda.empty_cache()
    # each tensor's max |difference| as a share of its max |g| in the run without REMAT
    grad_rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(grads_remat, grads)]
    del grads, grads_remat
    rel = lambda key: float(np.max(np.abs(np.asarray(remat[key]) - res[key]) / np.abs(res[key])))  # noqa: E731
    cmp = {"phase": "ssmr_train_remat_vs_plain", "peak_mem_gib": [res["peak_mem_gib"], remat["peak_mem_gib"]],
           "step_ms_median": [res["step_ms_median"], remat["step_ms_median"]],
           "first_loss_max_rel_diff": rel("loss_first"), "second_loss_max_rel_diff": rel("loss_second"),
           "first_grads_max_rel_diff": max(grad_rel), "first_grads_tensors": len(grad_rel),
           "first_grads_bit_identical": sum(r == 0.0 for r in grad_rel)}
    emit(cmp)
    if not (cmp["first_loss_max_rel_diff"] <= LOSS_RTOL and cmp["second_loss_max_rel_diff"] <= LOSS_RTOL
            and cmp["first_grads_max_rel_diff"] <= GRAD_REL and remat["peak_mem_gib"] < res["peak_mem_gib"]):
        raise AssertionError(f"REMAT changes the loss or the gradients or does not lower the peak: {cmp}")
    return res, remat


def phase_bf16_train_main(ckpt_dir, norm, f32_first_loss):
    """The Trainer at configs/superslomo_original.ini with ``[TPU]
    COMPUTE_DTYPE = bfloat16`` (B=32, 224x224): bf16 convs on float32 master
    weights: every U-Net conv gets a bf16 input and the VGG's f32 (``trainer_main_path`` records and checks it). Its
    first step's loss against the f32 one of the same weights and batch
    (``f32_first_loss``), within BF16_LOSS_REL of the total."""
    res, tr, _ = trainer_main_path("bf16_train_main_path", ckpt_dir, "superslomo_original.ini", norm,
                                   TPU_COMPUTE_DTYPE="bfloat16")
    params = list(tr.model.parameters())
    res["param_dtypes"] = sorted({str(p.dtype) for p in params})
    del tr
    torch.cuda.empty_cache()
    f32 = np.asarray(f32_first_loss)
    res["first_loss_f32"] = f32.tolist()
    res["first_loss_rel_diff_to_f32"] = (np.abs(np.asarray(res["loss_first"]) - f32) / np.abs(f32)).tolist()
    emit({"phase": "bf16_train_first_loss_vs_f32", "bf16": res["loss_first"], "f32": f32.tolist(),
          "rel_diff": res["first_loss_rel_diff_to_f32"]})
    if res["param_dtypes"] != ["torch.float32"] or res["first_loss_rel_diff_to_f32"][0] > BF16_LOSS_REL:
        raise AssertionError(f"bf16 training: {res}")
    return res


# --------------------------------------------------------------------------- #
# the data path and the command lines (phases 15-17)

FILTERS = ("none", "sub", "up", "average", "paeth")


def png_bytes(rgb, ft, level=1):
    """A (H, W, 3) uint8 image as an 8-bit RGB PNG, every row with filter type
    ``ft`` (0-4), deflated at ``level``: the stdlib's zlib and numpy only (at
    ``ft=1``, level 1, what cv2.imwrite writes)."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int32)
    up = np.vstack([np.zeros((1, w * 3), np.int32), x[:-1]])
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    c = np.zeros_like(x)
    c[:, 3:] = up[:, :-3]
    if ft == 4:
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    else:
        pred = (0, a, up, (a + up) >> 1)[ft]
    rows = np.hstack([np.full((h, 1), ft, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)])

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path, rgb, ft=1):
    with open(path, "wb") as f:
        f.write(png_bytes(rgb, ft))


def write_clip(folder, frames, name="frame_{:05d}.png", start=0):
    """``frames`` as PNG files (Sub rows, zlib level 1) in ``folder``, named
    ``name`` with their index from ``start``."""
    os.makedirs(folder)
    for i, img in enumerate(frames, start=start):
        write_png(os.path.join(folder, name.format(i)), img)


def phase_png_unfilter(H=720, W=1280, reps=5):
    """The compiled PNG unfilter (csrc/png_unfilter.cpp) against its plain
    version on a 720p panning-texture frame written with each filter type on
    every row: both equal the written pixels bit for bit. Times: the
    unfilter alone, compiled (median of ``reps``) and plain (one call); a whole
    decode (``png.imread``, median of ``reps``) and a plain one (inflate +
    plain unfilter); and 24 decodes of the Sub frame on 12 threads (the
    unfilter and zlib release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from superslomo_tpu_torch.data import png

    frame = panning_clips(np.random.default_rng(21), 1, H, W, n=1)[0, 0]
    want = frame.reshape(H, W * 3)
    out = {"phase": "png_unfilter_vs_plain", "frame_hw": [H, W], "cpu_count": os.cpu_count(), "filters": {}}
    with tempfile.TemporaryDirectory() as d:
        for ft, name in enumerate(FILTERS):
            path = os.path.join(d, f"{name}.png")
            write_png(path, frame, ft)
            _, stream, _ = png.read_chunks(path)
            raw = np.frombuffer(zlib.decompress(stream), np.uint8)
            times, got = [], None
            for _ in range(reps):
                buf = raw.copy()
                t0 = time.perf_counter()
                got = png.unfilter(buf, H, W * 3, 3)
                times.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _, stream, _ = png.read_chunks(path)
            inflated = np.frombuffer(zlib.decompress(stream), np.uint8)
            t1 = time.perf_counter()
            plain = png.unfilter_plain(inflated, H, W * 3, 3)
            t2 = time.perf_counter()
            decode = []
            for _ in range(reps):
                t3 = time.perf_counter()
                img = png.imread(path)
                decode.append((time.perf_counter() - t3) * 1e3)
            out["filters"][name] = {
                "file_mib": os.path.getsize(path) / 2**20,
                "unfilter_ms": statistics.median(times), "unfilter_plain_ms": (t2 - t1) * 1e3,
                "decode_ms": statistics.median(decode), "decode_plain_ms": (t2 - t0) * 1e3,
                "compiled_equals_plain": bool(np.array_equal(got, plain)),
                "equals_written": bool(np.array_equal(got, want) and np.array_equal(img, frame)),
            }
        sub = os.path.join(d, "sub.png")
        with ThreadPoolExecutor(12) as pool:
            list(pool.map(png.imread, [sub] * 12))
            t0 = time.perf_counter()
            list(pool.map(png.imread, [sub] * 24))
            out["sub_decode_12_threads_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / 24
    emit(out)
    bad = [k for k, v in out["filters"].items() if not (v["compiled_equals_plain"] and v["equals_written"])]
    if bad:
        raise AssertionError(f"the PNG unfilter differs from its plain version or the written pixels: {bad}")
    return out


def write_dataset(root, H=720, W=1280, vimeo_hw=(256, 448), adobe_entries=280, nfs_entries=280, vimeo_seqs=8,
                  vimeo_repeats=10, val_repeats=2):
    """A made-up dataset in the layouts the readers read: one 57-frame clip
    of panning-texture PNGs at H x W (Sub rows, zlib level 1, as cv2.imwrite
    writes them); the ADOBE and NFS train lists naming that clip's frames
    ``adobe_entries`` / ``nfs_entries`` times; ``vimeo_seqs`` Vimeo
    septuplets at ``vimeo_hw``, listed ``vimeo_repeats`` times; and a
    VAL_CLIPS pickle naming the clip ``val_repeats`` times (7 sliding windows
    each). Returns the config sections that point at it."""
    rng = np.random.default_rng(31)
    clip_dir = os.path.join(root, "adobe", "clip_000")
    os.makedirs(clip_dir)
    paths = []
    for i, img in enumerate(panning_clips(rng, 1, H, W, n=57)[0]):
        paths.append(os.path.join(clip_dir, f"frame_{i:05d}.png"))
        write_png(paths[-1], img)
    listing = f"{len(paths)}\n" + "".join(p + "\n" for p in paths)
    for name, entries in (("adobe_train.txt", adobe_entries), ("nfs_train.txt", nfs_entries)):
        with open(os.path.join(root, name), "w") as f:
            f.write(listing * entries)
    seqs = [f"{i:05d}/0001" for i in range(vimeo_seqs)]
    for seq in seqs:
        d = os.path.join(root, "vimeo", "sequences", seq)
        os.makedirs(d)
        for i, img in enumerate(panning_clips(rng, 1, *vimeo_hw, n=7)[0], start=1):
            write_png(os.path.join(d, f"im{i}.png"), img)
    with open(os.path.join(root, "vimeo", "list.txt"), "w") as f:
        f.write("\n".join(seqs * vimeo_repeats) + "\n")
    with open(os.path.join(root, "val_clips.pkl"), "wb") as f:
        pickle.dump(["clip_000"] * val_repeats, f)
    return {
        "ADOBE_DATA": {"ROOTDIR": os.path.join(root, "adobe"), "VAL_CLIPS": os.path.join(root, "val_clips.pkl"),
                       "TRAINPATHS": os.path.join(root, "adobe_train.txt"), "H_IN": H, "W_IN": W},
        "NFS_DATA": {"TRAINPATHS": os.path.join(root, "nfs_train.txt")},
        "VIMEO_DATA": {"ROOTDIR": os.path.join(root, "vimeo"), "TRAINPATHS": os.path.join(root, "vimeo", "list.txt")},
    }


def write_small_eval_dataset(root, H=48, W=96, n=17):
    """One ``n``-frame clip at H x W (padded to 64x96 by the ADOBE eval
    transform: 2 sliding windows) and its VAL_CLIPS pickle; returns the
    config sections."""
    write_clip(os.path.join(root, "small", "clip_000"), panning_clips(np.random.default_rng(32), 1, H, W, n=n)[0])
    with open(os.path.join(root, "small", "val_clips.pkl"), "wb") as f:
        pickle.dump(["clip_000"], f)
    return {"ADOBE_DATA": {"ROOTDIR": os.path.join(root, "small"), "H_IN": H, "W_IN": W,
                           "VAL_CLIPS": os.path.join(root, "small", "val_clips.pkl")}}


def data_phases(norm, scale=False):
    """Phases 15-17 over a made-up dataset in a temporary directory: the PNG
    unfilter, the eval CLI, and the train CLI in f32 and bf16; with
    ``scale``, then phase 23 over the same datasets (else None)."""
    png = phase_png_unfilter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sections = write_dataset(root, val_repeats=1)
        small = write_small_eval_dataset(root)
        emit({"phase": "dataset_written", "seconds": time.perf_counter() - t0})
        eval_cli = phase_eval_cli(root, sections, small, n_windows=7)  # the clip's 7 windows: one batch
        train_clis = [phase_train_cli(root, sections, norm, dtype) for dtype in ("float32", "bfloat16")]
        scaled = scale_phase(root, sections, norm) if scale else None
    return png, eval_cli, train_clis, scaled


def write_config(path, base, *section_dicts):
    """``configs/<base>`` with every (SECTION: {KEY: value}) of
    ``section_dicts`` set, written to ``path``."""
    parser = configparser.RawConfigParser()
    parser.optionxform = str
    parser.read(_config_path(base))
    for sections in section_dicts:
        for section, values in sections.items():
            for k, v in values.items():
                parser.set(section, k, str(v))
    with open(path, "w") as f:
        parser.write(f)
    return path


def loader_ms(cfg, split, n_batches):
    """The Loader alone over ``get_dataset(cfg, split)``: ms to the first
    batch and the median ms per batch after it, over ``n_batches`` (or the
    epoch); returns them and the batches."""
    from superslomo_tpu_torch.data import get_dataset

    batches, times = [], []
    t0 = time.perf_counter()
    for batch in get_dataset(cfg, split):
        t1 = time.perf_counter()
        times.append((t1 - t0) * 1e3)
        batches.append(batch)
        if len(batches) == n_batches:
            break
        t0 = time.perf_counter()
    return {"first_batch_ms": times[0], "ms_per_batch": statistics.median(times[1:]) if len(times) > 1 else None,
            "batch_ms": times, "batches": len(times)}, batches


class _Recorder:
    """Wraps ``owner.name`` (a function, or a method: its first argument is
    then the object) for the ``with`` block: each call's result goes
    through ``after(result)`` and is kept with its arguments and the host
    times of its start and end; with ``cuda_events``, CUDA events are
    recorded before and after each call (the device work it queued), read
    by ``device_ms()`` after a synchronise."""

    def __init__(self, owner, name, after=lambda r: r, cuda_events=False):
        self.owner, self.name, self.after, self.cuda_events = owner, name, after, cuda_events
        self.calls, self.events = [], []

    def __enter__(self):
        inner = self.orig = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            if self.cuda_events:
                pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                pair[0].record()
            t0 = time.perf_counter()
            result = self.after(inner(*args, **kwargs))
            self.calls.append((t0, time.perf_counter(), args, result))
            if self.cuda_events:
                pair[1].record()
                self.events.append(pair)
            return result

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    def device_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def phase_eval_cli(root, sections, small_sections, n_windows):
    """The eval CLI (``python -m superslomo_tpu_torch.cli.evaluate_interpolation``,
    on the card by default) at configs/superslomo_eval.ini as shipped (ADOBE,
    720p padded to 736, B=8, 12 loader threads, f32, seeded weights) over the
    made-up dataset (``n_windows`` sliding windows: 7, one batch; the
    host's scoring takes ~0.6 s an image, so more batches cost minutes). The
    Evaluator runs each batch as fused steps of ``step_samples`` samples (2
    at 720p: the shapes of phase 5; the batch's last step has 1). Its metrics equal Evaluator.run on the same
    batches given explicitly (read by the Loader alone, timed); 4 multi-flow
    launches a fused step, counted; the wall time of the CLI's Evaluator.run
    per batch against the prepared run's, and the prepared run's time in
    the host's scoring (waiting for a batch's copy included). Then the CLI on the card against
    the CLI on the CPU (``--device cpu``) over a 17-frame 48x96 clip (padded
    to 64x96): the predictions within the serving bar."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, load_config, ops
    from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli
    from superslomo_tpu_torch.cli.common import load_model_params
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter

    ini = write_config(os.path.join(root, "eval.ini"), "superslomo_eval.ini", sections)
    args = ["-c", ini, "--expt", "chip_smoke", "--log", os.path.join(root, "eval.log")]
    counter.launches = ops._WarpMultiflow.launches = 0
    t0 = time.perf_counter()
    with _Recorder(Evaluator, "run") as run, _Recorder(SuperSloMo, "interpolate_multi_t") as steps:
        cli = eval_cli.main(args)  # default --device cuda
    cli_wall = time.perf_counter() - t0
    launches, bwd_launches, n_steps = counter.launches, ops._WarpMultiflow.launches, len(steps.calls)
    cli_run_s = run.calls[0][1] - run.calls[0][0]

    cfg = load_config(ini)
    loader, batches = loader_ms(cfg, "VAL", n_batches=None)
    evaluator = Evaluator(cfg, load_model_params(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Recorder(Evaluator, "_score") as score:
        prepared = evaluator.run(batches)
    prepared_s = time.perf_counter() - t0
    score_s = sum(t1 - t0 for t0, t1, *_ in score.calls)
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    res = {
        "phase": "eval_cli_main_path", "config": "configs/superslomo_eval.ini", "batch": cfg.getint("VAL", "BATCH_SIZE"),
        "loader_threads": cfg.getint("DATALOADER", "N_WORKERS"), "batches": n, "windows": n_windows,
        "frame_hw": list(batches[0][0].shape[2:4]), "step_samples": evaluator.step_samples, "fused_steps": n_steps,
        "cli_wall_s": cli_wall, "cli_run_ms_per_batch": cli_run_s * 1e3 / n,
        "prepared_run_ms_per_batch": prepared_s * 1e3 / n, "prepared_peak_mem_gib": peak / 2**30,
        "prepared_host_scoring_ms_per_batch": score_s * 1e3 / n, "images_per_batch": cli["n_images"] / n,
        "eval_loader": loader, "warp_launches": launches, "warp_launches_per_step": launches / n_steps,
        "warp_multiflow_backward_launches": bwd_launches, "cli": cli, "prepared": prepared,
        "cli_equals_prepared": cli == prepared,
    }
    del batches, evaluator
    torch.cuda.empty_cache()

    # card against CPU over a small clip
    small_ini = write_config(os.path.join(root, "eval_small.ini"), "superslomo_eval.ini", small_sections)
    preds = {}
    for device in ("cuda", "cpu"):
        with _Recorder(SuperSloMo, "interpolate_multi_t") as rec:
            metrics = eval_cli.main(["-c", small_ini, "--expt", "chip_smoke", "--log", os.path.join(root, "small.log"),
                                     "--device", device])
        preds[device] = (torch.cat([c[3][0].cpu() for c in rec.calls]), metrics)
    (p_card, m_card), (p_cpu, m_cpu) = preds["cuda"], preds["cpu"]
    res["small_card_vs_cpu"] = {
        "shape": list(p_cpu.shape), "max_abs_err": (p_card - p_cpu).abs().max().item(),
        "within_serving_bar": bool(torch.allclose(p_card, p_cpu, atol=SLICE_ATOL, rtol=SLICE_RTOL)),
        "metrics_card": m_card, "metrics_cpu": m_cpu,
    }
    emit(res)
    if launches != 4 * n_steps or n_steps < n or bwd_launches != 0:
        raise AssertionError(f"{launches} multi-flow launches ({bwd_launches} of its backward) over {n_steps} fused "
                             f"steps of {n} eval CLI batches, expected 4 a step (none)")
    if not res["cli_equals_prepared"]:
        raise AssertionError(f"the eval CLI's metrics differ from Evaluator.run on the same batches: {res}")
    if not (all(np.isfinite([cli["PSNR"], cli["SSIM"], cli["IE"]])) and cli["n_images"] == 7 * n_windows):
        raise AssertionError(f"eval CLI results: {cli}")
    if not res["small_card_vs_cpu"]["within_serving_bar"]:
        raise AssertionError(f"the eval CLI on the card and on the CPU disagree: {res['small_card_vs_cpu']}")
    return res


def phase_train_cli(root, sections, norm, dtype, steps=10, warmup=2, synthetic_steps=5, **overrides):
    """The train CLI (``python -m superslomo_tpu_torch.cli.train``, on the
    card by default) at configs/superslomo_original.ini as shipped (ALL:
    ADOBE + NFS + Vimeo, B=32, 224x224 crops, 12 loader threads, random VGG
    features) in ``dtype`` for ``steps`` steps over the made-up dataset (an
    epoch of 20 batches: the Loader decodes through every step), each step
    synchronised: its step ms and the wait for the feed before each step;
    then ``synthetic_steps`` steps of the same Trainer on synthetic
    in-memory batches (the step with its pageable H2D copy, no Loader
    running), and the Loader alone. The single-flow kernels' launches a step
    counted."""
    from superslomo_tpu_torch import Trainer, load_config
    from superslomo_tpu_torch.cli import train as train_cli

    ini = write_config(os.path.join(root, f"train_{dtype}.ini"), "superslomo_original.ini", sections, {
        "TRAIN": {"ALLOW_RANDOM_VGG": "TRUE", "CKPT_DIR": os.path.join(root, "ckpt")},
        "PROJECT": {"LOGDIR": os.path.join(root, "logs")}, "TPU": {"COMPUTE_DTYPE": dtype}}, overrides)
    cfg = load_config(ini)
    B = cfg.getint("TRAIN", "BATCH_SIZE")
    loader, _ = loader_ms(cfg, "TRAIN", n_batches=6)

    def synced(loss):
        torch.cuda.synchronize()
        return loss

    reset_single_counts()
    t_start = time.perf_counter()
    with _Recorder(Trainer, "train_step", after=synced) as rec:
        trainer = train_cli.main(["-c", ini, "--expt", f"chip_smoke_{dtype}", "--log", os.path.join(root, "train.log"),
                                  "--max-steps", str(steps)])
    cli_wall = time.perf_counter() - t_start
    launches = single_counts()
    calls = rec.calls
    step_ms = [(t1 - t0) * 1e3 for t0, t1, _, _ in calls]
    wait_ms = [(calls[0][0] - t_start) * 1e3] + [(calls[k][0] - calls[k - 1][1]) * 1e3 for k in range(1, len(calls))]
    on_card = all(isinstance(x, torch.Tensor) and x.is_cuda for _, _, args, _ in calls for x in args[1:])
    losses = np.stack([r.cpu().numpy() for *_, r in calls])
    checkpoint = trainer.checkpoint_path(trainer.epoch)

    batch = synthetic_train_batches(norm, n_batches=1, B=B, H=cfg.getint("TRAIN", "CROP_IMH"),
                                    W=cfg.getint("TRAIN", "CROP_IMW"), seed=41)[0]
    synthetic = []
    for _ in range(synthetic_steps):
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        synthetic.append((time.perf_counter() - t0) * 1e3)
    del trainer
    torch.cuda.empty_cache()
    steady = slice(warmup, None)
    per_step = (calls[-1][1] - calls[warmup - 1][1]) * 1e3 / (len(calls) - warmup)
    res = {
        "phase": "train_cli_main_path", "config": "configs/superslomo_original.ini", "compute_dtype": dtype,
        "batch": B, "crop_hw": [cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")],
        "loader_threads": cfg.getint("DATALOADER", "N_WORKERS"), "steps": len(calls), "cli_wall_s": cli_wall,
        "cli_ms_per_step": per_step, "step_ms_median": statistics.median(step_ms[steady]),
        "feed_wait_ms_median": statistics.median(wait_ms[steady]), "step_ms": step_ms, "feed_wait_ms": wait_ms,
        "synthetic_step_ms_median": statistics.median(synthetic), "synthetic_step_ms": synthetic,
        "train_loader": loader, "batches_on_card": on_card, "loss_first": losses[0].tolist(),
        "loss_last": losses[-1].tolist(), "checkpoint_saved": os.path.exists(checkpoint),
        "launches": launches, "launches_per_step": {k: v / len(calls) for k, v in launches.items()},
    }
    if os.path.exists(checkpoint):
        os.remove(checkpoint)
    emit(res)
    if len(calls) != steps or launches != train_step_launches(steps):
        raise AssertionError(f"train CLI: {len(calls)} steps, single-flow launches {launches}, expected "
                             f"{train_step_launches(steps)}")
    if not (on_card and res["checkpoint_saved"] and np.isfinite(losses).all()):
        raise AssertionError(f"train CLI: {res}")
    return res


# --------------------------------------------------------------------------- #
# the renderer and the flow evaluator through their command lines (phases 18-21)


def _launch_counts():
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as mf
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as single

    return {"warp_multiflow": mf.launches, "warp_single": single.launches,
            "warp_multiflow_backward": ops._WarpMultiflow.launches}


def _reset_launch_counts():
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as mf
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as single

    mf.launches = single.launches = ops._WarpMultiflow.launches = 0


SEEDED = {"STAGE1": {"LOADPREV": "FALSE"}, "STAGE2": {"LOADPREV": "FALSE"}}  # the CLIs' seeded weights


def phase_render_cli(root, frames, tag, base, n_windows, dtype=None, dump=False):
    """The render CLI (``python -m superslomo_tpu_torch.cli.visualize``, on
    the card by default, seeded weights, ``--upsample-rate 8``) at
    ``configs/<base>``'s model (``dtype``: its ``[TPU] COMPUTE_DTYPE``)
    over the first ``n_windows + 1`` frames of the 720p clip in
    ``root/clip``: ``n_windows`` windows, 8 frames written a window and the
    clip's last. Checks the file names and count, that every file decodes
    through ``png.imread`` to (720, 1280, 3), that the originals equal the
    input frames bit for bit, and the launches: 4 multi-flow a window, and
    single-flow ones only with ``dump`` (the intermediates' forward at t=0.5,
    4 a window for N_FRAMES=2), whose layouts it records. Reports the wall
    time, frames written a second, and the ms a window (median over the
    windows after the first, which holds cuDNN's autotuning) split into
    decode (``load_frames``), the fused step (CUDA events), the dump's
    forward (CUDA events), encode (``png.imwrite``), and the rest (the
    predictions' copy to the host, the crop and cast)."""
    from superslomo_tpu_torch import SuperSloMo
    from superslomo_tpu_torch.cli import visualize as render_cli
    from superslomo_tpu_torch.data import png
    from superslomo_tpu_torch.eval import visualize

    clip_dir, out_dir = os.path.join(root, f"in_{tag}"), os.path.join(root, f"out_{tag}")
    os.makedirs(clip_dir)
    for i in range(n_windows + 1):
        name = f"frame_{i:05d}.png"
        os.symlink(os.path.join(root, "clip", name), os.path.join(clip_dir, name))
    ini = write_config(os.path.join(root, f"render_{tag}.ini"), base, SEEDED,
                       {"TPU": {"COMPUTE_DTYPE": dtype}} if dtype else {})
    args = ["-c", ini, "--input-dir", clip_dir, "--output-dir", out_dir, "--log", os.path.join(root, "render.log")]
    if dump:
        args.append("--dump-intermediates")
    _reset_launch_counts()
    t0 = time.perf_counter()
    with (_Recorder(visualize.Interpolator, "interpolate_directory") as run,
          _Recorder(visualize.Interpolator, "load_frames") as dec, _Recorder(visualize, "imwrite") as enc,
          _Recorder(SuperSloMo, "interpolate_multi_t", cuda_events=True) as steps,
          _Recorder(SuperSloMo, "forward_inference", cuda_events=True) as dumps, _RecordForwardLayouts() as rec):
        message = render_cli.main(args)  # default --device cuda
    cli_wall = time.perf_counter() - t0
    launches = _launch_counts()
    step_ms, dump_ms = steps.device_ms(), dumps.device_ms()

    # the split of each window: from one load_frames to the next
    starts = [t0 for t0, *_ in dec.calls]
    windows = []
    for k in range(n_windows):
        lo, hi = starts[k], starts[k + 1]
        w = {"window_ms": (hi - lo) * 1e3, "decode_ms": (dec.calls[k][1] - lo) * 1e3, "step_ms": step_ms[k],
             "encode_ms": sum(t1 - t0 for t0, t1, *_ in enc.calls if lo <= t0 < hi) * 1e3,
             "dump_forward_ms": dump_ms[k] if dump else 0.0}
        w["other_ms"] = w["window_ms"] - w["decode_ms"] - w["step_ms"] - w["encode_ms"] - w["dump_forward_ms"]
        windows.append(w)
    steady = windows[1:]
    n_out = 8 * n_windows + 1
    run_s = run.calls[0][1] - run.calls[0][0]
    res = {
        "phase": f"render_{tag}", "config": f"configs/{base}", "compute_dtype": dtype or "float32",
        "dump_intermediates": dump, "frame_hw": list(frames.shape[1:3]), "upsample_rate": 8, "windows": n_windows,
        "frames_written": n_out, "cli_wall_s": cli_wall, "render_wall_s": run_s,
        "frames_per_s": n_out / run_s, "first_window_ms": windows[0]["window_ms"],
        "steady_frames_per_s": 8 * len(steady) / (sum(w["window_ms"] for w in steady) / 1e3),
        "median_ms_per_window": {k: statistics.median(w[k] for w in steady) for k in windows[0]},
        "ms_per_window": windows, "launches": launches,
        "launches_per_window": {k: v / n_windows for k, v in launches.items()}, "message": message,
    }
    names = sorted(n for n in os.listdir(out_dir) if n.endswith(".png"))
    expect_names = [f"{i:06d}.png" for i in range(n_out)]
    originals = {8 * k: frames[k] for k in range(n_windows)}
    originals[n_out - 1] = frames[n_windows]
    shapes, originals_equal = set(), True
    for i, name in enumerate(names):
        img = png.imread(os.path.join(out_dir, name))
        shapes.add(img.shape)
        if i in originals:
            originals_equal &= bool(np.array_equal(img, originals[i]))
    res.update(file_shapes=sorted(shapes), originals_bit_identical=originals_equal)
    if dump:
        hw = tuple(int(np.ceil(x / 32) * 32) for x in frames.shape[1:3])
        res["dump"] = {}
        for d, ctype in (("visibility", 0), ("flow_est", 2), ("flow_refined", 2)):
            files = sorted(os.listdir(os.path.join(out_dir, d)))
            heads = [png.read_chunks(os.path.join(out_dir, d, f))[0] for f in files]
            res["dump"][d] = {"files": files, "hw": sorted({(h, w) for w, h, *_ in heads}),
                              "colour_types": sorted({c for _, _, _, c, _ in heads})}
            if files != [f"{k:06d}.png" for k in range(n_windows)] or res["dump"][d]["hw"] != [hw] or \
                    res["dump"][d]["colour_types"] != [ctype]:
                raise AssertionError(f"render dump {d}: {res['dump'][d]}, expected {n_windows} files of {hw}")
    res["forward_layouts"] = sorted(set(rec.layouts))
    emit(res)
    want = {"warp_multiflow": 4 * n_windows, "warp_single": 4 * n_windows if dump else 0, "warp_multiflow_backward": 0}
    if launches != want:
        raise AssertionError(f"render {tag}: launches {launches} over {n_windows} windows, expected {want}")
    if message != f"wrote {n_out} frames to {out_dir}" or names != expect_names:
        raise AssertionError(f"render {tag}: {message!r}, files {names[:3]}...{names[-3:]} ({len(names)})")
    if shapes != {tuple(frames.shape[1:])} or not originals_equal:
        raise AssertionError(f"render {tag}: file shapes {shapes}, originals bit-identical {originals_equal}")
    return res


def write_sintel(root, H, W, n, seed, clip="alley_1"):
    """The Sintel EPE layout: ``final/<clip>/frame_%04d.png``, ``n`` frames
    of a texture panning 3 px a frame to the left, and
    ``flow/<clip>/frame_%04d.flo``, ``n - 1`` ground truths: that motion
    (u = -3 px, v = 0) plus a smooth field of up to 4 px (so that some
    pixels of the seeded model's flow lie within 3 px of it and some do
    not), every 97th pixel unknown (1e10). Returns the config section."""
    from superslomo_tpu_torch.utils.flo import write_flo

    os.makedirs(os.path.join(root, "flow", clip))
    write_clip(os.path.join(root, "final", clip), panning_clips(np.random.default_rng(seed), 1, H, W, n=n)[0],
               name="frame_{:04d}.png", start=1)  # Sintel numbers its frames from 1
    rng = np.random.default_rng(seed + 1)
    for i in range(n - 1):
        gt = smooth_flows(rng, 1, H, W, 4.0)[0].transpose(1, 2, 0) + np.float32([-3.0, 0.0])
        gt.reshape(-1, 2)[::97] = 1e10
        write_flo(gt, os.path.join(root, "flow", clip, f"frame_{i + 1:04d}.flo"))
    return {"SINTEL_EPE_DATA": {"ROOTDIR": root, "SETTING": "FINAL", "H_IN": H, "W_IN": W}}


def phase_flow_eval_cli(root):
    """The flow-EPE CLI (``python -m superslomo_tpu_torch.cli.evaluate_flow``,
    on the card by default, seeded weights) at configs/superslomo_eval.ini
    (N_FRAMES=2, f32, TF32 off) over a made-up Sintel clip of 8 frames at
    1024x436 (padded to 448): all 7 samples. Checks the JSON; 4 single-flow
    launches a sample (the forward's), none of the multi-flow kernel or its
    backward; records their layouts. Reports the ms a sample (median after
    the first): wall, the read (decode + pad), the forward (CUDA events)."""
    from superslomo_tpu_torch import SuperSloMo
    from superslomo_tpu_torch.cli import evaluate_flow as flow_cli
    from superslomo_tpu_torch.data.readers import SintelFlowReader

    sintel = os.path.join(root, "sintel")
    ini = write_config(os.path.join(root, "flow.ini"), "superslomo_eval.ini", SEEDED,
                       write_sintel(sintel, 436, 1024, n=8, seed=53))
    _reset_launch_counts()
    t0 = time.perf_counter()
    with (_Recorder(SintelFlowReader, "__getitem__") as reads,
          _Recorder(SuperSloMo, "forward", cuda_events=True) as fwd, _RecordForwardLayouts() as rec):
        results = flow_cli.main(["-c", ini, "--log", os.path.join(root, "flow.log")])  # default --device cuda
    cli_wall = time.perf_counter() - t0
    launches = _launch_counts()
    fwd_ms = fwd.device_ms()
    starts = [t0 for t0, *_ in reads.calls]
    n = len(starts)
    per_sample = [(starts[k + 1] - starts[k]) * 1e3 for k in range(n - 1)]
    res = {
        "phase": "flow_eval_cli_main_path", "config": "configs/superslomo_eval.ini", "frame_hw": [436, 1024],
        "padded_hw": [448, 1024], "samples": n, "cli_wall_s": cli_wall, "results": results,
        "first_sample_ms": per_sample[0] if per_sample else None,
        "median_ms_per_sample": {"wall": statistics.median(per_sample[1:]),
                                 "read": statistics.median((t1 - t0) * 1e3 for t0, t1, *_ in reads.calls[1:]),
                                 "forward": statistics.median(fwd_ms[1:])},
        "forward_ms": fwd_ms, "launches": launches, "launches_per_sample": {k: v / n for k, v in launches.items()},
        "forward_layouts": sorted(set(rec.layouts)),
    }
    emit(res)
    if set(results) != {"EPE", "gt3px_percent", "n_samples"} or results["n_samples"] != 7 or n != 7 or not (
            np.isfinite(results["EPE"]) and 0 <= results["gt3px_percent"] <= 100):
        raise AssertionError(f"flow eval CLI results: {results} over {n} samples read")
    if launches != {"warp_multiflow": 0, "warp_single": 4 * n, "warp_multiflow_backward": 0}:
        raise AssertionError(f"flow eval CLI: launches {launches} over {n} samples, expected 4 single-flow a sample")
    return res


def phase_render_flow_card_vs_cpu(root):
    """Both command lines on the card and with ``--device cpu`` at a small
    size (configs/superslomo_eval.ini, seeded weights): the renderer over a
    3-frame 64x96 clip (2 windows, 17 frames): the originals equal, the
    renders within one level; the flow evaluator over 2 samples of 52x96
    Sintel frames (padded to 64x96): EPE within 1e-3 px, the >3 px share
    within one pixel's share."""
    from superslomo_tpu_torch.cli import evaluate_flow as flow_cli
    from superslomo_tpu_torch.cli import visualize as render_cli
    from superslomo_tpu_torch.data import png

    small = os.path.join(root, "small")
    write_clip(os.path.join(small, "clip"), panning_clips(np.random.default_rng(54), 1, 64, 96, n=3)[0])
    ini = write_config(os.path.join(small, "render.ini"), "superslomo_eval.ini", SEEDED)
    flow_ini = write_config(os.path.join(small, "flow.ini"), "superslomo_eval.ini", SEEDED,
                            write_sintel(os.path.join(small, "sintel"), 52, 96, n=3, seed=55))
    outs, flows = {}, {}
    for device in ("cuda", "cpu"):
        out = os.path.join(small, f"out_{device}")
        render_cli.main(["-c", ini, "--input-dir", os.path.join(small, "clip"), "--output-dir", out,
                         "--log", os.path.join(small, "render.log"), "--device", device])
        outs[device] = {n: png.imread(os.path.join(out, n)) for n in sorted(os.listdir(out))}
        flows[device] = flow_cli.main(["-c", flow_ini, "--log", os.path.join(small, "flow.log"), "--device", device])
    card, cpu = outs["cuda"], outs["cpu"]
    diffs = [int(np.abs(card[n].astype(np.int16) - cpu[n].astype(np.int16)).max()) for n in cpu]
    flipped = sum(int((card[n] != cpu[n]).sum()) for n in cpu)
    one_pixel = 100.0 / (52 * 96)
    res = {
        "phase": "render_flow_cli_card_vs_cpu", "render_files": len(cpu), "render_max_level_diff": max(diffs),
        "render_values_differing": flipped, "originals_equal": all(np.array_equal(card[n], cpu[n]) for n in (
            "000000.png", "000008.png", "000016.png")),
        "flow_card": flows["cuda"], "flow_cpu": flows["cpu"],
        "epe_diff": abs(flows["cuda"]["EPE"] - flows["cpu"]["EPE"]),
        "gt3px_diff": abs(flows["cuda"]["gt3px_percent"] - flows["cpu"]["gt3px_percent"]), "gt3px_bar": one_pixel,
    }
    emit(res)
    if sorted(card) != sorted(cpu) or len(cpu) != 17 or max(diffs) > 1 or not res["originals_equal"]:
        raise AssertionError(f"the render CLI on the card and on the CPU disagree: {res}")
    if (flows["cuda"]["n_samples"] != flows["cpu"]["n_samples"] or res["epe_diff"] > 1e-3
            or res["gt3px_diff"] > one_pixel):
        raise AssertionError(f"the flow eval CLI on the card and on the CPU disagree: {res}")
    return res


def render_phases(render_fwd):
    """Phases 18-21 in a temporary directory: the render CLI (CONV f32 over
    8 windows, CONV bf16 over 4, SSM-R over 3, the intermediates dump over
    2) over a 9-frame 720p panning clip, the flow-EPE CLI, and both CLIs on
    the card against the CPU; every single-flow launch of the dump and the
    flow evaluator held to a layout of ``render_fwd``'s cases."""
    with tempfile.TemporaryDirectory() as root:
        frames = panning_clips(np.random.default_rng(51), 1, 720, 1280, n=9)[0]
        write_clip(os.path.join(root, "clip"), frames)
        renders = [
            phase_render_cli(root, frames, "cli_main_path", "superslomo_eval.ini", n_windows=8),
            phase_render_cli(root, frames, "cli_main_path_bf16", "superslomo_eval.ini", n_windows=4,
                             dtype="bfloat16"),
            phase_render_cli(root, frames, "ssmr_main_path", "superslomo_recurrent.ini", n_windows=3),
            phase_render_cli(root, frames, "dump_intermediates", "superslomo_eval.ini", n_windows=2, dump=True),
        ]
        flow_eval = phase_flow_eval_cli(root)
        card_vs_cpu = phase_render_flow_card_vs_cpu(root)
    check_forward_layouts(render_fwd["layouts"], renders[-1]["forward_layouts"], path="render_dump")
    check_forward_layouts(render_fwd["layouts"], flow_eval["forward_layouts"], path="flow_eval")
    return renders, flow_eval, card_vs_cpu


# --------------------------------------------------------------------------- #
# native checkpoints and data parallel across ranks (phases 22-23)


def _seconds(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_native_checkpoint(ckpt_dir, norm, tr=None, pt=None):
    """Phase 22: the JAX package's native checkpoint directory on the card.
    ``tr`` is phase 11's Trainer at configs/superslomo_original.ini as
    shipped (B=32, 224x224, f32) after its steps and ``pt`` the ``.pt`` it
    saved; without them (``--scale-only``) a Trainer of its own takes two
    steps of ``train`` on cuDNN's heuristics. The Trainer writes a native
    directory with its Adam state (``Trainer.save_native``); a fresh Trainer
    resumes from it: every weight, ``exp_avg``, ``exp_avg_sq`` and ``step``,
    the epoch and the step equal the writer's bit for bit, and its next
    step's loss is within LOSS_RTOL of the writer's next step on the same
    batch (8 single-flow forward and 8 flow-gradient launches, counted).
    ``cli.convert_checkpoint`` turns the ``.pt`` into a directory that
    ``load_model_params`` reads to the ``.pt``'s tensors, bit for bit. The
    write and read seconds of the whole directory, and a decode and encode
    of each file (the ~73 MB stage files, the ~300 MB optimizer file)."""
    from superslomo_tpu_torch import Trainer
    from superslomo_tpu_torch import weights as wio
    from superslomo_tpu_torch.cli import convert_checkpoint
    from superslomo_tpu_torch.cli.common import load_model_params
    from superslomo_tpu_torch.training.checkpoint import load_native_checkpoint
    from superslomo_tpu_torch.utils import msgpack

    config = _config_path("superslomo_original.ini")
    cfg = _train_config(ckpt_dir, config)
    B, H, W = cfg.getint("TRAIN", "BATCH_SIZE"), cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")
    benchmark = torch.backends.cudnn.benchmark
    if tr is None:
        tr = Trainer(cfg, expt_name="native_writer")
        torch.backends.cudnn.benchmark = benchmark = False
        tr.train(synthetic_train_batches(norm, 1, B, H, W, seed=5), max_steps=2)
        pt = tr.checkpoint_path(tr.epoch)
    native = os.path.join(ckpt_dir, "native")
    torch.cuda.synchronize()
    _, write_s = _seconds(tr.save_native, native)
    files = {}
    for name in sorted(os.listdir(native)):
        path = os.path.join(native, name)
        files[name] = {"bytes": os.path.getsize(path)}
        if name.endswith(".msgpack"):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                tree = msgpack.unpackb(f.read())
            files[name]["read_decode_s"] = time.perf_counter() - t0
            files[name]["encode_s"] = _seconds(msgpack.packb, tree)[1]
            del tree
    (_, adam, meta), read_s = _seconds(load_native_checkpoint, native, tr.spec)
    from_native = {f"STAGE{n}_{k}": v for n in (1, 2) for k, v in (("LOADPREV", "TRUE"), ("WEIGHTS", native))}
    resumed = Trainer(_train_config(ckpt_dir, config, **from_native), expt_name="native_resumed")
    torch.backends.cudnn.benchmark = benchmark
    same_weights = all(torch.equal(a, b) for stage in ("stage1", "stage2") for a, b in zip(
        getattr(tr.model, stage).state_dict().values(), getattr(resumed.model, stage).state_dict().values()))
    same_adam = all(torch.equal(tr.optimizer.state[p][k].cpu(), resumed.optimizer.state[q][k].cpu())
                    for (_, _, p), (_, _, q) in zip(tr.trainable, resumed.trainable)
                    for k in ("step", "exp_avg", "exp_avg_sq"))
    batch = synthetic_train_batches(norm, 1, B, H, W, seed=61)[0]
    writer_loss = tr.train_step(*batch).cpu().numpy()
    reset_single_counts()
    resumed_loss = resumed.train_step(*batch).cpu().numpy()
    torch.cuda.synchronize()
    launches = single_counts()

    converted = os.path.join(ckpt_dir, "converted")
    _, convert_s = _seconds(convert_checkpoint.main, [pt, converted])
    from_converted = {f"STAGE{n}_{k}": v for n in (1, 2) for k, v in (("LOADPREV", "TRUE"), ("WEIGHTS", converted))}
    loaded = load_model_params(_train_config(ckpt_dir, config, **from_converted))
    blob = wio.load_checkpoint(pt)
    convert_equal = all(torch.equal(loaded[s][k], v) for s in ("stage1", "stage2")
                        for k, v in blob[f"{s}_state_dict"].items())
    res = {
        "phase": "native_checkpoint", "config": "configs/superslomo_original.ini", "batch": B, "crop_hw": [H, W],
        "files": files, "write_s": write_s, "read_s": read_s, "convert_s": convert_s,
        "meta": {k: meta[k] for k in ("epoch", "step")}, "adam_step": adam["step"],
        "writer_epoch_step": [tr.epoch, tr.step], "resumed_epoch_step": [resumed.epoch, resumed.step],
        "resumed_identical_weights": same_weights, "resumed_identical_adam": same_adam,
        "next_loss_writer": writer_loss.tolist(), "next_loss_resumed": resumed_loss.tolist(),
        "next_loss_max_rel_diff": float(np.max(np.abs(resumed_loss - writer_loss) / np.abs(writer_loss))),
        "resumed_step_launches": launches, "converted_equals_pt": convert_equal,
    }
    del resumed, loaded, blob
    torch.cuda.empty_cache()
    emit(res)
    if not (same_weights and same_adam and res["writer_epoch_step"] == res["resumed_epoch_step"] == [
            meta["epoch"], meta["step"]] and res["next_loss_max_rel_diff"] <= LOSS_RTOL):
        raise AssertionError(f"the Trainer resumed from the native checkpoint differs from the writer: {res}")
    if launches != train_step_launches(1):
        raise AssertionError(f"single-flow launches {launches} in the resumed train step, expected 8 + 8")
    if not convert_equal:
        raise AssertionError(f"the converted .pt does not load to the .pt's weights: {res}")
    return res


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks_layout(world):
    """The backend and each rank's card: one card a rank over NCCL where
    there are enough cards, else every rank on card 0 over gloo (NCCL takes
    one rank a card)."""
    if torch.cuda.device_count() >= world:
        return "nccl", list(range(world))
    return "gloo", [0] * world


def _rank_entry(fn, rank, out_dir, args):
    result = fn(rank, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_ranks(fn, world, args, timeout=600):
    """``fn(rank, *args)`` in ``world`` spawned processes, as torchrun would
    start them (``torchrun_env``); returns their results in rank order. A
    rank that fails or outlives ``timeout`` fails the phase; every process
    is ended before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_rank_entry, args=(fn, r, out, args)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{fn.__name__}: ranks ended with {[p.exitcode for p in procs]}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def torchrun_env(rank, world, local_rank, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))


def timed_train_steps(tr, batches):
    """Each step on the host clock, synchronised, and its backward's device
    time (CUDA events around ``Tensor.backward``: DDP's gradient all-reduce
    runs inside it); returns step ms, backward ms, losses and the first
    step's gradients (on the host, the optimizer's order)."""
    step_ms, losses = [], []
    with _Recorder(torch.Tensor, "backward", cuda_events=True) as rec:
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(tr.train_step(*batch).cpu().numpy())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(losses) == 1:
                first_grads = [p.grad.to("cpu", copy=True) for *_, p in tr.trainable]
    return step_ms, rec.device_ms(), losses, first_grads


def ddp_train_rank(rank, world, port, backend, local_ranks, ckpt_dir, B, steps):
    """One rank of phase 23b: the Trainer at configs/superslomo_original.ini
    with global batch ``B`` under DDP, ``steps`` steps of its share of the
    synthetic batches, on cuDNN's heuristics."""
    from superslomo_tpu_torch import Trainer, parallel
    from superslomo_tpu_torch.data.augmentations import Normalize

    torchrun_env(rank, world, local_ranks[rank], port)
    device = parallel.init_data_parallel(backend=backend)
    cfg = _train_config(ckpt_dir, _config_path("superslomo_original.ini"), TRAIN_BATCH_SIZE=str(B))
    tr = Trainer(cfg, expt_name=f"ddp_rank{rank}")
    torch.backends.cudnn.benchmark = False
    H, W = cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")
    batches = synthetic_train_batches(Normalize(cfg.pixel_mean(), cfg.pixel_std()), steps, B, H, W, seed=71)
    share = B // world
    reset_single_counts()
    step_ms, backward_ms, losses, grads = timed_train_steps(
        tr, [tuple(x[rank * share:(rank + 1) * share] for x in b) for b in batches])
    res = {"rank": parallel.rank(), "world": parallel.world(), "backend": torch.distributed.get_backend(),
           "device": str(device), "ddp": type(tr.step_model).__name__, "step_ms": step_ms, "backward_ms": backward_ms,
           "loss": losses, "launches": single_counts(), "first_grads": grads,
           "weights": [p.detach().cpu() for *_, p in tr.trainable]}
    torch.distributed.destroy_process_group()
    return res


def ddp_eval_rank(rank, world, port, backend, local_ranks, args):
    """One rank of phase 23c: ``cli.evaluate_interpolation`` (its ``main``,
    as torchrun starts it) with the fused steps' predictions and the
    multi-flow launches recorded."""
    from superslomo_tpu_torch import SuperSloMo, ops
    from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter

    torchrun_env(rank, world, local_ranks[rank], port)
    counter.launches = ops._WarpMultiflow.launches = 0
    with _Recorder(SuperSloMo, "interpolate_multi_t") as rec:
        metrics = eval_cli.main([*args, "--dist-backend", backend])
    return {"rank": rank, "metrics": metrics, "preds": torch.cat([c[3][0].cpu() for c in rec.calls]),
            "fused_steps": len(rec.calls), "launches": counter.launches,
            "multiflow_backward": ops._WarpMultiflow.launches}


def phase_torchrun_train_cli(root, sections, steps=3, batch=4):
    """Phase 23a: ``python -m torch.distributed.run --nproc-per-node 1 -m
    superslomo_tpu_torch.cli.train`` at configs/superslomo_original.ini over
    phase 17's made-up dataset with ``batch`` samples (a cut of the batch, for
    the cuDNN autotuning a new process pays), ``steps`` steps: NCCL, world
    1 (the backend read back from its log); its last step's losses within
    LOSS_RTOL of the single-process CLI's (in this process) on the same seed
    and batches."""
    from superslomo_tpu_torch import Trainer
    from superslomo_tpu_torch.cli import train as train_cli

    ini = write_config(os.path.join(root, "train_torchrun.ini"), "superslomo_original.ini", sections, {
        "TRAIN": {"ALLOW_RANDOM_VGG": "TRUE", "CKPT_DIR": os.path.join(root, "ckpt"), "BATCH_SIZE": batch},
        "PROJECT": {"LOGDIR": os.path.join(root, "logs")}})

    def args(expt):
        return ["-c", ini, "--expt", expt, "--log", os.path.join(root, f"{expt}.log"), "--max-steps", str(steps)]

    t0 = time.perf_counter()
    with _Recorder(Trainer, "train_step") as rec:
        train_cli.main(args("single"))
    single_s = time.perf_counter() - t0
    single = [r.cpu().numpy() for *_, r in rec.calls]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "superslomo_tpu_torch.cli.train", "--", *args("torchrun")]
    root_dir = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root_dir}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train CLI exited {proc.returncode}: {err[-3000:]}")
    printed = json.loads(out.strip().splitlines()[-1])
    with open(os.path.join(root, "torchrun.log")) as f:
        backend = re.findall(r"backend (\w+)", f.read())
    res = {
        "phase": "torchrun_train_cli", "config": "configs/superslomo_original.ini", "batch": batch, "steps": steps,
        "backend_logged": backend, "torchrun": printed, "single_losses": [x.tolist() for x in single],
        "last_loss_max_rel_diff": float(np.max(np.abs(np.asarray(printed["loss"]) - single[-1]) / np.abs(single[-1]))),
        "single_cli_s": single_s, "torchrun_cli_s": torchrun_s,
    }
    emit(res)
    if backend != ["nccl"] or printed["step"] != steps or len(single) != steps:
        raise AssertionError(f"torchrun train CLI: {res}")
    if res["last_loss_max_rel_diff"] > LOSS_RTOL:
        raise AssertionError(f"the torchrun train CLI's losses differ from the single-process CLI's: {res}")
    return res


def phase_ddp_train(ckpt_dir, norm, world=2, B=8, steps=2):
    """Phase 23b: ``world`` ranks at global batch ``B`` (B / world a rank),
    224x224, f32, ``steps`` steps on cuDNN's heuristics, one card a rank
    over NCCL where there are enough cards, else all ranks on the one card
    over gloo (the backend printed), against the single-process Trainer at
    B on the same batches: the first step's all-reduced gradients within
    GRAD_REL of each tensor's max |g|, every step's loss within LOSS_RTOL,
    the ranks' weights after the steps bit-identical; 8 single-flow forward
    and 8 flow-gradient launches a step a rank; the step ms on each rank
    and the backward's share against the single process's. The weights'
    distance to the single process is reported, not held to a bar, as in
    phase 13's REMAT check: Adam passes a rounding of a gradient within a
    few eps of zero on to its weight as lr * rounding / eps, up to 2 lr a
    step (9.7e-4 of a tensor's max in this phase run on the CPU at 32x32)."""
    from superslomo_tpu_torch import Trainer

    backend, local_ranks = _ranks_layout(world)
    print(f"chip_smoke: phase 23b runs {world} ranks over {backend} on cards {local_ranks}", flush=True)
    ranks = spawn_ranks(ddp_train_rank, world, (world, _free_port(), backend, local_ranks, ckpt_dir, B, steps))
    cfg = _train_config(ckpt_dir, _config_path("superslomo_original.ini"), TRAIN_BATCH_SIZE=str(B))
    tr = Trainer(cfg, expt_name="ddp_reference")
    torch.backends.cudnn.benchmark = False
    batches = synthetic_train_batches(norm, steps, B, cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW"),
                                      seed=71)
    reset_single_counts()
    step_ms, backward_ms, losses, want_grads = timed_train_steps(tr, batches)
    torch.backends.cudnn.benchmark = True
    want = [p.detach().cpu() for *_, p in tr.trainable]
    del tr
    torch.cuda.empty_cache()

    def max_rel(got, ref):
        return max(((x - w).abs().max() / w.abs().max()).item() for x, w in zip(got, ref))

    grad_rel = max(max_rel(r["first_grads"], want_grads) for r in ranks)
    rel = max_rel(ranks[0]["weights"], want)
    identical = all(torch.equal(x, y) for r in ranks[1:] for x, y in zip(ranks[0]["weights"], r["weights"]))
    loss_rel = max(float(np.max(np.abs(a - b) / np.abs(b))) for r in ranks for a, b in zip(r["loss"], losses))
    res = {
        "phase": "ddp_train", "config": "configs/superslomo_original.ini", "world": world, "global_batch": B,
        "backend": [r["backend"] for r in ranks], "devices": [r["device"] for r in ranks],
        "wrapped_in": [r["ddp"] for r in ranks], "steps": steps,
        "step_ms_by_rank": [r["step_ms"] for r in ranks], "backward_ms_by_rank": [r["backward_ms"] for r in ranks],
        "backward_share_by_rank": [float(np.sum(r["backward_ms"]) / np.sum(r["step_ms"])) for r in ranks],
        "single_process_step_ms": step_ms, "single_process_backward_ms": backward_ms,
        "single_process_backward_share": float(np.sum(backward_ms) / np.sum(step_ms)),
        "launches_by_rank": [r["launches"] for r in ranks],
        "launches_per_step_by_rank": [{k: v / steps for k, v in r["launches"].items()} for r in ranks],
        "first_grads_max_rel_diff": grad_rel, "weights_max_rel_diff": rel, "ranks_bit_identical": identical,
        "loss_max_rel_diff": loss_rel,
        "cudnn_benchmark": False,
    }
    emit(res)
    if not (identical and grad_rel <= GRAD_REL and loss_rel <= LOSS_RTOL):
        raise AssertionError(f"DDP training differs from the single-process Trainer or across ranks: {res}")
    if any(r["launches"] != train_step_launches(steps) for r in ranks) or set(res["backend"]) != {backend}:
        raise AssertionError(f"DDP training: launches or backend: {res}")
    return res


def phase_ddp_eval_cli(root, world=2):
    """Phase 23c: ``cli.evaluate_interpolation`` at ``world`` ranks (as in
    phase 23b: NCCL on a card each, else gloo on the one card) over phase
    16's 17-frame 48x96 clip (2 windows, one batch, a sample a rank): the
    ranks' predictions, put together, and its metrics within phase 16's
    card-against-CPU bar (SLICE_ATOL, SLICE_RTOL) of the single-process CLI
    on the card; the metrics equal on every rank; 4 multi-flow launches a
    fused step a rank."""
    from superslomo_tpu_torch import SuperSloMo
    from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli

    ini = os.path.join(root, "eval_small.ini")
    args = ["-c", ini, "--expt", "chip_smoke_ddp", "--log", os.path.join(root, "small_ddp.log")]
    backend, local_ranks = _ranks_layout(world)
    print(f"chip_smoke: phase 23c runs {world} ranks over {backend} on cards {local_ranks}", flush=True)
    ranks = spawn_ranks(ddp_eval_rank, world, (world, _free_port(), backend, local_ranks, args))
    with _Recorder(SuperSloMo, "interpolate_multi_t") as rec:
        single = eval_cli.main(args)
    want = torch.cat([c[3][0].cpu() for c in rec.calls])
    got = torch.cat([r["preds"] for r in ranks])[:len(want)]
    metric_ok = all(abs(ranks[0]["metrics"][k] - single[k]) <= SLICE_ATOL + SLICE_RTOL * abs(single[k])
                    for k in ("PSNR", "SSIM", "IE"))
    res = {
        "phase": "ddp_eval_cli", "config": "configs/superslomo_eval.ini", "world": world, "backend": backend,
        "metrics_by_rank": [r["metrics"] for r in ranks], "single_process": single,
        "preds_shape": list(want.shape), "preds_max_abs_err": (got - want).abs().max().item(),
        "preds_within_serving_bar": bool(torch.allclose(got, want, atol=SLICE_ATOL, rtol=SLICE_RTOL)),
        "metrics_within_serving_bar": metric_ok,
        "fused_steps_by_rank": [r["fused_steps"] for r in ranks], "launches_by_rank": [r["launches"] for r in ranks],
        "launches_per_step_by_rank": [r["launches"] / r["fused_steps"] for r in ranks],
        "multiflow_backward_by_rank": [r["multiflow_backward"] for r in ranks],
    }
    emit(res)
    if not (res["preds_within_serving_bar"] and metric_ok and all(
            r["metrics"] == ranks[0]["metrics"] for r in ranks) and ranks[0]["metrics"]["n_images"] == single["n_images"]):
        raise AssertionError(f"the eval CLI at {world} ranks differs from the single process: {res}")
    if any(r["launches"] != 4 * r["fused_steps"] or r["multiflow_backward"] for r in ranks):
        raise AssertionError(f"multi-flow launches at {world} ranks: {res}")
    return res


def scale_phase(root, sections, norm):
    """Phase 23 in the directory of phases 16-17's made-up datasets."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        return {"torchrun_train": phase_torchrun_train_cli(root, sections), "ddp_train": phase_ddp_train(ckpt_dir, norm),
                "ddp_eval": phase_ddp_eval_cli(root)}


def scale_only(norm):
    """``--scale-only``: phase 22 with a Trainer of its own, then the
    datasets of phases 16-17 and phase 23."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        native = phase_native_checkpoint(ckpt_dir, norm)
    with tempfile.TemporaryDirectory() as root:
        sections = write_dataset(root, val_repeats=1)
        write_config(os.path.join(root, "eval_small.ini"), "superslomo_eval.ini", write_small_eval_dataset(root))
        return {"native": native, **scale_phase(root, sections, norm)}


def ddp_only(norm, world):
    """``--ddp-ranks N``: phases 23b and 23c at ``N`` ranks, one card a rank
    over NCCL where there are ``N`` cards (the global batch of 23b is 2 a
    rank; 23c's two samples padded to ``N``, so ranks past the second run
    the padding alone)."""
    with tempfile.TemporaryDirectory() as root:
        write_config(os.path.join(root, "eval_small.ini"), "superslomo_eval.ini", write_small_eval_dataset(root))
        return {"ddp_train": phase_ddp_train(root, norm, world=world, B=2 * world),
                "ddp_eval": phase_ddp_eval_cli(root, world=world)}


def ptxas_usage(log):
    """{kernel instance: ptxas's register, stack and shared-memory line} from
    an nvcc -Xptxas -v log; instances named by kernel and dtype."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"(?:warp_(?:multiflow_grad(?:_sum)?|multiflow|single_forward|single_flow_grad|"
                               r"single_img_grad)|grad_store)_kernel", mangled)
            dtype = "bf16" if "bfloat16" in mangled else "f32"
            name = f"{kernel.group(0) if kernel else mangled} {dtype}"
        elif name and "registers" in line:
            out[name] = line.split(":", 1)[1].strip()
            name = None
    return out


def check_backward_layouts(cases, recorded):
    """Raise unless the layout (``backward_layout``: the image's dtype, the
    strides of image, flow and output gradient) of every backward launch
    recorded in a train step is that of a gradient kernel case."""
    seen = {r["layout"] for r in recorded}
    missing = seen - set(cases)
    emit({"phase": "train_backward_layouts_covered", "layouts": sorted(seen), "missing": sorted(missing)})
    if missing:
        raise AssertionError(f"backward layouts of the train step with no gradient kernel case: {sorted(missing)}")


def check_forward_layouts(cases, recorded, path="ssmr"):
    """Raise unless every single-flow forward launch recorded on ``path``
    (the SSM-R stream's windows; the renderer's dump and the flow
    evaluator's samples) has the layout (``forward_layout``) of a forward
    kernel case."""
    seen = {tuple(tuple(x) if isinstance(x, list) else x for x in r) for r in recorded}
    missing = seen - cases
    emit({"phase": f"{path}_forward_layouts_covered", "layouts": sorted(seen), "missing": sorted(missing)})
    if missing:
        raise AssertionError(f"forward layouts of the {path} path with no forward kernel case: {sorted(missing)}")


def kernels_line(kern, single, ssmr_fwd, main_f32, main_bf16, train, ssmr_stream, ssmr_main, mf_grad, trains,
                 eval_cli, train_clis, render_fwd, renders, flow_eval, scaled):
    """Every kernel of the paths with its launches on the main paths (the
    SuperSloMo-R ones a step and a window as well, the single-flow kernels'
    a step of each train path in ``trains`` and of each train CLI run in
    ``train_clis``, the multi-flow kernel's a step of the eval CLI, both
    forward kernels' a window of each render CLI run in ``renders`` and the
    single-flow kernel's a sample of the flow-EPE CLI, the single-flow
    kernels' a step of each rank of the DDP Trainer and of the Trainer
    resumed from a native checkpoint, the multi-flow kernel's a fused step
    of each rank of the DDP eval CLI: ``scaled``, phases 22-23), error,
    times, bound, plain and library times; and the multi-flow warp's backward, its
    launches counted on every main path (none expected: serving runs without
    autograd, training uses the single-flow warp) and a backward in its own
    phase."""
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
        "ssmr_launches_per_step": {f"{r['compute_dtype']}_b{r['batch']}": r["launches"]["warp_multiflow"] / len(
            r["step_ms"]) for r in ssmr_main},
        "eval_cli_launches": eval_cli["warp_launches"], "eval_cli_launches_per_step": eval_cli["warp_launches_per_step"],
        "render_cli_launches_per_window": {r["phase"]: r["launches_per_window"]["warp_multiflow"] for r in renders},
        "ddp_eval_cli_launches_per_step_by_rank": scaled["ddp_eval"]["launches_per_step_by_rank"],
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
        "ssmr_launches_per_window": {r["compute_dtype"]: r["launches"]["warp_single"] / r["windows"]
                                     for r in ssmr_stream},
        "launches_per_train_step": {r["phase"]: r["launches_per_step"]["forward"] for r in trains},
        "launches_per_train_cli_step": {r["compute_dtype"]: r["launches_per_step"]["forward"] for r in train_clis},
        "render_cli_launches_per_window": {r["phase"]: r["launches_per_window"]["warp_single"] for r in renders},
        "flow_eval_cli_launches_per_sample": flow_eval["launches_per_sample"]["warp_single"],
        "launches_per_ddp_train_step_by_rank": [r["forward"] for r in scaled["ddp_train"]["launches_per_step_by_rank"]],
        "launches_per_resumed_train_step": scaled["native"]["resumed_step_launches"]["forward"],
        **{case: {k: single[case][k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms", "bound_ms")}
           for case in ("dense_flow", "smooth_flow", "720p_f32", "720p_bf16")},
        **{f"ssmr_window_{case}": {k: c[k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                     "bound_ms", "img_strides")}
           for case, c in ssmr_fwd["cases"].items()},
        **{case: {k: c[k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms", "bound_ms",
                                    "img_strides", "shape")}
           for case, c in render_fwd["cases"].items()},
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
            "launches_per_train_step": {r["phase"]: r["launches_per_step"][key] for r in trains},
            "launches_per_train_cli_step": {r["compute_dtype"]: r["launches_per_step"][key] for r in train_clis},
            "launches_per_ddp_train_step_by_rank": [r[key] for r in scaled["ddp_train"]["launches_per_step_by_rank"]],
            "launches_per_resumed_train_step": scaled["native"]["resumed_step_launches"][key],
            "cases": {case: {k: c[key].get(k) for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                        "bound_ms")}
                      for case, c in grad_cases.items()},
        }
        if key == "flow_grad":
            entry["cases"].update({f"720p_{tag}": {k: single[f"720p_{tag}"]["flow_grad"][k] for k in (
                "max_abs_err", "ms", "device_ms", "host_ms", "library_ms", "bound_ms")} for tag in ("f32", "bf16")})
        grads.append(entry)
    f32 = mf_grad[("step_flows", "f32")]
    bwd_by_path = {
        "main_path_float32": main_f32["warp_multiflow_backward_launches"],
        "main_path_bfloat16": main_bf16["warp_multiflow_backward_launches"],
        **{f"ssmr_stream_{r['compute_dtype']}": r["launches"]["warp_multiflow_backward"] for r in ssmr_stream},
        **{f"ssmr_main_path_{r['compute_dtype']}_b{r['batch']}": r["launches"]["warp_multiflow_backward"]
           + r.get("eval_warp_multiflow_backward_launches", 0) for r in ssmr_main},
        **{r["phase"]: r["launches"]["multiflow_backward"] for r in trains},
        "eval_cli_main_path": eval_cli["warp_multiflow_backward_launches"],
        **{f"train_cli_main_path_{r['compute_dtype']}": r["launches"]["multiflow_backward"] for r in train_clis},
        **{r["phase"]: r["launches"]["warp_multiflow_backward"] for r in renders},
        "flow_eval_cli_main_path": flow_eval["launches"]["warp_multiflow_backward"],
        "native_resumed_train_step": scaled["native"]["resumed_step_launches"]["multiflow_backward"],
        **{f"ddp_train_rank{i}": r["multiflow_backward"] for i, r in enumerate(scaled["ddp_train"]["launches_by_rank"])},
        **{f"ddp_eval_cli_rank{i}": n for i, n in enumerate(scaled["ddp_eval"]["multiflow_backward_by_rank"])},
    }
    mf_bwd = {
        "name": "warp_multiflow_grad", "route": "cuda",
        "source": "superslomo_tpu_torch/csrc/warp_multiflow.cu",
        "replaces": "superslomo_tpu/ops/warp_pallas.py:428",
        "launches": sum(bwd_by_path.values()), "launches_by_main_path": bwd_by_path,
        "launches_per_backward": f32["launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["backward"]["ms"], "device_ms": f32["backward"]["device_ms"], "host_ms": f32["backward"]["host_ms"],
        "kernel": f32["kernel"], "plain_ms": f32["plain_backward_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_backward_ms"], "fwd_bwd_ms": f32["fwd_bwd"]["ms"],
        "fwd_bwd_device_ms": f32["fwd_bwd"]["device_ms"], "plain_fwd_bwd_ms": f32["plain_fwd_bwd_ms"],
        "library_fwd_bwd_ms": f32["library_fwd_bwd_ms"], "shape": f32["shape"],
        "flows": "the step's (smooth, <= 30 px); the cases below at the same shape",
        "plain": "ops.warp_multiflow_backward_reference", "library": f32["library"],
        "cases": {f"{case}_{tag}": {k: r[k] for k in ("launches", "max_abs_err", "backward", "kernel", "fwd_bwd",
                                                      "plain_backward_ms", "library_backward_ms", "bound_ms")}
                  for (case, tag), r in mf_grad.items() if "kernel" in r and (case, tag) != ("step_flows", "f32")},
    }
    return [mf, fwd, *grads, mf_bwd]


def nvidia_smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--kernels-only", action="store_true", help="build, then only the kernel phases")
    ap.add_argument("--data-only", action="store_true",
                    help="build, then only the data path and command-line phases (15-17)")
    ap.add_argument("--render-only", action="store_true",
                    help="build, then only the renderer and flow-EPE command-line phases (18-21)")
    ap.add_argument("--scale-only", action="store_true",
                    help="build, then only the native checkpoint and data-parallel phases (22-23)")
    ap.add_argument("--ddp-ranks", type=int, default=None,
                    help="build, then only phases 23b-23c at this many ranks (one card a rank where there are "
                         "enough)")
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
        "cuda": torch.version.cuda, "cpu_count": os.cpu_count(), "kernel_build_s": time.perf_counter() - t0,
        "nvcc_ptxas": {name: ptxas_usage(log) for name, log in cuda_build.build_logs.items()},
    })

    cfg = default_config()
    norm = Normalize(cfg.pixel_mean(), cfg.pixel_std())
    if args.data_only:
        data_phases(norm)
        print(smi, flush=True)
        emit({"data_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0
    if args.render_only:
        render_phases(phase_render_forward_cases())
        print(smi, flush=True)
        emit({"render_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0
    if args.ddp_ranks:
        ddp_only(norm, args.ddp_ranks)
        print(smi, flush=True)
        emit({"ddp_ranks": args.ddp_ranks, "device": {"kind": torch.cuda.get_device_name(0),
                                                      "count": torch.cuda.device_count()}})
        return 0
    if args.scale_only:
        scale_only(norm)
        print(smi, flush=True)
        emit({"scale_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0

    clock_before = nvidia_smi("clocks.sm,clocks.max.sm")
    kern = phase_kernel()
    single = phase_single_kernels()
    ssmr_fwd = phase_ssmr_forward_cases()
    render_fwd = phase_render_forward_cases()
    mf_grad = phase_multiflow_grad()
    emit({"phase": "sm_clock", "before_kernel_phases": clock_before, "after_kernel_phases": nvidia_smi(
        "clocks.sm,clocks.max.sm"), "query": "clocks.sm,clocks.max.sm"})
    if args.kernels_only:
        print(smi, flush=True)
        emit({"kernels_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0
    phase_slice()
    batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=2, B=2, H=720, W=1280, seed=2)
    main_f32 = phase_main_path("float32", batches)
    main_bf16 = phase_main_path("bfloat16", batches)
    del batches
    phase_upsample_slices()
    phase_ssmr_slice()
    ssmr_stream = [phase_ssmr_stream(dtype) for dtype in ("bfloat16", "float32")]
    check_forward_layouts(ssmr_fwd["layouts"], [r for s in ssmr_stream for r in s["forward_layouts_first_window"]])
    ssmr_batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=2, B=2, H=720, W=1280, seed=8,
                                     n_frames=4)
    ssmr_main = phase_ssmr_main_path(ssmr_batches)
    del ssmr_batches
    with tempfile.TemporaryDirectory() as ckpt_dir:
        phase_train_vs_cpu(ckpt_dir, norm)
        phase_convergence(ckpt_dir)
        train, train_tr = phase_train_main(ckpt_dir, norm)
        native = phase_native_checkpoint(ckpt_dir, norm, train_tr, train["checkpoint"])
        del train_tr
        torch.cuda.empty_cache()
        phase_ssmr_train_vs_cpu(ckpt_dir, norm)
        ssmr_train, ssmr_remat = phase_ssmr_train_main(ckpt_dir, norm)
        bf16_train = phase_bf16_train_main(ckpt_dir, norm, train["loss_first"])
    trains = [train, ssmr_train, ssmr_remat, bf16_train]
    check_backward_layouts(single["layouts"], [r for t in trains for r in t["backward_layouts_first_step"]])
    _, eval_cli, train_clis, scaled = data_phases(norm, scale=True)
    renders, flow_eval, _ = render_phases(render_fwd)

    kernels = kernels_line(kern, single, ssmr_fwd, main_f32, main_bf16, train, ssmr_stream, ssmr_main, mf_grad,
                           trains, eval_cli, train_clis, render_fwd, renders, flow_eval, {"native": native, **scaled})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
