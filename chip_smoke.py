#!/usr/bin/env python3
"""Smoke run of the PyTorch port (superslomo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3: build, kernels against plain
    python3 chip_smoke.py --data-only      # phases 1 and 15-17: build, the image decoders, the data path, the CLIs
    python3 chip_smoke.py --render-only    # phases 1 and 18-21: build, the renderer (PNG and JPEG) and flow-EPE CLIs
    python3 chip_smoke.py --scale-only     # phases 1 and 22-23: build, native checkpoints, data parallel
    python3 chip_smoke.py --ddp-ranks 4    # phases 1 and 23b-c at 4 ranks (a card a rank on 4 cards)
    python3 chip_smoke.py --spatial-ranks 4  # phases 1, 5b and 14b at 2 and 4 ranks (a card a rank on 4 cards)

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
     beside grid_sample and the memory bound; then the kernel under a row
     window (``kernel_rows_vs_plain``: the halo warp of phase 5b, the first
     and the last of 2 spatial ranks' blocks of the 736-row pair extended by
     HALO_ROWS rows each side, f32 and bf16, the step's flows and noise
     with |v| up to 130 px) against its
     plain version with the same window;
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
     its bound and grid_sample's backward and forward + backward; then the
     single-flow forward and flow-gradient kernels under a row window
     (``phase_single_rows``, cases ``rows_*``: the last of 2 spatial ranks'
     blocks of the train step under a grid, 96 rows of 224 at B=32 through
     the pair's view and the head's flow, and 352 rows of 736 at B=2, f32
     and bf16, the image the whole frame) against their plain versions with
     the same window: the forward exact in f32 and the f32 result cast in
     bf16, the flow gradient within GRAD_KERNEL_REL; beside the whole-frame
     kernels (the same rows' results, their device ms over the frame), the
     bound of the block's bytes and grid_sample and its backward on the same
     rows; then the two gradient kernels that differentiate an image under a
     row window (``phase_windowed_grads``): the single-flow image gradient
     at B=32, 224², on the last of 2 ranks' rows [128, 224) against its
     288-row halo planes (frame rows [32, 320)), noise flows with patches
     shifted 150 px (taps past the planes' first row and the frame's last)
     and smooth flows, f32 and bf16, against autograd of the plain warp with
     the same window; the multi-flow backward at B=2, n=7 on rows [384, 736)
     of the 736-row pair against its 624-row halo planes, the step's flows
     and noise within 130 px in f32 and bf16 and +-200 px in f32, against
     the plain backward with the same window; each within GRAD_KERNEL_REL
     (bf16: plus the one rounding), timed beside the bound with the planes'
     rows, the kernel's device ms over the whole frame and grid_sample's
     backward on the same rows;
  4. serving slice on the card against the same slice on the CPU: the
     full-width model with seeded weights at 128x224, f32 with TF32 off;
  5. serving main path: the Evaluator at 720p (padded to 736), 8x, B=2, over
     a synthetic batch (two until the script neared its time limit), in f32
     and bf16, with the step's time, frames/s
     and peak memory, and the multi-flow kernel's launches counted per step;
     and the shipped eval batch, B=8, in one ``interpolate_multi_t`` call
     (``main_path_b8``, four slices of 2): its ms, frames/s, peak GiB (below
     the card's 80), 16 multi-flow launches, and its predictions and bound
     equal to four B=2 calls' on the same frames;
  5b. height sharding for serving (``sharded_serving``): 2 ranks on a
     (1 x 2) grid (NCCL, a card a rank, where there are two cards, else both
     on the one card over gloo, staging the halo rows through host memory),
     each with its 384- or 352-row block of phase 5's first batch: the fused
     step in f32 and bf16 against phase 5's one-process step (f32 within the
     serving bar, bf16 by the mean, the bound), with each rank's step ms,
     peak memory, 4 multi-flow launches, 60 halo exchanges and the MB it
     sends a step; the warp pair through the halo (the step's flows, noise
     within the 135-px reach) and through the whole height (+-200 px)
     against the one-process kernel; then the main path, the Evaluator on
     the grid over the batch: its scores against phase 5's, 4 launches a
     fused step a rank, no rerun; then the gradients
     (``sharded_gradients``): ``warp_spmd.warp_sharded`` and
     ``warp_multiflow_sharded`` (f32, bf16) on each rank's rows of 720p
     planes through the halo and the whole height, their image and flow
     gradients against one process's, and the f32 fused step at 720p B=1
     differentiated (the sum of its prediction's squares) by every parameter
     and the frames against one process's, by the relative L2 distance, with
     the backward exchanges and gathers and the windowed multi-flow backward
     launches (4) a rank. ``--spatial-ranks N`` runs it at 2 and N ranks,
     with one f32 step at 2176x3840 (4K), B=1, at N ranks on N cards;
  6. the decoder's last upsample of the 720p SuperSloMo-R step (batch 21,
     beyond the CUDA kernel's 32-bit indexing, so written in batch slices)
     bit for bit F.interpolate on the same slices, f32 and bf16, and under
     autograd in bf16 (a slice a call, joined) its output and input gradient
     bit for bit each slice's own F.interpolate and backward; then the
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
     Evaluator with the shipped recurrent config over a 4-frame batch;
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
      shape takes minutes) and with 5 timed steps, then with [TPU] REMAT (a
      lower peak, the same first loss);
  14. bf16 training: the Trainer at configs/superslomo_original.ini with
      [TPU] COMPUTE_DTYPE = bfloat16 as in phase 11: every parameter,
      gradient and Adam moment f32, the first loss beside the f32 one. The
      backward launches' layouts of phases 11, 13 and 14 must each be a
      gradient case of phase 3;
  14b. training under a spatial grid (``sharded_train``): 2 ranks on a (1 x
      2) grid (gloo on one card, NCCL a card a rank where there are two),
      each with its block of rows (128 + 96 of 224): the Trainer at
      configs/superslomo_original.ini, global B=8, f32, 2 steps, and at
      configs/superslomo_recurrent.ini, B=2, with [TPU] REMAT, 1 step, on
      cuDNN's heuristics, against one process's Trainer on the same batches:
      the first step's gradients within GRAD_REL of each tensor's max, every
      loss within LOSS_RTOL, the ranks' weights bit-identical; 8 single-flow
      forward and 8 flow-gradient launches a step a rank, all under a row
      window, no image gradient; the halo exchanges forward and backward,
      the MB sent and the gathers a step a rank; step ms and peak GiB a rank
      against one process's. ``--spatial-ranks N`` runs it at 2 and N ranks
      on the shipped training config (224², B=32) and a 720p f32 step at B=2;
  15. the PNG unfilter (csrc/png_unfilter.cpp, host C++) against its plain
      version on 720p frames that the script encodes itself (zlib and numpy),
      one file per filter type: both equal the written pixels bit for bit;
      the unfilter's and a whole decode's ms, compiled and plain, and a
      decode's on 12 threads, and the frame interlaced (Adam7): its decode
      equals the non-interlaced one; then the JPEG decode
      (csrc/jpeg_decode.cpp, host C++) against its plain version on a 720p
      frame that the script's own JPEG writer (numpy) writes at q95:
      baseline in 4:2:0, 4:4:4, grey and 4:2:0 with restart markers,
      progressive 4:2:0 (libjpeg's 10-scan script, its own optimal Huffman
      tables before each scan) with and without restarts, sequential in
      three scans, Adobe CMYK and YCCK: bit for bit, the decode ms beside
      the baseline's and the PNG decode's (``jpeg_decode_vs_plain``); then
      the raster readers (``raster_decode_vs_plain``) on the 720p frame as
      the script writes it in BMP (24-bit and RLE8), PPM, PGM, PAM, PFM,
      TIFF (none, LZW with the predictor, PackBits, Deflate in tiles,
      16-bit), Sun raster, HDR (run-length scanlines), GIF (the frame in a
      256-colour palette, and an interlaced sub-rectangle with a
      transparent index) and lossless WebP (the writer's transforms case:
      subtract-green, predictor, cross-colour, LZ77 copies and a colour
      cache; and its colour-indexing case at 16 colours), and lossy WebP
      (the script's own VP8 writer, ``vp8_bytes``: a B_PRED-heavy frame and
      one with the simple loop filter, their bytes and PSNR): each lossless
      decode equals what cv2 reads from the file, the compiled routines of
      csrc/raster_decode.cpp, csrc/webp_decode.cpp and csrc/vp8_decode.cpp
      equal their plain twins (WebP's on a 180x320 frame), and a
      progressive 4:2:0 JPEG cut after its third scan (block-smoothed)
      decodes as its plain twin; the decode ms and its ratio to PNG's; and
      the Loader (12 threads) over an ADOBE list naming the 57-frame clip's
      frames in turn as BMP, PPM, LZW TIFF, lossless and lossy WebP: its
      batches equal, bit for bit, those of the PNG list (PNG copies of the
      lossy frames' decode), each decoder's calls counted
      (``raster_loader_vs_png``);
  16. the eval CLI's main path: ``cli.evaluate_interpolation`` at
      configs/superslomo_eval.ini as shipped (720p padded to 736, B=8, 12
      loader threads, f32) over a made-up dataset of 720p PNGs in a
      temporary directory (a 17-frame val clip: 2 sliding windows, one
      batch, one fused-step slice of 2 samples): its metrics equal
      Evaluator.run on the same batches given explicitly, 4 multi-flow
      launches a slice, the wall time a batch
      beside the prepared run's and the Loader's; the CLI on the card
      against the CLI on the CPU over a 48x96 clip within the serving bar;
      then this slice's main path, the same CLI over those 17 frames as
      lossy WebP and over PNG copies of their decode: PSNR, SSIM and IE
      equal, 4 multi-flow launches a fused step counted from 0 just before
      the lossy run, the VP8 decoder's calls counted
      (``eval_cli_vp8_vs_png_copy``);
  17. the train CLI's main path: ``cli.train`` at
      configs/superslomo_original.ini as shipped (ALL: ADOBE and NFS clip
      lists naming the 57 frames 280 times each, 80 Vimeo septuplets: 20
      batches, so the Loader keeps decoding through every step; B=32,
      224x224 crops, 12 loader threads), in f32 and bf16, 5 steps through
      the pinned side-stream feed: step ms, the wait for the feed before each
      step, the same Trainer's step on in-memory batches, the Loader's ms a
      batch, 8 single-flow forward and 8 flow-gradient launches a step;
      then in f32 for 4 steps over ADOBE and NFS clip lists naming the
      clip written again with its frames in turn as JPEG, GIF, lossless and
      lossy WebP (``train_cli_main_path`` with ``frames``
      "gif+jpg+vp8+webp"), each decoder's calls counted.
  18. the render CLI's main path: ``cli.visualize`` at
      configs/superslomo_eval.ini's model (CONV, f32, TF32 off) over a
      9-frame 720p panning clip at 8x (8 windows, 65 frames written), and in
      bf16 over 4 windows; the file names and count, every file decoded to
      720x1280, the originals equal to the input frames bit for bit, 4
      multi-flow and no single-flow launch a window; wall s, frames written
      a second, and the ms a window split into decode, fused step (CUDA
      events) and encode; then in f32 over 4 windows of the clip written as
      JPEG frames of five kinds (baseline, progressive, sequential in three
      scans, Adobe CMYK, progressive cut after its third scan), and over PNG
      copies of the port's decode of them:
      the two runs' files equal byte for byte (``render_jpeg_vs_png_copy``);
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
(``--kernels-only``) for a same-card comparison; the row-window cases
(``phase_kernel_rows``, ``phase_single_rows``) need a package whose warp
wrappers take a row window.
"""

import argparse
import configparser
import contextlib
import functools
import heapq
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


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; each phase's line carries the script's seconds so far
    (``t_s``), so that the phases' durations can be read from the output."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
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


def warp_bound(B, C, n, H, W, in_bytes, out_bytes, planes_rows=None):
    """Least time of one multi-flow warp: each input read once (planes of
    ``planes_rows`` rows, by default H) and each output written once, against
    12 f32 operations per (pixel, flow) for the position and weights and 7
    per channel for the taps."""
    Hp = H if planes_rows is None else planes_rows
    nbytes = B * C * Hp * W * in_bytes + 2 * B * n * H * W * 4 + B * C * n * H * W * out_bytes
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


def _mf_library(p, u, v, row_off=0):
    """grid_sample over the planes tiled n times: one f32 call computing the
    same warp (a bf16 grid could not address 1280 columns; for bf16 planes it
    samples the same bf16 values in f32, as the kernel does). ``row_off``:
    the planes' row of the flows' first row (a row window's y_base -
    p_base; rows past the frame are zeros in the planes there)."""
    B, n, H, W = u.shape
    C, Hp = p.shape[1], p.shape[2]
    xs = torch.arange(W, device=u.device, dtype=torch.float32)
    ys = torch.arange(H, device=u.device, dtype=torch.float32)[:, None] + row_off
    grid = torch.stack([2 * (xs + u) / (W - 1) - 1, 2 * (ys + v) / (Hp - 1) - 1], dim=-1).reshape(B * n, H, W, 2)
    tiled = p.float()[:, None].expand(B, n, C, Hp, W).reshape(B * n, C, Hp, W)
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


def sharded_window_cases():
    """(case, dtype tag, planes, u, v, RowWindow) at the sharded serving
    path's shapes (phase 5b): the first and the last of 2 spatial ranks'
    blocks of a 736-row frame (384 and 352 rows), the 6-channel pair's
    channels_last slice extended by HALO_ROWS rows of each neighbour (zeros
    past the frame), n=7 flows of the block's rows, f32 and bf16 planes;
    the step's kind of flows (smooth, up to ~30 px: its rows of phase 2's),
    and noise with |v| up to 130 px (within the halo's reach)."""
    from superslomo_tpu_torch.parallel import halo

    B, n, H, W, hv = 2, 7, 736, 1280, halo.HALO_ROWS
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    pair = torch.from_numpy(rng.standard_normal((B, H + 2 * hv, W, 6), dtype=np.float32)).to(dev)
    pair[:, :hv] = 0
    pair[:, hv + H:] = 0  # the frame's top and bottom halos are zeros
    pair = pair.permute(0, 3, 1, 2)
    su, sv = step_flows(np.random.default_rng(11), B, n, H, W, dev)
    cases = []
    for rank, (y0, rows) in enumerate(((0, 384), (384, 352))):
        window = halo.RowWindow(y0, y0 - hv, rows + 2 * hv, H)
        planes = pair[:, :, y0:y0 + rows + 2 * hv]
        flows = {"step_flows": (su[:, :, y0:y0 + rows], sv[:, :, y0:y0 + rows]), "noise_130px": tuple(
            torch.from_numpy(x).to(dev) for x in (rng.normal(0.0, 7.0, (B, n, rows, W)).astype(np.float32),
                                                  rng.uniform(-130.0, 130.0, (B, n, rows, W)).astype(np.float32)))}
        for kind, (u, v) in flows.items():
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                cases.append((f"rank{rank}_of_2_{kind}", tag, planes.to(dt)[:, 3:6], u, v, window))
    return cases


def phase_kernel_rows():
    """The multi-flow kernel under a row window (the halo warp of phase 5b:
    positions in frame rows, the planes' rows around the block's) against
    its plain version with the same window, exact in f32 and the f32 result
    cast in bf16; timed beside the memory bound and grid_sample over the
    extended planes."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops import warp_cuda

    kernel, plain = warp_cuda.warp_multiflow_planar_cuda, ops.warp_multiflow_planar_reference
    out = {}
    for case, tag, p, u, v, window in sharded_window_cases():
        B, C, Hp, W = p.shape
        n, H = u.shape[1], u.shape[2]
        call = lambda: kernel(p, u, v, rows=window)  # noqa: E731
        got, want = call(), plain(p, u, v, p.dtype, rows=window)
        lib = _mf_library(p, u, v, row_off=window.y_base - window.p_base)
        torch.cuda.synchronize()
        err, same = check_mf(f"{case} {tag}", p, u, v, got, want, lambda: kernel(p.float(), u, v, rows=window))
        res = {
            "shape": [B, C, n, H, W], "planes_rows": Hp, "window": list(window), "planes_strides": list(p.stride()),
            "max_abs_err": err, "library_max_abs_diff": (lib().reshape(B, n, C, H, W).transpose(1, 2)
                                                         - got.float()).abs().max().item(),
            **timings(call), "plain_ms": cuda_ms(lambda: plain(p, u, v, p.dtype, rows=window), reps=20, warmup=1),
            "library_ms": cuda_ms(lib), "max_abs_flow": max(u.abs().max().item(), v.abs().max().item()),
        }
        if same is not None:
            res["bit_identical_to_f32_cast"] = same
        res["bound_ms"], res["bound_by"] = warp_bound(B, C, n, H, W, p.element_size(), got.element_size(), Hp)
        out[(case, tag)] = res
        emit({"phase": "kernel_rows_vs_plain", "case": case, "dtype": tag, **res})
    return out


def multiflow_grad_bound(B, C, n, H, W, esize, planes_rows=None):
    """Least time of the multi-flow warp's backward, as (ms, bound_by): the
    planes (of ``planes_rows`` rows, by default H), u, v and the output
    gradient read once, the three gradients written once, against the f32
    operations per (pixel, flow): 12 for the position and weights, per
    channel 12 for the flow gradient's taps and 8 for the image gradient's
    scatter."""
    Hp = H if planes_rows is None else planes_rows
    nbytes = 2 * B * C * Hp * W * esize + 4 * B * n * H * W * 4 + B * C * n * H * W * esize
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


def single_bounds(B, C, H, W, esize, planes_rows=None):
    """Least times of the single-flow kernels, as (ms, bound_by) each: every
    input read once and every output written once (the image, and the image
    gradient, of ``planes_rows`` rows, by default H), against the f32
    operations per pixel (12 for the position and weights; per channel 7 for
    the forward's taps, 12 for the flow gradient's, 8 for the image
    gradient's scatter)."""
    img = B * C * (H if planes_rows is None else planes_rows) * W * esize
    out, flow, px = B * C * H * W * esize, B * 2 * H * W * 4, B * H * W

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    return {
        "forward": bound(img + out + flow, px * (12 + 7 * C)),
        "flow_grad": bound(img + out + 2 * flow, px * (12 + 12 * C)),  # img, g, flow in; grad_flow out
        "img_grad": bound(out + img + flow, px * (12 + 8 * C)),  # g, flow in; grad_img out in the image's dtype
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


def _grid_rows(flow, y_base, H):
    """grid_sample's normalised sample positions of a (B, 2, h, W) flow of
    frame rows [y_base, y_base + h) over an image of the frame's H rows."""
    W = flow.shape[-1]
    xs = torch.arange(W, device=flow.device, dtype=torch.float32)
    ys = torch.arange(y_base, y_base + flow.shape[2], device=flow.device, dtype=torch.float32)[:, None]
    return torch.stack([2 * (xs + flow[:, 0]) / (W - 1) - 1, 2 * (ys + flow[:, 1]) / (H - 1) - 1], dim=-1)


def single_window_cases(rng, dev):
    """(case, dtype tag, image, the whole frame's flow, the window) of the
    single-flow kernels under a row window, as the train step under a
    spatial grid launches them: the image the whole frame gathered, the flow
    and the output the last of 2 spatial ranks' blocks. At 224² (the shipped
    training shape, B=32: rows [128, 224), 96 of 224) the image is the
    frame's view of a 6-channel pair (pixel stride 6) and the flow a
    4-channel head's (stride 4); at 720p (B=2, rows [384, 736), 352 of 736)
    NCHW; noise flows (std 4 and 7 px) with patches shifted 150 px, f32 and
    the bf16 pair."""
    from superslomo_tpu_torch.parallel import halo
    from superslomo_tpu_torch.parallel.mesh import row_blocks

    cases = []
    for case, B, H, W, std, pair_view in (("train224_rank1_of_2", 32, 224, 224, 4.0, True),
                                          ("720p_rank1_of_2", 2, 736, 1280, 7.0, False)):
        y0 = row_blocks(H, 2)[0]
        window = halo.RowWindow(y0, 0, H, H)
        flow = _flow_field(rng, B, H, W, std, 150.0)
        if pair_view:
            pairs = _channels_last(rng, B, 6, H, W, dev)
            head = np.concatenate([flow, rng.normal(0, std, (B, H, W, 2)).astype(np.float32)], -1)
            flow = torch.from_numpy(head).to(dev).permute(0, 3, 1, 2)[:, 0:2]
            imgs = {"f32": pairs[:, 3:6], "bf16": pairs.bfloat16()[:, 3:6]}
        else:
            img = torch.from_numpy(rng.standard_normal((B, 3, H, W), dtype=np.float32)).to(dev)
            flow = torch.from_numpy(flow).to(dev).permute(0, 3, 1, 2).contiguous()
            imgs = {"f32": img, "bf16": img.bfloat16()}
        for tag, img in imgs.items():
            cases.append((case, tag, img, flow, window))
    return cases


def phase_single_rows():
    """The single-flow forward and flow-gradient kernels under a row window
    (``single_window_cases``) against their plain versions with the same
    window: the forward exact in f32 and the f32 result cast in bf16, the
    flow gradient within GRAD_KERNEL_REL of the max; beside the whole-frame
    kernels on the same rows (the windowed results equal to their rows,
    reported) and their device ms over the whole frame. Each timed beside
    the bound of the block's bytes, the plain version and grid_sample (its
    backward computing the grid's gradient alone) on the same rows, a grid
    over the whole-height image."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as fwd

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    out = {}
    for case, tag, img, whole_flow, window in single_window_cases(rng, dev):
        B, C, H, W = img.shape
        rows = slice(window.y_base, H)
        flow = whole_flow[:, :, rows]
        h = flow.shape[2]
        g = torch.from_numpy(rng.standard_normal((B, C, h, W), dtype=np.float32)).to(dev, img.dtype)
        got = fwd(img, flow, rows=window)
        want = ops.warp_single_reference(img, flow, rows=window)
        whole = fwd(img, whole_flow)[:, :, rows]
        fl = flow.detach().clone().requires_grad_(True)
        want_gf, = torch.autograd.grad(ops.warp_single_reference(img.float(), fl, rows=window), fl, g.float())
        _, got_gf = bwd(img, flow, g, False, True, rows=window)
        g_whole = torch.zeros((B, C, H, W), device=dev, dtype=img.dtype)
        g_whole[:, :, rows] = g
        whole_gf = bwd(img, whole_flow, g_whole, False, True)[1][:, :, rows]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        bounds = single_bounds(B, C, h, W, img.element_size())
        img32, g32 = img.float(), g.float()
        grid = _grid_rows(flow, window.y_base, H)
        res = {
            "shape": [B, C, h, W], "frame_rows": H, "window": list(window), "img_strides": list(img.stride()),
            "flow_strides": list(flow.stride()), "max_abs_err": err,
            "equal_to_whole_frame_rows": bool(torch.equal(got, whole)),
            **timings(lambda: fwd(img, flow, rows=window)),
            "whole_frame_device_ms": cuda_ms(lambda: fwd(img, whole_flow), queued=True),
            "plain_ms": cuda_ms(lambda: ops.warp_single_reference(img, flow, rows=window), reps=5, warmup=1),
            "library_ms": cuda_ms(lambda: _grid_sample(img32, grid)),
            "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1],
        }
        if tag == "bf16":
            res["bit_identical_to_f32_cast"] = torch.equal(
                got.view(torch.int16), fwd(img32, flow, rows=window).bfloat16().view(torch.int16))
        grad = {
            "max_abs_err": (got_gf - want_gf).abs().max().item(),
            "bar": GRAD_KERNEL_REL * want_gf.abs().max().item(),
            "equal_to_whole_frame_rows": bool(torch.equal(got_gf, whole_gf)),
            **timings(lambda: bwd(img, flow, g, False, True, rows=window)),
            "whole_frame_device_ms": cuda_ms(lambda: bwd(img, whole_flow, g_whole, False, True), queued=True),
            "library_ms": cuda_ms(lambda: _library_grads(img32, grid, g32, [False, True])),
            "bound_ms": bounds["flow_grad"][0], "bound_by": bounds["flow_grad"][1],
        }
        res["flow_grad"] = grad
        out[(case, tag)] = res
        emit({"phase": "single_kernels_vs_plain", "case": f"rows_{case}", "dtype": tag,
              **{k: v for k, v in res.items() if k != "flow_grad"}})
        emit({"phase": "single_grad_kernels_vs_plain", "case": f"rows_{case}", "dtype": tag, "flow_grad": grad})
        ok = (err == 0.0 if tag == "f32" else res["bit_identical_to_f32_cast"]
              and err <= 2.0**-7 * want.float().abs().max().item())
        if not ok or grad["max_abs_err"] > grad["bar"]:
            raise AssertionError(f"single-flow kernels under a row window, {case} {tag}: {res}")
    return out


def img_grad_window_cases(rng, dev):
    """(case, dtype tag, image, flow, output gradient, window) of the
    single-flow image gradient under a row window, as ``warp_spmd.warp_sharded``
    launches it on the last of 2 spatial ranks at the training shape (B=32,
    224², rows [128, 224)): the image its halo planes, frame rows [32, 320),
    288 rows (96 of the rank above, its own 96, 96 of zeros past the frame),
    the frame of a 6-channel pair (pixel stride 6), the flow a 4-channel
    head's (stride 4); noise flows (std 4 px) with patches shifted 150 px,
    whose taps pass the planes' first row and the frame's last, and smooth
    flows up to 10 px; f32 and the bf16 pair."""
    from superslomo_tpu_torch.parallel import halo
    from superslomo_tpu_torch.parallel.mesh import row_blocks

    B, C, H, W = 32, 3, 224, 224
    blocks = row_blocks(H, 2)
    y0, h = blocks[0], blocks[1]
    hv = min(halo.HALO_ROWS, min(blocks))
    window = halo.RowWindow(y0, y0 - hv, h + 2 * hv, H)
    frame = _channels_last(rng, B, 6, H, W, dev)
    pair = torch.zeros((B, window.p_rows, W, 6), device=dev).permute(0, 3, 1, 2)
    pair[:, :, :H - window.p_base] = frame[:, :, window.p_base:]
    flows = {"noise_150px": _flow_field(rng, B, h, W, 4.0, 150.0),
             "smooth_10px": smooth_flows(rng, B, h, W, 10.0).transpose(0, 2, 3, 1)}
    cases = []
    for kind, f in flows.items():
        head = np.concatenate([f, rng.normal(0, 4, (B, h, W, 2)).astype(np.float32)], -1)
        flow = torch.from_numpy(np.ascontiguousarray(head)).to(dev).permute(0, 3, 1, 2)[:, 0:2]
        g = torch.from_numpy(rng.standard_normal((B, C, h, W), dtype=np.float32)).to(dev)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            cases.append((f"train224_rank1_of_2_{kind}", tag, pair.to(dt)[:, 3:6], flow, g.to(dt), window))
    return cases


def mf_grad_window_cases():
    """(case, dtype tag, planes, u, v, output gradient, window) of the
    multi-flow backward under a row window: the last of 2 spatial ranks'
    cases of ``sharded_window_cases`` (rows [384, 736) of the 736-row pair at
    B=2, n=7, against its 624-row halo planes: the step's flows and noise
    with |v| up to 130 px, f32 and bf16), and f32 flows uniform within +-200
    px, whose taps pass the planes' first row and the frame's last."""
    cases = []
    rng = np.random.default_rng(31)
    for case, tag, p, u, v, window in sharded_window_cases():
        if not case.startswith("rank1"):
            continue
        g = torch.from_numpy(rng.standard_normal(p.shape[:2] + u.shape[1:], dtype=np.float32)).to(p.device)
        cases.append((case, tag, p, u, v, g.to(p.dtype), window))
        if case.endswith("noise_130px") and tag == "f32":
            far = tuple(torch.from_numpy(rng.uniform(-200.0, 200.0, u.shape).astype(np.float32)).to(p.device)
                        for _ in range(2))
            cases.append(("rank1_of_2_200px", tag, p, *far, g, window))
    return cases


def phase_windowed_grads():
    """The gradient kernels under a row window against their plain versions
    on the card: the single-flow image gradient (``img_grad_window_cases``;
    with the flow gradient launched beside it) against autograd of
    ``ops.warp_single_reference(..., rows=)``, and the multi-flow backward
    (``mf_grad_window_cases``, all three gradients, through the wrapper and
    through ``ops._WarpMultiflow``: one launch, 3 device operations, counted
    as windowed) against ``ops.warp_multiflow_backward_reference(...,
    rows=)``; each within GRAD_KERNEL_REL of the reference's max (bf16: plus
    the planes' gradient's one rounding). Each timed (ms, device_ms,
    host_ms) beside its bound with the planes' rows, the same kernel's
    device ms over the whole frame (the block's flows and output gradient,
    zeros elsewhere), and grid_sample's backward computing the image's (the
    planes') gradient alone on the same rows."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda as mf_kernel
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd

    dev = torch.device("cuda")
    out = {"img_grad": {}, "mf_grad": {}}
    for case, tag, img, flow, g, window in img_grad_window_cases(np.random.default_rng(41), dev):
        B, C, Hp, W = img.shape
        h = flow.shape[2]
        im = img.detach().float().requires_grad_(True)
        fl = flow.detach().clone().requires_grad_(True)
        want_gi, want_gf = torch.autograd.grad(ops.warp_single_reference(im, fl, rows=window), (im, fl), g.float())
        bwd.windowed_img_grad_launches = 0
        got_gi, _ = bwd(img, flow, g, True, False, rows=window)
        both_gi, both_gf = bwd(img, flow, g, True, True, rows=window)
        torch.cuda.synchronize()
        gi_bar = GRAD_KERNEL_REL * want_gi.abs().max().item()
        gi_tol = gi_bar + (2.0**-8 * want_gi.abs() if img.dtype == torch.bfloat16 else 0.0)
        gf_bar = GRAD_KERNEL_REL * want_gf.abs().max().item()
        # the same work over the whole frame: the block's flow and output gradient, zeros elsewhere
        frame_img = torch.zeros((B, C, window.frame_rows, W), device=dev, dtype=img.dtype)
        top = max(0, window.p_base)
        frame_img[:, :, top:] = img[:, :, top - window.p_base:window.frame_rows - window.p_base]
        whole_flow = torch.zeros((B, 2, window.frame_rows, W), device=dev)
        whole_flow[:, :, window.y_base:window.y_base + h] = flow
        whole_g = torch.zeros((B, C, window.frame_rows, W), device=dev, dtype=img.dtype)
        whole_g[:, :, window.y_base:window.y_base + h] = g
        grid = _grid_rows(flow, window.y_base - window.p_base, Hp)  # over the planes' rows
        img32, g32 = img.float(), g.float()
        bound = single_bounds(B, C, h, W, img.element_size(), planes_rows=Hp)["img_grad"]
        res = {
            "shape": [B, C, h, W], "planes_rows": Hp, "window": list(window), "img_strides": list(img.stride()),
            "flow_strides": list(flow.stride()), "max_abs_err": (got_gi.float() - want_gi).abs().max().item(),
            "bar": gi_bar, "bf16_rounding_allowed": img.dtype == torch.bfloat16,
            "flow_grad_beside_max_abs_err": (both_gf - want_gf).abs().max().item(), "flow_grad_bar": gf_bar,
            "windowed_launches": bwd.windowed_img_grad_launches,
            "max_abs_flow": flow.abs().max().item(),
            **timings(lambda: bwd(img, flow, g, True, False, rows=window)),
            "whole_frame_device_ms": cuda_ms(lambda: bwd(frame_img, whole_flow, whole_g, True, False), queued=True),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                ops.warp_single_reference(im, fl.detach(), rows=window), im, g.float()), reps=5, warmup=1),
            "library_ms": cuda_ms(lambda: _library_grads(img32, grid, g32, [True, False])),
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        ok = (bool(((got_gi.float() - want_gi).abs() <= gi_tol).all())
              and bool(((both_gi.float() - want_gi).abs() <= gi_tol).all())
              and res["flow_grad_beside_max_abs_err"] <= gf_bar and got_gi.dtype == img.dtype
              and got_gi.shape == img.shape and res["windowed_launches"] == 2)
        out["img_grad"][(case, tag)] = res
        emit({"phase": "single_grad_kernels_vs_plain", "case": f"rows_img_grad_{case}", "dtype": tag, **res})
        if not ok:
            raise AssertionError(f"the image gradient under a row window, {case} {tag}: {res}")
    for case, tag, p, u, v, g, window in mf_grad_window_cases():
        B, C, Hp, W = p.shape
        n, h = u.shape[1], u.shape[2]
        want = ops.warp_multiflow_backward_reference(p.float(), u, v, g.float(), True, True, rows=window)
        leaves = [x.detach().requires_grad_(True) for x in (p, u, v)]
        result = ops.warp_multiflow_planar(*leaves, rows=window)
        mf_kernel.launches = mf_kernel.windowed = ops._WarpMultiflow.launches = 0
        through = torch.autograd.grad(result, leaves, g)
        launches = {"kernel": mf_kernel.launches, "windowed": mf_kernel.windowed,
                    "multiflow_backward": ops._WarpMultiflow.launches}
        got = mf_kernel(p, u, v, g, True, True, rows=window)
        torch.cuda.synchronize()
        errs, ok = check_mf_grads(got, want, p.dtype)
        errs_through, ok_through = check_mf_grads(through, want, p.dtype)
        ok &= ok_through and launches == {"kernel": 1, "windowed": 1, "multiflow_backward": 3}
        ok &= got[0].shape == p.shape and got[1].shape == u.shape
        whole_p = torch.zeros((B, C, window.frame_rows, W), device=dev, dtype=p.dtype)
        top = max(0, window.p_base)
        whole_p[:, :, top:] = p[:, :, top - window.p_base:window.frame_rows - window.p_base]
        whole_uvg = []
        for x in (u, v, g):
            z = torch.zeros(x.shape[:-2] + (window.frame_rows, W), device=dev, dtype=x.dtype)
            z[..., window.y_base:window.y_base + h, :] = x
            whole_uvg.append(z)
        xs = torch.arange(W, device=dev, dtype=torch.float32)
        ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + (window.y_base - window.p_base)
        grid = torch.stack([2 * (xs + u) / (W - 1) - 1, 2 * (ys + v) / (Hp - 1) - 1], dim=-1).reshape(B * n, h, W, 2)
        tiled = p.float()[:, None].expand(B, n, C, Hp, W).reshape(B * n, C, Hp, W)
        g_lib = g.float().transpose(1, 2).reshape(B * n, C, h, W)
        bound = multiflow_grad_bound(B, C, n, h, W, p.element_size(), planes_rows=Hp)
        res = {
            "shape": [B, C, n, h, W], "planes_rows": Hp, "window": list(window), "planes_strides": list(p.stride()),
            "grads": errs, "grads_through_autograd": errs_through, "launches": launches,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_abs_flow": max(u.abs().max().item(), v.abs().max().item()),
            **timings(lambda: mf_kernel(p, u, v, g, True, True, rows=window)),
            "whole_frame_device_ms": cuda_ms(lambda: mf_kernel(whole_p, *whole_uvg, True, True), queued=True),
            "plain_ms": cuda_ms(lambda: ops.warp_multiflow_backward_reference(p, u, v, g, True, True, rows=window),
                                reps=5, warmup=1),
            "library_ms": cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_lib, tiled, grid, 0, 0, True, [True, True])),
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        out["mf_grad"][(case, tag)] = res
        emit({"phase": "multiflow_grad_vs_plain", "case": f"rows_{case}", "dtype": tag, **res})
        if not ok:
            raise AssertionError(f"the multi-flow backward under a row window, {case} {tag}: {res}")
        del result, through, got, want, whole_p, whole_uvg, tiled, grid, g_lib
        torch.cuda.empty_cache()
    return out


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

        def recording(img, flow, **window):
            self.layouts.append(forward_layout(img, flow))
            return self.inner(img, flow, **window)

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
    a time: f32 and bf16, bit for bit ``F.interpolate`` on the same slices.
    Then under autograd in bf16 (a train step at that batch: one
    ``F.interpolate`` a slice, joined by ``torch.cat``): the output bit for
    bit each slice's own ``F.interpolate``, the graph a ``torch.cat`` of one
    upsample a slice, and the input's gradient for a standard normal output
    gradient against each slice's own backward. That backward is not
    reproducible on the card (its atomic adds run in a varying order: on an
    H100, two calls on 4 samples of this shape differed in 47 M elements, by
    up to 0.109 at values up to 7.19), so the gradient is
    gated within twice the largest difference between two of the library's
    own calls on the same slices, measured here: bit for bit where they
    agree."""
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
    x = torch.randn((N, H, W, C), generator=gen, device="cuda").bfloat16().permute(0, 3, 1, 2).requires_grad_(True)
    got = resize.upsample_2x_bilinear(x)
    g = torch.randn(got.shape, generator=gen, device="cuda").bfloat16()
    grad, = torch.autograd.grad(got, x, g, retain_graph=True)
    parts = got.grad_fn.next_functions
    graph = (type(got.grad_fn).__name__ == "CatBackward0" and len(parts) == -(-N // step)
             and all(type(f).__name__ == "UpsampleBilinear2DBackward0" for f, _ in parts))
    same, grad_diff, spread = True, 0.0, 0.0
    for i in range(0, N, step):
        xs = x[i : i + step].detach().requires_grad_(True)
        want = F.interpolate(xs, scale_factor=2, mode="bilinear", align_corners=False)
        same &= torch.equal(got[i : i + step], want)
        ref_a, ref_b = (torch.autograd.grad(want, xs, g[i : i + step], retain_graph=True)[0] for _ in range(2))
        grad_diff = max(grad_diff, (grad[i : i + step].float() - ref_a.float()).abs().max().item())
        spread = max(spread, (ref_a.float() - ref_b.float()).abs().max().item())
        del want, ref_a, ref_b
    res["bf16_autograd"] = {"bit_identical": same, "graph_cat_of_slice_upsamples": graph,
                            "grad_max_abs_diff": grad_diff, "library_run_to_run_max_abs_diff": spread,
                            "grad_max_abs": grad.float().abs().max().item(), "requires_grad": got.requires_grad,
                            "channels_last": got.is_contiguous(memory_format=torch.channels_last),
                            "output_elements": got.numel()}
    del x, got, g, grad, parts
    torch.cuda.empty_cache()
    emit(res)
    auto = res["bf16_autograd"]
    if not all(res[tag]["bit_identical"] and res[tag]["channels_last"] for tag in ("f32", "bf16", "bf16_autograd")) \
            or not (auto["graph_cat_of_slice_upsamples"] and auto["requires_grad"]
                    and auto["grad_max_abs_diff"] <= 2 * auto["library_run_to_run_max_abs_diff"]):
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


def phase_main_path(dtype, batches, steps=6):
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
        pred, bound = model.interpolate_multi_t(frames, t_values, with_bounds=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    B, n_t = frames.shape[0], t_values.shape[0]
    big = big_batch_call(model, frames, t_values, dtype)

    counter.launches = ops._WarpMultiflow.launches = 0
    t0 = time.perf_counter()
    ev = Evaluator(cfg, model)
    results = ev.run(batches)
    wall = time.perf_counter() - t0
    launches, bwd_launches = counter.launches, ops._WarpMultiflow.launches
    res = {
        "phase": "main_path", "compute_dtype": dtype, "batch": B, "n_t": n_t,
        "frame_hw": list(frames.shape[2:4]), "step_ms_median": statistics.median(times),
        "step_ms": times, "frames_per_s": B * n_t / (statistics.median(times) / 1e3),
        "peak_mem_gib": peak / 2**30, "eval_batches": len(batches), "eval_wall_s": wall,
        "warp_launches": launches, "warp_multiflow_backward_launches": bwd_launches, **results,
        "b8": {k: v for k, v in big.items() if k != "phase"},
    }
    emit(res)
    if launches != 4 * len(batches) or bwd_launches != 0:
        raise AssertionError(f"{launches} warp launches ({bwd_launches} of its backward) over {len(batches)} "
                             "steps, expected 4 per step (none)")
    if not all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"], results["max_flow_bound"]])):
        raise AssertionError(f"non-finite metrics: {results}")
    # the first batch's step and scores, for the sharded step of phase 5b
    n = B * n_t
    res["reference"] = {"pred": pred.cpu(), "bound": float(bound), "scores": [ev.psnr[:n], ev.ssim[:n], ev.ie[:n]],
                        "eval_bound": ev.bounds[0]}
    return res


def big_batch_call(model, frames, t_values, dtype, B=8, reps=2):
    """The shipped eval batch in one ``interpolate_multi_t`` call: ``B``
    samples at 720p 8x (phase 5's two, mirrored left-right, upside down and
    both), which the model runs as slices of its ``step_samples`` (2 here,
    the B=2 step's shapes); the host ms of a call (synchronised, median of
    ``reps``), its peak GiB and multi-flow launches (4 a slice), and the max
    abs difference of its predictions from B / 2 calls of 2 samples on the
    same frames (the same shapes and cuDNN algorithms: 0.0 expected) and of
    its bound from theirs."""
    from superslomo_tpu_torch.models.superslomo import step_samples
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter

    frames = torch.cat([frames, frames.flip(3), frames.flip(2), frames.flip(2).flip(3)])[:B]
    per = step_samples(frames.shape[2], frames.shape[3], t_values.shape[0], frames.shape[1] - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred, bound = model.interpolate_multi_t(frames, t_values, with_bounds=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = counter.launches / reps
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = [model.interpolate_multi_t(frames[i:i + 2], t_values, with_bounds=True) for i in range(0, B, 2)]
    diff = (pred - torch.cat([p for p, _ in parts])).abs().max().item()
    ms = statistics.median(times)
    res = {"phase": "main_path_b8", "compute_dtype": dtype, "batch": B, "step_samples": per, "call_ms": ms,
           "call_ms_each": times, "frames_per_s": B * t_values.shape[0] / (ms / 1e3), "peak_mem_gib": peak,
           "warp_launches_per_call": launches, "max_abs_diff_vs_b2_calls": diff,
           "bound": float(bound), "bound_of_b2_calls": max(float(b) for _, b in parts),
           "finite": bool(torch.isfinite(pred).all()), "shape": list(pred.shape)}
    emit(res)
    del pred, parts
    torch.cuda.empty_cache()
    if not (res["finite"] and res["shape"] == [B, t_values.shape[0], *frames.shape[2:4], 3] and per == 2
            and launches == 4 * B // per and diff == 0.0 and res["bound"] == res["bound_of_b2_calls"]
            and peak < 80):
        raise AssertionError(f"the B={B} call differs from {B // 2} B=2 calls or passes the card: {res}")
    return res


# a bf16 step of the spatial ranks against one process's bf16 step on the same
# card: the ranks' convs run other cuDNN algorithms (heuristics, other
# shapes), so their bf16 roundings differ, and a flow's rounding moves its
# warp by up to a bf16 ulp of the flow; held by the mean, at a tenth of the
# bf16-against-f32 bar of phase 8
SHARD_BF16_MEAN = 1e-3


def _serving_config(dtype, H=720, W=1280):
    from superslomo_tpu_torch import default_config

    cfg = default_config(DATA_DATASET="ADOBE", TPU_COMPUTE_DTYPE=dtype)
    cfg.set("ADOBE_DATA", "H_IN", H)
    cfg.set("ADOBE_DATA", "W_IN", W)
    return cfg


def serving_batch(norm):
    """Phase 5's first batch: 2 samples of 720p padded to 736, 7 targets."""
    from superslomo_tpu_torch.data.augmentations import eval_padding_for

    return synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=1, B=2, H=720, W=1280, seed=2)[0]


def serving_reference(batch):
    """One process's step (f32, bf16) and f32 Evaluator scores on ``batch``,
    on cuDNN's heuristics: phase 5b's reference where phase 5 did not run
    (``--spatial-ranks``)."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, weights

    ref = {}
    frames = torch.from_numpy(batch[0]).cuda()
    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    for dtype in ("float32", "bfloat16"):
        cfg = _serving_config(dtype)
        model = SuperSloMo(cfg.model_spec()).load_state(weights.seeded_state(cfg.model_spec(), seed=0))
        torch.backends.cudnn.benchmark = False
        pred, bound = model.interpolate_multi_t(frames, t_values, with_bounds=True)
        ref[dtype] = {"pred": pred.cpu(), "bound": float(bound)}
        if dtype == "float32":
            ev = Evaluator(cfg, model)
            ev.run([batch])
            ref[dtype].update(scores=[ev.psnr, ev.ssim, ev.ie], eval_bound=ev.bounds[0])
        del model
    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    return ref


def _rows_of(blocks, s):
    r0 = sum(blocks[:s])
    return slice(r0, r0 + blocks[s])


def sharded_steps(model, grid, frames, t_values, steps):
    """The fused step on this rank's rows under the grid: one warm-up step,
    then ``steps`` timed on the host clock (synchronised): ms, peak GiB, and
    per step the multi-flow launches, halo exchanges and the bytes sent."""
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter
    from superslomo_tpu_torch.parallel import halo

    with halo.spatial(grid):
        model.interpolate_multi_t(frames, t_values, with_bounds=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter.launches = 0
        halo.reset_counts()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            pred, bound = model.interpolate_multi_t(frames, t_values, with_bounds=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": times, "step_ms_median": statistics.median(times),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": counter.launches / steps, "exchanges_per_step": halo.counts["exchanges"] / steps,
            "exchange_mb_sent_per_step": halo.counts["bytes_sent"] / steps / 1e6, "bound": float(bound),
            "finite": bool(torch.isfinite(pred).all()), "pred": pred.cpu()}


def sharded_warps(grid, blocks, reps=10):
    """The step's warp pair on this rank's rows of a 720p pair (B=2, n=7)
    under the grid, through the halo (the step's kind of flows; noise flows
    with |v| up to 130 px, within the halo's reach) and through the whole
    height (flows up to +-200 px, beyond it), each against the one-process
    kernel on the whole frame, cut to this rank's rows; the host ms of a
    pair (the exchange or gather and 2 launches, synchronised) beside one
    process's 2 launches over the whole frame."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.parallel import halo, warp_spmd

    B, n, H, W = 2, 7, 736, 1280
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    pair = torch.from_numpy(rng.standard_normal((B, H, W, 6), dtype=np.float32)).to(dev).permute(0, 3, 1, 2)
    rows = _rows_of(blocks, grid.spatial_index)
    cases = {
        "halo_step_flows": [step_flows(np.random.default_rng(20 + i), B, n, H, W, dev) for i in range(2)],
        "halo_noise_within_reach": [tuple(torch.from_numpy(x).to(dev) for x in (
            rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32),
            rng.uniform(-130.0, 130.0, (B, n, H, W)).astype(np.float32))) for _ in range(2)],
        "full_height_200px": [tuple(torch.from_numpy(rng.uniform(-200.0, 200.0, (B, n, H, W)).astype(np.float32)).to(
            dev) for _ in range(2)) for _ in range(2)],
    }

    def host_median(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {}
    local_pair = pair[:, :, rows]
    for case, flows in cases.items():
        full = case.startswith("full")
        local = [(u[:, :, rows], v[:, :, rows]) for u, v in flows]
        with halo.spatial(grid), halo.full_height_warps() if full else contextlib.nullcontext():
            def sharded():
                return warp_spmd.warp_multiflow_sharded(local_pair, local, blocks, unguarded=True)

            got = sharded()
            ms = host_median(sharded)

        def whole():
            return [ops.warp_multiflow_planar(pair[:, 3 * i:3 * i + 3], u, v) for i, (u, v) in enumerate(flows)]

        want = whole()
        err = max((g - w[:, :, :, rows]).abs().max().item() for g, w in zip(got, want))
        out[case] = {"max_abs_err": err, "pair_ms": ms, "one_process_pair_ms": host_median(whole),
                     "max_abs_v": max(v.abs().max().item() for _, v in flows)}
    return out


def fused_step_grads(model, frames, t_values):
    """The fused step (``SuperSloMo._multi_t_planar``, TF32 off) differentiated:
    the gradients of the sum of its prediction's squares by every parameter
    and by the frames, on the CPU, with the host ms of the forward and
    backward (synchronised); under ``halo.spatial``, this rank's."""
    from superslomo_tpu_torch.models.superslomo import tf32_off

    frames = frames.detach().requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tf32_off():
        pred, _ = model._multi_t_planar(frames, t_values)
        grads = torch.autograd.grad((pred ** 2).sum(), params + [frames])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"params": [g.cpu() for g in grads[:-1]], "frames": grads[-1].cpu(), "fwd_bwd_ms": ms,
            "names": [n for n, _ in model.named_parameters()]}


def fused_step_grad_reference(frames, t_values):
    """One process's ``fused_step_grads`` on phase 5's first sample (f32
    CONV, 720p, 7 t, the seeded weights of phase 5), on cuDNN's heuristics
    as the ranks run, for phase 5b's sharded gradient; the peak GiB."""
    from superslomo_tpu_torch import SuperSloMo, weights

    spec = _serving_config("float32").model_spec()
    model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
    torch.backends.cudnn.benchmark = False
    torch.cuda.reset_peak_memory_stats()
    ref = fused_step_grads(model, torch.from_numpy(frames).cuda(), t_values.cuda())
    ref["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.backends.cudnn.benchmark = True
    del model
    torch.cuda.empty_cache()
    return ref


def _grad_errs(got, want, bars):
    """{name: max |err| and bar} of gradients against one process's (``bars``
    as shares of each reference's max |g|), and whether all are within."""
    errs = {}
    for name, a, w, rel in zip(("img", "u", "v") if len(got) == 3 else ("img", "flow"), got, want, bars):
        errs[name] = {"max_abs_err": (a.float() - w.float()).abs().max().item(),
                      "bar": rel * w.float().abs().max().item()}
    return errs, all(e["max_abs_err"] <= e["bar"] for e in errs.values())


def sharded_grads(grid, blocks, model, frames, t_values):
    """Phase 5b's gradients on this rank: ``warp_spmd.warp_sharded`` (B=2,
    C=3) and ``warp_multiflow_sharded`` (B=2, n=7, f32 and bf16 planes) on
    this rank's rows of 720p planes, through the halo (the step's flows,
    within the reach) and the whole height (+-200 px, beyond it), their
    image and flow gradients against one process's warp over the whole frame
    cut to this rank's rows (GRAD_KERNEL_REL of each gradient's max; bf16
    planes' gradient two bf16 roundings: the halo rows' part is rounded on
    the rank that warps them, the owner's part on the owner, and their sum
    again); then the f32 fused step differentiated on this rank's rows of
    ``frames`` (``fused_step_grads``), with the halo counts and the windowed
    gradient launches set to 0 just before it and read just after."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda as mf_bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.parallel import halo, warp_spmd

    B, C, n, H, W = 2, 3, 7, 736, 1280
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    rows = _rows_of(blocks, grid.spatial_index)
    img = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    g1 = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    g3 = torch.from_numpy(rng.standard_normal((B, C, n, H, W), dtype=np.float32)).to(dev)
    flows = {"halo": step_flows(np.random.default_rng(24), B, n, H, W, dev),
             "full": tuple(torch.from_numpy(rng.uniform(-200.0, 200.0, (B, n, H, W)).astype(np.float32)).to(dev)
                           for _ in range(2))}
    out = {}

    def grads(fn, xs, g):
        leaves = [x.detach().requires_grad_(True) for x in xs]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    def reset():
        halo.reset_counts()
        bwd.launches = bwd.img_grad_launches = bwd.windowed_img_grad_launches = 0
        mf_bwd.launches = mf_bwd.windowed = ops._WarpMultiflow.launches = 0

    def launches():
        return {"img_grad": bwd.img_grad_launches, "img_grad_windowed": bwd.windowed_img_grad_launches,
                "multiflow_backward": mf_bwd.launches, "multiflow_backward_windowed": mf_bwd.windowed,
                "multiflow_backward_operations": ops._WarpMultiflow.launches}

    for case, (u, v) in flows.items():
        flow = torch.stack([u[:, 0], v[:, 0]], 1)
        # one process's warp over the whole frame (no grid in effect), cut to this rank's rows
        want = [x[:, :, rows] for x in grads(ops.warp_auto, (img, flow), g1)]
        reset()
        with halo.spatial(grid):
            got = grads(warp_spmd.warp_sharded, (img[:, :, rows], flow[:, :, rows]), g1[:, :, rows])
        errs, ok = _grad_errs(got, want, (GRAD_KERNEL_REL, GRAD_KERNEL_REL))
        out[f"single_{case}"] = {"grads": errs, "ok": ok, "halo": dict(halo.counts), "launches": launches(),
                                 "max_abs_v": v[:, 0].abs().max().item()}
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            p, g = img.to(dt), g3.to(dt)
            want = [x[..., rows, :] for x in grads(ops.warp_multiflow_planar, (p, u, v), g)]
            reset()
            with halo.spatial(grid):
                got = grads(lambda *x: warp_spmd.warp_multiflow_sharded(x[0], [x[1:]], blocks)[0],
                            (p[:, :, rows], u[:, :, rows], v[:, :, rows]), g[:, :, :, rows])
            planes_bar = 2.0**-7 if dt == torch.bfloat16 else GRAD_KERNEL_REL
            errs, ok = _grad_errs(got, want, (planes_bar, GRAD_KERNEL_REL, GRAD_KERNEL_REL))
            out[f"multi_{case}_{tag}"] = {"grads": errs, "ok": ok, "halo": dict(halo.counts), "launches": launches(),
                                          "max_abs_v": v.abs().max().item()}
    with halo.spatial(grid):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        step = fused_step_grads(model, frames, t_values)
        step["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        step["halo"] = dict(halo.counts)
        step["launches"] = launches()
        out["fused_step"] = step
    return out


def sharded_serving_rank(rank, world, port, backend, local_ranks, steps, four_k):
    """One rank of phase 5b on a (1 x world) grid: the 720p serving step in
    f32 and bf16 on its block of rows (``sharded_steps``), the warp pairs
    (``sharded_warps``), then the main path, the Evaluator on the grid over
    phase 5's first batch with the launch and exchange counts set to 0 just
    before it; with ``four_k``, one f32 step at 2176x3840, B=1. cuDNN's
    heuristics throughout (the ranks' conv shapes are new)."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, ops, parallel, weights
    from superslomo_tpu_torch.data.augmentations import Normalize
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter
    from superslomo_tpu_torch.parallel import halo

    torchrun_env(rank, world, local_ranks[rank], port)
    device = parallel.init_data_parallel(backend=backend)
    grid = parallel.make_grid(1, world)
    blocks = parallel.row_blocks(736, world)
    rows = _rows_of(blocks, grid.spatial_index)
    cfg = _serving_config("float32")
    batch = serving_batch(Normalize(cfg.pixel_mean(), cfg.pixel_std()))
    frames = torch.from_numpy(np.ascontiguousarray(batch[0][:, :, rows])).to(device)
    t_values = torch.arange(1, 8, dtype=torch.float32, device=device) / 8
    res = {"rank": rank, "grid": [grid.data_index, grid.spatial_index], "backend": torch.distributed.get_backend(),
           "device": str(device), "blocks": list(blocks), "halo_reach": halo.halo_reach(blocks)}
    models = {}
    for dtype in ("float32", "bfloat16"):
        spec = _serving_config(dtype).model_spec()
        models[dtype] = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
        torch.backends.cudnn.benchmark = False
        res[dtype] = sharded_steps(models[dtype], grid, frames, t_values, steps)
    del models["bfloat16"]
    torch.cuda.empty_cache()
    res["warps"] = sharded_warps(grid, blocks)
    res["grads"] = sharded_grads(grid, blocks, models["float32"], frames[:1], t_values)
    torch.cuda.empty_cache()

    counter.launches = ops._WarpMultiflow.launches = 0
    halo.reset_counts()
    t0 = time.perf_counter()
    ev = Evaluator(cfg, models["float32"], grid=grid)
    results = ev.run([batch])
    res["eval"] = {"wall_s": time.perf_counter() - t0, "results": results, "scores": [ev.psnr, ev.ssim, ev.ie],
                   "launches": counter.launches, "multiflow_backward": ops._WarpMultiflow.launches,
                   "exchanges": halo.counts["exchanges"], "reruns": ev.reruns, "threshold": ev.bound_threshold,
                   "step_samples": ev.step_samples}
    if four_k:
        res["4k"] = sharded_4k_step(models["float32"], grid, steps=2)
    torch.distributed.destroy_process_group()
    return res


def sharded_4k_step(model, grid, steps):
    """One f32 fused step at 2176x3840 (4K, /32-padded), B=1, 8x, on this
    rank's rows: the frames made on the card from a seed, a warm-up step,
    then ``steps`` timed (``sharded_steps``)."""
    from superslomo_tpu_torch import parallel

    H, W = 2176, 3840
    blocks = parallel.row_blocks(H, grid.n_spatial)
    gen = torch.Generator(device="cuda").manual_seed(4)
    frames = torch.randn((1, 2, H, W, 3), generator=gen, device="cuda")[:, :, _rows_of(blocks, grid.spatial_index)]
    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    res = sharded_steps(model, grid, frames.contiguous(), t_values, steps)
    res.pop("pred")
    return {"frame_hw": [H, W], "batch": 1, "blocks": list(blocks), **res}


def phase_sharded_serving(world, reference, steps=3, four_k=False):
    """Phase 5b: height sharding for serving, ``world`` ranks on a (1 x
    world) grid (NCCL, a card a rank, where there are enough cards, else all
    on the one card over gloo): ``sharded_serving_rank``. Checks: each
    dtype's step, the ranks' blocks put together, against one process's on
    the same card (``reference``: phase 5's, or ``serving_reference``): f32
    within the serving bar (SLICE_ATOL, SLICE_RTOL), bf16 by the mean
    (SHARD_BF16_MEAN); the bound (the MAX over the ranks) within 1e-4 (f32)
    and a bf16 rounding of one process's; 4 multi-flow launches a step on
    every rank; the halo and full-height warp pairs within KERNEL_ATOL of
    the one-process kernel; the Evaluator's per-image scores within the
    serving bar of one process's, equal on every rank, 4 launches a fused
    step a rank, no rerun (the bound within the reach of 135 px). Then the
    gradients (``sharded_grads``, phase ``sharded_gradients``): the sharded
    warps' within their bars in both branches, with one exchange (halo) or
    one gather (whole height) forward and one back a call; and the f32 fused
    step differentiated on the first sample, its parameters' gradients
    summed over the ranks and its frames' put together, against one
    process's (``fused_step_grad_reference``, computed here first and kept
    in ``reference``): all parameters together and the frames within
    GRAD_REL by the relative L2 distance, the gate of phase 14b's shipped
    cases (the step's gradient is discontinuous; each tensor's max error is
    reported), with 4 windowed multi-flow backward launches (12 device
    operations), no image-gradient launch and an exchange's backward for
    every exchange a rank."""
    backend, local_ranks = _ranks_layout(world)
    t0 = time.perf_counter()
    if "fused_step_grads" not in reference:
        cfg = _serving_config("float32")
        from superslomo_tpu_torch.data.augmentations import Normalize

        frames = serving_batch(Normalize(cfg.pixel_mean(), cfg.pixel_std()))[0][:1]
        reference["fused_step_grads"] = fused_step_grad_reference(frames, torch.arange(1, 8, dtype=torch.float32) / 8)
    print(f"chip_smoke: phase 5b runs {world} spatial ranks over {backend} on cards {local_ranks}", flush=True)
    ranks = spawn_ranks(sharded_serving_rank, world, (world, _free_port(), backend, local_ranks, steps, four_k),
                        timeout=900)
    res = {"phase": "sharded_serving", "config": "configs/superslomo_eval.ini", "grid": [1, world],
           "backend": [r["backend"] for r in ranks], "devices": [r["device"] for r in ranks],
           "blocks": ranks[0]["blocks"], "halo_rows_reach": ranks[0]["halo_reach"], "batch": 2, "n_t": 7,
           "frame_hw": [736, 1280]}
    bad = []
    for dtype in ("float32", "bfloat16"):
        got = torch.cat([r[dtype].pop("pred") for r in ranks], dim=2)
        want = reference[dtype]["pred"]
        diff = (got - want).abs()
        entry = {"max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
                 "bound_by_rank": [r[dtype]["bound"] for r in ranks], "one_process_bound": reference[dtype]["bound"],
                 **{k: [r[dtype][k] for r in ranks] for k in (
                     "step_ms_median", "step_ms", "peak_mem_gib", "launches_per_step", "exchanges_per_step",
                     "exchange_mb_sent_per_step", "finite")}}
        res[dtype] = entry
        bound_rel = 1e-4 if dtype == "float32" else 2.0**-7
        close = (torch.allclose(got, want, atol=SLICE_ATOL, rtol=SLICE_RTOL) if dtype == "float32"
                 else entry["mean_abs_diff"] <= SHARD_BF16_MEAN)
        if not (close and all(entry["finite"]) and all(
                abs(b - entry["one_process_bound"]) <= bound_rel * entry["one_process_bound"]
                for b in entry["bound_by_rank"])):
            bad.append(f"{dtype} step")
        if any(n != 4 for n in entry["launches_per_step"]):
            bad.append(f"{dtype} launches")
    res["warps"] = {case: {k: [r["warps"][case][k] for r in ranks] for k in ranks[0]["warps"][case]}
                    for case in ranks[0]["warps"]}
    if any(e > KERNEL_ATOL for w in res["warps"].values() for e in w["max_abs_err"]):
        bad.append("warps")
    want_scores = reference["float32"]["scores"]
    res["eval"] = {k: [r["eval"][k] for r in ranks] for k in (
        "wall_s", "launches", "multiflow_backward", "exchanges", "reruns", "threshold", "step_samples")}
    res["eval"]["results"] = ranks[0]["eval"]["results"]
    res["eval"]["launches_per_fused_step_by_rank"] = [r["eval"]["launches"] / -(-2 // r["eval"]["step_samples"])
                                                      for r in ranks]
    res["eval"]["scores_max_abs_diff"] = [
        float(np.max(np.abs(np.asarray(g) - np.asarray(w)))) for g, w in zip(ranks[0]["eval"]["scores"], want_scores)]
    scores_ok = all(np.allclose(r["eval"]["scores"][i], want_scores[i], atol=SLICE_ATOL, rtol=SLICE_RTOL)
                    for r in ranks for i in range(3))
    if not (scores_ok and all(r["eval"]["results"] == ranks[0]["eval"]["results"] for r in ranks)):
        bad.append("evaluator scores")
    if any(n != 4 for n in res["eval"]["launches_per_fused_step_by_rank"]) or any(res["eval"]["multiflow_backward"]) \
            or any(res["eval"]["reruns"]):
        bad.append("evaluator launches or reruns")
    grads = sharded_grads_summary(ranks, reference["fused_step_grads"])
    bad += grads.pop("bad")
    if four_k:
        res["4k"] = {k: [r["4k"][k] for r in ranks] for k in ranks[0]["4k"]}
        if not all(res["4k"]["finite"]) or any(n != 4 for n in res["4k"]["launches_per_step"]):
            bad.append("4k step")
    res["phase_s"] = time.perf_counter() - t0
    emit(res)
    emit({"phase": "sharded_gradients", "grid": [1, world], "backend": res["backend"], **grads})
    res["grads"] = grads
    if bad:
        raise AssertionError(f"sharded serving at {world} ranks: {bad}")
    return res


def _rel_l2(got, want):
    return (sum(((a - w) ** 2).sum() for a, w in zip(got, want)) / sum((w ** 2).sum() for w in want)).sqrt().item()


def sharded_grads_summary(ranks, ref):
    """Phase 5b's gradient checks (see ``phase_sharded_serving``) from the
    ranks' ``sharded_grads``, as one JSON-ready dict with the list of what
    failed under ``bad``."""
    bad = []
    warps = {case: {k: [r["grads"][case][k] for r in ranks] for k in ("grads", "ok", "halo", "launches", "max_abs_v")}
             for case in ranks[0]["grads"] if case != "fused_step"}
    for case, w in warps.items():
        want = (1, 1, 0, 0) if "halo" in case else (0, 0, 1, 1)
        # one windowed backward launch a call: the image gradient's (single-flow) or the multi-flow backward's
        kernel = "img_grad_windowed" if case.startswith("single") else "multiflow_backward_windowed"
        if not all(w["ok"]) or any((c["exchanges"], c["backward_exchanges"], c["gathers"], c["backward_gathers"])
                                   != want for c in w["halo"]) or any(n[kernel] != 1 for n in w["launches"]):
            bad.append(f"sharded gradients {case}")
    steps = [r["grads"].pop("fused_step") for r in ranks]
    got = [sum(s["params"][i] for s in steps) for i in range(len(ref["params"]))]
    frames = torch.cat([s["frames"] for s in steps], dim=2)
    per_tensor = {n: ((a - w).abs().max() / w.abs().max()).item() for n, a, w in zip(ref["names"], got, ref["params"])}
    worst = max(per_tensor, key=per_tensor.get)
    step = {
        "frame_hw": [736, 1280], "batch": 1, "n_t": 7, "compute_dtype": "float32", "loss": "sum of pred squared",
        "params_rel_l2_diff": _rel_l2(got, ref["params"]), "frames_rel_l2_diff": _rel_l2([frames], [ref["frames"]]),
        "frames_max_rel_diff": ((frames - ref["frames"]).abs().max() / ref["frames"].abs().max()).item(),
        "params_max_rel_diff": per_tensor[worst], "params_worst_tensor": worst,
        "params_tensors_over_grad_rel": {n: e for n, e in per_tensor.items() if e > GRAD_REL},
        "fwd_bwd_ms_by_rank": [s["fwd_bwd_ms"] for s in steps], "single_process_fwd_bwd_ms": ref["fwd_bwd_ms"],
        "peak_mem_gib_by_rank": [s["peak_mem_gib"] for s in steps], "single_process_peak_mem_gib": ref["peak_mem_gib"],
        "halo_by_rank": [s["halo"] for s in steps], "launches_by_rank": [s["launches"] for s in steps],
        "warp_launches_rank0": {k: sum(w["launches"][0][k] for w in warps.values()) for k in steps[0]["launches"]},
    }
    if not (step["params_rel_l2_diff"] <= GRAD_REL and step["frames_rel_l2_diff"] <= GRAD_REL):
        bad.append("fused step gradients")
    want_launches = {"img_grad": 0, "img_grad_windowed": 0, "multiflow_backward": 4, "multiflow_backward_windowed": 4,
                     "multiflow_backward_operations": 12}
    if any(s["launches"] != want_launches for s in steps) or any(
            s["halo"]["backward_exchanges"] != s["halo"]["exchanges"] or s["halo"]["gathers"] for s in steps):
        bad.append("fused step gradient launches or exchanges")
    return {"warps": warps, "fused_step": step, "bad": bad}


def spatial_only(norm, world):
    """``--spatial-ranks N``: phase 5b at 2 ranks and at N (a card a rank
    over NCCL where there are enough cards), against one process's steps and
    scores on the same card (``serving_reference``); at N ranks, when they
    have a card each, one f32 step at 2176x3840, which one card cannot
    hold. Then phase 14b at 2 and N ranks on the shipped training config
    (224², B=32) and a 720p step at B=2, f32, against one process's."""
    reference = serving_reference(serving_batch(norm))
    four_k = torch.cuda.device_count() >= world
    runs = [phase_sharded_serving(2, reference, four_k=four_k and world == 2)]
    if world != 2:
        runs.append(phase_sharded_serving(world, reference, four_k=four_k))
    del reference
    torch.cuda.empty_cache()
    references = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for w in sorted({2, world}):
            runs.append(phase_sharded_train(ckpt_dir, norm, world=w, cases=sharded_train_cases(shipped=True),
                                            references=references, shipped=True))
    return runs


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


def phase_ssmr_main_path(batches, steps=6, eval_batches=1, during_autotune=None):
    """The fused 8x step of SuperSloMo-R at 720p with a streamed-in state
    (from ``forward_inference`` of the window before): f32 at B=1, bf16 at
    B=1 and B=2; each step's ms (median of ``steps`` after 2 warm-up
    steps), frames/s, peak memory and the multi-flow kernel's launches, 4 a
    slice of the model's ``step_samples`` (1 here: a sample's 3 windows
    bring 21 stage-2 images, past the budget of 14, so B=2 runs as two
    slices with their samples' states). Then the Evaluator with the f32 model over the first
    ``eval_batches`` of ``batches`` at B=1 (two until the script neared its
    time limit), and bf16 against f32 on the same input. ``during_autotune``
    (a VP8Files, or None) is started before the first configuration's
    warm-up, while cuDNN's autotuning keeps the device busy (~2 min), and
    joined before its first timed step, so no timed step shares the host
    with it."""
    from superslomo_tpu_torch import Evaluator, SuperSloMo, ops, weights
    from superslomo_tpu_torch.models.superslomo import step_samples
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

        if during_autotune is not None and dtype == "float32":
            during_autotune.start()
        for _ in range(2):  # cuDNN autotuning happens here
            step()
        torch.cuda.synchronize()
        if during_autotune is not None and dtype == "float32":
            during_autotune.join()
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
        slices = -(-B // step_samples(frames.shape[2], frames.shape[3], 7, frames.shape[1] - 1))
        res = {
            "phase": "ssmr_main_path", "config": "configs/superslomo_recurrent.ini", "compute_dtype": dtype,
            "batch": B, "n_t": 7, "frame_hw": list(frames.shape[2:4]), "streamed_state": True,
            "step_ms_median": med, "step_ms": times, "frames_per_s": B * 7 / (med / 1e3),
            "peak_mem_gib": peak / 2**30, "launches": launches, "slices_per_step": slices, "bound": float(bound),
            "finite": bool(torch.isfinite(pred).all()),
        }
        if not res["finite"]:
            raise AssertionError(f"non-finite SSM-R step output: {res}")
        if launches != {"warp_multiflow": 4 * slices * steps, "warp_single": 0, "warp_multiflow_backward": 0}:
            raise AssertionError(f"kernel launches {launches} over {steps} steps of {slices} slices, expected 4 "
                                 "multi-flow a slice")
        if B == 1:
            preds[dtype] = pred
        if dtype == "float32":  # the shipped config's model under the Evaluator
            mf.launches = ops._WarpMultiflow.launches = 0
            t0 = time.perf_counter()
            results = Evaluator(cfg, model).run([(f[:1], g[:1], n[:1]) for f, g, n in batches[:eval_batches]])
            res.update(eval_batches=eval_batches, eval_batch=1, eval_wall_s=time.perf_counter() - t0,
                       eval_warp_multiflow_launches=mf.launches,
                       eval_warp_multiflow_backward_launches=ops._WarpMultiflow.launches, **results)
            if not all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"]])):
                raise AssertionError(f"non-finite SSM-R metrics: {results}")
            if mf.launches != 4 * eval_batches or ops._WarpMultiflow.launches != 0:
                raise AssertionError(f"{mf.launches} multi-flow launches over {eval_batches} evaluator batches")
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
            "img_grad": bwd.img_grad_launches, "multiflow_backward": ops._WarpMultiflow.launches,
            "forward_windowed": fwd.windowed, "flow_grad_windowed": bwd.windowed_flow_grad_launches}


def reset_single_counts():
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda as bwd
    from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_cuda as fwd

    fwd.launches = bwd.launches = bwd.flow_grad_launches = bwd.img_grad_launches = ops._WarpMultiflow.launches = 0
    fwd.windowed = bwd.windowed_flow_grad_launches = 0


def train_step_launches(steps, windowed=False):
    """What ``steps`` train steps launch: 8 single-flow forward and 8
    flow-gradient launches a step, no image gradient, no multi-flow
    backward; under a spatial grid (``windowed``) all 16 under a row
    window, else none."""
    n = 8 * steps
    return {"forward": n, "backward": n, "flow_grad": n, "img_grad": 0, "multiflow_backward": 0,
            "forward_windowed": n if windowed else 0, "flow_grad_windowed": n if windowed else 0}


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
                                       timed=5, cudnn_benchmark=False)
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


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filtered(rgb, ft):
    """(h, w, 3) uint8 pixels → (h, 1 + 3 w) rows of filter type ``ft`` (0-4)."""
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
    return np.hstack([np.full((h, 1), ft, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)])


def png_bytes(rgb, ft, level=1, interlace=False):
    """A (H, W, 3) uint8 image as an 8-bit RGB PNG, every row with filter type
    ``ft`` (0-4), deflated at ``level``: the stdlib's zlib and numpy only (at
    ``ft=1``, level 1, what cv2.imwrite writes); with ``interlace``, in
    Adam7's seven passes, each filtered on its own."""
    h, w, _ = rgb.shape
    passes = [rgb[y0::dy, x0::dx] for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),))]
    rows = b"".join(_filtered(p, ft).tobytes() for p in passes if p.size)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(rows, level)) + chunk(b"IEND", b""))


def write_png_bytes(rgb):
    """The frame as cv2.imwrite writes a PNG: Sub rows, zlib level 1."""
    return png_bytes(rgb, 1)


def write_png(path, rgb, ft=1):
    with open(path, "wb") as f:
        f.write(png_bytes(rgb, ft))


def write_clip(folder, frames, name="frame_{:05d}.png", start=0):
    """``frames`` as PNG files (Sub rows, zlib level 1) in ``folder``, named
    ``name`` with their index from ``start``."""
    os.makedirs(folder)
    for i, img in enumerate(frames, start=start):
        write_png(os.path.join(folder, name.format(i)), img)


# a JPEG writer, numpy only (the card's machine has no cv2 or PIL): a float
# forward DCT, Annex K's quantisation tables scaled by quality as libjpeg
# scales them; baseline files with Annex K's Huffman tables, or progressive
# and multi-scan files whose scans are coded as libjpeg's encoder codes them
# (jcphuff.c: successive approximation, EOB runs, refinement correction bits),
# each with its own optimal Huffman tables; YCbCr, grey, CMYK and YCCK. The
# CPU tests hold cv2's decode of its files against the port's.

_ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))
# the quantisation tables of ITU T.81 Annex K.1 (luminance) and K.2 (chrominance), natural order
_LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# the Huffman tables of Annex K.3: (code counts by length 1-16, symbols)
_AC_LUMA_SYMBOLS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_SYMBOLS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a35"
    "363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596979899"
    "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {  # (class 0 DC / 1 AC, table 0 luma / 1 chroma) → (counts, symbols)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), _AC_LUMA_SYMBOLS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), _AC_CHROMA_SYMBOLS),
}
JPEG_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}  # the luma's (h, v)


def quant_tables(quality):
    """Annex K's two tables scaled to ``quality`` (1-100) as libjpeg scales
    them, each entry clamped to 1-255 (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((base * scale + 50) // 100, 1, 255) for base in (_LUMA_Q, _CHROMA_Q)]


def _huffman_codes(counts, symbols):
    """symbol → (code, length) of a canonical Huffman table, as two arrays of 256."""
    code_of, size_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, size_of


_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def _blocks(plane, by, bx):
    """(by * 8, bx * 8) plane → (by, bx, 8, 8) blocks."""
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


def _amplitude(v):
    """(size, bits) of JPEG's magnitude category coding of integers ``v``."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _pack_bits(codes, sizes):
    """The bit string of ``codes`` (each ``sizes`` <= 16 bits, MSB first),
    padded with 1-bits to a byte, as bytes with a 0x00 stuffed after each 0xFF."""
    pad = -int(sizes.sum()) % 8
    codes, sizes = np.append(codes, (1 << pad) - 1), np.append(sizes, pad)
    left = (codes << (16 - sizes)).astype(">u2")  # each code in the top bits of 16
    bits = np.unpackbits(left.view(np.uint8)).reshape(-1, 16)
    out = np.packbits(bits[np.arange(16) < sizes[:, None]])
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _entropy_code(blocks, comps, restart):
    """Huffman-code quantised ``blocks`` (a list per scan component of (by, bx,
    64) natural-order arrays) in the scan's order, with a restart every
    ``restart`` MCUs (0: none): the entropy-coded segment with its RST markers."""
    tables = {(c, t): _huffman_codes(*STD_HUFFMAN[(c, t)]) for (c, t) in STD_HUFFMAN}
    if len(comps) == 1:  # one component: a block an MCU, in raster order
        coef = blocks[0].reshape(-1, 64)
        ci = np.zeros(len(coef), np.int64)
        per_mcu = 1
    else:  # each MCU: each component's v x h blocks in raster order
        my, mx = blocks[0].shape[0] // comps[0][2], blocks[0].shape[1] // comps[0][1]
        per = [b.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, v * h, 64)
               for b, (_, h, v, _) in zip(blocks, comps)]
        coef = np.concatenate(per, axis=1).reshape(-1, 64)
        per_mcu = sum(h * v for _, h, v, _ in comps)
        ci = np.tile(np.repeat(np.arange(len(comps)), [h * v for _, h, v, _ in comps]), my * mx)
    coef = coef[:, _ZIGZAG]  # zigzag order
    n = len(coef)
    mcu = np.arange(n) // per_mcu
    segment = mcu // restart if restart else np.zeros(n, np.int64)
    table = np.array([c[3] for c in comps])[ci]
    # DC differences, each component's predictor reset at each restart
    diff = coef[:, 0].copy()
    for c in range(len(comps)):
        idx = np.flatnonzero(ci == c)
        d = np.diff(coef[idx, 0], prepend=0)
        first = np.r_[True, segment[idx][1:] != segment[idx][:-1]]
        d[first] = coef[idx[first], 0]
        diff[idx] = d
    pieces = []  # (sort key, code, size)
    dsize, dbits = _amplitude(diff)
    key = np.arange(n) * 65 * 4
    for t in (0, 1):
        m = table == t
        code, size = tables[(0, t)]
        pieces += [(key[m], code[dsize[m]], size[dsize[m]]), (key[m] + 1, dbits[m], dsize[m])]
    b, k = np.nonzero(coef[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    prev[1:] = np.where(b[1:] == b[:-1], k[:-1], 0)
    run = k - prev - 1
    v = coef[b, k]
    asize, abits = _amplitude(v)
    sym = (run % 16) * 16 + asize
    zrl = run // 16
    last = np.zeros(n, np.int64)  # each block's last nonzero position
    last[b] = k
    for t in (0, 1):
        m = table[b] == t
        code, size = tables[(1, t)]
        kb = b[m] * 65 * 4 + k[m] * 4
        nz = np.repeat(kb, zrl[m])
        pieces += [(nz, np.full(len(nz), code[0xF0]), np.full(len(nz), size[0xF0])),
                   (kb + 1, code[sym[m]], size[sym[m]]), (kb + 2, abits[m], asize[m])]
        eob = np.flatnonzero((last < 63) & (table == t))
        pieces.append((eob * 65 * 4 + 64 * 4, np.full(len(eob), code[0]), np.full(len(eob), size[0])))
    keys = np.concatenate([p[0] for p in pieces])
    codes = np.concatenate([p[1] for p in pieces]).astype(np.int64)
    sizes = np.concatenate([p[2] for p in pieces]).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys, codes, sizes = keys[order], codes[order], sizes[order]
    seg_of = segment[keys // 260]
    out = b""
    bounds = np.searchsorted(seg_of, np.arange(seg_of[-1] + 2 if n else 1))
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        if s:
            out += bytes([0xFF, 0xD0 + (s - 1) % 8])
        out += _pack_bits(codes[lo:hi], sizes[lo:hi])
    return out


def progression(n):
    """libjpeg's ``jpeg_simple_progression`` script for ``n`` components:
    (component indices, Ss, Se, Ah, Al) per scan; 10 scans for YCbCr, 6 for
    grey, 18 for 4 components."""
    every = tuple(range(n))
    if n == 3:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]

    def each(ss, se, ah, al):
        return [((c,), ss, se, ah, al) for c in range(n)]

    return [(every, 0, 0, 0, 1), *each(1, 5, 0, 2), *each(6, 63, 0, 2), *each(1, 63, 2, 1), (every, 0, 0, 1, 0),
            *each(1, 63, 1, 0)]


SCRIPTS = {  # name → (component count → scans)
    "progressive": progression,
    "components": lambda n: [((c,), 0, 63, 0, 0) for c in range(n)],  # sequential, one scan a component
    "luma_chroma": lambda n: [((0,), 0, 63, 0, 0), (tuple(range(1, n)), 0, 63, 0, 0)],  # Y, then the rest interleaved
}


def optimal_huffman(freq):
    """(counts, symbols) of a Huffman table for the symbol frequencies
    ``freq`` (256 of them): codes of at most 16 bits with the all-ones code
    left free, as libjpeg's ``jpeg_gen_optimal_table`` builds them (ITU T.81
    Annex K.2: a reserved symbol takes the all-ones code, lengths past 16
    are folded back)."""
    freq = [int(f) for f in freq] + [1]
    codesize, others = [0] * 257, [-1] * 257
    heap = [(f, -s) for s, f in enumerate(freq) if f]
    heapq.heapify(heap)
    while len(heap) > 1:  # merge the two rarest trees; a tree's symbols are a chain through ``others``
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        c1, c2 = -n1, -n2
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
        heapq.heappush(heap, (f1 + f2, n1))
    bits = [0] * 65
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(64, 16, -1):  # Annex K.3's adjustment of lengths past 16
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol
    symbols = bytes(s for size in range(1, 65) for s in range(256) if codesize[s] == size)
    return tuple(bits[1:17]), symbols


def _own_blocks(comps, w, h):
    """Each component's own (block rows, block columns), as libjpeg lays them out."""
    if len(comps) == 1:
        return [(-(-h // 8), -(-w // 8))]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    return [(-(-(-(-h * v // vmax)) // 8), -(-(-(-w * hh // hmax)) // 8)) for _, hh, v, _ in comps]


def _scan_order(blocks, comps, scan_comps, w, h, restart):
    """A scan's blocks in coding order: (n, 64) zigzag-order coefficients,
    each block's index in the scan's components, and its restart segment."""
    if len(scan_comps) == 1:
        c = scan_comps[0]
        rows, cols = _own_blocks(comps, w, h)[c]
        coef = blocks[c][:rows, :cols].reshape(-1, 64)
        ci, mcu = np.zeros(len(coef), np.int64), np.arange(len(coef))
    else:
        my, mx = blocks[0].shape[0] // comps[0][2], blocks[0].shape[1] // comps[0][1]
        per = [blocks[c].reshape(my, comps[c][2], mx, comps[c][1], 64).transpose(0, 2, 1, 3, 4)
               .reshape(my * mx, comps[c][1] * comps[c][2], 64) for c in scan_comps]
        coef = np.concatenate(per, axis=1).reshape(-1, 64)
        sizes = [comps[c][1] * comps[c][2] for c in scan_comps]
        ci = np.tile(np.repeat(np.arange(len(scan_comps)), sizes), my * mx)
        mcu = np.arange(len(coef)) // sum(sizes)
    segment = mcu // restart if restart else np.zeros(len(coef), np.int64)
    return np.asarray(coef, np.int64)[:, _ZIGZAG], ci, segment


class _Events:
    """A scan's coded items: Huffman symbols (class 0 DC, 1 AC) and raw bit
    strings, each with a sort key (block, slot, position, phase, sub) that
    puts them in the order of the stream."""

    def __init__(self):
        self.keys, self.cls, self.vals, self.nbits = [], [], [], []

    def add(self, key, cls, vals, nbits=0):
        vals = np.atleast_1d(np.asarray(vals, np.int64))
        self.keys.append(np.stack([np.broadcast_to(np.asarray(k, np.int64), vals.shape) for k in key], axis=1))
        self.cls.append(np.full(vals.shape, cls, np.int64))
        self.vals.append(vals)
        self.nbits.append(np.broadcast_to(np.asarray(nbits, np.int64), vals.shape))

    def arrays(self):
        if not self.keys:
            return np.zeros((0, 5), np.int64), *(np.zeros(0, np.int64) for _ in range(3))
        return (np.concatenate(self.keys), np.concatenate(self.cls), np.concatenate(self.vals),
                np.concatenate(self.nbits))


def _dc_events(ev, coef, ci, segment, al):
    """DC values (shifted right by Al) coded as differences from each
    component's predictor, reset at each restart."""
    dc = coef[:, 0] >> al
    diff = dc.copy()
    for c in np.unique(ci):
        idx = np.flatnonzero(ci == c)
        d = np.diff(dc[idx], prepend=0)
        first = np.r_[True, segment[idx][1:] != segment[idx][:-1]]
        d[first] = dc[idx[first]]
        diff[idx] = d
    size, bits = _amplitude(diff)
    b = np.arange(len(coef))
    ev.add((b, 1, -1, 0, 0), 0, size)
    ev.add((b, 1, -1, 1, 0), 2, bits, size)


def _eob_runs(ev, trailing, active, segment, max_run, tail_bits=None):
    """The EOB runs over the blocks with ``trailing`` zeros (or correction
    bits) in their band, flushed as libjpeg's encoder flushes them: before
    the next ``active`` block (one with a coefficient to code), at a
    restart, at the scan's end, at ``max_run`` blocks, and past 937 buffered
    correction bits (``tail_bits``: each block's count). Returns per block
    the (block, slot) key of the flush that codes its run (-1 outside runs)."""
    n = len(trailing)
    owner = np.full((n, 2), -1)
    flushes, run, buffered, first = [], 0, 0, 0
    trailing, active, segment = trailing.tolist(), active.tolist(), segment.tolist()
    tail_bits = [0] * n if tail_bits is None else tail_bits.tolist()

    def flush(b, slot):
        nonlocal run, buffered
        flushes.append((b, slot, run))
        owner[first : b + 1] = np.where(owner[first : b + 1, :1] == -2, (b, slot), owner[first : b + 1])
        run, buffered = 0, 0

    for b in range(n):
        if run and active[b]:
            flush(b - 1, 2)
        if trailing[b]:
            if not run:
                first = b
            owner[b] = -2  # a member of the run being counted
            run += 1
            buffered += tail_bits[b]
            if run == max_run or buffered > 937:
                flush(b, 2)
        if run and (b == n - 1 or segment[b + 1] != segment[b]):
            flush(b, 2)
    if flushes:
        fb, fs, runs = np.array(flushes).T
        r = np.array([int(x).bit_length() - 1 for x in runs])
        ev.add((fb, fs, -2, 0, 0), 1, r << 4)
        ev.add((fb[r > 0], fs[r > 0], -1, 0, 0), 2, (runs - (1 << r))[r > 0], r[r > 0])
    return owner


def _ac_first_events(ev, coef, segment, ss, se, al, max_run):
    """The band Ss..Se of each block, each coefficient's magnitude shifted
    right by Al: runs of zeros and sizes as Huffman symbols (a ZRL for each
    16 zeros before a coefficient), the magnitude bits, and EOB runs of at
    most ``max_run`` blocks (1 in a sequential scan: a block's EOB)."""
    band = coef[:, ss : se + 1]
    t = np.sign(band) * (np.abs(band) >> al)
    b, i = np.nonzero(t)
    prev = np.full(len(i), -1)
    prev[1:] = np.where(b[1:] == b[:-1], i[:-1], -1)
    run = i - prev - 1
    size, bits = _amplitude(t[b, i])
    zrl = run // 16
    zb, zi = np.repeat(b, zrl), np.repeat(i, zrl)
    ev.add((zb, 1, zi, 0, np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl)), 1, np.full(len(zb), 0xF0))
    ev.add((b, 1, i, 1, 0), 1, (run % 16) * 16 + size)
    ev.add((b, 1, i, 2, 0), 2, bits, size)
    last = np.full(len(coef), -1)
    last[b] = i
    _eob_runs(ev, last < band.shape[1] - 1, last >= 0, segment, max_run)


def _ac_refine_events(ev, coef, segment, ss, se, al):
    """The next bit (Al) of the band Ss..Se, as libjpeg's
    ``encode_mcu_AC_refine`` codes it: coefficients that become +-1 as
    run/size symbols and a sign bit, the correction bits of the coefficients
    already nonzero buffered until the next symbol, ZRLs only before a
    coefficient that comes before the block's last new one, and EOB runs
    carrying the correction bits of their blocks' tails."""
    a = np.abs(coef[:, ss : se + 1]) >> al
    n, length = a.shape
    new = a == 1
    eob = np.where(new.any(axis=1), length - 1 - np.argmax(new[:, ::-1], axis=1), -1)
    r = np.zeros(n, np.int64)
    pending = np.zeros((n, length), bool)  # correction bits buffered since the block's last symbol
    for i in range(length):
        nonzero = a[:, i] != 0
        r += ~nonzero
        zb = np.flatnonzero(nonzero & (i <= eob) & (r > 15))  # ZRLs, the buffered bits after the first
        count = r[zb] // 16
        ev.add((zb, 1, i, 0, 0), 1, np.full(len(zb), 0xF0))
        pb, pp = np.nonzero(pending[zb])
        ev.add((zb[pb], 1, i, 0, 1 + pp), 2, a[zb[pb], pp] & 1, 1)
        more = np.repeat(zb, count - 1)
        ev.add((more, 1, i, 0, 100 + np.arange(len(more))), 1, np.full(len(more), 0xF0))
        pending[zb] = False
        r[zb] %= 16
        pending[:, i] = a[:, i] > 1
        nb = np.flatnonzero(new[:, i])
        ev.add((nb, 1, i, 1, 0), 1, r[nb] * 16 + 1)
        ev.add((nb, 1, i, 2, 0), 2, (coef[nb, ss + i] > 0).astype(np.int64), 1)
        pb, pp = np.nonzero(pending[nb])
        ev.add((nb[pb], 1, i, 3, pp), 2, a[nb[pb], pp] & 1, 1)
        pending[nb] = False
        r[nb] = 0
    owner = _eob_runs(ev, (r > 0) | pending.any(axis=1), eob >= 0, segment, 0x7FFF, pending.sum(axis=1))
    pb, pp = np.nonzero(pending)  # the tails' bits, after their run's EOB symbol
    ev.add((owner[pb, 0], owner[pb, 1], pb, pp, 0), 2, a[pb, pp] & 1, 1)


def _scan_code(blocks, comps, scan, w, h, restart, progressive):
    """One scan's DHT segment (its own tables, optimal for it: DC table 0,
    AC table 0) and its entropy-coded segment with its RST markers."""
    scan_comps, ss, se, ah, al = scan
    coef, ci, segment = _scan_order(blocks, comps, scan_comps, w, h, restart)
    ev = _Events()
    if not progressive:
        _dc_events(ev, coef, ci, segment, 0)
        _ac_first_events(ev, coef, segment, 1, 63, 0, max_run=1)
    elif ss == 0 and ah == 0:
        _dc_events(ev, coef, ci, segment, al)
    elif ss == 0:
        ev.add((np.arange(len(coef)), 1, -1, 0, 0), 2, (coef[:, 0] >> al) & 1, 1)
    elif ah == 0:
        _ac_first_events(ev, coef, segment, ss, se, al, max_run=0x7FFF)
    else:
        _ac_refine_events(ev, coef, segment, ss, se, al)
    keys, cls, vals, nbits = ev.arrays()
    dht, codes, sizes = b"", vals.copy(), nbits.copy()
    for c in (0, 1):
        m = cls == c
        if m.any():
            counts, symbols = optimal_huffman(np.bincount(vals[m], minlength=256))
            dht += bytes([c * 16, *counts]) + symbols
            code_of, size_of = _huffman_codes(counts, symbols)
            codes[m], sizes[m] = code_of[vals[m]], size_of[vals[m]]
    order = np.lexsort(keys.T[::-1])
    codes, sizes, seg_of = codes[order], sizes[order], segment[keys[order, 0]]
    out = b""
    bounds = np.searchsorted(seg_of, np.arange(segment[-1] + 2))
    for s in range(len(bounds) - 1):
        if s:
            out += bytes([0xFF, 0xD0 + (s - 1) % 8])
        out += _pack_bits(codes[bounds[s] : bounds[s + 1]], sizes[bounds[s] : bounds[s + 1]])
    return (_segment(0xC4, dht) if dht else b""), out


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def exif_block(orientation, big_endian=False):
    """A TIFF-structured EXIF block whose IFD0 holds one entry, Orientation
    (0x0112, SHORT) = ``orientation``."""
    e = ">" if big_endian else "<"
    return ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def jpeg_from_coefficients(w, h, comps, blocks, qtables, restart=0, orientation=None, scans=None, adobe=None):
    """A JPEG of quantised DCT ``blocks``: ``comps`` (id, h, v, table) per
    component (table 0 luma, 1 chroma), ``blocks`` their (by, bx, 64)
    natural-order arrays covering the MCUs, ``qtables`` the tables they were
    quantised by; an APP1 EXIF block with ``orientation``. ``scans``: None
    for one baseline scan of every component with Annex K's Huffman tables,
    else (component indices, Ss, Se, Ah, Al) per scan: a progressive file
    (SOF2) where some scan codes a band or a bit, else a sequential one in
    those scans; each of them with its own Huffman tables, optimal for it, in
    a DHT before it. ``restart``: MCUs between restarts, one number or one a
    scan (a DRI before each scan where it changes). ``adobe``: an APP14 Adobe
    marker with this transform in place of the JFIF APP0 (0: RGB or CMYK,
    2: YCCK)."""
    app = (_segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)) if adobe is not None
           else _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    out = b"\xff\xd8" + app
    if orientation is not None:
        out += _segment(0xE1, b"Exif\x00\x00" + exif_block(orientation))
    for t, q in enumerate(qtables[: 1 + max(c[3] for c in comps)]):
        out += _segment(0xDB, bytes([t]) + bytes(np.asarray(q)[_ZIGZAG].astype(np.uint8)))
    frame = struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(bytes([i, hh * 16 + vv, t]) for i, hh, vv, t in comps)
    if scans is None:
        out += _segment(0xC0, frame)
        for t in range(1 + max(c[3] for c in comps)):
            for c in (0, 1):
                counts, symbols = STD_HUFFMAN[(c, t)]
                out += _segment(0xC4, bytes([c * 16 + t, *counts]) + symbols)
        if restart:
            out += _segment(0xDD, struct.pack(">H", restart))
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([i, t * 17]) for i, _, _, t in comps)
                        + b"\x00\x3f\x00")
        return out + _entropy_code(blocks, comps, restart) + b"\xff\xd9"
    progressive = any(tuple(s[1:]) != (0, 63, 0, 0) for s in scans)
    out += _segment(0xC2 if progressive else 0xC0, frame)
    in_force = 0
    for scan, interval in zip(scans, restart if isinstance(restart, (list, tuple)) else [restart] * len(scans)):
        if interval != in_force:
            out += _segment(0xDD, struct.pack(">H", interval))
            in_force = interval
        dht, data = _scan_code(blocks, comps, scan, w, h, interval, progressive)
        sc, ss, se, ah, al = scan
        out += dht + _segment(0xDA, bytes([len(sc)]) + b"".join(bytes([comps[c][0], 0]) for c in sc)
                              + bytes([ss, se, ah * 16 + al])) + data
    return out + b"\xff\xd9"


def _ycbcr(rgb):
    """JFIF's YCbCr planes of (H, W, 3) float RGB."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b]


def jpeg_bytes(img, quality=95, sampling="420", restart=0, orientation=None, colour="ycbcr", scans=None):
    """A JPEG of ``img``: (H, W, 3) uint8 RGB as YCbCr at ``sampling`` (one
    of JPEG_SAMPLING; chroma averaged over each sample's pixels), as RGB
    (``colour="rgb"``: 4:4:4, components R, G, B, Adobe transform 0), as CMYK
    (``colour="cmyk"``: 4:4:4:4, Adobe transform 0) or YCCK (``"ycck"``: Y
    and K at ``sampling``, Adobe transform 2), the CMYK samples stored
    inverted as Adobe writes them (K the largest of R, G and B), or (H, W)
    uint8 grey; quantised by Annex K's tables at ``quality``; in one baseline
    scan with Annex K's Huffman tables, or in ``scans`` (a SCRIPTS name, or
    a list as ``jpeg_from_coefficients`` takes it); a restart interval of
    ``restart`` MCUs and an EXIF ``orientation`` when given."""
    img = np.asarray(img, np.float64)
    H, W = img.shape[:2]
    adobe = None
    if img.ndim == 2:
        planes, comps = [img], [(1, 1, 1, 0)]
        hmax = vmax = 1
    else:
        hmax, vmax = JPEG_SAMPLING[sampling]
        if colour == "ycbcr":
            planes, comps = _ycbcr(img), [(1, hmax, vmax, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        elif colour == "rgb":
            hmax = vmax = 1
            planes, comps, adobe = list(np.moveaxis(img, 2, 0)), [(82, 1, 1, 0), (71, 1, 1, 0), (66, 1, 1, 0)], 0
        else:
            k = img.max(axis=2)
            cmy = 255 - (k[..., None] - img) * 255 / np.maximum(k, 1)[..., None]
            if colour == "cmyk":
                hmax = vmax = 1
                planes, comps, adobe = [*np.moveaxis(cmy, 2, 0), k], [(67, 1, 1, 0), (77, 1, 1, 0), (89, 1, 1, 0),
                                                                      (75, 1, 1, 0)], 0
            else:
                planes, comps, adobe = [*_ycbcr(255 - cmy), k], [(1, hmax, vmax, 0), (2, 1, 1, 1), (3, 1, 1, 1),
                                                                 (4, hmax, vmax, 0)], 2
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    q = quant_tables(quality)
    blocks = []
    for plane, (_, h, v, t) in zip(planes, comps):
        fy, fx = vmax // v, hmax // h
        ph, pw = -(-H // fy), -(-W // fx)  # the component's own size
        plane = np.pad(plane, ((0, ph * fy - H), (0, pw * fx - W)), mode="edge")
        plane = plane.reshape(ph, fy, pw, fx).mean(axis=(1, 3))
        by, bx = (my * v, mx * h) if len(comps) > 1 else (-(-H // 8), -(-W // 8))
        plane = np.pad(plane, ((0, by * 8 - ph), (0, bx * 8 - pw)), mode="edge") - 128
        coef = _DCT @ _blocks(plane, by, bx) @ _DCT.T
        blocks.append(np.round(coef.reshape(by, bx, 64) / q[t]).astype(np.int64))
    if isinstance(scans, str):
        scans = SCRIPTS[scans](len(comps))
    return jpeg_from_coefficients(W, H, comps, blocks, q, restart, orientation, scans, adobe)


def write_jpeg(path, img, **kwargs):
    with open(path, "wb") as f:
        f.write(jpeg_bytes(img, **kwargs))


def phase_png_unfilter(H=720, W=1280, reps=5):
    """The compiled PNG unfilter (csrc/png_unfilter.cpp) against its plain
    version on a 720p panning-texture frame written with each filter type on
    every row: both equal the written pixels bit for bit. Times: the
    unfilter alone, compiled (median of ``reps``) and plain (one call); a whole
    decode (``png.imread``, median of ``reps``) and a plain one (inflate +
    plain unfilter); and 24 decodes of the Sub frame on 12 threads (the
    unfilter and zlib release the GIL). Then the frame interlaced (Adam7, Sub
    rows): its decode equals the non-interlaced one, timed beside it."""
    from concurrent.futures import ThreadPoolExecutor

    from superslomo_tpu_torch.data import png

    frame = panning_clips(np.random.default_rng(21), 1, H, W, n=1)[0, 0]
    want = frame.reshape(H, W * 3)
    out = {"phase": "png_unfilter_vs_plain", "frame_hw": [H, W], "cpu_count": os.cpu_count(), "filters": {}}
    with tempfile.TemporaryDirectory() as d:
        for ft, name in enumerate(FILTERS):
            path = os.path.join(d, f"{name}.png")
            write_png(path, frame, ft)
            _, stream, _, _ = png.read_chunks(path)
            raw = np.frombuffer(zlib.decompress(stream), np.uint8)
            times, got = [], None
            for _ in range(reps):
                buf = raw.copy()
                t0 = time.perf_counter()
                got = png.unfilter(buf, H, W * 3, 3)
                times.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _, stream, _, _ = png.read_chunks(path)
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
        adam7 = os.path.join(d, "adam7.png")
        with open(adam7, "wb") as f:
            f.write(png_bytes(frame, 1, interlace=True))
        times, img = [], None
        for _ in range(reps):  # beside the Sub frame's decode: the same pixels, the same filter
            t0 = time.perf_counter()
            img = png.imread(adam7)
            times.append((time.perf_counter() - t0) * 1e3)
        out["adam7"] = {"file_mib": os.path.getsize(adam7) / 2**20, "decode_ms": statistics.median(times),
                        "decode_ms_each": times, "sub_decode_ms": out["filters"]["sub"]["decode_ms"],
                        "equals_non_interlaced": bool(np.array_equal(img, png.imread(sub)))}
    emit(out)
    bad = [k for k, v in out["filters"].items() if not (v["compiled_equals_plain"] and v["equals_written"])]
    if bad or not out["adam7"]["equals_non_interlaced"]:
        raise AssertionError(f"the PNG unfilter differs from its plain version or the written pixels: {bad}, "
                             f"or the Adam7 decode from the non-interlaced one: {out['adam7']}")
    return out


JPEG_CASES = {  # name → the writer's arguments (q95, a 720p panning-texture frame)
    "420": {"sampling": "420"}, "444": {"sampling": "444"}, "grey": {"grey": True},
    "420_restart": {"sampling": "420", "restart": 8},
    "progressive_420": {"sampling": "420", "scans": "progressive"},
    "progressive_420_rst": {"sampling": "420", "scans": "progressive", "restart": 8},
    "multiscan_420": {"sampling": "420", "scans": "components"},
    "cmyk": {"colour": "cmyk"}, "ycck": {"colour": "ycck", "sampling": "420"},
}


def jpeg_decode_times(cases, H=720, W=1280, reps=15):
    """Each case of ``cases`` (name → the writer's arguments, as JPEG_CASES)
    written at q95 from the 720p panning-texture frame into a temporary
    directory and decoded whole (``jpeg.imread``: read, markers, the routine)
    ``reps`` times after one untimed decode (the file in the page cache):
    name → (the decode ms of each rep, the file's MiB). Uses only the writer
    and ``jpeg.imread``, so an earlier tree's package can be timed too."""
    from superslomo_tpu_torch.data import jpeg

    frame = panning_clips(np.random.default_rng(21), 1, H, W, n=1)[0, 0]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, kw in cases.items():
            kw = dict(kw)
            path = os.path.join(d, f"{name}.jpg")
            write_jpeg(path, frame[..., 1] if kw.pop("grey", False) else frame, quality=95, **kw)
            jpeg.imread(path)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jpeg.imread(path)
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = (times, os.path.getsize(path) / 2**20)
    return out


def phase_jpeg_decode(png_res, H=720, W=1280, reps=9):
    """The compiled JPEG decode (csrc/jpeg_decode.cpp: entropy decode, IDCT,
    upsampling and colour conversion) against its plain version
    (``jpeg.decode_plain``) on a 720p panning-texture frame written at q95:
    baseline in 4:2:0, 4:4:4, grey, and 4:2:0 with a restart every 8 MCUs (the
    one-pass routine); progressive 4:2:0 (libjpeg's 10-scan script) with and
    without restarts, sequential 4:2:0 in three scans, Adobe CMYK (4:4:4:4)
    and YCCK (4:2:0:4) (the scans' coefficient buffers and the output pass):
    bit for bit, and within 30 dB PSNR of the written frame (the writer's own
    loss). The plain decode runs at 720p for every case. Times: a whole
    decode (``jpeg_decode_times``: median of ``reps``) beside the baseline
    4:2:0's and the PNG decode of phase 15 on the same frame kind; the plain
    decode (one call); 24 decodes of the baseline and of the progressive
    4:2:0 frame on 12 threads (the routines release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from superslomo_tpu_torch.data import jpeg

    frame = panning_clips(np.random.default_rng(21), 1, H, W, n=1)[0, 0]
    out = {"phase": "jpeg_decode_vs_plain", "frame_hw": [H, W], "quality": 95, "reps": reps, "cases": {},
           "png_sub_decode_ms": png_res["filters"]["sub"]["decode_ms"]}
    times = jpeg_decode_times(JPEG_CASES, H, W, reps)
    with tempfile.TemporaryDirectory() as d:
        for name, kw in JPEG_CASES.items():
            kw = dict(kw)
            img = frame[..., 1] if kw.pop("grey", False) else frame
            path = os.path.join(d, f"{name}.jpg")
            write_jpeg(path, img, quality=95, **kw)
            got = jpeg.imread(path)
            with open(path, "rb") as f:
                data = f.read()
            header = jpeg.read_header(data, path)
            t0 = time.perf_counter()
            plain = jpeg.decode_plain(data, header, path)
            plain_ms = (time.perf_counter() - t0) * 1e3
            ref = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
            mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
            out["cases"][name] = {
                "file_mib": times[name][1], "scans": len(header.scans), "progressive": header.progressive,
                "colour": header.colour, "decode_ms": statistics.median(times[name][0]),
                "decode_ms_each": times[name][0], "plain_ms": plain_ms, "plain_hw": [H, W], "shape": list(got.shape),
                "compiled_equals_plain": bool(np.array_equal(got, plain)),
                "psnr_db": 10 * np.log10(255**2 / mse) if mse else float("inf"),
            }
        with ThreadPoolExecutor(12) as pool:
            for name in ("420", "progressive_420"):
                path = os.path.join(d, f"{name}.jpg")
                list(pool.map(jpeg.imread, [path] * 12))
                t0 = time.perf_counter()
                list(pool.map(jpeg.imread, [path] * 24))
                out[f"{name}_decode_12_threads_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / 24
    base = out["cases"]["420"]["decode_ms"]
    out["decode_ms_over_baseline_420"] = {k: v["decode_ms"] / base for k, v in out["cases"].items()}
    emit(out)
    bad = {k: v for k, v in out["cases"].items()
           if not (v["compiled_equals_plain"] and v["shape"] == [H, W, 3] and v["psnr_db"] > 30)}
    if bad:
        raise AssertionError(f"the JPEG decode differs from its plain version or the written frame: {bad}")
    return out


# --------------------------------------------------------------------------- #
# the uncompressed and lossless raster formats (phase 15c): writers in numpy
# and the stdlib, as the card's machine has no cv2 or PIL


def _runs(row, cap):
    """(values, lengths) of the runs of equal values along ``row``, each
    at most ``cap`` long."""
    edges = np.flatnonzero(np.diff(row)) + 1
    starts, ends = np.concatenate([[0], edges]), np.concatenate([edges, [row.size]])
    n = -(-(ends - starts) // cap)
    first = np.repeat(starts, n) + cap * (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    return row[first], np.minimum(np.repeat(ends, n) - first, cap)


def _run_packets(row, repeat, literal, min_run, cap):
    """``row`` as runs of ``min_run`` or more equal bytes (``repeat(n, v)``)
    and literal spans of at most ``cap`` bytes between them (``literal(b)``)."""
    vals, lens = _runs(row, cap)
    ends = np.cumsum(lens)
    out, lit = [], 0
    for j in np.flatnonzero(lens >= min_run):
        start = ends[j] - lens[j]
        out += [literal(row[a:min(a + cap, start)].tobytes()) for a in range(lit, start, cap)]
        out.append(repeat(int(lens[j]), int(vals[j])))
        lit = ends[j]
    out += [literal(row[a:min(a + cap, row.size)].tobytes()) for a in range(lit, row.size, cap)]
    return b"".join(out)


def bmp_bytes(img, rle8=False):
    """A BMP of the (H, W, 3) RGB frame (BITMAPINFOHEADER, bottom-up rows):
    24 bits, or with ``rle8`` the frame in a 3-3-2 palette (``palette_332``)
    RLE8-coded as runs of up to 255 pixels, an end of line after each row and
    an end of bitmap."""
    h, w = img.shape[:2]
    if rle8:
        idx = palette_332_index(img)[::-1]
        pixels = b"".join(np.stack(_runs(row, 255)[::-1], axis=1).astype(np.uint8).tobytes() + b"\0\0"
                          for row in idx) + b"\0\1"
        pal = np.concatenate([palette_332()[:, ::-1], np.zeros((256, 1), np.uint8)], axis=1).tobytes()
        bpp, comp, used = 8, 1, 256
    else:
        pixels = np.pad(img[::-1, :, ::-1].reshape(h, -1), ((0, 0), (0, -3 * w % 4))).tobytes()
        pal, bpp, comp, used = b"", 24, 0, 0
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, comp, len(pixels), 2835, 2835, used, 0)
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + pal + pixels


def palette_332():
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, (i >> 2 & 7) * 255 // 7, (i & 3) * 255 // 3], axis=1).astype(np.uint8)


def palette_332_index(img):
    return (img[..., 0] & 0xE0) | (img[..., 1] >> 3 & 0x1C) | img[..., 2] >> 6


def pnm_bytes(img, kind):
    """The (H, W, 3) RGB frame as a binary PPM, its green as a PGM, a PAM
    (its samples BGR, as cv2 reads a PAM of depth 3), or a little-endian PFM
    of the same values (bottom-up rows)."""
    h, w = img.shape[:2]
    if kind == "ppm":
        return f"P6\n{w} {h}\n255\n".encode() + img.tobytes()
    if kind == "pgm":
        return f"P5\n{w} {h}\n255\n".encode() + img[..., 1].tobytes()
    if kind == "pam":
        return f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n".encode() + \
            img[..., ::-1].tobytes()
    return f"PF\n{w} {h}\n-1.0\n".encode() + img[::-1].astype("<f4").tobytes()


def sun_bytes(img):
    """A standard-type 24-bit Sun raster (BGR, rows padded to 16 bits)."""
    h, w = img.shape[:2]
    rows = np.pad(img[..., ::-1].reshape(h, -1), ((0, 0), (0, 3 * w % 2))).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, 24, len(rows), 1, 0, 0) + rows


def hdr_bytes(img):
    """A Radiance HDR of the frame with exponent 128 (each value m / 256), in
    new-style run-length scanlines."""
    h, w = img.shape[:2]
    rgbe = np.concatenate([img, np.full((h, w, 1), 128, np.uint8)], axis=2)
    lines = [f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()]
    for row in rgbe:
        lines.append(bytes([2, 2, w >> 8, w & 255]))
        lines += [_run_packets(row[:, c], lambda n, v: bytes([128 + n, v]), lambda b: bytes([len(b)]) + b, 3, 127)
                  for c in range(4)]
    return b"".join(lines)


def hdr_expected(img):
    """What cv2 reads from ``hdr_bytes(img)``: m / 256 * 255, half to even."""
    return np.rint(img.astype(np.float32) * np.float32(2.0**-8) * np.float32(255)).astype(np.uint8)


def lzw_encode(data: bytes) -> bytes:
    """TIFF's LZW of ``data``, as libtiff's encoder codes it (a clear code
    first and when the table fills, the code width growing one code early)."""
    codes, widths = [256], [9]
    table, free, nbits = {}, 258, 9
    ent = data[0]
    for c in data[1:]:
        code = table.get(ent << 8 | c)
        if code is not None:
            ent = code
            continue
        codes.append(ent)
        widths.append(nbits)
        ent = c
        table[codes[-1] << 8 | c] = free
        free += 1
        if free == 4094:
            codes.append(256)
            widths.append(nbits)
            table, free, nbits = {}, 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    codes += [ent]
    widths += [nbits]
    if free + 1 > (1 << nbits) - 1 and nbits < 12:
        nbits += 1
    codes.append(257)
    widths.append(nbits)
    return _pack_codes(np.array(codes, np.int64), np.array(widths, np.int64))


def lzw_literal(data: bytes) -> bytes:
    """A valid TIFF LZW stream of ``data`` that numpy writes fast: every byte
    a 9-bit literal code, a clear code before each 253 (so the width never
    grows)."""
    raw = np.frombuffer(data, np.uint8).astype(np.int64)
    pad = -raw.size % 253
    body = np.concatenate([np.full((raw.size + pad) // 253, 256)[:, None],
                           np.pad(raw, (0, pad), constant_values=-1).reshape(-1, 253)], axis=1).reshape(-1)
    codes = np.concatenate([body[body >= 0], [257]]).astype(np.int32)
    return np.packbits((codes[:, None] >> np.arange(8, -1, -1, dtype=np.int32) & 1).astype(np.uint8)).tobytes()


def _pack_codes(codes, widths):
    """Codes of the given widths (9-12 bits), MSB first, packed into bytes."""
    k = np.arange(12, dtype=np.int32)
    bits = (codes.astype(np.int32)[:, None] >> np.maximum(widths.astype(np.int32)[:, None] - 1 - k, 0)) & 1
    return np.packbits(bits[k < widths[:, None]].astype(np.uint8)).tobytes()


def packbits_encode(rows) -> bytes:
    """PackBits of each row: runs of 3 or more equal bytes as repeats, the
    rest as literals of up to 128."""
    return b"".join(_run_packets(row, lambda n, v: bytes([257 - n, v]), lambda b: bytes([len(b) - 1]) + b, 3, 128)
                    for row in rows)


def jpeg_abbreviated(data):
    """A JPEG ``data`` split as libtiff writes a TIFF's JPEG strips: (its
    DQT and DHT segments, the stream without them and without APPn)."""
    tables, rest, pos = b"", b"\xff\xd8", 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack_from(">H", data, pos + 2)[0] + 2
        segment = data[pos:pos + length]
        if data[pos + 1] in (0xDB, 0xC4):
            tables += segment
        elif not 0xE0 <= data[pos + 1] <= 0xEF:
            rest += segment
        pos += length
    return tables, rest + data[pos:]


def ycbcr_units(block, hs, vs):
    """(rows, cols, 3) uint8 RGB as TIFF's YCbCr data units: JFIF's Y, Cb,
    Cr rounded, hs x vs luma samples then the unit's mean Cb and Cr; a unit
    cut by the edge padded by replication."""
    rows, cols = block.shape[:2]
    ur, uc = -(-rows // vs), -(-cols // hs)
    ycc = np.stack(_ycbcr(np.pad(block, ((0, ur * vs - rows), (0, uc * hs - cols), (0, 0)), mode="edge")
                          .astype(np.float64)), axis=-1)
    units = ycc.reshape(ur, vs, uc, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = np.clip(np.round(units[..., 0].reshape(ur, uc, vs * hs)), 0, 255)
    chroma = np.clip(np.round(units[..., 1:].reshape(ur, uc, -1, 2).mean(axis=2)), 0, 255)
    return np.concatenate([luma, chroma], axis=2).astype(np.uint8).tobytes()


def _tiff_ifd(chunks, fields, bigtiff, tile, ch):
    """A little-endian TIFF (classic, or BigTIFF: version 43, 8-byte offsets
    and counts, 20-byte entries) of ``chunks`` and the IFD ``fields`` {tag:
    (type, values)}: type 3 SHORT, 4 LONG, 7 UNDEFINED (bytes), 16 LONG8;
    the chunk offsets and counts added (LONG8 in a BigTIFF)."""
    body = bytearray(b"II" + (struct.pack("<HHHQ", 43, 8, 0, 0) if bigtiff else struct.pack("<HI", 42, 0)))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + bytes(len(c) % 2)
    kind = 16 if bigtiff else 4
    counts = [len(c) for c in chunks]
    if tile:
        fields.update({322: (4, [tile[0]]), 323: (4, [tile[1]]), 324: (kind, offsets), 325: (kind, counts)})
    else:
        fields.update({273: (kind, offsets), 278: (4, [ch]), 279: (kind, counts)})
    ifd = len(body)
    struct.pack_into("<Q" if bigtiff else "<I", body, 8 if bigtiff else 4, ifd)
    entry, inline = (20, 8) if bigtiff else (12, 4)
    blobs, entries = bytearray(), []
    blob_at = ifd + (8 if bigtiff else 2) + entry * len(fields) + inline
    for tag in sorted(fields):
        kind, values = fields[tag]
        packed = bytes(values) if kind == 7 else struct.pack("<" + {3: "H", 4: "I", 16: "Q"}[kind] * len(values),
                                                             *values)
        head = struct.pack("<HHQ" if bigtiff else "<HHI", tag, kind, len(values))
        if len(packed) <= inline:
            entries.append(head + packed.ljust(inline, b"\0"))
        else:
            entries.append(head + struct.pack("<Q" if bigtiff else "<I", blob_at + len(blobs)))
            blobs += packed + bytes(len(packed) % 2)
    count = struct.pack("<Q" if bigtiff else "<H", len(fields))
    return bytes(body + count + b"".join(entries) + bytes(inline) + blobs)


def tiff_bytes(img, compression="none", predictor=False, tile=None, bits=8, rows_per_strip=16, bigtiff=False,
               photometric="rgb", subsampling=(2, 2), quality=95):
    """A little-endian TIFF of the frame in strips of ``rows_per_strip``
    or ``tile`` (w, h) tiles; 8 bits, or 16 (each value v * 257);
    ``compression`` none, lzw, lzw_literal (``lzw_literal``), packbits,
    deflate or jpeg (each strip or tile a baseline JPEG of quality
    ``quality`` from ``jpeg_bytes``, abbreviated: its tables in the
    JPEGTables field), with the horizontal predictor if asked; a BigTIFF
    with ``bigtiff``. ``photometric``: "rgb"; "ycbcr" (JPEG at the
    ``subsampling`` (h, v), or without JPEG as ``ycbcr_units``' data units;
    the YCbCrSubSampling field); "cmyk" (C, M, Y = 255 - R, G, B and K = 0,
    which libtiff turns back into the frame exactly)."""
    h, w = img.shape[:2]
    spp = 4 if photometric == "cmyk" else 3
    samples = img.astype(np.uint16) * 257 if bits == 16 else img
    if photometric == "cmyk":
        samples = np.dstack([255 - img, np.zeros((h, w, 1), np.uint8)])
    cw, ch = tile or (w, rows_per_strip)
    sampling = {v: k for k, v in JPEG_SAMPLING.items()}.get(tuple(subsampling))
    chunks, tables = [], None
    for y in range(0, h, ch):
        for x in range(0, w, cw) if tile else [0]:
            block = samples[y:y + ch, x:x + cw]
            if tile:
                block = np.pad(block, ((0, ch - block.shape[0]), (0, cw - block.shape[1]), (0, 0)),
                               mode="edge" if compression == "jpeg" else "constant")
            if compression == "jpeg":
                colour = {"ycbcr": "ycbcr", "rgb": "rgb"}[photometric]
                t, stream = jpeg_abbreviated(jpeg_bytes(block, quality=quality, sampling=sampling, colour=colour))
                assert tables in (None, t), "strips coded with different tables"
                tables = t
                chunks.append(stream)
                continue
            if photometric == "ycbcr":
                data = ycbcr_units(block, *subsampling)
                raw = np.frombuffer(data, np.uint8)[None]
            else:
                if predictor:
                    block = np.concatenate([block[:, :1], block[:, 1:] - block[:, :-1]], axis=1)
                raw = block.astype("<u2" if bits == 16 else np.uint8)
                data = raw.tobytes()
            chunks.append({"none": lambda: data, "lzw": lambda: lzw_encode(data),
                           "lzw_literal": lambda: lzw_literal(data), "deflate": lambda: zlib.compress(data, 6),
                           "packbits": lambda: packbits_encode(raw.reshape(raw.shape[0], -1))}[compression]())
    code = {"none": 1, "lzw": 5, "lzw_literal": 5, "deflate": 8, "packbits": 32773, "jpeg": 7}[compression]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [code]),
              262: (3, [{"rgb": 2, "ycbcr": 6, "cmyk": 5}[photometric]]), 277: (3, [spp]), 284: (3, [1])}
    if predictor:
        fields[317] = (3, [2])
    if photometric == "ycbcr":
        fields[530] = (3, list(subsampling))
    if tables is not None:
        fields[347] = (7, list(b"\xff\xd8" + tables + b"\xff\xd9"))
    return _tiff_ifd(chunks, fields, bigtiff, tile, ch)


# --------------------------------------------------------------------------- #
# GIF and lossless WebP (phase 15c): writers in numpy and the stdlib


def gif_lzw(idx: bytes, min_size: int, defer_clear=False) -> bytes:
    """GIF's LZW of the palette indices ``idx`` (codes LSB first, from
    min_size + 1 to 12 bits, no early change): a clear code first, another
    when the table fills, or with ``defer_clear`` none (the table stays
    frozen at 4096 entries: a deferred clear); an end code last."""
    clear = 1 << min_size
    codes, widths = [clear], [min_size + 1]
    table, free, nbits = {}, clear + 2, min_size + 1
    ent = idx[0]
    for c in idx[1:]:
        key = ent << 8 | c
        code = table.get(key)
        if code is not None:
            ent = code
            continue
        codes.append(ent)
        widths.append(nbits)
        ent = c
        if free < 4096:
            table[key] = free
            free += 1
            if free > 1 << nbits and nbits < 12:
                nbits += 1
        elif not defer_clear:
            codes.append(clear)
            widths.append(nbits)
            table, free, nbits = {}, clear + 2, min_size + 1
    codes += [ent, clear + 1]
    widths += [nbits, nbits]
    return pack_lsb(np.array(codes, np.int64), np.array(widths, np.int64))


def pack_lsb(values, nbits):
    """Fields of ``nbits`` (at most 25) bits each, LSB first, packed into bytes."""
    values, nbits = np.asarray(values, np.int64), np.asarray(nbits, np.int64)
    at = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    shifted = (values & ((1 << nbits) - 1)) << (at & 7)
    size = -(-int(nbits.sum()) // 8) + 4
    out = np.zeros(size, np.int64)
    for k in range(4):  # the fields' bits do not overlap, so their byte sums are their ORs
        out += np.bincount((at >> 3) + k, weights=(shifted >> (8 * k)) & 255, minlength=size).astype(np.int64)
    return out[:size - 4].astype(np.uint8).tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\0"


def _colour_table(palette):
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    return bits - 1, table.tobytes()


def gif_bytes(idx, palette, local=None, screen=None, at=(0, 0), background=0, transparent=None, interlace=False,
              version=b"GIF89a", defer_clear=False, lzw=None, min_size=None):
    """A GIF of the (h, w) palette indices ``idx``: the global colour table
    ``palette`` ((n, 3) RGB, or None for none), a ``local`` table (or none),
    a logical ``screen`` (w, h) with the image at ``at`` (x, y) and the
    ``background`` index, a Graphic Control Extension with the
    ``transparent`` index, interlaced rows, and real LZW codes (``gif_lzw``)
    of the smallest minimum code size that holds the tables, or the LZW data
    ``lzw``."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    tables = [t for t in (palette, local) if t is not None]
    flags, out = 0, []
    if palette is not None:
        size, table = _colour_table(palette)
        flags, out = 0x80 | size << 4 | size, [table]
    out.insert(0, version + struct.pack("<HHBBB", sw, sh, flags, background, 0))
    if transparent is not None:
        out.append(b"\x21\xf9\x04" + bytes([1, 0, 0, transparent, 0]))
    if interlace:
        idx = idx[np.concatenate([np.arange(start, h, step) for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])]
    flags = 0x40 if interlace else 0
    if local is not None:
        size, table = _colour_table(local)
        flags |= 0x80 | size
    out.append(b"\x2c" + struct.pack("<HHHHB", at[0], at[1], w, h, flags))
    if local is not None:
        out.append(table)
    min_size = min_size or max(2, int(np.ceil(np.log2(max([len(t) for t in tables] + [2])))))
    data = lzw if lzw is not None else gif_lzw(idx.astype(np.uint8).tobytes(), min_size, defer_clear)
    return b"".join(out) + bytes([min_size]) + _sub_blocks(data) + b"\x3b"


def gif_frame(img):
    """(the GIF of the frame in the 3-3-2 palette, what cv2 reads from it)."""
    return gif_bytes(palette_332_index(img), palette_332()), palette_332()[palette_332_index(img)]


def gif_window(img):
    """(an interlaced GIF whose 3-3-2 image covers the frame but for a border
    of 8 pixels, with a transparent index, on a screen of the frame's size
    whose background is index 0x25; what cv2 reads from it: the background
    around the image and under its transparent pixels)."""
    idx = palette_332_index(img)[8:-8, 8:-8]
    pal = palette_332()
    hidden = int(np.bincount(idx.reshape(-1), minlength=256).argmax())  # the commonest index is transparent
    data = gif_bytes(idx, pal, screen=img.shape[1::-1], at=(8, 8), background=0x25, transparent=hidden,
                     interlace=True)
    want = np.empty_like(img)
    want[:] = pal[0x25]
    want[8:-8, 8:-8] = np.where((idx == hidden)[..., None], pal[0x25], pal[idx])
    return data, want


def huffman_lengths(freq, limit):
    """Code lengths (at most ``limit``) of a complete prefix code for the
    symbol frequencies ``freq``; a lone used symbol (or symbol 0 when none is
    used) gets length 1, which VP8L reads as a code of no bits."""
    freq = np.asarray(freq, np.int64)
    lengths = np.zeros(freq.size, np.int64)
    used = np.flatnonzero(freq)
    if used.size <= 1:
        lengths[used[0] if used.size else 0] = 1
        return lengths
    heap = [(int(freq[s]), int(s), [int(s)]) for s in used]
    heapq.heapify(heap)
    depth = np.zeros(freq.size, np.int64)
    while len(heap) > 1:
        f1, k1, s1 = heapq.heappop(heap)
        f2, k2, s2 = heapq.heappop(heap)
        depth[s1 + s2] += 1
        heapq.heappush(heap, (f1 + f2, min(k1, k2), s1 + s2))
    bits = np.bincount(depth[used], minlength=64)
    for i in range(63, limit, -1):  # fold lengths past the limit back, keeping the code complete (T.81 K.3)
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    order = used[np.lexsort((used, -freq[used]))]  # the most frequent symbols get the shortest codes
    lengths[order] = np.repeat(np.arange(64), bits)
    return lengths


def _canonical(lengths):
    """Each symbol's canonical code, bit-reversed for an LSB-first stream."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(lengths.size, np.int64)
    code = 0
    for n in range(1, 16):
        for s in np.flatnonzero(lengths == n):
            codes[s] = int(f"{code:0{n}b}"[::-1], 2)
            code += 1
        code <<= 1
    if np.count_nonzero(lengths) == 1:
        lengths = np.zeros_like(lengths)  # one symbol: no bits
    return codes, lengths


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _vp8l_code(fields, freq):
    """Append the normal prefix code of ``freq`` (its lengths through the
    code-length code) to ``fields``; returns (codes, lengths) to write symbols."""
    lengths = huffman_lengths(freq, 15)
    cl = huffman_lengths(np.bincount(lengths, minlength=19), 7)
    n = 19
    while n > 4 and cl[_CL_ORDER[n - 1]] == 0:
        n -= 1
    fields += [(0, 1), (n - 4, 4)] + [(int(cl[_CL_ORDER[i]]), 3) for i in range(n)] + [(0, 1)]
    cl_codes, cl_bits = _canonical(cl)
    fields.append((cl_codes[lengths], cl_bits[lengths]))
    return _canonical(lengths)


def _length_prefix(v):
    """VP8L's prefix coding of values >= 1: (symbol, extra bits, extra value)."""
    v = np.asarray(v, np.int64) - 1
    hb = np.maximum(np.frexp(np.maximum(v, 1))[1] - 1, 0)
    second = (v >> np.maximum(hb - 1, 0)) & 1
    small = v < 4
    return (np.where(small, v, 2 * hb + second), np.where(small, 0, hb - 1),
            np.where(small, 0, v & ((1 << np.maximum(hb - 1, 0)) - 1)))


def _vp8l_image(fields, argb, xsize, cache_bits=0, main=False):
    """Append one entropy-coded image of the ARGB pixels ``argb`` (the
    ``main`` image, with its bit for no meta prefix codes, or a sub-image):
    with ``cache_bits``, LZ77 copies of runs of 3 or more pixels equal to the
    pixel to their left (distance code 2) or above (code 1), and colour
    cache hits for the other pixels where the cache holds them; else
    literals alone."""
    p = np.asarray(argb, np.int64).reshape(-1)
    n = p.size
    fields += [(1, 1), (cache_bits, 4)] if cache_bits else [(0, 1)]
    if main:
        fields.append((0, 1))  # no meta prefix codes
    kind = np.zeros(n, np.int8)  # 0 literal, 1 cache hit, 2 copy start, 3 copied
    copy_len = np.zeros(n, np.int64)
    copy_dist = np.zeros(n, np.int8)  # distance code 2 (left) or 1 (above)
    if cache_bits:
        for code, dist in ((2, 1), (1, xsize)):
            same = np.zeros(n, bool)
            same[dist:] = (p[dist:] == p[:-dist]) & (kind[dist:] == 0)
            edges = np.flatnonzero(np.diff(np.concatenate([[0], same.astype(np.int8), [0]])))
            s, e = edges[::2], edges[1::2]
            s, e = s[e - s >= 3], e[e - s >= 3]
            cover = np.zeros(n + 1, np.int64)
            cover[s] += 1
            cover[e] -= 1
            kind[np.cumsum(cover[:-1]) > 0] = 3
            chunks = -(-(e - s) // 4096)  # copies of at most 4096 pixels
            first = np.repeat(s, chunks) + 4096 * (np.arange(chunks.sum()) - np.repeat(np.cumsum(chunks) - chunks, chunks))
            kind[first] = 2
            copy_len[first] = np.minimum(np.repeat(e, chunks) - first, 4096)
            copy_dist[first] = code
        h = ((0x1E35A7BD * p) & 0xFFFFFFFF) >> (32 - cache_bits)
        order = np.lexsort((np.arange(n), h))
        prev = np.full(n, -1)
        same_h = h[order[1:]] == h[order[:-1]]
        prev[order[1:][same_h]] = order[:-1][same_h]  # the last earlier pixel of the same hash: what the cache holds
        kind[(kind == 0) & (prev >= 0) & (p[np.maximum(prev, 0)] == p)] = 1
    lit, hit, start = np.flatnonzero(kind == 0), np.flatnonzero(kind == 1), np.flatnonzero(kind == 2)
    len_sym, len_extra_bits, len_extra = _length_prefix(copy_len[start])
    green = np.zeros(n, np.int64)
    green[lit] = (p[lit] >> 8) & 255
    if cache_bits:
        green[hit] = 280 + h[hit]
    green[start] = 256 + len_sym
    shown = np.sort(np.concatenate([lit, hit, start]))
    channels = [(p[lit] >> 16) & 255, p[lit] & 255, (p[lit] >> 24) & 255]
    codes = [_vp8l_code(fields, np.bincount(green[shown], minlength=280 + (1 << cache_bits if cache_bits else 0)))]
    codes += [_vp8l_code(fields, np.bincount(c, minlength=256)) for c in channels]
    dist_sym = copy_dist[start].astype(np.int64) - 1  # codes 1 and 2: symbols 0 and 1, no extra bits
    codes.append(_vp8l_code(fields, np.bincount(dist_sym, minlength=40)))
    # each shown position's fields, in the stream's order: up to four (value, bits) pairs
    val = np.zeros((n, 4), np.int64)
    nb = np.zeros((n, 4), np.int64)
    gc, gl = codes[0]
    val[shown, 0], nb[shown, 0] = gc[green[shown]], gl[green[shown]]
    for k, c in enumerate(channels, start=1):
        val[lit, k], nb[lit, k] = codes[k][0][c], codes[k][1][c]
    val[start, 1], nb[start, 1] = len_extra, len_extra_bits
    val[start, 2], nb[start, 2] = codes[4][0][dist_sym], codes[4][1][dist_sym]
    fields.append((val[shown].reshape(-1), nb[shown].reshape(-1)))


def _argb(planes):
    a, r, g, b = (np.asarray(x, np.int64) for x in planes)
    return (a << 24) | (r << 16) | (g << 8) | b


def _predictions(X, mode):
    """Each pixel's VP8L prediction (H, W, 4) int64 (ARGB channel order) for
    the (H, W) predictor ``mode`` of its tile, from the pixels (H, W, 4)."""
    L = np.zeros_like(X)
    L[:, 1:] = X[:, :-1]
    T = np.zeros_like(X)
    T[1:] = X[:-1]
    TL = np.zeros_like(X)
    TL[1:, 1:] = X[:-1, :-1]
    TR = np.zeros_like(X)
    TR[1:, :-1] = X[:-1, 1:]
    TR[1:, -1] = X[1:, 0]  # the last column's top-right: the current row's first pixel
    pred = np.zeros_like(X)
    pred[..., 0] = 255  # modes 0, 14, 15: opaque black
    avg = lambda a, b: (a + b) >> 1  # noqa: E731
    half = lambda a, b: a + np.where(a < b, -((b - a) >> 1), (a - b) >> 1)  # a + (a - b) / 2, C's rounding  # noqa: E731
    formulas = {1: lambda l, t, tl, tr: l, 2: lambda l, t, tl, tr: t, 3: lambda l, t, tl, tr: tr,
                4: lambda l, t, tl, tr: tl, 5: lambda l, t, tl, tr: avg(avg(l, tr), t),
                6: lambda l, t, tl, tr: avg(l, tl), 7: lambda l, t, tl, tr: avg(l, t),
                8: lambda l, t, tl, tr: avg(tl, t), 9: lambda l, t, tl, tr: avg(t, tr),
                10: lambda l, t, tl, tr: avg(avg(l, tl), avg(t, tr)),
                11: lambda l, t, tl, tr: np.where((np.abs(l - tl) - np.abs(t - tl)).sum(-1, keepdims=True) <= 0,
                                                  t, l),
                12: lambda l, t, tl, tr: np.clip(l + t - tl, 0, 255),
                13: lambda l, t, tl, tr: np.clip(half(avg(l, t), tl), 0, 255)}
    for m, f in formulas.items():
        sel = mode == m
        pred[sel] = f(L[sel], T[sel], TL[sel], TR[sel])
    pred[0, 0] = (255, 0, 0, 0)
    pred[0, 1:] = L[0, 1:]
    pred[1:, 0] = T[1:, 0]
    return pred


def _int8(v):
    return ((np.asarray(v, np.int64) + 128) & 255) - 128


def vp8l_bytes(img, kind="transforms", pred_bits=5, cache_bits=6):
    """A lossless WebP (RIFF + VP8L) of the (H, W, 3) RGB frame, which cv2
    reads back bit for bit. ``transforms``: subtract-green, then the
    predictor in tiles of 2^pred_bits with modes 0-15 in turn across the
    tiles, then cross-colour with multipliers in turn across the tiles; the
    residuals with LZ77 copies (the pixel to the left, and above) and a
    colour cache. ``palette``: colour indexing of a frame of at most 16
    colours, 2 to 8 pixels bundled a byte, the packed image with copies and
    the cache."""
    H, W, _ = img.shape
    fields = [(0x2F, 8), (W - 1, 14), (H - 1, 14), (0, 1), (0, 3)]
    X = np.concatenate([np.full((H, W, 1), 255, np.int64), img.astype(np.int64)], axis=2)  # A, R, G, B
    if kind == "palette":
        colours, idx = np.unique(_argb(np.moveaxis(X, 2, 0)).reshape(-1), return_inverse=True)
        assert colours.size <= 16, "the palette case takes a frame of at most 16 colours"
        bits = 0 if colours.size > 16 else 1 if colours.size > 4 else 2 if colours.size > 2 else 3
        fields += [(1, 1), (3, 2), (colours.size - 1, 8)]
        delta = np.stack([(colours >> s) & 255 for s in (0, 8, 16, 24)], -1)
        delta[1:] = (delta[1:] - delta[:-1]) & 255
        _vp8l_image(fields, (delta << np.array([0, 8, 16, 24])).sum(-1), colours.size)
        per = 1 << bits
        idx = np.pad(idx.reshape(H, W), ((0, 0), (0, -W % per)))
        packed = (idx.reshape(H, -1, per) << ((8 >> bits) * np.arange(per))).sum(-1)
        fields.append((0, 1))
        _vp8l_image(fields, 0xFF000000 | packed << 8, packed.shape[1], cache_bits, main=True)
    else:
        X[..., 1] = (X[..., 1] - X[..., 2]) & 255  # subtract green
        X[..., 3] = (X[..., 3] - X[..., 2]) & 255
        th, tw = -(-H // (1 << pred_bits)), -(-W // (1 << pred_bits))
        ty, tx = np.mgrid[0:th, 0:tw]
        modes = (3 * tx + 5 * ty) % 16
        mode = np.repeat(np.repeat(modes, 1 << pred_bits, 0), 1 << pred_bits, 1)[:H, :W]
        R = (X - _predictions(X, mode)) & 255
        mult = np.stack([(7 * tx + 3 * ty) % 64 - 32, (5 * tx + 11 * ty) % 64 - 32, (3 * tx + 7 * ty) % 64 - 32])
        m = np.repeat(np.repeat(mult, 1 << pred_bits, 1), 1 << pred_bits, 2)[:, :H, :W]
        g, r = _int8(R[..., 2]), R[..., 1].copy()
        R[..., 1] = (r - ((m[0] * g) >> 5)) & 255
        R[..., 3] = (R[..., 3] - ((m[1] * g) >> 5) - ((m[2] * _int8(r)) >> 5)) & 255
        fields += [(1, 1), (2, 2), (1, 1), (0, 2), (pred_bits - 2, 3)]
        _vp8l_image(fields, 0xFF000000 | modes << 8, tw)
        fields += [(1, 1), (1, 2), (pred_bits - 2, 3)]
        _vp8l_image(fields, _argb([np.full_like(tx, 255), mult[2] & 255, mult[1] & 255, mult[0] & 255]), tw)
        fields.append((0, 1))
        _vp8l_image(fields, _argb(np.moveaxis(R, 2, 0)), W, cache_bits, main=True)
    values = np.concatenate([np.atleast_1d(v) for v, _ in fields])
    nbits = np.concatenate([np.broadcast_to(np.atleast_1d(b), np.atleast_1d(v).shape) for v, b in fields])
    data = pack_lsb(values, nbits)
    body = b"VP8L" + struct.pack("<I", len(data)) + data + bytes(len(data) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def palette_16(img):
    """The frame in 16 colours: its channels' sum cut into 16 levels, each
    level a colour of its own."""
    level = (img.astype(np.int64).sum(2) * 16 // 766)
    return np.stack([level * 17, 255 - level * 17, (level * 53) & 255], -1).astype(np.uint8)


# A small VP8 key-frame writer: numpy for the transforms, a boolean encoder in Python.
_VP8_M1, _VP8_M2 = 20091 / 65536 + 1, 35468 / 65536
_VP8_IDCT = np.array([[1, _VP8_M1, 1, _VP8_M2], [1, _VP8_M2, -1, -_VP8_M1], [1, -_VP8_M2, -1, _VP8_M1],
                      [1, -_VP8_M1, 1, -_VP8_M2]])  # the decoder's 1-D inverse transform, 8 x the residual
_VP8_FDCT = np.linalg.inv(_VP8_IDCT)
_VP8_WHT = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
VP8_SUB_MODES = 10  # B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU in libwebp's order
_VP8_SUB_TREE = {0: "0", 1: "10", 2: "110", 3: "11100", 4: "111010", 5: "111011", 6: "11110", 7: "111110",
                 8: "1111110", 9: "1111111"}  # each sub-mode's bits, read with probabilities 0-8 in tree order
_VP8_SUB_NODES = {0: (0,), 1: (0, 1), 2: (0, 1, 2), 3: (0, 1, 2, 3, 4), 4: (0, 1, 2, 3, 4, 5), 5: (0, 1, 2, 3, 4, 5),
                  6: (0, 1, 2, 3, 6), 7: (0, 1, 2, 3, 6, 7), 8: (0, 1, 2, 3, 6, 7, 8), 9: (0, 1, 2, 3, 6, 7, 8)}


class BoolWriter:
    """The VP8 boolean encoder (RFC 6386, section 7.3); ``fixed`` events
    carry their probability, ``put`` codes one."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & 0x80000000:  # carry into the bytes written
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def literal(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1, 128)

    def signed(self, v, n):
        self.literal(abs(v), n)
        self.put(int(v < 0), 128)

    def flag(self, v, n):
        """An optional signed field: a flag, then the value when it is not 0."""
        self.put(int(v != 0), 128)
        if v:
            self.signed(v, n)

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            i = len(self.out) - 1
            while self.out[i] == 255:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _vp8_yuv(img):
    """(H, W, 3) RGB → BT.601 studio-range Y (H, W) and 2x2-averaged U, V."""
    rgb = img.astype(np.int64)
    R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    Y = ((66 * R + 129 * G + 25 * B + 128) >> 8) + 16
    U = ((-38 * R - 74 * G + 112 * B + 128) >> 8) + 128
    V = ((112 * R - 94 * G - 18 * B + 128) >> 8) + 128
    H, W = Y.shape
    pad = ((0, H & 1), (0, W & 1))
    U, V = (np.pad(P, pad, mode="edge") for P in (U, V))
    U, V = ((P[0::2, 0::2] + P[1::2, 0::2] + P[0::2, 1::2] + P[1::2, 1::2] + 2) >> 2 for P in (U, V))
    return Y, U, V


def _quantise(coeffs, dq, first=0):
    """Round (..., 16) raster-order coefficients to levels (at most DCT_CAT6's
    2114) with (DC, AC) factors dq; returns (levels, dequantised)."""
    step = np.full(16, dq[1], np.float64)
    step[0] = dq[0]
    lev = np.clip(np.round(coeffs / step), -2114, 2114).astype(np.int64)
    lev[..., :first] = 0
    return lev, lev * step.astype(np.int64)


def _vp8_residual(res):
    """(..., 4, 4) residual → (..., 16) coefficients, the inverse of the decoder's DCT."""
    return np.einsum("ij,...jk,lk->...il", _VP8_FDCT, 8.0 * res, _VP8_FDCT).reshape(*res.shape[:-2], 16)


def _vp8_blocks(plane):
    """(4n, 4m) → (n * m, 4, 4) in raster order of the 4x4 blocks."""
    n, m = plane.shape[0] // 4, plane.shape[1] // 4
    return plane.reshape(n, 4, m, 4).transpose(0, 2, 1, 3).reshape(n * m, 4, 4)


def _vp8_unblocks(blocks, n, m):
    return blocks.reshape(n, m, 4, 4).transpose(0, 2, 1, 3).reshape(4 * n, 4 * m)


def _vp8_macroblock(Y, U, V, R, mb_x, mb_y, mb_w, mode, sub_modes, uv_mode, dq):
    """Choose nothing: code the macroblock in the given modes against its
    prediction from the reconstruction R (Y, U, V planes, updated in place);
    returns the levels (lists): Y2 (or None), 16 Y and 8 chroma blocks,
    zigzag order. A residual that rounds to no level adds nothing."""
    from superslomo_tpu_torch.data import vp8

    RY, RU, RV = R
    y0, x0 = 16 * mb_y, 16 * mb_x
    zz = np.array(vp8.ZIGZAG)
    y2 = None
    if mode is not None:  # 16x16
        pred = vp8.predict_16(mode, *vp8.edges(RY, y0, x0, 16, mb_x, mb_y), mb_x, mb_y)
        coeffs = _vp8_residual(_vp8_blocks(Y[y0:y0 + 16, x0:x0 + 16] - pred))
        dc = coeffs[:, 0].reshape(4, 4)
        y2_lev, y2_deq = _quantise((_VP8_WHT.T @ dc @ _VP8_WHT / 2).reshape(1, 16), dq[1])
        y_lev, y_deq = _quantise(coeffs, dq[0], first=1)
        y_deq[:, 0] = vp8.inverse_wht(y2_deq[0])
        recon = np.clip(pred + _vp8_unblocks(vp8.inverse_dct(y_deq), 4, 4), 0, 255) if y_deq.any() else pred
        y2 = y2_lev[0, zz].tolist()
    else:
        work = vp8.luma4_work(RY, mb_x, mb_y, mb_w)
        y_lev = np.zeros((16, 16), np.int64)
        for k in range(16):
            by, bx = 4 * (k // 4), 4 * (k % 4)
            pred = vp8.predict_luma4(sub_modes[k], work[by, bx + 1:bx + 9], work[by + 1:by + 5, bx], work[by, bx])
            lev, deq = _quantise(_vp8_residual(Y[y0 + by:y0 + by + 4, x0 + bx:x0 + bx + 4] - pred), dq[0])
            y_lev[k] = lev
            work[by + 1:by + 5, bx + 1:bx + 5] = np.clip(pred + vp8.inverse_dct(deq), 0, 255)
        recon = work[1:, 1:17]
    RY[y0:y0 + 16, x0:x0 + 16] = recon
    uv = []
    for P, RP in ((U, RU), (V, RV)):
        pred = vp8.predict_16(uv_mode, *vp8.edges(RP, y0 // 2, x0 // 2, 8, mb_x, mb_y), mb_x, mb_y)
        lev, deq = _quantise(_vp8_residual(_vp8_blocks(P[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] - pred)), dq[2])
        if deq.any():
            pred = np.clip(pred + _vp8_unblocks(vp8.inverse_dct(deq), 2, 2), 0, 255)
        RP[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = pred
        uv.append(lev)
    return y2, y_lev[:, zz].tolist(), np.concatenate(uv)[:, zz].tolist()


def _vp8_tokens(events, lev, first, ctx, t):
    """Append the token events (context id or -prob, bit) of one block's
    levels (zigzag order) from index ``first`` in context ``ctx`` of type t;
    returns whether it coded a non-zero level."""
    from superslomo_tpu_torch.data.vp8 import BANDS, CAT_PROBAS

    def node(n, c, k):
        return ((t * 8 + BANDS[n]) * 3 + c) * 11 + k

    last = 15
    while last >= first and not lev[last]:
        last -= 1
    if last < first:  # an empty block: its end at once
        events.append((node(first, ctx, 0), 0))
        return False
    n, c = first, ctx
    while n < 16:
        events.append((node(n, c, 0), int(n <= last)))
        if n > last:
            return last >= first
        while lev[n] == 0:
            events.append((node(n, c, 1), 0))
            n, c = n + 1, 0
        v = abs(lev[n])
        events.append((node(n, c, 1), 1))
        events.append((node(n, c, 2), int(v > 1)))
        if v > 1:
            p = lambda k, n=n, c=c: node(n, c, k)  # noqa: E731
            if v <= 4:
                events += [(p(3), 0), (p(4), int(v > 2))] + ([(p(5), v - 3)] if v > 2 else [])
            elif v <= 10:
                events += [(p(3), 1), (p(6), 0), (p(7), int(v > 6))]
                events += [(-159, v - 5)] if v <= 6 else [(-165, (v - 7) >> 1), (-145, (v - 7) & 1)]
            else:
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                extra, tab = v - 3 - (8 << cat), CAT_PROBAS[cat]
                events += [(p(3), 1), (p(6), 1), (p(8), cat >> 1), (p(9 + (cat >> 1)), cat & 1)]
                events += [(-prob, (extra >> (len(tab) - 1 - i)) & 1) for i, prob in enumerate(tab)]
        events.append((-128, int(lev[n] < 0)))
        n, c = n + 1, (2 if v > 1 else 1)
    return True


def vp8_bytes(img, q=40, filter="normal", level=20, sharpness=0, partitions=1, skip=True, segments=None,
              lf_delta=None, quant_deltas=(0, 0, 0, 0, 0), version=0, bpred=0.3, seed=0):
    """A lossy WebP (RIFF + a VP8 key frame) of the (H, W, 3) RGB frame, from a
    small encoder: BT.601 4:2:0, each macroblock's modes a seeded choice
    (B_PRED with probability ``bpred`` and then each sub-mode at random, else
    one of the four 16x16 modes; a chroma mode at random), the residual
    against the prediction from the writer's own reconstruction through the
    inverse of the decoder's DCT (and WHT for a 16x16 macroblock's DCs),
    rounded at quantiser index ``q`` with ``quant_deltas`` (Y1 DC, Y2 DC, Y2
    AC, UV DC, UV AC). The header: ``filter`` "normal" or "simple" at
    ``level`` (0-63) and ``sharpness`` (0-7); ``partitions`` token partitions
    (1, 2, 4 or 8); with ``skip`` the skip probability (macroblocks without a
    level skipped); ``segments`` None or a dict of "absolute" (bool), "quant"
    and "strength" (4 values each) and "map" (bool: a seeded segment a
    macroblock, coded with 3 tree probabilities, else none); ``lf_delta``
    None or (reference delta 0, B_PRED mode delta 0); the frame tag's
    ``version`` (0-3). The token probabilities are the defaults, updated
    where this frame's own counts save bits (at least one update)."""
    from superslomo_tpu_torch.data import vp8

    rng = np.random.default_rng(seed)
    H, W, _ = img.shape
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    Y, U, V = _vp8_yuv(img)
    Y = np.pad(Y, ((0, 16 * mb_h - H), (0, 16 * mb_w - W)), mode="edge")
    U, V = (np.pad(P, ((0, 8 * mb_h - P.shape[0]), (0, 8 * mb_w - P.shape[1])), mode="edge") for P in (U, V))
    R = (np.zeros_like(Y), np.zeros_like(U), np.zeros_like(V))
    seg = segments or {}
    seg_map = rng.integers(0, 4, (mb_h, mb_w)) if seg.get("map") else np.zeros((mb_h, mb_w), np.int64)
    dqs = []
    for s in range(4):
        qs = q if not seg else seg["quant"][s] + (0 if seg.get("absolute") else q)
        dqs.append(vp8.dequant(qs, quant_deltas))
    mbs = []
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            i4 = rng.random() < bpred
            mode = None if i4 else int(rng.integers(4))
            subs = rng.integers(0, VP8_SUB_MODES, 16).tolist() if i4 else None
            uv_mode = int(rng.integers(4))
            levels = _vp8_macroblock(Y, U, V, R, mb_x, mb_y, mb_w, mode, subs, uv_mode, dqs[seg_map[mb_y, mb_x]])
            empty = not any(any(block) for b in levels if b is not None for block in (b if b and isinstance(b[0], list) else [b]))
            mbs.append((mode, subs, uv_mode, levels, bool(skip and empty)))
    # the token events of each partition, in the decoder's contexts
    parts = [[] for _ in range(partitions)]
    top = [[0] * 9 for _ in range(mb_w)]  # per column: Y2, 4 Y, 2 U, 2 V non-zero flags
    for mb_y in range(mb_h):
        left = [0] * 9
        events = parts[mb_y % partitions]
        for mb_x in range(mb_w):
            mode, subs, uv_mode, (y2, ylev, uvlev), skipped = mbs[mb_y * mb_w + mb_x]
            t = top[mb_x]
            if skipped:
                keep = [t[0], left[0]] if mode is None else [0, 0]
                t[:], left[:] = [keep[0]] + [0] * 8, [keep[1]] + [0] * 8
                continue
            first, ytype = 0, 3
            if mode is not None:
                t[0] = left[0] = int(_vp8_tokens(events, y2, 0, t[0] + left[0], 1))
                first, ytype = 1, 0
            for k in range(16):
                y, x = divmod(k, 4)
                t[1 + x] = left[1 + y] = int(_vp8_tokens(events, ylev[k], first, t[1 + x] + left[1 + y], ytype))
            for k in range(8):
                base = 5 if k < 4 else 7
                y, x = divmod(k % 4, 2)
                t[base + x] = left[base + y] = int(_vp8_tokens(events, uvlev[k], 0, t[base + x] + left[base + y], 2))
    proba = vp8.COEFF_PROBA.reshape(-1).astype(np.int64).copy()
    update = vp8.COEFF_UPDATE.reshape(-1).astype(np.int64)
    changed = {}
    ids = np.array([e for events in parts for e, _ in events if e >= 0], np.int64)
    bits = np.array([b for events in parts for e, b in events if e >= 0], np.int64)
    ones = np.bincount(ids, weights=bits, minlength=proba.size)
    total = np.bincount(ids, minlength=proba.size)
    for k in np.flatnonzero(total):
        p = int(np.clip(round(256 * (total[k] - ones[k]) / total[k]), 1, 255))
        old, zeros = proba[k], total[k] - ones[k]
        gain = (zeros * (np.log2(p / 256) - np.log2(old / 256)) +
                ones[k] * (np.log2(1 - p / 256) - np.log2(1 - old / 256)))
        if gain > 9 + np.log2(256 / max(256 - update[k], 1)):
            changed[k] = p
    if not changed:  # at least one update
        k = int(np.flatnonzero(total)[0]) if total.any() else 0
        changed[k] = int(np.clip(proba[k] + 1, 1, 255))
    for k, p in changed.items():
        proba[k] = p
    token_bytes = []
    for events in parts:
        bw = BoolWriter()
        for e, b in events:
            bw.put(b, int(proba[e]) if e >= 0 else -e)
        token_bytes.append(bw.finish())
    # the first partition: the header, then each macroblock's modes
    bw = BoolWriter()
    bw.literal(0, 2)  # colour space, clamping type
    bw.put(int(bool(seg)), 128)
    seg_probs = (128, 128, 128)
    if seg:
        bw.put(int(bool(seg.get("map"))), 128)
        bw.put(1, 128)  # update the segment data
        bw.put(int(bool(seg.get("absolute"))), 128)
        for v in seg["quant"]:
            bw.flag(v, 7)
        for v in seg["strength"]:
            bw.flag(v, 6)
        if seg.get("map"):
            for p in seg_probs:
                bw.put(1, 128)
                bw.literal(p, 8)
    bw.put(int(filter == "simple"), 128)
    bw.literal(level, 6)
    bw.literal(sharpness, 3)
    bw.put(int(lf_delta is not None), 128)
    if lf_delta is not None:
        bw.put(1, 128)
        for v in (lf_delta[0], 2, -3, 4):  # reference deltas: a key frame reads the first
            bw.flag(v, 6)
        for v in (lf_delta[1], -5, 6, 0):  # mode deltas: the first is B_PRED's
            bw.flag(v, 6)
    bw.literal(partitions.bit_length() - 1, 2)
    bw.literal(q, 7)
    for v in quant_deltas:
        bw.flag(v, 4)
    bw.put(0, 128)  # refresh entropy probabilities
    for k in range(proba.size):
        bw.put(int(k in changed), int(update[k]))
        if k in changed:
            bw.literal(changed[k], 8)
    n_skipped = sum(m[4] for m in mbs)
    skip_p = int(np.clip(round(256 * (len(mbs) - n_skipped) / len(mbs)), 1, 255))
    bw.put(int(skip), 128)
    if skip:
        bw.literal(skip_p, 8)
    intra_t = [0] * (4 * mb_w)
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        for mb_x in range(mb_w):
            mode, subs, uv_mode, _, skipped = mbs[mb_y * mb_w + mb_x]
            if seg.get("map"):
                s = int(seg_map[mb_y, mb_x])
                bw.put(int(s >= 2), seg_probs[0])
                bw.put(s & 1, seg_probs[1 + (s >> 1)])
            if skip:
                bw.put(int(skipped), skip_p)
            bw.put(int(mode is not None), 145)
            if mode is not None:
                bw.put(int(mode in (1, 3)), 156)  # TM, H
                bw.put(int(mode in (1, 2)), 128 if mode in (1, 3) else 163)  # TM of TM / H, V of V / DC
                intra_t[4 * mb_x:4 * mb_x + 4] = [mode] * 4
                intra_l[:] = [mode] * 4
            else:
                for k, sub in enumerate(subs):
                    y, x = divmod(k, 4)
                    p = vp8.BMODES_PROBA[intra_t[4 * mb_x + x], intra_l[y]]
                    for node, b in zip(_VP8_SUB_NODES[sub], _VP8_SUB_TREE[sub]):
                        bw.put(int(b), int(p[node]))
                    intra_t[4 * mb_x + x] = intra_l[y] = sub
            bw.put(int(uv_mode != 0), 142)
            if uv_mode:
                bw.put(int(uv_mode != 2), 114)
                if uv_mode != 2:
                    bw.put(int(uv_mode == 1), 183)
    first = bw.finish()
    tag = (version << 1) | 0x10 | (len(first) << 5)
    frame = (bytes([tag & 255, (tag >> 8) & 255, tag >> 16]) + b"\x9d\x01\x2a" + struct.pack("<HH", W, H) + first +
             b"".join(len(p).to_bytes(3, "little") for p in token_bytes[:-1]) + b"".join(token_bytes))
    body = b"VP8 " + struct.pack("<I", len(frame)) + frame + bytes(len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


VP8_FRAME = dict(q=20, bpred=0.1)  # a clip's lossy WebP frame: 720p in about 35 KB; 1 macroblock in 10 B_PRED


def _vp8_job(img, kwargs):
    return vp8_bytes(img, **kwargs)


EVAL_VP8_FRAMES = 17  # the lossy eval clip: two 9-frame windows, one batch (phase 5's B=2 shapes)
VP8_CLIP = sorted(set(range(EVAL_VP8_FRAMES)) | set(range(4, 57, 5)))  # the eval clip; every 5th frame of the lists


def raster_frame(H=720, W=1280):
    """The raster decode phase's panning-texture frame."""
    return panning_clips(np.random.default_rng(21), 1, H, W, n=1)[0, 0]


class VP8Files:
    """The lossy WebP files of the data phases, written by ``vp8_bytes`` in 8
    spawned processes (the writer's per-macroblock Python holds the
    interpreter lock, so threads would run one at a time) from ``start`` to
    ``join``: the 57-frame clip of ``write_dataset`` (the same seed) at the
    indices ``VP8_CLIP`` (``VP8_FRAME``, seeded by index; keys ("clip", i))
    and the raster phase's ``VP8_CASES`` of ``raster_frame`` at H x W and at
    ``PLAIN_HW`` (keys (name, (h, w))). ``data`` holds each file's bytes."""

    def __init__(self, H=720, W=1280):
        clip = panning_clips(np.random.default_rng(31), 1, H, W, n=57)[0]
        frame = raster_frame(H, W)
        self.jobs = {("clip", i): (clip[i], dict(VP8_FRAME, seed=i)) for i in VP8_CLIP}
        for name, kw in VP8_CASES.items():
            for h, w in {(H, W), (min(PLAIN_HW["webp"][0], H), min(PLAIN_HW["webp"][1], W))}:
                self.jobs[name, (h, w)] = (frame[:h, :w], kw)
        self.pool, self.futures, self.data, self.t0 = None, None, {}, None
        self.record = {"phase": "vp8_files_written", "files": len(self.jobs)}

    def start(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {key: self.pool.submit(_vp8_job, img, kw) for key, (img, kw) in self.jobs.items()}
        return self

    def join(self):
        """Wait for every file (starting them first if need be); records the
        seconds from start to the last file and the wait in ``join``."""
        if self.futures is None and not self.data:
            self.start()
        if self.futures is not None:
            t0 = time.perf_counter()
            self.data = {key: f.result() for key, f in self.futures.items()}
            self.pool.shutdown()
            self.futures = None
            now = time.perf_counter()
            self.record.update(seconds=now - self.t0, join_wait_s=now - t0, bytes_per_clip_frame=statistics.median(
                len(v) for (kind, _), v in self.data.items() if kind == "clip"))
            emit(self.record)
        return self


def write_vp8_clip(root, files):
    """The clip frames of ``files`` (a joined VP8Files) written under
    ``root``; returns {index: path}."""
    clip_dir = os.path.join(root, "adobe_vp8", "clip_000")
    os.makedirs(clip_dir)
    paths = {i: os.path.join(clip_dir, f"frame_{i:05d}.webp") for i in VP8_CLIP}
    for i, path in paths.items():
        with open(path, "wb") as f:
            f.write(files.data["clip", i])
    return paths


RASTER_CASES = {  # name → (the writer of a 720p frame, what cv2 reads from it (None: not known on the card, its
    # PSNR recorded), whether the plain decode is compared: a compiled routine runs, or the case is new)
    "bmp_24": (bmp_bytes, lambda f: f, False),
    "bmp_rle8": (lambda f: bmp_bytes(f, rle8=True), lambda f: palette_332()[palette_332_index(f)], True),
    "ppm": (lambda f: pnm_bytes(f, "ppm"), lambda f: f, False),
    "pgm": (lambda f: pnm_bytes(f, "pgm"), lambda f: np.repeat(f[..., 1:2], 3, axis=2), False),
    "pam": (lambda f: pnm_bytes(f, "pam"), lambda f: f, False),
    "pfm": (lambda f: pnm_bytes(f, "pfm"), lambda f: f, False),
    "tiff_none": (tiff_bytes, lambda f: f, False),
    "tiff_lzw_predictor": (lambda f: tiff_bytes(f, "lzw", predictor=True), lambda f: f, True),
    "tiff_packbits": (lambda f: tiff_bytes(f, "packbits"), lambda f: f, True),
    "tiff_deflate_tiled": (lambda f: tiff_bytes(f, "deflate", tile=(256, 256)), lambda f: f, False),
    "tiff_16bit": (lambda f: tiff_bytes(f, bits=16), lambda f: f, False),
    "tiff_jpeg_ycbcr_420_strips": (lambda f: tiff_bytes(f, "jpeg", photometric="ycbcr"), None, True),
    "tiff_jpeg_rgb_tiles": (lambda f: tiff_bytes(f, "jpeg", tile=(256, 256)), None, True),
    "tiff_ycbcr_22_lzw": (lambda f: tiff_bytes(f, "lzw", photometric="ycbcr"), None, True),
    "tiff_cmyk_deflate": (lambda f: tiff_bytes(f, "deflate", photometric="cmyk"), lambda f: f, True),
    "bigtiff_lzw_predictor": (lambda f: tiff_bytes(f, "lzw", predictor=True, bigtiff=True), lambda f: f, True),
    "sun_24": (sun_bytes, lambda f: f, False),
    "hdr_rle": (hdr_bytes, hdr_expected, True),
}


PALETTE_CASES = {  # name → the writer of (the file, what cv2 reads from it) for a 720p frame
    "gif_332": gif_frame,
    "gif_interlaced_transparent_window": gif_window,
    "webp_transforms": lambda f: (vp8l_bytes(f), f),
    "webp_colour_indexing": lambda f: (vp8l_bytes(palette_16(f), "palette"), palette_16(f)),
}
VP8_CASES = {  # name → the writer's arguments for a 720p frame (what cv2 reads from it is not known on the card)
    "webp_lossy_bpred": dict(q=24, bpred=0.9, seed=3),
    "webp_lossy_simple_filter": dict(q=24, filter="simple", level=24, sharpness=2, seed=4),
}
PLAIN_HW = {"gif": (720, 1280), "webp": (180, 320)}  # where the plain twin is compared: its decode stays under 5 s


def phase_raster_decode(png_res, jpeg_res, H=720, W=1280, reps=4, vp8=None):
    """The raster readers (``data/bmp.py``, ``pnm.py``, ``tiff.py``,
    ``sunras.py``, ``hdr.py``, ``gif.py`` and ``webp.py``,
    through ``data/image.py``) on the 720p panning-texture frame written by
    this script's writers in each case of RASTER_CASES and PALETTE_CASES:
    each decode equals what cv2 reads from the file (the frame, or its
    palette or HDR rounding), and where a routine of csrc/raster_decode.cpp
    or csrc/webp_decode.cpp runs (RLE8, LZW, PackBits, HDR scanlines, GIF's
    LZW, VP8L, VP8), and in the TIFF kinds of BigTIFF, JPEG, YCbCr and CMYK
    (JPEG-in-TIFF YCbCr 4:2:0 in 16-row strips and RGB in 256x256 tiles,
    YCbCr 2x2 with LZW, CMYK with Deflate, a BigTIFF of the LZW + predictor
    case; the JPEG and YCbCr ones lossy, their PSNR recorded), the plain
    decode equals the compiled one: on the 720p
    file, or for WebP, whose plain decode takes longer than 5 s there, on
    the same case written from the frame's top-left 180x320 (``plain_hw``).
    The lossy WebP cases of VP8_CASES (a B_PRED-heavy frame, a frame with the
    simple filter) have no pixels known to equal: their bytes and PSNR
    against the frame are recorded. Then a
    q95 progressive 4:2:0 JPEG cut after its third scan (block smoothing):
    the compiled decode equals the plain one. Times: a whole decode (median
    of ``reps``, the file in the page cache) and its ratio to phase 15's PNG
    Sub decode of the same frame kind, the plain decode (one call). ``vp8``:
    the VP8Files of the lossy cases (made and joined here when None)."""
    from superslomo_tpu_torch.data import bmp, gif, hdr, image, jpeg, tiff, webp

    plains = {"bmp": bmp.decode, "tiff": tiff.decode, "bigtiff": tiff.decode, "hdr": hdr.decode, "gif": gif.decode,
              "webp": webp.decode}
    frame = raster_frame(H, W)
    vp8 = (vp8 or VP8Files(H, W)).join()
    png_ms = png_res["filters"]["sub"]["decode_ms"]
    out = {"phase": "raster_decode_vs_plain", "frame_hw": [H, W], "reps": reps, "cases": {},
           "png_sub_decode_ms": png_ms, "jpeg_baseline_420_decode_ms": jpeg_res["cases"]["420"]["decode_ms"]}
    cases = [(name, lambda f, w=write, e=expected: (w(f), e and e(f)), compiled)
             for name, (write, expected, compiled) in RASTER_CASES.items()]
    cases += [(name, make, True) for name, make in PALETTE_CASES.items()]
    cases += [(name, lambda f, name=name: (vp8.data[name, f.shape[:2]], None), True) for name in VP8_CASES]
    with tempfile.TemporaryDirectory() as d:
        for name, make, compiled in cases:
            t0 = time.perf_counter()
            data, want = make(frame)
            path = os.path.join(d, name)
            with open(path, "wb") as f:
                f.write(data)
            write_s = time.perf_counter() - t0
            got = image.imread(path)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                image.imread(path)
                times.append((time.perf_counter() - t0) * 1e3)
            rec = {"file_mib": len(data) / 2**20, "file_bytes": len(data), "write_s": write_s,
                   "decode_ms": statistics.median(times), "decode_ms_each": times,
                   "ratio_to_png": statistics.median(times) / png_ms,
                   "equals_written": None if want is None else bool(np.array_equal(got, want))}
            if want is None:
                rec["psnr_db"] = float(10 * np.log10(255**2 / np.mean((got.astype(np.float64) - frame) ** 2)))
            if compiled:
                kind = name.split("_")[0]
                ph, pw = (min(a, b) for a, b in zip(PLAIN_HW.get(kind, (H, W)), (H, W)))
                if (ph, pw) != (H, W):
                    data, _ = make(frame[:ph, :pw])
                    got = image.decode(data, path)
                t0 = time.perf_counter()
                plain = plains[kind](data, path, plain=True)
                rec.update(plain_ms=(time.perf_counter() - t0) * 1e3, plain_hw=[ph, pw],
                           compiled_equals_plain=bool(np.array_equal(plain, got)))
            out["cases"][name] = rec
        data = jpeg_bytes(frame, quality=95, scans="progressive")
        cut = data[: jpeg.read_header(data).scans[2].end] + b"\xff\xd9"
        rec = {}
        for tag, blob in (("whole", data), ("cut_after_3_scans", cut)):
            path = os.path.join(d, f"{tag}.jpg")
            with open(path, "wb") as f:
                f.write(blob)
            image.imread(path)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = image.imread(path)
                times.append((time.perf_counter() - t0) * 1e3)
            rec[f"{tag}_decode_ms"] = statistics.median(times)
        t0 = time.perf_counter()
        plain = jpeg.decode_plain(cut, jpeg.read_header(cut))
        rec.update(plain_ms=(time.perf_counter() - t0) * 1e3, compiled_equals_plain=bool(np.array_equal(plain, got)),
                   scans=len(jpeg.read_header(data).scans),
                   psnr_db=float(10 * np.log10(255**2 / np.mean((got.astype(np.float64) - frame) ** 2))))
        out["progressive_cut_after_3_scans"] = rec
    emit(out)
    bad = {k: v for k, v in out["cases"].items()
           if v["equals_written"] is False or not v.get("compiled_equals_plain", True)}
    if bad or not rec["compiled_equals_plain"]:
        raise AssertionError(f"a raster decode differs from what cv2 reads or from its plain version: {bad} {rec}")
    return out


LOADER_FORMATS = {"bmp": bmp_bytes, "ppm": lambda f: pnm_bytes(f, "ppm"),
                  "tif": lambda f: tiff_bytes(f, "lzw_literal", predictor=True), "webp": vp8l_bytes,
                  "tif_jpeg": lambda f: tiff_bytes(f, "jpeg", photometric="ycbcr"),
                  "tif_ycbcr": lambda f: tiff_bytes(f, "lzw", photometric="ycbcr")}
LOADER_KINDS = (*LOADER_FORMATS, "vp8")  # in turn along the clip; "vp8": the frame of ``write_vp8_clip``
LOSSY_KINDS = ("vp8", "tif_jpeg", "tif_ycbcr")  # what cv2 reads from these is not known on the card
DECODERS = {"png": ("png", "imread"), "jpg": ("jpeg", "imread"), "bmp": ("bmp", "decode"), "ppm": ("pnm", "decode"),
            "tif": ("tiff", "decode"), "gif": ("gif", "decode"), "webp": ("webp", "decode"),
            "vp8": ("webp", "_vp8_rgb"), "tif_jpeg": ("tiff", "_jpeg_chunk"),
            "tif_ycbcr": ("tiff", "_units_chunk")}  # kind → the reader's call (a lossy WebP is both "webp" and "vp8",
# a JPEG-in-TIFF both "tif" and "tif_jpeg", a subsampled YCbCr TIFF both "tif" and "tif_ycbcr")


def clip_kinds(kinds, n):
    """Each frame's kind along an n-frame clip: "vp8" at every 5th frame
    (where ``VP8_CLIP`` writes its lossy frames), the other ``kinds`` in turn
    between."""
    others = [k for k in kinds if k != "vp8"]
    out = []
    for i in range(n):
        out.append("vp8" if i % 5 == 4 and "vp8" in kinds else others[(len(out) - out.count("vp8")) % len(others)])
    return out


def frame_kind(path):
    """The extension of ``path``; "vp8" for a simple WebP file whose
    bitstream is lossy; "tif_jpeg" for a JPEG-compressed TIFF, "tif_ycbcr"
    for a subsampled YCbCr one."""
    ext = os.path.splitext(path)[1][1:]
    if ext == "webp":
        with open(path, "rb") as f:
            if f.read(16)[12:16] == b"VP8 ":
                return "vp8"
    if ext == "tif":
        from superslomo_tpu_torch.data import tiff

        with open(path, "rb") as f:
            tags = tiff.read_tags(f.read())[1]
        if tags.get(259, (1,))[0] == 7:
            return "tif_jpeg"
        if tags.get(262, (0,))[0] == 6 and tuple(tags.get(530, (2, 2))) != (1, 1):
            return "tif_ycbcr"
    return ext


def _tagged_decode(decode, tag, ext, *args):
    tag(ext)
    return decode(*args)


@contextlib.contextmanager
def counted_decodes(exts):
    """Counts each format's decodes (``DECODERS``: the call ``data/image.py``
    makes) while the block runs; yields a dict ext → count, filled at the
    end (appends from the Loader's threads are atomic)."""
    import importlib

    decoded, counts = [], {}
    patched = []
    for ext in exts:
        module = importlib.import_module(f"superslomo_tpu_torch.data.{DECODERS[ext][0]}")
        inner = getattr(module, DECODERS[ext][1])
        setattr(module, DECODERS[ext][1], functools.partial(_tagged_decode, inner, decoded.append, ext))
        patched.append((module, DECODERS[ext][1], inner))
    try:
        yield counts
    finally:
        for module, attr, inner in patched:
            setattr(module, attr, inner)
        counts.update({ext: decoded.count(ext) for ext in exts})


def write_frames(paths, frames, writers):
    """Each frame written to its path by its writer (bytes of the frame), in
    8 threads: numpy releases the interpreter lock in the writers' array
    work."""
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        path, img, write = job
        with open(path, "wb") as f:
            f.write(write(img))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, zip(paths, frames, writers)))


def phase_raster_loader(root, sections, vp8, H=720, W=1280, n_batches=2):
    """The Loader alone (configs/superslomo_original.ini's ADOBE train list,
    12 threads, B=32, 224x224 crops) over an ADOBE list naming the 57-frame
    720p clip of ``write_dataset`` (the same seed) written again with its
    frames in turn as 24-bit BMP, binary PPM, LZW TIFF (predictor 2; 9-bit
    literal codes, ``lzw_literal``), lossless WebP (``vp8l_bytes``'
    transforms case), JPEG-in-TIFF (YCbCr 4:2:0 in 16-row strips), YCbCr
    2x2 TIFF with LZW and lossy WebP (the frames ``vp8``, {index: path}, of
    ``write_vp8_clip``): the first ``n_batches`` batches equal, bit for bit,
    those of the list over the PNG frames (PNG copies of the port's decode in
    place of the lossy ones, ``LOSSY_KINDS``), and each format's decoder ran;
    ms a batch of each list (each format's decode ms is
    ``raster_decode_vs_plain``'s)."""
    from superslomo_tpu_torch import load_config
    from superslomo_tpu_torch.data import image

    frames = panning_clips(np.random.default_rng(31), 1, H, W, n=57)[0]
    with open(sections["ADOBE_DATA"]["TRAINPATHS"]) as f:
        text = png_text = f.read()
    png_dir = os.path.join(root, "adobe", "clip_000")
    clip_dir = os.path.join(root, "adobe_raster", "clip_000")
    os.makedirs(clip_dir)
    t0 = time.perf_counter()
    kind = clip_kinds(LOADER_KINDS, len(frames))
    paths = [vp8[i] if kind[i] == "vp8" else os.path.join(clip_dir, f"frame_{i:05d}.{kind[i].split('_')[0]}")
             for i in range(len(frames))]
    own = [i for i in range(len(frames)) if kind[i] != "vp8"]
    write_frames([paths[i] for i in own], [frames[i] for i in own], [LOADER_FORMATS[kind[i]] for i in own])
    for i, path in enumerate(paths):
        original = os.path.join(png_dir, f"frame_{i:05d}.png")
        text = text.replace(original, path)
        if kind[i] in LOSSY_KINDS:
            copy = os.path.join(clip_dir, f"frame_{i:05d}_decoded.png")
            write_png(copy, image.imread(path))
            png_text = png_text.replace(original, copy)
    lists = {name: os.path.join(root, f"adobe_{name}_train.txt") for name in ("png", "raster")}
    for name, body in (("png", png_text), ("raster", text)):
        with open(lists[name], "w") as f:
            f.write(body)  # the PNG list's entries, each frame in its format (or as the PNG of its decode)
    res = {"phase": "raster_loader_vs_png", "batches": n_batches, "frames_by_format": {
        ext: kind.count(ext) for ext in LOADER_KINDS},
        "write_s": time.perf_counter() - t0, "lists": {}}
    ref = None
    for name, path in lists.items():
        ini = write_config(os.path.join(root, f"loader_{name}.ini"), "superslomo_original.ini", sections,
                           {"DATA": {"DATASET": "ADOBE"}, "ADOBE_DATA": {"TRAINPATHS": path}})
        cfg = load_config(ini)
        with counted_decodes(LOADER_KINDS) as decodes:
            timing, batches = loader_ms(cfg, "TRAIN", n_batches)
        if ref is None:
            ref = batches
        same = len(batches) == len(ref) and all(
            all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(x, y)) for x, y in zip(batches, ref))
        res["lists"][name] = {**timing, "equals_png": same, "threads": cfg.getint("DATALOADER", "N_WORKERS"),
                              "batch": cfg.getint("TRAIN", "BATCH_SIZE"), "decodes": decodes}
    emit(res)
    if not (res["lists"]["raster"]["equals_png"] and all(res["lists"]["raster"]["decodes"].values())):
        raise AssertionError(f"the Loader's batches over BMP / PPM / TIFF / WebP / JPEG-in-TIFF / YCbCr TIFF / lossy "
                             f"WebP frames differ from the PNG list's: {res}")
    return res


def write_dataset(root, H=720, W=1280, vimeo_hw=(256, 448), adobe_entries=280, nfs_entries=280, vimeo_seqs=8,
                  vimeo_repeats=10, val_repeats=2, val_frames=57):
    """A made-up dataset in the layouts the readers read: one 57-frame clip
    of panning-texture PNGs at H x W (Sub rows, zlib level 1, as cv2.imwrite
    writes them); the ADOBE and NFS train lists naming that clip's frames
    ``adobe_entries`` / ``nfs_entries`` times; ``vimeo_seqs`` Vimeo
    septuplets at ``vimeo_hw``, listed ``vimeo_repeats`` times; and a
    VAL_CLIPS pickle naming ``val_repeats`` times the clip or, with fewer
    ``val_frames``, a clip of hard links to its first frames ((val_frames -
    1) / 8 sliding windows each: 7 for the whole clip). Returns the config
    sections that point at it."""
    rng = np.random.default_rng(31)
    clip_dir = os.path.join(root, "adobe", "clip_000")
    os.makedirs(clip_dir)
    frames = panning_clips(rng, 1, H, W, n=57)[0]
    paths = [os.path.join(clip_dir, f"frame_{i:05d}.png") for i in range(len(frames))]
    write_frames(paths, frames, [write_png_bytes] * len(frames))
    listing = f"{len(paths)}\n" + "".join(p + "\n" for p in paths)
    for name, entries in (("adobe_train.txt", adobe_entries), ("nfs_train.txt", nfs_entries)):
        with open(os.path.join(root, name), "w") as f:
            f.write(listing * entries)
    seqs = [f"{i:05d}/0001" for i in range(vimeo_seqs)]
    jobs = []
    for seq in seqs:
        d = os.path.join(root, "vimeo", "sequences", seq)
        os.makedirs(d)
        jobs += [(os.path.join(d, f"im{i}.png"), img)
                 for i, img in enumerate(panning_clips(rng, 1, *vimeo_hw, n=7)[0], start=1)]
    write_frames([p for p, _ in jobs], [img for _, img in jobs], [write_png_bytes] * len(jobs))
    with open(os.path.join(root, "vimeo", "list.txt"), "w") as f:
        f.write("\n".join(seqs * vimeo_repeats) + "\n")
    val_clip = "clip_000"
    if val_frames < len(paths):
        val_clip = "val_000"
        os.makedirs(os.path.join(root, "adobe", val_clip))
        for path in paths[:val_frames]:
            os.link(path, os.path.join(root, "adobe", val_clip, os.path.basename(path)))
    with open(os.path.join(root, "val_clips.pkl"), "wb") as f:
        pickle.dump([val_clip] * val_repeats, f)
    return {
        "ADOBE_DATA": {"ROOTDIR": os.path.join(root, "adobe"), "VAL_CLIPS": os.path.join(root, "val_clips.pkl"),
                       "TRAINPATHS": os.path.join(root, "adobe_train.txt"), "H_IN": H, "W_IN": W},
        "NFS_DATA": {"TRAINPATHS": os.path.join(root, "nfs_train.txt")},
        "VIMEO_DATA": {"ROOTDIR": os.path.join(root, "vimeo"), "TRAINPATHS": os.path.join(root, "vimeo", "list.txt")},
    }


MIXED_FORMATS = {"jpg": lambda f: jpeg_bytes(f, quality=95), "gif": lambda f: gif_frame(f)[0], "webp": vp8l_bytes,
                 "png": write_png_bytes, "vp8": None, "tif_jpeg": LOADER_FORMATS["tif_jpeg"],
                 "tif_ycbcr": LOADER_FORMATS["tif_ycbcr"]}  # kind → its writer; None: the frame of ``write_vp8_clip``


def write_mixed_train_lists(root, sections, vp8, H=720, W=1280, entries=280):
    """The 57-frame 720p clip of ``write_dataset`` (the same seed) written
    again with its frames in turn as q95 4:2:0 JPEG, GIF (``gif_frame``: the
    3-3-2 palette), lossless WebP (``vp8l_bytes``' transforms case), PNG,
    lossy WebP (the frames ``vp8``, {index: path}, of ``write_vp8_clip``),
    JPEG-in-TIFF (YCbCr 4:2:0 in 16-row strips) and YCbCr 2x2 TIFF with LZW,
    and
    ADOBE and NFS train lists, written by ``utils.make_clips``, naming the
    clip ``entries`` times each; returns ``sections`` with those lists
    (Vimeo's septuplets stay PNG, as the readers name them)."""
    from superslomo_tpu_torch.utils import make_clips

    clip_dir = os.path.join(root, "adobe_mixed", "clip_000")
    os.makedirs(clip_dir)
    frames = panning_clips(np.random.default_rng(31), 1, H, W, n=57)[0]
    kind = clip_kinds(MIXED_FORMATS, len(frames))
    paths = [vp8[i] if kind[i] == "vp8" else os.path.join(clip_dir, f"frame_{i:05d}.{kind[i].split('_')[0]}")
             for i in range(len(frames))]
    own = [i for i in range(len(frames)) if kind[i] != "vp8"]
    write_frames([paths[i] for i in own], [frames[i] for i in own], [MIXED_FORMATS[kind[i]] for i in own])
    lists = {}
    for name in ("ADOBE_DATA", "NFS_DATA"):
        lists[name] = os.path.join(root, f"{name.lower()}_mixed_train.txt")
        make_clips.write_clip_list([paths] * entries, lists[name])
    return {**sections, **{name: {**sections[name], "TRAINPATHS": path} for name, path in lists.items()}}


def write_small_eval_dataset(root, H=48, W=96, n=17):
    """One ``n``-frame clip at H x W (padded to 64x96 by the ADOBE eval
    transform: 2 sliding windows) and its VAL_CLIPS pickle; returns the
    config sections."""
    write_clip(os.path.join(root, "small", "clip_000"), panning_clips(np.random.default_rng(32), 1, H, W, n=n)[0])
    with open(os.path.join(root, "small", "val_clips.pkl"), "wb") as f:
        pickle.dump(["clip_000"], f)
    return {"ADOBE_DATA": {"ROOTDIR": os.path.join(root, "small"), "H_IN": H, "W_IN": W,
                           "VAL_CLIPS": os.path.join(root, "small", "val_clips.pkl")}}


def data_phases(norm, scale=False, vp8_files=None):
    """Phases 15-17 over a made-up dataset in a temporary directory: the PNG
    unfilter, the JPEG decode, the raster, GIF and WebP (lossless and lossy)
    decodes and the Loader over a clip list of BMP, PPM, TIFF (LZW,
    JPEG-in-TIFF, YCbCr) and WebP frames, the eval CLI over PNG frames and
    (``eval_cli["vp8"]``) over lossy WebP frames against their PNG copies,
    the train CLI in f32 and bf16, and in f32 over clip lists naming JPEG,
    GIF, lossless WebP, PNG, lossy WebP, JPEG-in-TIFF and YCbCr TIFF frames
    in turn; with ``scale``, then phase 23 over the same datasets
    (else None). ``vp8_files``: the VP8Files, started earlier or here."""
    vp8_files = (vp8_files or VP8Files()).join()
    png = phase_png_unfilter()
    jpeg = phase_jpeg_decode(png)
    phase_raster_decode(png, jpeg, vp8=vp8_files)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sections = write_dataset(root, val_repeats=1, val_frames=17)
        small = write_small_eval_dataset(root)
        vp8 = write_vp8_clip(root, vp8_files)
        emit({"phase": "dataset_written", "seconds": time.perf_counter() - t0})
        phase_raster_loader(root, sections, vp8)
        # the eval CLI over PNG copies of the lossy clip's decode (2 windows: one batch), then over the lossy clip
        eval_cli = phase_eval_cli(root, val_clip(root, sections, vp8, "png"), small, n_windows=2)
        eval_cli["vp8"] = phase_eval_cli_vp8(root, sections, vp8, eval_cli["cli"])
        train_clis = [phase_train_cli(root, sections, norm, dtype) for dtype in ("float32", "bfloat16")]
        t0 = time.perf_counter()
        mixed_sections = write_mixed_train_lists(root, sections, vp8)
        emit({"phase": "mixed_dataset_written", "seconds": time.perf_counter() - t0})
        train_clis.append(phase_train_cli(root, mixed_sections, norm, "float32", steps=4, warmup=2, synthetic_steps=0,
                                          loader_batches=2))
        scaled = scale_phase(root, sections, norm) if scale else None
    return png, jpeg, eval_cli, train_clis, scaled


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
    made-up dataset (``n_windows`` sliding windows: 2, one batch; the
    host's scoring takes 0.6-0.9 s an image, so more windows cost minutes).
    The model's fused step takes each batch as slices of ``step_samples``
    samples (2 at 720p: the shapes of phase 5). Its metrics equal Evaluator.run on the same batches given explicitly
    (read by the Loader alone, timed); 4 multi-flow launches a slice
    (``_multi_t_planar`` call), counted; the wall time of the CLI's Evaluator.run
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
    with _Recorder(Evaluator, "run") as run, _Recorder(SuperSloMo, "_multi_t_planar") as steps:
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


def val_clip(root, sections, vp8, kind, n_frames=EVAL_VP8_FRAMES):
    """``sections`` with VAL_CLIPS naming one ADOBE clip of the first
    ``n_frames`` frames of ``vp8`` ({index: path}, ``write_vp8_clip``): as
    lossy WebP (``kind`` "vp8") or as PNG copies of the port's decode of
    them ("png"). The files are named .png either way: the ADOBE eval reader
    globs *.png in both packages, and the frame reader picks its decoder by
    the file's bytes."""
    from superslomo_tpu_torch.data import image

    clip = f"val_{kind}"
    os.makedirs(os.path.join(sections["ADOBE_DATA"]["ROOTDIR"], clip))
    for i in range(n_frames):
        path = os.path.join(sections["ADOBE_DATA"]["ROOTDIR"], clip, f"frame_{i:05d}.png")
        if kind == "vp8":
            os.link(vp8[i], path)
        else:
            write_png(path, image.imread(vp8[i]))
    clips = os.path.join(root, f"val_clips_{kind}.pkl")
    with open(clips, "wb") as f:
        pickle.dump([clip], f)
    return {**sections, "ADOBE_DATA": {**sections["ADOBE_DATA"], "VAL_CLIPS": clips}}


def phase_eval_cli_vp8(root, sections, vp8, png_metrics, n_frames=EVAL_VP8_FRAMES):
    """This slice's main path: the eval CLI at configs/superslomo_eval.ini as
    shipped (ADOBE, 720p padded to 736, B=8, 12 loader threads, f32, seeded
    weights, on the card) over a clip of the first ``n_frames`` frames as
    lossy WebP (``val_clip``); PSNR, SSIM and IE equal ``png_metrics``, the
    eval CLI's over the PNG copies of their decode (``phase_eval_cli``). The
    multi-flow kernel's launches counted from 0 just before it, 4 a fused
    step (``_multi_t_planar`` call), none of its backward; the VP8
    decoder's calls counted, above 0."""
    from superslomo_tpu_torch import SuperSloMo, ops
    from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli
    from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_planar_cuda as counter

    ini = write_config(os.path.join(root, "eval_vp8.ini"), "superslomo_eval.ini",
                       val_clip(root, sections, vp8, "vp8", n_frames))
    counter.launches = ops._WarpMultiflow.launches = 0
    t0 = time.perf_counter()
    with _Recorder(SuperSloMo, "_multi_t_planar") as steps, counted_decodes(["vp8"]) as decodes:
        metrics = eval_cli.main(["-c", ini, "--expt", "chip_smoke_vp8", "--log", os.path.join(root, "eval_vp8.log")])
    lossy = {"cli_wall_s": time.perf_counter() - t0, "metrics": metrics, "fused_steps": len(steps.calls),
             "warp_launches": counter.launches, "decodes": decodes,
             "warp_multiflow_backward_launches": ops._WarpMultiflow.launches}
    res = {"phase": "eval_cli_vp8_vs_png_copy", "config": "configs/superslomo_eval.ini", "frames": n_frames,
           "frame_bytes": [os.path.getsize(vp8[i]) for i in range(n_frames)], "vp8": lossy,
           "png_copy_metrics": png_metrics, "metrics_equal": metrics == png_metrics,
           "warp_launches": lossy["warp_launches"],
           "warp_launches_per_step": lossy["warp_launches"] / max(lossy["fused_steps"], 1)}
    emit(res)
    if not res["metrics_equal"]:
        raise AssertionError(f"the eval CLI over lossy WebP frames scores apart from over their PNG copies: {res}")
    if lossy["fused_steps"] < 1 or lossy["warp_launches"] != 4 * lossy["fused_steps"] or \
            lossy["warp_multiflow_backward_launches"]:
        raise AssertionError(f"{lossy['warp_launches']} multi-flow launches "
                             f"({lossy['warp_multiflow_backward_launches']} of its backward) over "
                             f"{lossy['fused_steps']} fused steps, expected 4 a step (none)")
    if not (decodes["vp8"] and all(np.isfinite([metrics["PSNR"], metrics["SSIM"], metrics["IE"]]))):
        raise AssertionError(f"eval CLI over lossy WebP: {res}")
    return res


def list_frame_kinds(sections):
    """The kinds (``frame_kind``), sorted and joined by "+", of the frames
    that the first clip of the ADOBE train list of ``sections`` names: "png",
    or "jpg", "gif+jpg+vp8+webp", ... (each a kind whose decoder ``DECODERS``
    names; a lossy WebP is decoded by both "webp" and "vp8", a JPEG-in-TIFF
    or subsampled YCbCr TIFF by "tif" and its own kind)."""
    with open(sections["ADOBE_DATA"]["TRAINPATHS"]) as f:
        n = int(f.readline())
        paths = [f.readline().strip() for _ in range(n)]
    kinds = {frame_kind(p) for p in paths}
    kinds |= {"webp"} if "vp8" in kinds else set()
    return "+".join(sorted(kinds | ({"tif"} if kinds & {"tif_jpeg", "tif_ycbcr"} else set())))


def phase_train_cli(root, sections, norm, dtype, steps=5, warmup=2, synthetic_steps=2, loader_batches=3,
                    **overrides):
    """The train CLI (``python -m superslomo_tpu_torch.cli.train``, on the
    card by default) at configs/superslomo_original.ini as shipped (ALL:
    ADOBE + NFS + Vimeo, B=32, 224x224 crops, 12 loader threads, random VGG
    features) in ``dtype`` for ``steps`` steps over the made-up dataset (an
    epoch of 20 batches: the Loader decodes through every step), each step
    synchronised: its step ms and the wait for the feed before each step;
    then ``synthetic_steps`` steps of the same Trainer on synthetic
    in-memory batches (the step with its pageable H2D copy, no Loader
    running), and the Loader alone over ``loader_batches``. The single-flow
    kernels' launches a step counted, and each frame format's decodes in
    the CLI's run (``counted_decodes``): every format that the clip lists
    name must be decoded. The record names those formats
    (``list_frame_kinds``)."""
    from superslomo_tpu_torch import Trainer, load_config
    from superslomo_tpu_torch.cli import train as train_cli

    frames = list_frame_kinds(sections)
    tag = dtype if frames == "png" else f"{dtype}_{frames.replace('+', '_')}"
    ini = write_config(os.path.join(root, f"train_{tag}.ini"), "superslomo_original.ini", sections, {
        "TRAIN": {"ALLOW_RANDOM_VGG": "TRUE", "CKPT_DIR": os.path.join(root, "ckpt")},
        "PROJECT": {"LOGDIR": os.path.join(root, "logs")}, "TPU": {"COMPUTE_DTYPE": dtype}}, overrides)
    cfg = load_config(ini)
    B = cfg.getint("TRAIN", "BATCH_SIZE")
    loader, _ = loader_ms(cfg, "TRAIN", n_batches=loader_batches)

    def synced(loss):
        torch.cuda.synchronize()
        return loss

    reset_single_counts()
    t_start = time.perf_counter()
    with _Recorder(Trainer, "train_step", after=synced) as rec, counted_decodes(frames.split("+")) as decodes:
        trainer = train_cli.main(["-c", ini, "--expt", f"chip_smoke_{tag}", "--log", os.path.join(root, "train.log"),
                                  "--max-steps", str(steps)])
    cli_wall = time.perf_counter() - t_start
    launches = single_counts()
    calls = rec.calls
    step_ms = [(t1 - t0) * 1e3 for t0, t1, _, _ in calls]
    wait_ms = [(calls[0][0] - t_start) * 1e3] + [(calls[k][0] - calls[k - 1][1]) * 1e3 for k in range(1, len(calls))]
    on_card = all(isinstance(x, torch.Tensor) and x.is_cuda for _, _, args, _ in calls for x in args[1:])
    losses = np.stack([r.cpu().numpy() for *_, r in calls])
    checkpoint = trainer.checkpoint_path(trainer.epoch)

    synthetic = []
    if synthetic_steps:
        batch = synthetic_train_batches(norm, n_batches=1, B=B, H=cfg.getint("TRAIN", "CROP_IMH"),
                                        W=cfg.getint("TRAIN", "CROP_IMW"), seed=41)[0]
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
        "frames": frames, "tag": tag, "batch": B,
        "crop_hw": [cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")],
        "loader_threads": cfg.getint("DATALOADER", "N_WORKERS"), "steps": len(calls), "cli_wall_s": cli_wall,
        "cli_ms_per_step": per_step, "step_ms_median": statistics.median(step_ms[steady]),
        "feed_wait_ms_median": statistics.median(wait_ms[steady]), "step_ms": step_ms, "feed_wait_ms": wait_ms,
        "synthetic_step_ms_median": statistics.median(synthetic) if synthetic else None,
        "synthetic_step_ms": synthetic,
        "train_loader": loader, "batches_on_card": on_card, "loss_first": losses[0].tolist(),
        "loss_last": losses[-1].tolist(), "checkpoint_saved": os.path.exists(checkpoint),
        "launches": launches, "launches_per_step": {k: v / len(calls) for k, v in launches.items()},
        "decodes": decodes,
    }
    if os.path.exists(checkpoint):
        os.remove(checkpoint)
    emit(res)
    if len(calls) != steps or launches != train_step_launches(steps):
        raise AssertionError(f"train CLI: {len(calls)} steps, single-flow launches {launches}, expected "
                             f"{train_step_launches(steps)}")
    if not (on_card and res["checkpoint_saved"] and np.isfinite(losses).all() and all(decodes.values())):
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


def phase_render_cli(root, frames, tag, base, n_windows, dtype=None, dump=False, clip="clip", ext="png"):
    """The render CLI (``python -m superslomo_tpu_torch.cli.visualize``, on
    the card by default, seeded weights, ``--upsample-rate 8``) at
    ``configs/<base>``'s model (``dtype``: its ``[TPU] COMPUTE_DTYPE``)
    over the first ``n_windows + 1`` frames (``frame_%05d.<ext>``) of the
    720p clip in ``root/<clip>`` (``frames``: their decoded pixels):
    ``n_windows`` windows, 8 frames written a window and the
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
        name = f"frame_{i:05d}.{ext}"
        os.symlink(os.path.join(root, clip, name), os.path.join(clip_dir, name))
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
        "frames": ext, "dump_intermediates": dump, "frame_hw": list(frames.shape[1:3]), "upsample_rate": 8,
        "windows": n_windows,
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


RENDER_JPEG_KINDS = ({}, {"scans": "progressive"}, {"scans": "components"}, {"colour": "cmyk"},
                     {"scans": "progressive", "cut_after": 3})  # a frame each; the last block-smoothed


def phase_render_jpeg(root, frames, n_windows=4):
    """The render CLI over a JPEG clip: the first ``n_windows + 1`` frames
    of the 720p clip written as q95 JPEG files of five kinds in turn
    (baseline 4:2:0, progressive 4:2:0, sequential 4:2:0 in three scans,
    Adobe CMYK, progressive 4:2:0 cut after its third scan, which the reader
    block-smooths; CONV, f32, as phase 18), then over PNG copies of the
    port's decode of those files; every file the two runs write is the same,
    byte for byte (the same pixels in, the same renders out)."""
    from superslomo_tpu_torch.data import jpeg

    os.makedirs(os.path.join(root, "clip_jpg"))
    kinds = [RENDER_JPEG_KINDS[i % len(RENDER_JPEG_KINDS)] for i in range(n_windows + 1)]
    for i, (img, kind) in enumerate(zip(frames[: n_windows + 1], kinds)):
        kind = dict(kind)
        cut = kind.pop("cut_after", None)
        data = jpeg_bytes(img, quality=95, **kind)
        if cut:
            data = data[: jpeg.read_header(data).scans[cut - 1].end] + b"\xff\xd9"
        with open(os.path.join(root, "clip_jpg", f"frame_{i:05d}.jpg"), "wb") as f:
            f.write(data)
    decoded = np.stack([jpeg.imread(os.path.join(root, "clip_jpg", f"frame_{i:05d}.jpg"))
                        for i in range(n_windows + 1)])
    write_clip(os.path.join(root, "clip_jpg_png"), decoded)
    runs = [phase_render_cli(root, decoded, "cli_main_path_jpeg", "superslomo_eval.ini", n_windows, clip="clip_jpg",
                             ext="jpg"),
            phase_render_cli(root, decoded, "cli_main_path_jpeg_png_copy", "superslomo_eval.ini", n_windows,
                             clip="clip_jpg_png")]
    names = sorted(os.listdir(os.path.join(root, "out_cli_main_path_jpeg")))
    differ = []
    for name in names:
        with open(os.path.join(root, "out_cli_main_path_jpeg", name), "rb") as a, \
                open(os.path.join(root, "out_cli_main_path_jpeg_png_copy", name), "rb") as b:
            if a.read() != b.read():
                differ.append(name)
    res = {"phase": "render_jpeg_vs_png_copy", "windows": n_windows, "files": len(names), "files_differing": differ,
           "frame_kinds": [("cut " if "cut_after" in k else "") + k.get("scans", k.get("colour", "baseline"))
                           for k in kinds],
           "decode_ms_jpeg": runs[0]["median_ms_per_window"]["decode_ms"],
           "decode_ms_png_copy": runs[1]["median_ms_per_window"]["decode_ms"]}
    emit(res)
    if differ or len(names) != 8 * n_windows + 1:
        raise AssertionError(f"the renders of the JPEG clip and of its PNG copy differ: {res}")
    return runs


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
    8 windows, CONV bf16 over 4, SSM-R over 3, CONV f32 over 4 windows of
    JPEG frames and of their PNG copy, the intermediates dump over 2) over a
    9-frame 720p panning clip, the flow-EPE CLI, and both CLIs on
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
            *phase_render_jpeg(root, frames),
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
    with _Recorder(SuperSloMo, "_multi_t_planar") as rec:  # a call a fused-step slice
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


def sharded_train_cases(shipped=False):
    """(name, config, global batch, H, W, N_FRAMES, steps, config overrides)
    of phase 14b: in the whole run, configs/superslomo_original.ini at 224²
    and global B=8, f32, 2 steps, and configs/superslomo_recurrent.ini at
    B=2 with [TPU] REMAT, 1 step; with ``shipped`` (``--spatial-ranks``),
    the shipped training config (224², B=32, f32) and a 720p f32 step at
    B=2 (736x1280), 3 steps each."""
    if shipped:
        return [("conv_f32_b32", "superslomo_original.ini", 32, 224, 224, 2, 3, {}),
                ("conv_f32_720p_b2", "superslomo_original.ini", 2, 736, 1280, 2, 3, {})]
    return [("conv_f32_b8", "superslomo_original.ini", 8, 224, 224, 2, 2, {}),
            ("ssmr_remat_b2", "superslomo_recurrent.ini", 2, 224, 224, 4, 1, {"TPU_REMAT": "TRUE"})]


def _case_config(ckpt_dir, config, B, overrides):
    return _train_config(ckpt_dir, _config_path(config), TRAIN_BATCH_SIZE=str(B), **overrides)


def sharded_train_rank(rank, world, port, backend, local_ranks, ckpt_dir, cases):
    """One rank of phase 14b on a (1 x world) grid: for each case a
    ``Trainer(grid=...)`` on cuDNN's heuristics over the case's synthetic
    batches (whole frames: the Trainer takes this rank's rows), with the
    single-flow launches and the halo exchanges set to 0 just before its
    steps: step and backward ms, losses, launches, exchanges, peak GiB, a
    digest of the weights after the steps; rank 0 also returns the first
    step's gradients."""
    import hashlib

    from superslomo_tpu_torch import Trainer, parallel
    from superslomo_tpu_torch.data.augmentations import Normalize
    from superslomo_tpu_torch.parallel import halo

    torchrun_env(rank, world, local_ranks[rank], port)
    device = parallel.init_data_parallel(backend=backend)
    grid = parallel.make_grid(1, world)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(device), "cases": {}}
    for name, config, B, H, W, n_frames, steps, overrides in cases:
        cfg = _case_config(ckpt_dir, config, B, overrides)
        tr = Trainer(cfg, expt_name=f"sharded_{name}_rank{rank}", grid=grid)
        torch.backends.cudnn.benchmark = False
        batches = synthetic_train_batches(Normalize(cfg.pixel_mean(), cfg.pixel_std()), steps, B, H, W, seed=73,
                                          n_frames=n_frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_single_counts()
        halo.reset_counts()
        step_ms, backward_ms, losses, grads = timed_train_steps(tr, batches)
        digest = hashlib.sha256()
        for *_, p in tr.trainable:
            digest.update(p.detach().cpu().contiguous().numpy().tobytes())
        res = {"step_ms": step_ms, "backward_ms": backward_ms, "loss": losses, "launches": single_counts(),
               "halo": dict(halo.counts), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "weights_sha256": digest.hexdigest()}
        if rank == 0:
            res["first_grads"], res["names"] = grads, [f"{stage}.{key}" for stage, key, _ in tr.trainable]
        out["cases"][name] = res
        del tr, grads
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def sharded_train_reference(ckpt_dir, norm, case):
    """One process's Trainer on phase 14b's batches of ``case``, on cuDNN's
    heuristics: step ms, losses, the first step's gradients, peak GiB."""
    from superslomo_tpu_torch import Trainer

    name, config, B, H, W, n_frames, steps, overrides = case
    tr = Trainer(_case_config(ckpt_dir, config, B, overrides), expt_name=f"sharded_reference_{name}")
    torch.backends.cudnn.benchmark = False
    batches = synthetic_train_batches(norm, steps, B, H, W, seed=73, n_frames=n_frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, backward_ms, losses, grads = timed_train_steps(tr, batches)
    ref = {"step_ms": step_ms, "backward_ms": backward_ms, "loss": losses, "first_grads": grads,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.backends.cudnn.benchmark = True
    del tr
    torch.cuda.empty_cache()
    return ref


def phase_sharded_train(ckpt_dir, norm, world=2, cases=None, references=None, shipped=False):
    """Phase 14b: training under a spatial grid, ``world`` ranks on a (1 x
    world) grid (NCCL, a card a rank, where there are enough cards, else all
    on the one card over gloo, the halo rows staged through host memory):
    ``sharded_train_rank`` for each of ``cases`` (``sharded_train_cases``)
    against one process's Trainer on the same batches
    (``sharded_train_reference``, kept in ``references`` across calls).
    Checks: the first step's gradients within GRAD_REL of each tensor's max,
    every step's loss within LOSS_RTOL on every rank, the ranks' weights
    after the steps bit-identical; 8 single-flow forward and 8 flow-gradient
    launches a step a rank, all under a row window, no image gradient, no
    multi-flow backward. With ``shipped`` (``--spatial-ranks``: the cases of
    ``sharded_train_cases(shipped=True)``, 3 steps) the first step's loss and
    the first step's gradient of all parameters together (relative L2, the
    bar of phase 9) are gated, and each tensor's reported: the step's
    gradient is discontinuous (the leaky ReLUs', the max pools' and the
    warps' switches, the L1 kinks), and where a tensor's gradient sums over
    few positions one switch moves it by a visible share of its max; at
    224², B=32, stage 2's second bottleneck conv (7x7 positions a sample)
    lay 1.85e-3 of its max from one process's in two calls on two cards,
    every other tensor within 1e-4. Adam then passes a rounding of a
    gradient near zero on to its weight as lr · rounding / eps, so the later
    steps' losses start from weights that far apart and are reported.
    Reports each rank's step ms and peak GiB beside one process's, the halo
    exchanges forward and backward and the MB sent a step a rank, and the
    gathers a step."""
    from superslomo_tpu_torch.parallel.mesh import row_blocks

    backend, local_ranks = _ranks_layout(world)
    print(f"chip_smoke: phase 14b runs {world} spatial ranks over {backend} on cards {local_ranks}", flush=True)
    cases = cases or sharded_train_cases()
    references = {} if references is None else references
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_train_rank, world, (world, _free_port(), backend, local_ranks, ckpt_dir, cases),
                        timeout=900)
    res = {"phase": "sharded_train", "grid": [1, world], "backend": [r["backend"] for r in ranks],
           "devices": [r["device"] for r in ranks], "cudnn_benchmark": False, "cases": {}}
    bad = []
    for case in cases:
        name, config, B, H, W, n_frames, steps, overrides = case
        if name not in references:
            references[name] = sharded_train_reference(ckpt_dir, norm, case)
        want = references[name]
        got = [r["cases"][name] for r in ranks]
        per_tensor = {n: ((x - w).abs().max() / w.abs().max()).item()
                      for n, x, w in zip(got[0]["names"], got[0]["first_grads"], want["first_grads"])}
        worst = max(per_tensor, key=per_tensor.get)
        grad_rel = per_tensor[worst]
        grad_l2 = (sum(((x - w) ** 2).sum() for x, w in zip(got[0]["first_grads"], want["first_grads"]))
                   / sum((w ** 2).sum() for w in want["first_grads"])).sqrt().item()
        loss_rel = max(float(np.max(np.abs(a - b) / np.abs(b)))
                       for r in got for a, b in list(zip(r["loss"], want["loss"]))[:1 if shipped else steps])
        identical = len({r["weights_sha256"] for r in got}) == 1
        per_step = {k: [r["halo"][k] / steps for r in got] for k in got[0]["halo"]}
        entry = {
            "config": f"configs/{config}", "overrides": overrides, "global_batch": B, "frame_hw": [H, W],
            "n_frames": n_frames, "steps": steps, "blocks": list(row_blocks(H, world)),
            "step_ms_by_rank": [r["step_ms"] for r in got], "backward_ms_by_rank": [r["backward_ms"] for r in got],
            "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in got],
            "single_process_step_ms": want["step_ms"], "single_process_backward_ms": want["backward_ms"],
            "single_process_peak_mem_gib": want["peak_mem_gib"],
            "last_step_ms_ratio_by_rank": [r["step_ms"][-1] / want["step_ms"][-1] for r in got],
            "launches_per_step_by_rank": [{k: v / steps for k, v in r["launches"].items()} for r in got],
            "exchanges_per_step_by_rank": per_step["exchanges"],
            "backward_exchanges_per_step_by_rank": per_step["backward_exchanges"],
            "exchange_mb_sent_per_step_by_rank": [x / 1e6 for x in per_step["bytes_sent"]],
            "backward_exchange_mb_sent_per_step_by_rank": [x / 1e6 for x in per_step["backward_bytes_sent"]],
            "gathers_per_step_by_rank": per_step["gathers"],
            "first_grads_max_rel_diff": grad_rel, "first_grads_worst_tensor": worst,
            "first_grads_tensors_over_grad_rel": {n: e for n, e in per_tensor.items() if e > GRAD_REL},
            "first_grads_rel_l2_diff": grad_l2, "gradient_gate": "all_parameters_l2" if shipped else "per_tensor",
            "loss_max_rel_diff": loss_rel, "loss_gated_steps": 1 if shipped else steps,
            "ranks_bit_identical": identical,
            "loss_rank0": [x.tolist() for x in got[0]["loss"]], "loss_single_process": [x.tolist() for x in want["loss"]],
        }
        res["cases"][name] = entry
        if not (identical and (grad_l2 if shipped else grad_rel) <= GRAD_REL and loss_rel <= LOSS_RTOL):
            bad.append(f"{name}: gradients, losses or ranks")
        if any(r["launches"] != train_step_launches(steps, windowed=True) for r in got):
            bad.append(f"{name}: launches")
        if any(n != 1 for n in per_step["gathers"]):
            bad.append(f"{name}: gathers")
    res["phase_s"] = time.perf_counter() - t0
    emit(res)
    if bad:
        raise AssertionError(f"sharded training at {world} ranks: {bad}")
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
    with _Recorder(SuperSloMo, "_multi_t_planar") as rec:
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
                 eval_cli, train_clis, render_fwd, renders, flow_eval, scaled, kern_rows, sharded, single_rows,
                 sharded_train, win_grads):
    """Every kernel of the paths with its launches on the main paths (the
    SuperSloMo-R ones a step and a window as well, the single-flow kernels'
    a step of each train path in ``trains`` and of each train CLI run in
    ``train_clis``, the multi-flow kernel's a step of the eval CLI (over
    PNG frames, and over lossy WebP ones: ``eval_cli["vp8"]``), both
    forward kernels' a window of each render CLI run in ``renders`` and the
    single-flow kernel's a sample of the flow-EPE CLI, the single-flow
    kernels' a step of each rank of the DDP Trainer and of the Trainer
    resumed from a native checkpoint, the multi-flow kernel's a fused step
    of each rank of the DDP eval CLI: ``scaled``, phases 22-23), error,
    times, bound, plain and library times; and the multi-flow warp's backward, its
    launches counted on every main path (none expected: serving runs without
    autograd, training uses the single-flow warp) and a backward in its own
    phase. The multi-flow kernel's entry also has its launches a B=8 call,
    its SuperSloMo-R launches a step beside the slices of that step (4
    launches a slice: the bf16 B=2 step runs as two slices of 1), its
    launches a step and a
    fused step of the Evaluator on each rank of the sharded serving path
    (``sharded``, phase 5b) and its row-window cases (``kern_rows``). The
    single-flow kernels' entries have their launches by main path
    (``launches_by_main_path``: each train path's, each train CLI run's, each
    DDP rank's, the resumed step's and each rank's of each case of the
    sharded Trainer, ``sharded_train``, phase 14b) and the forward's and the
    flow gradient's row-window cases (``single_rows``). The two gradient
    kernels under a row window (``win_grads``) have entries of their own,
    their launches those of phase 5b's differentiated sharded warps and
    fused step on rank 0 (``sharded``'s gradients, each counted from 0 just
    before it); the image gradient's and the multi-flow
    backward's entries list those cases too. Raises unless every serving and
    train main path launched no image gradient and no multi-flow backward."""
    def train_launches(key):
        paths = {r["phase"]: r["launches"][key] for r in trains}
        paths.update({f"train_cli_main_path_{r['tag']}": r["launches"][key] for r in train_clis})
        paths.update({f"ddp_train_rank{i}": r[key] for i, r in enumerate(scaled["ddp_train"]["launches_by_rank"])})
        paths["native_resumed_train_step"] = scaled["native"]["resumed_step_launches"][key]
        for case, c in sharded_train["cases"].items():
            paths.update({f"sharded_train_{case}_rank{i}": r[key] * c["steps"]
                          for i, r in enumerate(c["launches_per_step_by_rank"])})
        return paths

    def rows_cases(key=None):
        return {f"{case}_{tag}": {k: (r if key is None else r[key])[k] for k in (
            "max_abs_err", "ms", "device_ms", "host_ms", "whole_frame_device_ms", "library_ms", "bound_ms")}
            for (case, tag), r in single_rows.items()}

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
        "launches_per_b8_call": {r["compute_dtype"]: r["b8"]["warp_launches_per_call"] for r in (main_f32, main_bf16)},
        "ssmr_launches_per_step": {f"{r['compute_dtype']}_b{r['batch']}": r["launches"]["warp_multiflow"] / len(
            r["step_ms"]) for r in ssmr_main},
        "ssmr_slices_per_step": {f"{r['compute_dtype']}_b{r['batch']}": r["slices_per_step"] for r in ssmr_main},
        "eval_cli_launches": eval_cli["warp_launches"], "eval_cli_launches_per_step": eval_cli["warp_launches_per_step"],
        "eval_cli_vp8_launches": eval_cli["vp8"]["warp_launches"],
        "eval_cli_vp8_launches_per_step": eval_cli["vp8"]["warp_launches_per_step"],
        "render_cli_launches_per_window": {r["phase"]: r["launches_per_window"]["warp_multiflow"] for r in renders},
        "ddp_eval_cli_launches_per_step_by_rank": scaled["ddp_eval"]["launches_per_step_by_rank"],
        "sharded_launches_per_step_by_rank": {dtype: sharded[dtype]["launches_per_step"]
                                              for dtype in ("float32", "bfloat16")},
        "sharded_eval_launches_per_fused_step_by_rank": sharded["eval"]["launches_per_fused_step_by_rank"],
        "flows": "noise (std 7 px, patches shifted 150 px); the cases below at the same shape",
        "cases": {f"{case}_{tag}": {k: r[k] for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                      "bound_ms", "planes_strides")}
                  for (case, tag), r in kern.items()},
        "row_window_cases": {f"{case}_{tag}": {k: r[k] for k in (
            "max_abs_err", "ms", "device_ms", "host_ms", "plain_ms", "library_ms", "bound_ms", "window")}
            for (case, tag), r in kern_rows.items()},
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
        "launches_per_train_cli_step": {r["tag"]: r["launches_per_step"]["forward"] for r in train_clis},
        "render_cli_launches_per_window": {r["phase"]: r["launches_per_window"]["warp_single"] for r in renders},
        "flow_eval_cli_launches_per_sample": flow_eval["launches_per_sample"]["warp_single"],
        "launches_per_ddp_train_step_by_rank": [r["forward"] for r in scaled["ddp_train"]["launches_per_step_by_rank"]],
        "launches_per_resumed_train_step": scaled["native"]["resumed_step_launches"]["forward"],
        "launches_by_main_path": train_launches("forward"),
        "launches_per_sharded_train_step_by_rank": {
            case: [r["forward"] for r in c["launches_per_step_by_rank"]] for case, c in sharded_train["cases"].items()},
        "row_window_cases": rows_cases(),
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
            "launches_per_train_cli_step": {r["tag"]: r["launches_per_step"][key] for r in train_clis},
            "launches_per_ddp_train_step_by_rank": [r[key] for r in scaled["ddp_train"]["launches_per_step_by_rank"]],
            "launches_per_resumed_train_step": scaled["native"]["resumed_step_launches"][key],
            "launches_by_main_path": train_launches(key),
            "launches_per_sharded_train_step_by_rank": {
                case: [r[key] for r in c["launches_per_step_by_rank"]] for case, c in sharded_train["cases"].items()},
            "cases": {case: {k: c[key].get(k) for k in ("max_abs_err", "ms", "device_ms", "host_ms", "library_ms",
                                                        "bound_ms")}
                      for case, c in grad_cases.items()},
        }
        if key == "img_grad":
            entry["row_window_cases"] = window_grad_cases(win_grads, "img_grad")
        if key == "flow_grad":
            entry["row_window_cases"] = rows_cases("flow_grad")
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
        **{f"train_cli_main_path_{r['tag']}": r["launches"]["multiflow_backward"] for r in train_clis},
        **{r["phase"]: r["launches"]["warp_multiflow_backward"] for r in renders},
        "flow_eval_cli_main_path": flow_eval["launches"]["warp_multiflow_backward"],
        "native_resumed_train_step": scaled["native"]["resumed_step_launches"]["multiflow_backward"],
        **{f"ddp_train_rank{i}": r["multiflow_backward"] for i, r in enumerate(scaled["ddp_train"]["launches_by_rank"])},
        **{f"ddp_eval_cli_rank{i}": n for i, n in enumerate(scaled["ddp_eval"]["multiflow_backward_by_rank"])},
        **{f"sharded_train_{case}_rank{i}": r["multiflow_backward"] * c["steps"]
           for case, c in sharded_train["cases"].items() for i, r in enumerate(c["launches_per_step_by_rank"])},
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
        "row_window_cases": window_grad_cases(win_grads, "mf_grad"),
    }
    main_img_grads = grads[1]["launches_by_main_path"]
    if any(bwd_by_path.values()) or any(main_img_grads.values()):
        raise AssertionError(f"a main path launched the multi-flow backward {bwd_by_path} or the image gradient "
                             f"{main_img_grads}")
    return [mf, fwd, *grads, mf_bwd, *windowed_grad_entries(win_grads, sharded)]


def window_grad_cases(win_grads, kind):
    """The row-window cases of ``phase_windowed_grads``' ``kind`` (img_grad,
    mf_grad) for the kernels line."""
    return {f"{case}_{tag}": {k: r[k] for k in (
        "max_abs_err", "ms", "device_ms", "host_ms", "whole_frame_device_ms", "plain_ms", "library_ms", "bound_ms",
        "planes_rows")} for (case, tag), r in win_grads[kind].items()}


def windowed_grad_entries(win_grads, sharded):
    """The kernels line's entries of the two gradient kernels under a row
    window (see ``kernels_line``)."""
    step = sharded["grads"]["fused_step"]
    windowed = []
    for kind, name, replaces, key in (
            ("img_grad", "warp_single_img_grad_rows", "superslomo_tpu/ops/warp_pallas.py:663", "img_grad_windowed"),
            ("mf_grad", "warp_multiflow_grad_rows", "superslomo_tpu/ops/warp_pallas.py:428",
             "multiflow_backward_windowed")):
        case, tag = next(iter(win_grads[kind]))
        r = win_grads[kind][(case, tag)]
        windowed.append({
            "name": name, "route": "cuda",
            "source": f"superslomo_tpu_torch/csrc/{'warp_single' if kind == 'img_grad' else 'warp_multiflow'}.cu",
            "replaces": replaces, "launches": step["warp_launches_rank0"][key] + step["launches_by_rank"][0][key],
            "launches_by_main_path": {"sharded_warp_gradients_rank0": step["warp_launches_rank0"][key],
                                      "sharded_fused_step_gradient_rank0": step["launches_by_rank"][0][key]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "whole_frame_device_ms": r["whole_frame_device_ms"],
            "shape": r["shape"], "planes_rows": r["planes_rows"], "case": f"{case}_{tag}",
            "cases": window_grad_cases(win_grads, kind),
            "library": "aten.grid_sampler_2d_backward on the same rows"
                       + (", the planes tiled n times" if kind == "mf_grad" else ""),
        })
    return windowed


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
    ap.add_argument("--spatial-ranks", type=int, default=None,
                    help="build, then only phases 5b and 14b at 2 and at this many spatial ranks (one card a rank "
                         "where there are enough), with a 2176x3840 f32 serving step at this many")
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
    if args.spatial_ranks:
        spatial_only(norm, args.spatial_ranks)
        print(smi, flush=True)
        emit({"spatial_ranks": args.spatial_ranks, "device": {"kind": torch.cuda.get_device_name(0),
                                                              "count": torch.cuda.device_count()}})
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
    kern_rows = phase_kernel_rows()
    single = phase_single_kernels()
    single_rows = phase_single_rows()
    ssmr_fwd = phase_ssmr_forward_cases()
    render_fwd = phase_render_forward_cases()
    mf_grad = phase_multiflow_grad()
    win_grads = phase_windowed_grads()
    emit({"phase": "sm_clock", "before_kernel_phases": clock_before, "after_kernel_phases": nvidia_smi(
        "clocks.sm,clocks.max.sm"), "query": "clocks.sm,clocks.max.sm"})
    if args.kernels_only:
        print(smi, flush=True)
        emit({"kernels_only": True, "device": {"kind": torch.cuda.get_device_name(0)}})
        return 0
    phase_slice()
    batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=1, B=2, H=720, W=1280, seed=2)
    main_f32 = phase_main_path("float32", batches)
    main_bf16 = phase_main_path("bfloat16", batches)
    del batches
    sharded = phase_sharded_serving(2, {"float32": main_f32.pop("reference"), "bfloat16": main_bf16.pop("reference")})
    phase_upsample_slices()
    phase_ssmr_slice()
    ssmr_stream = [phase_ssmr_stream(dtype) for dtype in ("bfloat16", "float32")]
    check_forward_layouts(ssmr_fwd["layouts"], [r for s in ssmr_stream for r in s["forward_layouts_first_window"]])
    ssmr_batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=2, B=2, H=720, W=1280, seed=8,
                                     n_frames=4)
    vp8_files = VP8Files()  # the data phases' lossy WebP files, written during the SSM-R step's autotuning
    ssmr_main = phase_ssmr_main_path(ssmr_batches, during_autotune=vp8_files)
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
        sharded_train = phase_sharded_train(ckpt_dir, norm)
    trains = [train, ssmr_train, ssmr_remat, bf16_train]
    check_backward_layouts(single["layouts"], [r for t in trains for r in t["backward_layouts_first_step"]])
    _, _, eval_cli, train_clis, scaled = data_phases(norm, scale=True, vp8_files=vp8_files)
    renders, flow_eval, _ = render_phases(render_fwd)

    kernels = kernels_line(kern, single, ssmr_fwd, main_f32, main_bf16, train, ssmr_stream, ssmr_main, mf_grad,
                           trains, eval_cli, train_clis, render_fwd, renders, flow_eval, {"native": native, **scaled},
                           kern_rows, sharded, single_rows, sharded_train, win_grads)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
