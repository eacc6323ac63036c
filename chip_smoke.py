#!/usr/bin/env python3
"""Smoke run of the PyTorch port (superslomo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: the card's name and power limit, the CUDA version, and the
     warp kernel's nvcc build (from csrc/ in this checkout, at first use);
  2. kernel against plain: the multi-flow warp kernel against its plain
     PyTorch version at the main path's shapes (736x1280, C=3, n=7, B=2),
     with flows beyond the Pallas kernel's +-128 px band, in f32 and with
     bf16 planes and store, timed beside grid_sample and the memory bound;
  3. slice on the card against the same slice on the CPU: the full-width
     model with seeded weights at 128x224, f32 with TF32 off;
  4. main path: the Evaluator at 720p (padded to 736), 8x, B=2, over three
     synthetic batches, in f32 and bf16, with the step's time, frames/s and
     peak memory, and the warp kernel's launches counted per step.
One JSON object per line; the last line is the run's verdict. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-5
SLICE_ATOL, SLICE_RTOL = 5e-4, 1e-3  # the full-model bar of the JAX package


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=25, warmup=3):
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def warp_bound(B, C, n, H, W, in_bytes, out_bytes):
    """Least time of one multi-flow warp: each input read once and each output
    written once, against 12 f32 operations per (pixel, flow) for the
    position and weights and 7 per channel for the taps."""
    nbytes = B * C * H * W * in_bytes + 2 * B * n * H * W * 4 + B * C * n * H * W * out_bytes
    ops = B * n * H * W * (12 + 7 * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel():
    """The warp kernel against its plain version at the main path's shapes."""
    from superslomo_tpu_torch import ops
    from superslomo_tpu_torch.ops import warp_cuda

    B, C, n, H, W = 2, 3, 7, 736, 1280
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    planes = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32)).to(dev)
    u = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    v = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    u[:, :, 200:400, 300:600] += 150.0  # a patch shifted beyond the Pallas band
    v[:, :, 400:600, 100:400] -= 140.0
    u, v = torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)
    kernel, plain = warp_cuda.warp_multiflow_planar_cuda, ops.warp_multiflow_planar_reference

    # the library yardstick: f32 grid_sample over the image tiled n times (a
    # bf16 grid could not address 1280 columns; for bf16 planes it samples
    # the same bf16 values in f32, as the kernel does)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    grid = torch.stack([2 * (xs + u) / (W - 1) - 1, 2 * (ys + v) / (H - 1) - 1], dim=-1)
    grid = grid.reshape(B * n, H, W, 2)

    def library(p):
        tiled = p.float()[:, None].expand(B, n, C, H, W).reshape(B * n, C, H, W)
        return lambda: F.grid_sample(tiled, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    out = {}
    for tag, pdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p = planes.to(pdt).contiguous()
        got = kernel(p, u, v)
        want = plain(p, u, v, pdt)
        lib = library(p)()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lib_diff = (lib.reshape(B, n, C, H, W).transpose(1, 2) - got.float()).abs().max().item()
        res = {
            "shape": [B, C, n, H, W], "max_abs_err": err,
            "library_max_abs_diff": lib_diff,
            "ms": cuda_ms(lambda: kernel(p, u, v)),
            "plain_ms": cuda_ms(lambda: plain(p, u, v, pdt), reps=20, warmup=1),
            "library_ms": cuda_ms(library(p)),
        }
        res["bound_ms"], res["bound_by"] = warp_bound(B, C, n, H, W, p.element_size(), got.element_size())
        if tag == "f32":
            if err > KERNEL_ATOL:
                raise AssertionError(f"f32 kernel differs from the plain warp by {err}")
        else:
            f32_store = kernel(p.float(), u, v)  # the upcast is exact
            res["bit_identical_to_f32_cast"] = torch.equal(
                got.view(torch.int16), f32_store.bfloat16().view(torch.int16))
            if not res["bit_identical_to_f32_cast"]:
                raise AssertionError("bf16 store is not the f32 result cast")
            if err > 2.0**-7 * want.float().abs().max().item():  # one bf16 ulp
                raise AssertionError(f"bf16 kernel differs from the plain warp by {err}")
        out[tag] = res
        emit({"phase": "kernel_vs_plain", "dtype": tag, **res})
    return out


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


def synthetic_batches(norm, padding, n_batches, B, H, W, seed):
    """Reader-shaped batches: a smooth texture panning 3 px a frame over a
    9-frame clip; ends are the inputs, the 7 inner frames the targets."""
    rng = np.random.default_rng(seed)
    left, right, top, bottom = padding
    pad = ((0, 0), (0, 0), (top, bottom), (left, right), (0, 0))
    yy, xx = np.mgrid[0:H, 0 : W + 32].astype(np.float32)
    out = []
    for _ in range(n_batches):
        clips = []
        for _ in range(B):
            tex = np.zeros((H, W + 32, 3), np.float32)
            for _ in range(6):
                fy, fx = rng.uniform(0.005, 0.05, 2)
                tex += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None] * rng.uniform(10, 40, 3)
            tex = np.clip(tex + 128, 0, 255).astype(np.uint8)
            clips.append(np.stack([tex[:, 3 * i : 3 * i + W] for i in range(9)]))
        x = np.pad(norm(np.stack(clips)), pad)
        out.append((x[:, [0, 8]], x[:, 1:8], np.full(B, 7)))
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


def main() -> int:
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
    from superslomo_tpu_torch.ops import warp_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    warp_cuda.load_library()
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernel_build_s": time.perf_counter() - t0,
        "nvcc_ptxas": [ln for ln in warp_cuda.build_log.splitlines() if "registers" in ln],
    })

    kern = phase_kernel()
    phase_slice()
    cfg = default_config()
    norm = Normalize(cfg.pixel_mean(), cfg.pixel_std())
    batches = synthetic_batches(norm, eval_padding_for(720, 1280), n_batches=3, B=2, H=720, W=1280, seed=2)
    main_f32 = phase_main_path("float32", batches)
    main_bf16 = phase_main_path("bfloat16", batches)

    f32, bf16 = kern["f32"], kern["bf16"]
    entry = {
        "name": "warp_multiflow_planar", "route": "cuda",
        "source": "superslomo_tpu_torch/csrc/warp_multiflow.cu",
        "replaces": "superslomo_tpu/ops/warp_pallas.py:216",
        "launches": main_f32["warp_launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"], "shape": f32["shape"],
        "bf16": {
            "launches": main_bf16["warp_launches"], "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "bit_identical_to_f32_cast": bf16["bit_identical_to_f32_cast"],
        },
    }
    print(smi, flush=True)
    emit({"kernels": [entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
