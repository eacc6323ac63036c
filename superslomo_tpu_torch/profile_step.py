"""Where a step's device time goes, on the CUDA card.

    python3 -m superslomo_tpu_torch.profile_step [--dtype bfloat16]
    python3 -m superslomo_tpu_torch.profile_step --train

By default runs the fused 8x step ``SuperSloMo.interpolate_multi_t`` at 720p
(736x1280 after the /32 pad), n_t=7, B=2, with seeded weights. With
``--train`` it runs ``Trainer.train_step`` at configs/superslomo_original.ini
(B=32, 224x224 crops, f32, TF32 off) on seeded weights, random VGG features
and seeded frames. Either way it traces three steps after two warm-up steps
with ``torch.profiler`` and prints one JSON object: the step's wall time, the
device's busy share of the traced window, the device time per step by kernel
category (convolution, warp kernels, layout conversion, concat, resize/pool,
optimizer, other elementwise), the share of convolution time in kernels whose
names say NHWC, the convolutions' FLOPs per step (counted from their shapes,
the backward's from which of each conv's input and weight take a gradient)
and the rate they reach against the card's peak for the compute dtype, the
peak device memory, the heaviest kernels by name, the warp kernels' time and
launches per step by kernel, and the kernel that ran just before each warp
launch of one step.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from superslomo_tpu_torch import SuperSloMo, Trainer, default_config, load_config, weights

# H100 SXM dense peaks, bf16 tensor cores and float32 outside them (TF32 is off)
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}

# first match wins; matched against the lower-cased kernel name
_CATEGORIES = (
    ("warp_kernel", ("warp_multiflow", "warp_single")),
    ("layout_conversion", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "cutlass", "gemm", "sm90_", "wgrad", "fprop")),
    ("concat", ("catarray",)),
    ("resize_pool", ("upsample", "avg_pool", "avgpool", "max_pool", "maxpool")),
    ("elementwise_other", ("",)),
)


# the warp kernels by name (csrc/), for their time per step each (the image
# gradient's scratch fill shows as a memset, outside these)
_WARP_KERNELS = ("warp_multiflow_kernel", "warp_single_forward_kernel", "warp_single_flow_grad_kernel",
                 "warp_single_img_grad_kernel", "warp_single_img_grad_store_kernel")


def _category(name: str) -> str:
    low = name.lower()
    return next(cat for cat, keys in _CATEGORIES if any(k in low for k in keys))


def conv_flops(modules, run) -> int:
    """FLOPs of every convolution in ``modules`` during ``run()`` (2 per
    multiply-add), counted from the output shapes by forward hooks: the
    forward once, and under autograd once more for each of the input and the
    weight that takes a gradient (the backward's data and weight passes)."""
    total = 0

    def count(conv, inputs, out):
        nonlocal total
        kh, kw = conv.kernel_size
        fwd = 2 * out.numel() * kh * kw * conv.in_channels // conv.groups
        passes = 1
        if torch.is_grad_enabled():
            passes += int(inputs[0].requires_grad) + int(conv.weight.requires_grad)
        total += fwd * passes

    hooks = [m.register_forward_hook(count) for mod in modules for m in mod.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total


def _serving_step(dtype):
    """(step, modules, shape facts) of the fused 8x step at 720p, B=2."""
    spec = default_config(TPU_COMPUTE_DTYPE=dtype).model_spec()
    model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((2, 2, 736, 1280, 3), dtype=np.float32)).cuda()
    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    return (lambda: model.interpolate_multi_t(frames, t_values, with_bounds=True)), [model], {
        "step": "interpolate_multi_t", "compute_dtype": dtype, "batch": 2, "n_t": 7, "frame_hw": [736, 1280]}


def _train_step():
    """(step, modules, shape facts) of Trainer.train_step at the shipped
    training config."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "superslomo_original.ini"))
    cfg.set("TRAIN", "ALLOW_RANDOM_VGG", "TRUE")
    B, H, W = cfg.getint("TRAIN", "BATCH_SIZE"), cfg.getint("TRAIN", "CROP_IMH"), cfg.getint("TRAIN", "CROP_IMW")
    tr = Trainer(cfg)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, 2, H, W, 3), dtype=np.float32)
    targets = rng.standard_normal((B, 1, H, W, 3), dtype=np.float32)
    t = rng.uniform(0.125, 0.875, (B, 1)).astype(np.float32)
    return (lambda: tr.train_step(frames, targets, t)), [tr.model, tr.vgg], {
        "step": "train_step", "compute_dtype": "float32", "batch": B, "crop_hw": [H, W]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--train", action="store_true", help="profile Trainer.train_step (float32) instead")
    args = ap.parse_args()
    steps, top_n = 3, 12

    step, modules, facts = _train_step() if args.train else _serving_step(args.dtype)
    dtype = facts["compute_dtype"]
    flops = conv_flops(modules, step)  # also the first warm-up step
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_cat, by_name = defaultdict(float), defaultdict(float)
    warps = defaultdict(lambda: [0.0, 0])  # warp kernel → [us, launches]
    nhwc_conv = 0.0
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] += us
        by_name[e.name] += us
        if cat == "convolution" and "nhwc" in e.name.lower():
            nhwc_conv += us
        if cat == "warp_kernel":
            key = next((k for k in _WARP_KERNELS if k in e.name), e.name[:120])
            warps[key][0] += us
            warps[key][1] += 1
    # the kernel that ran just before each warp launch of the first traced
    # step: shows whether a copy of the warp's inputs precedes it
    ordered = sorted(kernels, key=lambda e: e.time_range.start)
    before_warp = [ordered[i - 1].name[:200] if i else None for i, e in enumerate(ordered)
                   if _category(e.name) == "warp_kernel"]
    busy = sum(by_cat.values())
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    per_step = lambda us: us / steps / 1e3  # noqa: E731
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    conv_s = per_step(by_cat["convolution"]) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), **facts, "steps": steps,
        "step_wall_ms": wall_ms / steps,
        "device_busy_ms_per_step": per_step(busy),
        "device_busy_share_of_kernel_span": busy / span,
        "kernels_per_step": len(kernels) / steps,
        "ms_per_step_by_category": {k: per_step(v) for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "nhwc_share_of_convolution": nhwc_conv / by_cat["convolution"] if by_cat["convolution"] else None,
        "conv_tflop_per_step": flops / 1e12,
        "conv_share_of_peak": flops / conv_s / PEAK_FLOP_S[dtype] if conv_s else None,
        "step_share_of_peak": flops / (per_step(busy) / 1e3) / PEAK_FLOP_S[dtype],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels_ms_per_step": [[name[:120], per_step(us)] for name, us in top],
        "warp_ms_and_launches_per_step": {k: [per_step(us), n / steps] for k, (us, n) in sorted(warps.items())},
        "kernel_before_each_warp": before_warp[: len(before_warp) // steps],
    }))


if __name__ == "__main__":
    main()
