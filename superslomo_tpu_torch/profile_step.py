"""Where the fused 8x step's device time goes, on the CUDA card.

    python3 -m superslomo_tpu_torch.profile_step [--dtype bfloat16]

Runs ``SuperSloMo.interpolate_multi_t`` at 720p (736x1280 after the /32 pad),
n_t=7, B=2, with seeded weights, and traces three steps after two warm-up
steps with ``torch.profiler``. Prints one JSON object: the step's wall time,
the device's busy share of the traced window, the device time per step by
kernel category (convolution, warp kernel, layout conversion, concat,
resize/pool, other elementwise), the share of convolution time in kernels
whose names say NHWC, the convolutions' FLOPs per step (counted from their
shapes) and the rate they reach against the card's peak for the compute dtype,
and the heaviest kernels by name.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from superslomo_tpu_torch import SuperSloMo, default_config, weights

# H100 SXM dense peaks, bf16 tensor cores and float32 outside them (TF32 is off)
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}

# first match wins; matched against the lower-cased kernel name
_CATEGORIES = (
    ("warp_kernel", ("warp_multiflow",)),
    ("layout_conversion", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "cutlass", "gemm", "sm90_", "wgrad", "fprop")),
    ("concat", ("catarray",)),
    ("resize_pool", ("upsample", "avg_pool", "avgpool")),
    ("elementwise_other", ("",)),
)


def _category(name: str) -> str:
    low = name.lower()
    return next(cat for cat, keys in _CATEGORIES if any(k in low for k in keys))


def conv_flops(model: SuperSloMo, frames, t_values) -> int:
    """FLOPs of every convolution in one step (2 per multiply-add), counted
    from the output shapes by forward hooks during one call."""
    total = 0

    def count(conv, _inputs, out):
        nonlocal total
        kh, kw = conv.kernel_size
        total += 2 * out.numel() * kh * kw * conv.in_channels // conv.groups

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        model.interpolate_multi_t(frames, t_values)
    finally:
        for h in hooks:
            h.remove()
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    batch, steps, top_n = 2, 3, 12

    spec = default_config(TPU_COMPUTE_DTYPE=args.dtype).model_spec()
    model = SuperSloMo(spec).load_state(weights.seeded_state(spec, seed=0))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((batch, 2, 736, 1280, 3), dtype=np.float32)).cuda()
    t_values = torch.arange(1, 8, dtype=torch.float32, device="cuda") / 8
    flops = conv_flops(model, frames, t_values)  # also the first warm-up step
    model.interpolate_multi_t(frames, t_values, with_bounds=True)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.interpolate_multi_t(frames, t_values, with_bounds=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_cat, by_name = defaultdict(float), defaultdict(float)
    nhwc_conv = 0.0
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] += us
        by_name[e.name] += us
        if cat == "convolution" and "nhwc" in e.name.lower():
            nhwc_conv += us
    busy = sum(by_cat.values())
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    per_step = lambda us: us / steps / 1e3  # noqa: E731
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    conv_s = per_step(by_cat["convolution"]) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "compute_dtype": args.dtype,
        "batch": batch, "n_t": 7, "frame_hw": [736, 1280], "steps": steps,
        "step_wall_ms": wall_ms / steps,
        "device_busy_ms_per_step": per_step(busy),
        "device_busy_share_of_kernel_span": busy / span,
        "kernels_per_step": len(kernels) / steps,
        "ms_per_step_by_category": {k: per_step(v) for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "nhwc_share_of_convolution": nhwc_conv / by_cat["convolution"] if by_cat["convolution"] else None,
        "conv_tflop_per_step": flops / 1e12,
        "conv_share_of_peak": flops / conv_s / PEAK_FLOP_S[args.dtype] if conv_s else None,
        "step_share_of_peak": flops / (per_step(busy) / 1e3) / PEAK_FLOP_S[args.dtype],
        "top_kernels_ms_per_step": [[name[:120], per_step(us)] for name, us in top],
    }))


if __name__ == "__main__":
    main()
