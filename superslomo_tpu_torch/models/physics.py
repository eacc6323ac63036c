"""The Super SloMo interpolation "physics" (Jiang et al., CVPR 2018):
arbitrary-t flow interpolation, the stage-2 input, the stage-2 head's
visibility and flow residuals, and the occlusion-aware blend.

Two forms. The planar functions (``interpolate_flows``,
``extract_stage2_planes``, ``blend``) serve the fused multi-t step on (H, W)
planes. The head functions serve ``SuperSloMo.forward`` and the losses on the
port's NCHW ``channels_last`` tensors: the frames of a pair and the flows of a
stage head are channel slices, which reach the single-flow warp as strided
views with no copy. ``t`` is a scalar or a (B, 1, 1, 1) per-sample tensor.

Under a spatial grid (``parallel.halo.spatial``) the head functions take
this rank's rows of the pair and the flows, and ``pair_rows``: the whole
height of the pair gathered from the spatial ranks (frames are data) and
the ``RowWindow`` of this rank's rows. Each warp then reads its frame from
the whole height through the window, so its output and its flow gradient are
one process's rows for any flow; the pointwise math and the pair's slices
that enter the stage-2 input stay on this rank's rows.

Channel layout of the 16-channel stage-2 input:
  [ img1(0:3) | g(img1, F̂_t1)(3:6) | F̂_t1(6:8) | F̂_t0(8:10)
    | g(img0, F̂_t0)(10:13) | img0(13:16) ]
and of the 5-channel stage-2 output:
  [ visibility logit V_1t(0) | ΔF_t1(1:3) | ΔF_t0(3:5) ]
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from superslomo_tpu_torch.ops import warp_auto


def interpolate_flows(flow_01, flow_10, t):
    """Arbitrary-t intermediate flow estimates from the bidirectional flow,
    applied to any broadcastable tensors:

    F̂_t0 = -(1-t)·t·F_01 + t²·F_10
    F̂_t1 = (1-t)²·F_01 - t·(1-t)·F_10

    :returns: (est_flow_t0, est_flow_t1).
    """
    est_flow_t0 = -(1.0 - t) * t * flow_01 + (t * t) * flow_10
    est_flow_t1 = (1.0 - t) * (1.0 - t) * flow_01 - t * (1.0 - t) * flow_10
    return est_flow_t0, est_flow_t1


class Stage2Outputs(NamedTuple):
    v_1t: torch.Tensor  # visibility of frame 1 at t, in (0, 1)
    dflow_t1: object  # residual flow t→1: a (u, v) pair of planes, or a (N, 2, H, W) tensor
    dflow_t0: object  # residual flow t→0, likewise
    v_0t: torch.Tensor  # 1 - v_1t


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))  # written as the reference does


def extract_stage2_planes(planes: Sequence[torch.Tensor]) -> Stage2Outputs:
    """Split the 5 planes of the stage-2 head (f32)."""
    v_1t = _sigmoid(planes[0])
    return Stage2Outputs(v_1t, (planes[1], planes[2]), (planes[3], planes[4]), 1.0 - v_1t)


def extract_stage2_outputs(head: torch.Tensor) -> Stage2Outputs:
    """Split the (N, 5, H, W) f32 stage-2 head: v_1t, v_0t (N, 1, H, W) and
    the residual flows (N, 2, H, W)."""
    v_1t = _sigmoid(head[:, 0:1])
    return Stage2Outputs(v_1t, head[:, 1:3], head[:, 3:5], 1.0 - v_1t)


def blend(warped_0, warped_1, v_0t, v_1t, t):
    """Î_t = ((1-t)·V_0t·g(I_0, F_t0) + t·V_1t·g(I_1, F_t1)) / ((1-t)·V_0t + t·V_1t).

    No epsilon in the denominator: the sigmoid keeps it strictly positive,
    and the reference's numerics are kept for parity."""
    weighted = (1.0 - t) * (warped_0 * v_0t) + t * (warped_1 * v_1t)
    return weighted / ((1.0 - t) * v_0t + t * v_1t)


def warp_frame(img_pair, i: int, flow, pair_rows=None, dtype=None):
    """Frame ``i`` of a 6-channel pair warped by ``flow`` (N, 2, H, W), in
    ``dtype`` when given (the frame cast first): from ``img_pair`` itself, or
    under a spatial grid from the whole height in ``pair_rows`` (``(pair,
    RowWindow)``) through the window."""
    src, rows = (img_pair, None) if pair_rows is None else pair_rows
    img = src[:, 3 * i:3 * i + 3]
    if dtype is not None:
        img = img.to(dtype)
    return warp_auto(img, flow) if rows is None else warp_auto(img, flow, rows=rows)


def compute_stage2_inputs(img_pair, flow_pred, t, warp_dtype=None, pair_rows=None):
    """The 16-channel stage-2 input, (N, 16, H, W) channels_last.

    :param img_pair: (N, 6, H, W) = [img0 | img1].
    :param flow_pred: (N, 4, H, W) f32 stage-1 head = [F_01 | F_10].
    :param warp_dtype: a reduced dtype (bf16) for the two warps, whose
        results feed only the stage-2 U-Net; they are upcast back.
    :param pair_rows: under a spatial grid, the whole height of the pair and
        this rank's row window (see the module's docstring).
    """
    est_flow_t0, est_flow_t1 = interpolate_flows(flow_pred[:, 0:2], flow_pred[:, 2:4], t)
    img_0, img_1 = img_pair[:, 0:3], img_pair[:, 3:6]
    if warp_dtype is not None and warp_dtype != img_pair.dtype:
        warped_img_1t = warp_frame(img_pair, 1, est_flow_t1, pair_rows, warp_dtype).to(img_pair.dtype)
        warped_img_0t = warp_frame(img_pair, 0, est_flow_t0, pair_rows, warp_dtype).to(img_pair.dtype)
    else:
        warped_img_1t = warp_frame(img_pair, 1, est_flow_t1, pair_rows)
        warped_img_0t = warp_frame(img_pair, 0, est_flow_t0, pair_rows)
    x = torch.cat([img_1, warped_img_1t, est_flow_t1, est_flow_t0, warped_img_0t, img_0], dim=1)
    return x.contiguous(memory_format=torch.channels_last)


def compute_output_image_from_flows(img_pair, est_flow_t1, est_flow_t0, stage2_output, t, pair_rows=None):
    """Refine the flows, warp both frames and blend with the visibilities:
    (N, 3, H, W) f32. ``pair_rows`` as for ``compute_stage2_inputs``."""
    outs = extract_stage2_outputs(stage2_output)
    warped_0 = warp_frame(img_pair, 0, est_flow_t0 + outs.dflow_t0, pair_rows)
    warped_1 = warp_frame(img_pair, 1, est_flow_t1 + outs.dflow_t1, pair_rows)
    return blend(warped_0, warped_1, outs.v_0t, outs.v_1t, t)


def compute_output_image(img_pair, stage2_input, stage2_output, t, pair_rows=None):
    """``compute_output_image_from_flows`` with the estimated flows read from
    the 16-channel stage-2 input."""
    return compute_output_image_from_flows(
        img_pair, stage2_input[:, 6:8], stage2_input[:, 8:10], stage2_output, t, pair_rows)


def refined_flows(stage2_input, stage2_output):
    """(F̂_t1 + ΔF_t1, F̂_t0 + ΔF_t0), each (N, 2, H, W)."""
    outs = extract_stage2_outputs(stage2_output)
    return stage2_input[:, 6:8] + outs.dflow_t1, stage2_input[:, 8:10] + outs.dflow_t0
