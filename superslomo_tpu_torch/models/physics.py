"""The Super SloMo interpolation "physics", on planes: arbitrary-t flow
interpolation, the stage-2 head's visibility and flow residuals, and the
occlusion-aware blend (Jiang et al., CVPR 2018).

Channel layout of the 16-channel stage-2 input:
  [ img1(0:3) | g(img1, F̂_t1)(3:6) | F̂_t1(6:8) | F̂_t0(8:10)
    | g(img0, F̂_t0)(10:13) | img0(13:16) ]
and of the 5-channel stage-2 output:
  [ visibility logit V_1t(0) | ΔF_t1(1:3) | ΔF_t0(3:5) ]
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def interpolate_flows(flow_01, flow_10, t):
    """Arbitrary-t intermediate flow estimates from the bidirectional flow,
    applied to any broadcastable tensors (one flow component each):

    F̂_t0 = -(1-t)·t·F_01 + t²·F_10
    F̂_t1 = (1-t)²·F_01 - t·(1-t)·F_10

    :returns: (est_flow_t0, est_flow_t1).
    """
    est_flow_t0 = -(1.0 - t) * t * flow_01 + (t * t) * flow_10
    est_flow_t1 = (1.0 - t) * (1.0 - t) * flow_01 - t * (1.0 - t) * flow_10
    return est_flow_t0, est_flow_t1


class Stage2Outputs(NamedTuple):
    v_1t: torch.Tensor  # visibility of frame 1 at t, in (0, 1)
    dflow_t1: tuple  # (u, v) residual flow t→1
    dflow_t0: tuple  # (u, v) residual flow t→0
    v_0t: torch.Tensor  # 1 - v_1t


def extract_stage2_outputs(planes: Sequence[torch.Tensor]) -> Stage2Outputs:
    """Split the 5 planes of the stage-2 head (f32)."""
    v_1t = 1.0 / (1.0 + torch.exp(-planes[0]))  # sigmoid, written as the reference does
    return Stage2Outputs(v_1t, (planes[1], planes[2]), (planes[3], planes[4]), 1.0 - v_1t)


def blend(warped_0, warped_1, v_0t, v_1t, t):
    """Î_t = ((1-t)·V_0t·g(I_0, F_t0) + t·V_1t·g(I_1, F_t1)) / ((1-t)·V_0t + t·V_1t).

    No epsilon in the denominator: the sigmoid keeps it strictly positive,
    and the reference's numerics are kept for parity."""
    weighted = (1.0 - t) * (warped_0 * v_0t) + t * (warped_1 * v_1t)
    return weighted / ((1.0 - t) * v_0t + t * v_1t)
