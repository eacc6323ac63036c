"""The Super SloMo composite training loss, after the reference:

* reconstruction: λ_R · per-sample mean L1(Î_t, I_t);
* warp: λ_W · per-sample mean of
    stage-1 term  L1(g(I_1, F_01), I_0) + L1(g(I_0, F_10), I_1)
    + stage-2 term L1(g(I_0, F_t0+ΔF_t0), I_t) + L1(g(I_1, F_t1+ΔF_t1), I_t),
  each term dropped when its stage is frozen;
* perceptual: λ_P · per-sample mean MSE of VGG-16 conv4_3 features, the
  target's computed without gradient.

The result is the reference's per-sample ``[B, 4]`` tensor ordered (total,
reconstruction, warp, perceptual). Windows are folded into the batch, so the
four loss warps and the VGG each run once at B·W_n; per-window losses are
averaged over windows.

Tensors arrive in the JAX layout (N, H, W, c). They are views of the model's
NCHW ``channels_last`` tensors, so the permutes back to NCHW copy nothing and
the warps read the frames and flows in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.models.physics import refined_flows
from superslomo_tpu_torch.models.superslomo import ModelOutputs
from superslomo_tpu_torch.ops import warp_auto


class LossWeights(NamedTuple):
    lambda_r: float = 60.0
    lambda_w: float = 10.0
    lambda_p: float = 20.0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) → (N,) mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.dim())))


def window_losses(
    img_pair: torch.Tensor,  # (N, H, W, 6)
    flowC_out: torch.Tensor,  # (N, H, W, 4)
    flowI_in: torch.Tensor,  # (N, H, W, 16)
    flowI_out: torch.Tensor,  # (N, H, W, 5)
    pred_img: torch.Tensor,  # (N, H, W, 3)
    target: torch.Tensor,  # (N, H, W, 3)
    spec: ModelSpec,
    weights: LossWeights,
    vgg: Callable[[torch.Tensor], torch.Tensor],  # (N, 3, H, W) → features
) -> torch.Tensor:
    """Losses of one interpolation window → (N, 4)."""
    pair, pred, tgt = _nchw(img_pair), _nchw(pred_img), _nchw(target)
    img_0, img_1 = pair[:, 0:3], pair[:, 3:6]

    loss_r = weights.lambda_r * _per_sample_mean(torch.abs(pred - tgt))

    warp = torch.zeros(pred.shape[0], dtype=pred.dtype, device=pred.device)
    if not spec.stage1_freeze:
        flowC = _nchw(flowC_out)
        warp = warp + _per_sample_mean(
            torch.abs(warp_auto(img_1, flowC[:, 0:2]) - img_0)
            + torch.abs(warp_auto(img_0, flowC[:, 2:4]) - img_1)
        )
    if not spec.stage2_freeze:
        pred_flow_t1, pred_flow_t0 = refined_flows(_nchw(flowI_in), _nchw(flowI_out))
        warp = warp + _per_sample_mean(
            torch.abs(warp_auto(img_0, pred_flow_t0) - tgt)
            + torch.abs(warp_auto(img_1, pred_flow_t1) - tgt)
        )
    loss_w = weights.lambda_w * warp

    feat_pred = vgg(pred)
    with torch.no_grad():
        feat_tgt = vgg(tgt)
    loss_p = weights.lambda_p * _per_sample_mean((feat_pred - feat_tgt) ** 2)

    total = loss_r + loss_w + loss_p
    return torch.stack([total, loss_r, loss_w, loss_p], dim=1)


def compute_losses(
    outputs: ModelOutputs,
    targets: torch.Tensor,  # (B, T-1, H, W, 3)
    spec: ModelSpec,
    weights: LossWeights,
    vgg: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """All windows → (B, 4), averaged over windows."""
    B, W_n = targets.shape[:2]

    def fold(x):
        return x.reshape((B * W_n,) + tuple(x.shape[2:]))

    per_sample = window_losses(
        fold(outputs.image_pairs), fold(outputs.flowC_out), fold(outputs.flowI_in),
        fold(outputs.flowI_out), fold(outputs.pred_images), fold(targets),
        spec, weights, vgg,
    )
    return per_sample.reshape(B, W_n, 4).mean(dim=1)
