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

Under a spatial grid (``ModelOutputs.pair_rows`` set by the model's forward
under ``parallel.halo.spatial``) the tensors hold this rank's rows. The four
loss warps read their frames from the gathered pairs through this rank's
row window, the VGG's convs exchange halo rows, and
each per-sample mean over H·W·C becomes this rank's sum over the whole
frame's count: the ranks' losses are parts that sum to one process's, and
each rank's backward differentiates its own part, with no collective inside
the autograd graph. The caller sums the parts over the spatial ranks
(``training/trainer.py``).
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


def _per_sample_mean(x: torch.Tensor, frame_rows=None) -> torch.Tensor:
    """(N, C, h, W) → (N,) mean over all non-batch axes. ``frame_rows``,
    under a spatial grid, ``(h0, H)``: this rank's rows and the frame's at
    full scale; the mean is then this rank's sum over the count of the whole
    frame at x's scale (``h`` is h0 at that scale)."""
    dims = tuple(range(1, x.dim()))
    if frame_rows is None:
        return x.mean(dim=dims)
    h0, H = frame_rows
    h = x.shape[2]
    return x.sum(dim=dims) / (x[0].numel() // h * (h * H // h0))


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
    pair_rows=None,  # under a spatial grid: ModelOutputs.pair_rows, the pairs' whole height and its window
) -> torch.Tensor:
    """Losses of one interpolation window → (N, 4); under a spatial grid,
    this rank's parts of them."""
    pair, pred, tgt = _nchw(img_pair), _nchw(pred_img), _nchw(target)
    img_0, img_1 = pair[:, 0:3], pair[:, 3:6]
    rows = None if pair_rows is None else (pred.shape[2], pair_rows[1].frame_rows)

    def warped(i, flow):  # frame i warped: from the pair, or from its whole height through the window
        if pair_rows is None:
            return warp_auto(pair[:, 3 * i:3 * i + 3], flow)
        return warp_auto(pair_rows[0][:, 3 * i:3 * i + 3], flow, rows=pair_rows[1])

    loss_r = weights.lambda_r * _per_sample_mean(torch.abs(pred - tgt), rows)

    warp = torch.zeros(pred.shape[0], dtype=pred.dtype, device=pred.device)
    if not spec.stage1_freeze:
        flowC = _nchw(flowC_out)
        warp = warp + _per_sample_mean(
            torch.abs(warped(1, flowC[:, 0:2]) - img_0)
            + torch.abs(warped(0, flowC[:, 2:4]) - img_1), rows
        )
    if not spec.stage2_freeze:
        pred_flow_t1, pred_flow_t0 = refined_flows(_nchw(flowI_in), _nchw(flowI_out))
        warp = warp + _per_sample_mean(
            torch.abs(warped(0, pred_flow_t0) - tgt)
            + torch.abs(warped(1, pred_flow_t1) - tgt), rows
        )
    loss_w = weights.lambda_w * warp

    feat_pred = vgg(pred)
    with torch.no_grad():
        feat_tgt = vgg(tgt)
    loss_p = weights.lambda_p * _per_sample_mean((feat_pred - feat_tgt) ** 2, rows)

    total = loss_r + loss_w + loss_p
    return torch.stack([total, loss_r, loss_w, loss_p], dim=1)


def compute_losses(
    outputs: ModelOutputs,
    targets: torch.Tensor,  # (B, T-1, H, W, 3)
    spec: ModelSpec,
    weights: LossWeights,
    vgg: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """All windows → (B, 4), averaged over windows; under a spatial grid,
    this rank's parts of them."""
    B, W_n = targets.shape[:2]

    def fold(x):
        return x.reshape((B * W_n,) + tuple(x.shape[2:]))

    per_sample = window_losses(
        fold(outputs.image_pairs), fold(outputs.flowC_out), fold(outputs.flowI_in),
        fold(outputs.flowI_out), fold(outputs.pred_images), fold(targets),
        spec, weights, vgg, outputs.pair_rows,
    )
    return per_sample.reshape(B, W_n, 4).mean(dim=1)
