"""The composite Super SloMo model: its forward over T-frame windows (the
training step's model) and its fused multi-t interpolation step.

``SuperSloMo.forward`` is the counterpart of the JAX model's ``__call__``: the
windows of adjacent frame pairs are folded into the batch, the stage-1 U-Net
gives the bidirectional flow, two single-flow warps build the stage-2 input,
the stage-2 U-Net refines, and two more warps and the visibility blend give
the interpolated frame. Autograd stays on; the outputs come back in the JAX
layout, (B, T-1, H, W, c).

``SuperSloMo.interpolate_multi_t`` is the serving path (the "8x slow-mo"
step): the stage-1 U-Net runs once per frame pair, the t-interpolated flows
are computed as (H, W) planes, two multi-flow warps build the stage-2 input,
the stage-2 U-Net runs with the t-grid folded into the batch, and two f32
multi-flow warps of the frames feed the visibility blend. The step also
returns a bound on every flow it warped with, ``max(boundC, boundC +
max|Δflow|)``.

The U-Nets run NCHW in ``torch.channels_last`` memory format. In float32 the
convolutions run with TF32 off (cuDNN and matmul); cuDNN's TF32 default keeps
about three decimal digits and breaks float32 parity with the reference. In
bfloat16 the step quantizes where the JAX package does: the U-Nets compute in
bf16, the stage-1 head is upcast to f32 before the flow algebra, the stage-2
input warps store bf16, the stage-2 head is upcast to f32, and the final
warps, the blend and the output are f32.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn as nn

from superslomo_tpu_torch.config import VALID_COMPUTE_DTYPES, ModelSpec
from superslomo_tpu_torch.device import resolve_device
from superslomo_tpu_torch.models import physics
from superslomo_tpu_torch.models.unet import UNet
from superslomo_tpu_torch.ops import warp_multiflow_planar


class ModelOutputs(NamedTuple):
    """Everything the losses and the image dump need, (B, T-1, H, W, c) f32."""

    image_pairs: torch.Tensor  # (B, T-1, H, W, 6)
    flowC_out: torch.Tensor  # (B, T-1, H, W, 4) stage-1 bidirectional flow
    flowI_in: torch.Tensor  # (B, T-1, H, W, 16) stage-2 input
    flowI_out: torch.Tensor  # (B, T-1, H, W, 5) stage-2 head
    pred_images: torch.Tensor  # (B, T-1, H, W, 3) interpolated frames
    t_interp: torch.Tensor  # (B, T-1, 1, 1, 1)


def mid_window(outputs: ModelOutputs) -> int:
    """The reference's mid-window convention: T_windows // 2."""
    return outputs.pred_images.shape[1] // 2


def make_pairs(frames: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) frames → (B, T-1, H, W, 6) adjacent-pair windows."""
    return torch.cat([frames[:, :-1], frames[:, 1:]], dim=-1)


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN convolutions and matmuls, restored on exit."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = flags[0].allow_tf32, flags[1].allow_tf32
    flags[0].allow_tf32 = flags[1].allow_tf32 = False
    try:
        yield
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32 = saved


def _tile_t(x: torch.Tensor, B: int, n_t: int, W_n: int) -> torch.Tensor:
    """(B·W_n, C, h, w) → (B·n_t·W_n, C, h, w) channels-last: each sample's
    windows repeated over the t-grid, sample-major."""
    nhwc = x.permute(0, 2, 3, 1)
    rest = tuple(nhwc.shape[1:])
    tiled = nhwc.reshape((B, 1, W_n) + rest).expand((B, n_t, W_n) + rest)
    return tiled.reshape((B * n_t * W_n,) + rest).permute(0, 3, 1, 2)


class SuperSloMo(nn.Module):
    """Two-stage Super SloMo with the CONV bottleneck.

    :param spec: model hyperparameters (``Config.model_spec()``).
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, spec: ModelSpec = ModelSpec(), device=None):
        super().__init__()
        if spec.compute_dtype not in VALID_COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {VALID_COMPUTE_DTYPES}")
        self.spec = spec
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, spec.compute_dtype)
        self.stage1 = UNet(6, 4, spec.stage1_bottleneck, emit_encoding=spec.cross_skip)
        self.stage2 = UNet(16, 5, spec.stage2_bottleneck, accept_encoding=spec.cross_skip)
        self.to(device=self.device, dtype=self.compute_dtype, memory_format=torch.channels_last)
        self.eval()
        if self.device.type == "cuda":
            # the step runs the same conv shapes batch after batch: let cuDNN
            # time its algorithms once per shape (a process-wide setting)
            torch.backends.cudnn.benchmark = True

    def load_state(self, state: dict) -> "SuperSloMo":
        """Load ``{"stage1": state_dict, "stage2": state_dict}`` (reference
        names, OIHW; cast to the compute dtype on load)."""
        self.stage1.load_state_dict(state["stage1"])
        self.stage2.load_state_dict(state["stage2"])
        return self

    def forward(self, frames, t_interp) -> ModelOutputs:
        """Forward over all windows, with autograd (training and single-t
        inference).

        :param frames: (B, T, H, W, 3) normalized frames, T = N_FRAMES; H, W
            /32-divisible.
        :param t_interp: per-window instants in (0, 1): (B, T-1) or
            (B, T-1, 1, 1, 1).
        """
        f32, cdt = torch.float32, self.compute_dtype
        frames = torch.as_tensor(frames, dtype=f32, device=self.device)
        pairs = make_pairs(frames)  # (B, W_n, H, W, 6)
        B, W_n, H, W, _ = pairs.shape
        t = torch.as_tensor(t_interp, dtype=f32, device=self.device).reshape(B, W_n, 1, 1, 1)
        BW = B * W_n
        x1 = pairs.reshape(BW, H, W, 6).permute(0, 3, 1, 2)  # channels-last view
        t_f = t.reshape(BW, 1, 1, 1)
        with tf32_off():
            head1, encoding = self.stage1(x1.to(cdt))
            flowC = head1.to(f32)
            flowI_in = physics.compute_stage2_inputs(
                x1, flowC, t_f, warp_dtype=cdt if cdt != f32 else None)
            head2, _ = self.stage2(flowI_in.to(cdt), encoding)
            flowI_out = head2.to(f32)
            pred = physics.compute_output_image(x1, flowI_in, flowI_out, t_f)

        def unfold(x):  # (BW, c, H, W) → (B, W_n, H, W, c)
            return x.permute(0, 2, 3, 1).reshape(B, W_n, H, W, x.shape[1])

        return ModelOutputs(pairs, unfold(flowC), unfold(flowI_in), unfold(flowI_out), unfold(pred), t)

    def interpolate_multi_t(self, frames, t_values, with_bounds: bool = False):
        """The fused multi-t interpolation step.

        :param frames: (B, T, H, W, 3) normalized frames; H, W /32-divisible.
        :param t_values: (n_t,) interpolation instants in (0, 1).
        :param with_bounds: also return the flow bound (a 0-d f32 tensor on
            the model's device). The CUDA warp is exact for any flow, so the
            bound is informational: no rerun depends on it.
        :returns: (B, n_t, H, W, 3) f32 predictions of the mid window, one per
            t; with ``with_bounds``, ``(pred, bound)``.
        """
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        t_values = torch.as_tensor(t_values, dtype=torch.float32, device=self.device)
        if frames.dim() != 5 or frames.shape[-1] != 3 or frames.shape[1] < 2:
            raise ValueError(f"frames must be (B, T>=2, H, W, 3), got {tuple(frames.shape)}")
        with torch.inference_mode(), tf32_off():
            pred, bound = self._multi_t_planar(frames, t_values.reshape(-1))
        return (pred, bound) if with_bounds else pred

    def _multi_t_planar(self, frames, t_values):
        f32, cdt = torch.float32, self.compute_dtype
        pairs = make_pairs(frames)  # (B, W_n, H, W, 6) f32
        B, W_n, H, W, _ = pairs.shape
        BW, n_t = B * W_n, t_values.shape[0]
        planes6 = pairs.reshape(BW, H, W, 6).permute(0, 3, 1, 2)  # channels-last view

        head1, encoding = self.stage1(planes6.to(cdt))  # (BW, 4, H, W) cdt
        bound_c = head1.abs().amax().to(f32)
        u01, v01, u10, v10 = head1.to(f32).permute(1, 0, 2, 3).contiguous()

        tc = t_values.reshape(1, n_t, 1, 1)
        u_t0, u_t1 = physics.interpolate_flows(u01[:, None], u10[:, None], tc)
        v_t0, v_t1 = physics.interpolate_flows(v01[:, None], v10[:, None], tc)  # (BW, n_t, H, W)

        # stage-2 input warps store the compute dtype (f32 accumulation)
        pl0, pl1 = planes6[:, 0:3].to(cdt), planes6[:, 3:6].to(cdt)
        w1t = warp_multiflow_planar(pl1, u_t1, v_t1, out_dtype=cdt)  # (BW, 3, n_t, H, W)
        w0t = warp_multiflow_planar(pl0, u_t0, v_t0, out_dtype=cdt)

        def bc(x):  # (BW, c, H, W) → (BW, c, n_t, H, W)
            return x[:, :, None].expand(-1, -1, n_t, -1, -1)

        est = torch.stack([u_t1, v_t1, u_t0, v_t0], dim=1).to(cdt)
        P = torch.cat([bc(pl1), w1t, est, w0t, bc(pl0)], dim=1)  # (BW, 16, n_t, H, W)
        # → (B·n_t·W_n, 16, H, W) channels-last, the t-grid folded into the batch
        x2 = (
            P.reshape(B, W_n, 16, n_t, H, W).permute(0, 3, 1, 4, 5, 2)
            .reshape(B * n_t * W_n, H, W, 16).permute(0, 3, 1, 2)
        )
        enc_t = None if encoding is None else _tile_t(encoding, B, n_t, W_n)
        head2, _ = self.stage2(x2, enc_t)  # (B·n_t·W_n, 5, H, W) cdt
        # refined flows = est + Δ, so boundC + max|Δ| bounds the final warps
        bound = torch.maximum(bound_c, bound_c + head2[:, 1:5].abs().amax().to(f32))

        mid = W_n // 2
        head2_mid = head2.reshape(B, n_t, W_n, 5, H, W)[:, :, mid]
        s2 = physics.extract_stage2_planes(
            head2_mid.to(f32).permute(2, 0, 1, 3, 4).contiguous()
        )  # planes (B, n_t, H, W)

        def mid_est(x):  # (BW, n_t, H, W) → (B, n_t, H, W) of the mid window
            return x.reshape(B, W_n, n_t, H, W)[:, mid]

        u_p_t1 = mid_est(u_t1) + s2.dflow_t1[0]
        v_p_t1 = mid_est(v_t1) + s2.dflow_t1[1]
        u_p_t0 = mid_est(u_t0) + s2.dflow_t0[0]
        v_p_t0 = mid_est(v_t0) + s2.dflow_t0[1]

        mp = pairs[:, mid].permute(0, 3, 1, 2)  # (B, 6, H, W) f32
        w0 = warp_multiflow_planar(mp[:, 0:3], u_p_t0, v_p_t0, out_dtype=f32)
        w1 = warp_multiflow_planar(mp[:, 3:6], u_p_t1, v_p_t1, out_dtype=f32)
        t_g = t_values.reshape(1, 1, n_t, 1, 1)
        pred = physics.blend(w0, w1, s2.v_0t[:, None], s2.v_1t[:, None], t_g)
        return pred.permute(0, 2, 3, 4, 1).contiguous(), bound  # (B, n_t, H, W, 3)
