"""The composite Super SloMo / SuperSloMo-R model: its forward over T-frame
windows (the training step's model and the streamed forward) and its fused
multi-t interpolation step.

``SuperSloMo.forward`` is the counterpart of the JAX model's ``__call__``: the
windows of adjacent frame pairs are folded into the batch, the stage-1 U-Net
gives the bidirectional flow, two single-flow warps build the stage-2 input,
the stage-2 U-Net refines, and two more warps and the visibility blend give
the interpolated frame. Autograd stays on; the outputs come back in the JAX
layout, (B, T-1, H, W, c). With a recurrent bottleneck (CLSTM / CGRU) each
stage's recurrence runs over the T-1 windows; ``rnn_carry`` starts it from
the state a previous window returned, so a long clip streams window after
window (``forward_inference`` is that path under ``torch.inference_mode``).

``SuperSloMo.interpolate_multi_t`` is the serving path (the "8x slow-mo"
step): the stage-1 U-Net runs once per frame pair, the t-interpolated flows
are computed as (H, W) planes, two multi-flow warps build the stage-2 input,
the stage-2 U-Net runs with the t-grid folded into the batch, and two f32
multi-flow warps of the frames feed the visibility blend. The step also
returns a bound on every flow it warped with, ``max(boundC, boundC +
max|Δflow|)``. A streamed-in ``rnn_carry`` starts stage 1 as given and
stage 2 with each sample's state repeated over its t-grid; the step returns
no state. A batch whose stage-2 batch would pass ``STEP_PIXELS`` runs as
consecutive slices of ``step_samples`` samples (the frames and the carry cut
alike), their predictions joined and their bounds' max returned: every op of
the step is per sample, so a slice computes what the whole batch would.

Under a spatial grid (``parallel.halo.spatial``) the fused step runs with
each frame's rows split across the spatial ranks: the frames given are this
rank's block of rows, every conv and upsample of the U-Nets exchanges halo
rows (``models/layers.py``, ``ops/resize.py``), each of the step's two warp
pairs exchanges its 6-channel pair's halo rows once and warps through a row
window (``parallel.warp_spmd.warp_multiflow_sharded``, unguarded: the halo
rows, or the whole height under ``halo.full_height_warps()``), and the bound
is reduced by MAX over the spatial ranks, so it is one process's bound. The
step then returns this rank's rows of the predictions.
``interpolate_multi_t`` serves under ``torch.inference_mode``; the step
itself (``_multi_t_planar``) is differentiable under the grid in its
parameters and its frames, as JAX's fused step under a mesh is: the
exchanges and the gather send the halo rows' and the gathered rows'
gradients back to their owners, and the windowed warps give the planes' and
the flows' gradients, so each rank holds one process's gradient of its rows
and its share of the parameters'.

``SuperSloMo.forward`` (training) runs under a grid too, on this rank's
block of each frame's rows. The convs and upsamples exchange halo rows as
in the fused step, and under autograd send the halo rows' gradient back to
their owners (``halo.exchange_rows``). The warps do not read halo rows: the
6-channel pairs are gathered to the whole height once a forward
(``halo.gather_rows``; frames are data, so nothing is differentiated through
the gather), and each of the step's eight single-flow warps (two for the
stage-2 input, two for the output, four in the losses, which reuse the
gathered pairs through ``ModelOutputs.pair_rows``) reads its frame from the
whole height through a ``RowWindow`` of this rank's rows. Positions are
taken in frame rows, so the warps and their flow gradients are one
process's rows of them for any flow: no guard, no host sync, no rerun, and
no exchange for the warps in the backward. Where this departs from the JAX
package's sharded train step (``parallel/warp_spmd.py::warp_sharded``):
within its ``halo_reach`` JAX's halo warp takes positions from the halo's
first row, an f32 ulp of a position apart from one process's (1.8-2.4e-5 on
noise planes); beyond it JAX's backward is still the halo path's gradient
(``g_bwd``), where the port's is the exact gradient, JAX's single-device
one. Under ``[TPU] REMAT`` the backward recomputes each U-Net stage, whose
exchanges then run again, in the same order on every rank; the gather is
outside the stages and is not repeated. The caller keeps ``halo.spatial``
in effect through the backward (``training/trainer.py``).

The U-Nets run NCHW in ``torch.channels_last`` memory format. In float32 the
convolutions run with TF32 off (cuDNN and matmul); cuDNN's TF32 default keeps
about three decimal digits and breaks float32 parity with the reference. In
bfloat16 the step quantizes where the JAX package does: the U-Nets compute in
bf16, the stage-1 head is upcast to f32 before the flow algebra, the stage-2
input warps store bf16, the stage-2 head is upcast to f32, and the final
warps, the blend and the output are f32.

The parameters are kept in ``param_dtype``: by default the compute dtype
(serving), or float32 master weights under a bf16 compute dtype (training,
as flax keeps them): every conv casts its weights to its input's dtype at
each call (``layers.Conv2d``). ``[TPU] REMAT`` recomputes each U-Net stage's
activations in the backward (``torch.utils.checkpoint``) instead of keeping
them, when autograd records.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.utils.checkpoint

from superslomo_tpu_torch.config import VALID_COMPUTE_DTYPES, ModelSpec
from superslomo_tpu_torch.device import resolve_device
from superslomo_tpu_torch.models import physics
from superslomo_tpu_torch.models.unet import UNet
from superslomo_tpu_torch.ops import warp_multiflow_planar
from superslomo_tpu_torch.parallel import halo, warp_spmd
from superslomo_tpu_torch.parallel.mesh import block_start

# The most stage-2 pixels (B·n_t·W_n images) one fused step computes at once:
# 14 images of 736x1280, the serving step at B=2, which keeps the H100 busy
# 0.998 of the step and peaks at 22.92 GiB in f32 (PERF.md §5). A larger batch
# runs as slices of that size: the shipped B=8 at 720p in one step needs more
# than the card's 80 GB in f32, and every other step shape costs minutes of
# cuDNN's autotuning there.
STEP_PIXELS = 14 * 736 * 1280


def step_samples(rows: int, width: int, n_t: int, n_windows: int) -> int:
    """The most samples one fused step takes within ``STEP_PIXELS``: each
    brings ``n_t * n_windows`` stage-2 images of ``rows`` x ``width`` (at
    720p 8x, 2; at least 1)."""
    return max(1, STEP_PIXELS // (n_t * n_windows * rows * width))


def stage_unets(spec: ModelSpec):
    """The two U-Nets of ``spec``: (stage 1: 6 → 4, stage 2: 16 → 5)."""
    layout = dict(clstm_merge=spec.clstm_merge, clstm_gate_order=spec.clstm_gate_order)
    return (UNet(6, 4, spec.stage1_bottleneck, emit_encoding=spec.cross_skip, **layout),
            UNet(16, 5, spec.stage2_bottleneck, accept_encoding=spec.cross_skip, **layout))


def check_stage_shapes(state: dict, spec: ModelSpec, stage: str) -> None:
    """Raise, naming the config keys to check, when a stage's state dict
    holds other keys (KeyError) or shapes (ValueError) than ``spec``'s
    U-Net."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in stage_unets(spec)[stage == "stage2"].state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    problems = [f"missing {k}" for k in want if k not in got] + [f"unexpected {k}" for k in got if k not in want]
    keys_differ = bool(problems)
    problems += [f"{k}: state {got[k]} vs model {s}" for k, s in want.items() if k in got and got[k] != s]
    if not problems:
        return
    hint = ""
    if any("conv6" in p for p in problems):
        hint = (" — the bottleneck's layout disagrees: check [STAGE1/2] BOTTLENECK, [TPU] CLSTM_MERGE "
                "(CONCAT = hidden/2 a direction, SUM = hidden a direction) and [TPU] CLSTM_GATE_ORDER")
    error = KeyError if keys_differ else ValueError
    raise error(f"{stage} weights do not match the model{hint}: " + "; ".join(problems[:12]))


class ModelOutputs(NamedTuple):
    """Everything the losses and the image dump need, (B, T-1, H, W, c) f32."""

    image_pairs: torch.Tensor  # (B, T-1, H, W, 6)
    flowC_out: torch.Tensor  # (B, T-1, H, W, 4) stage-1 bidirectional flow
    flowI_in: torch.Tensor  # (B, T-1, H, W, 16) stage-2 input
    flowI_out: torch.Tensor  # (B, T-1, H, W, 5) stage-2 head
    pred_images: torch.Tensor  # (B, T-1, H, W, 3) interpolated frames
    t_interp: torch.Tensor  # (B, T-1, 1, 1, 1)
    rnn_carry: Optional[dict] = None  # {"stage1": …, "stage2": …} of a recurrent model, else None
    # under a spatial grid: the windows' pairs gathered to the whole height,
    # (B·(T-1), 6, H, W) channels-last, and the RowWindow of this rank's rows
    pair_rows: Optional[tuple] = None


class Intermediates(NamedTuple):
    """The reference's inference intermediates of one window, (B, H, W, c)
    f32: the stage-1 flows, the estimated and refined flows at t, and the
    visibility of frame 0."""

    flowC_01: torch.Tensor
    flowC_10: torch.Tensor
    est_flow_t1: torch.Tensor
    est_flow_t0: torch.Tensor
    refined_flow_t1: torch.Tensor
    refined_flow_t0: torch.Tensor
    v_0t: torch.Tensor


def mid_window(outputs: ModelOutputs) -> int:
    """The reference's mid-window convention: T_windows // 2."""
    return outputs.pred_images.shape[1] // 2


def intermediates_for_window(outputs: ModelOutputs, window: int) -> Intermediates:
    """The stage-1 flows, estimated flows, refined flows and v_0t of one
    window of ``outputs``."""
    def nchw(x):  # (B, W_n, H, W, c) → the window's (B, c, H, W) view
        return x[:, window].permute(0, 3, 1, 2)

    def nhwc(x):
        return x.permute(0, 2, 3, 1)

    flowC, flowI_in, flowI_out = (outputs.flowC_out[:, window], outputs.flowI_in[:, window],
                                  outputs.flowI_out[:, window])
    ref_t1, ref_t0 = physics.refined_flows(nchw(outputs.flowI_in), nchw(outputs.flowI_out))
    return Intermediates(
        flowC_01=flowC[..., 0:2], flowC_10=flowC[..., 2:4],
        est_flow_t1=flowI_in[..., 6:8], est_flow_t0=flowI_in[..., 8:10],
        refined_flow_t1=nhwc(ref_t1), refined_flow_t0=nhwc(ref_t0),
        v_0t=nhwc(physics.extract_stage2_outputs(nchw(outputs.flowI_out)).v_0t),
    )


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


def _tile_carry(carry, n_t: int):
    """Each leaf (B, C, h, w) of a stage's state → (B·n_t, C, h, w): every
    sample's state repeated over its t-grid, sample-major (the stage-2
    fold's order)."""
    def tile(x):
        rest = tuple(x.shape[1:])
        return x[:, None].expand((x.shape[0], n_t) + rest).reshape((-1,) + rest)

    return None if carry is None else {k: tuple(tile(leaf) for leaf in v) for k, v in carry.items()}


def _stage_carry(rnn_carry, stage: str):
    """One stage's streamed-in state, or None."""
    return rnn_carry.get(stage) if rnn_carry else None


def _carry_samples(rnn_carry, lo: int, hi: int):
    """A streamed-in state's samples ``lo:hi`` (each leaf cut along its batch)."""
    if not rnn_carry:
        return rnn_carry
    return {stage: None if c is None else {k: tuple(x[lo:hi] for x in v) for k, v in c.items()}
            for stage, c in rnn_carry.items()}


class SuperSloMo(nn.Module):
    """Two-stage Super SloMo, with the CONV bottleneck or the recurrent
    ConvLSTM / ConvGRU bottleneck of SuperSloMo-R in either stage.

    :param spec: model hyperparameters (``Config.model_spec()``).
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"`` for the plain PyTorch path.
    :param param_dtype: the parameters' dtype; None for the compute dtype.
        The trainer passes ``torch.float32``: master weights that each conv
        casts to the compute dtype.
    """

    def __init__(self, spec: ModelSpec = ModelSpec(), device=None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if spec.compute_dtype not in VALID_COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {VALID_COMPUTE_DTYPES}")
        self.spec = spec
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, spec.compute_dtype)
        self.param_dtype = self.compute_dtype if param_dtype is None else param_dtype
        self.stage1, self.stage2 = stage_unets(spec)
        self.to(device=self.device, dtype=self.param_dtype, memory_format=torch.channels_last)
        self.eval()
        if self.device.type == "cuda":
            # the step runs the same conv shapes batch after batch: let cuDNN
            # time its algorithms once per shape (a process-wide setting)
            torch.backends.cudnn.benchmark = True

    def load_state(self, state: dict) -> "SuperSloMo":
        """Load ``{"stage1": state_dict, "stage2": state_dict}`` (reference
        names, OIHW; cast to the parameters' dtype on load)."""
        for stage in ("stage1", "stage2"):
            check_stage_shapes(state[stage], self.spec, stage)
            getattr(self, stage).load_state_dict(state[stage])
        return self

    def forward(self, frames, t_interp, rnn_carry: Optional[dict] = None) -> ModelOutputs:
        """Forward over all windows, with autograd (training and single-t
        inference, and the streamed forward of a recurrent model).

        :param frames: (B, T, H, W, 3) normalized frames, T = N_FRAMES; H, W
            /32-divisible. Under a spatial grid, this rank's block of each
            frame's rows.
        :param t_interp: per-window instants in (0, 1): (B, T-1) or
            (B, T-1, 1, 1, 1).
        :param rnn_carry: a recurrent model's state from a previous window
            (``ModelOutputs.rnn_carry``); None starts from zeros.
        :returns: ``ModelOutputs``; its ``rnn_carry`` is the new state of a
            recurrent model, else None; under a grid, this rank's rows and
            ``pair_rows``.
        """
        f32, cdt = torch.float32, self.compute_dtype
        frames = torch.as_tensor(frames, dtype=f32, device=self.device)
        pairs = make_pairs(frames)  # (B, W_n, H, W, 6)
        B, W_n, H, W, _ = pairs.shape
        t = torch.as_tensor(t_interp, dtype=f32, device=self.device).reshape(B, W_n, 1, 1, 1)
        BW = B * W_n
        x1 = pairs.reshape(BW, H, W, 6).permute(0, 3, 1, 2)  # channels-last view
        t_f = t.reshape(BW, 1, 1, 1)
        pair_rows = _gathered_pairs(x1)
        with tf32_off():
            head1, encoding, carry1 = self._run_stage(
                self.stage1, x1.to(cdt), None, W_n, _stage_carry(rnn_carry, "stage1"))
            flowC = head1.to(f32)
            flowI_in = physics.compute_stage2_inputs(
                x1, flowC, t_f, warp_dtype=cdt if cdt != f32 else None, pair_rows=pair_rows)
            head2, _, carry2 = self._run_stage(
                self.stage2, flowI_in.to(cdt), encoding, W_n, _stage_carry(rnn_carry, "stage2"))
            flowI_out = head2.to(f32)
            pred = physics.compute_output_image(x1, flowI_in, flowI_out, t_f, pair_rows)

        def unfold(x):  # (BW, c, H, W) → (B, W_n, H, W, c)
            return x.permute(0, 2, 3, 1).reshape(B, W_n, H, W, x.shape[1])

        carry = None if carry1 is None and carry2 is None else {"stage1": carry1, "stage2": carry2}
        return ModelOutputs(pairs, unfold(flowC), unfold(flowI_in), unfold(flowI_out), unfold(pred), t, carry,
                            pair_rows)

    def _run_stage(self, unet, x, cross_encoding, n_windows, carry):
        """One U-Net stage of ``forward``: under ``[TPU] REMAT``, while
        autograd records, its activations are recomputed in the backward."""
        if self.spec.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(unet, x, cross_encoding, n_windows, carry, use_reentrant=False)
        return unet(x, cross_encoding, n_windows=n_windows, rnn_carry=carry)

    def forward_inference(self, frames, t_interp, rnn_carry: Optional[dict] = None):
        """The reference-shaped inference call, under ``torch.inference_mode``:
        ``(mid-window image (B, H, W, 3), Intermediates, rnn_carry)``."""
        with torch.inference_mode():
            outputs = self(frames, t_interp, rnn_carry)
        mid = mid_window(outputs)
        return outputs.pred_images[:, mid], intermediates_for_window(outputs, mid), outputs.rnn_carry

    def interpolate_multi_t(self, frames, t_values, rnn_carry: Optional[dict] = None, with_bounds: bool = False):
        """The fused multi-t interpolation step.

        :param frames: (B, T, H, W, 3) normalized frames; H, W /32-divisible.
            Under a spatial grid, this rank's block of each frame's rows.
        :param t_values: (n_t,) interpolation instants in (0, 1).
        :param rnn_carry: a recurrent model's state from a previous window
            (batch B, from ``forward``); stage 2's is repeated over the
            t-grid. The step returns no new state.
        :param with_bounds: also return the flow bound (a 0-d f32 tensor on
            the model's device). The CUDA warp is exact for any flow, so in
            one process the bound is informational; under a spatial grid the
            halo warps are exact within ``halo.halo_reach`` of it.
        :returns: (B, n_t, H, W, 3) f32 predictions of the mid window, one per
            t (this rank's rows under a grid); with ``with_bounds``, ``(pred,
            bound)``. Any batch: past ``step_samples`` samples (by the largest
            block's rows under a grid, so every rank runs as many slices) it
            runs as slices of that many.
        """
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        t_values = torch.as_tensor(t_values, dtype=torch.float32, device=self.device).reshape(-1)
        if frames.dim() != 5 or frames.shape[-1] != 3 or frames.shape[1] < 2:
            raise ValueError(f"frames must be (B, T>=2, H, W, 3), got {tuple(frames.shape)}")
        B, T, H, W, _ = frames.shape
        grid = halo.active()
        blocks = None if grid is None else halo.frame_blocks(H, grid)  # every rank's rows
        per = step_samples(H if blocks is None else max(blocks), W, t_values.shape[0], T - 1)
        with torch.inference_mode(), tf32_off():
            steps = [self._multi_t_planar(frames[i:i + per], t_values, _carry_samples(rnn_carry, i, i + per), blocks)
                     for i in range(0, B, per)]
            if len(steps) == 1:
                pred, bound = steps[0]
            else:
                pred, bound = torch.cat([p for p, _ in steps]), torch.stack([b for _, b in steps]).amax()
        return (pred, bound) if with_bounds else pred

    def _multi_t_planar(self, frames, t_values, rnn_carry=None, blocks=None):
        """The fused step over the whole batch ``frames`` in one go; under a
        grid, ``blocks`` are every spatial rank's rows (gathered here if
        None)."""
        f32, cdt = torch.float32, self.compute_dtype
        pairs = make_pairs(frames)  # (B, W_n, H, W, 6) f32
        B, W_n, H, W, _ = pairs.shape
        BW, n_t = B * W_n, t_values.shape[0]
        planes6 = pairs.reshape(BW, H, W, 6).permute(0, 3, 1, 2)  # channels-last view
        grid = halo.active()
        if grid is not None and blocks is None:
            blocks = halo.frame_blocks(H, grid)  # every rank's rows

        x6 = planes6.to(cdt)  # the pairs in the compute dtype, channels-last
        head1, encoding, _ = self.stage1(
            x6, n_windows=W_n, rnn_carry=_stage_carry(rnn_carry, "stage1"))  # (BW, 4, H, W) cdt
        bound_c = head1.abs().amax().to(f32)
        u01, v01, u10, v10 = head1.to(f32).permute(1, 0, 2, 3).contiguous()

        tc = t_values.reshape(1, n_t, 1, 1)
        u_t0, u_t1 = physics.interpolate_flows(u01[:, None], u10[:, None], tc)
        v_t0, v_t1 = physics.interpolate_flows(v01[:, None], v10[:, None], tc)  # (BW, n_t, H, W)

        # stage-2 input warps store the compute dtype (f32 accumulation)
        pl0, pl1 = x6[:, 0:3], x6[:, 3:6]  # views: the warp reads them in place
        if grid is None:
            w1t = warp_multiflow_planar(pl1, u_t1, v_t1, out_dtype=cdt)  # (BW, 3, n_t, H, W)
            w0t = warp_multiflow_planar(pl0, u_t0, v_t0, out_dtype=cdt)
        else:
            w0t, w1t = warp_spmd.warp_multiflow_sharded(x6, ((u_t0, v_t0), (u_t1, v_t1)), blocks, unguarded=True)

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
        carry2 = _tile_carry(_stage_carry(rnn_carry, "stage2"), n_t)
        head2, _, _ = self.stage2(x2, enc_t, n_windows=W_n, rnn_carry=carry2)  # (B·n_t·W_n, 5, H, W) cdt
        # refined flows = est + Δ, so boundC + max|Δ| bounds the final warps
        if grid is None:
            bound = torch.maximum(bound_c, bound_c + head2[:, 1:5].abs().amax().to(f32))
        else:  # both maxima over the whole frame, then one process's sum
            m = halo.all_reduce(torch.stack([bound_c, head2[:, 1:5].abs().amax().to(f32)]), dist.ReduceOp.MAX,
                                grid.spatial_group)
            bound = torch.maximum(m[0], m[0] + m[1])

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
        if grid is None:
            w0 = warp_multiflow_planar(mp[:, 0:3], u_p_t0, v_p_t0, out_dtype=f32)
            w1 = warp_multiflow_planar(mp[:, 3:6], u_p_t1, v_p_t1, out_dtype=f32)
        else:
            w0, w1 = warp_spmd.warp_multiflow_sharded(mp, ((u_p_t0, v_p_t0), (u_p_t1, v_p_t1)), blocks,
                                                      unguarded=True)
        t_g = t_values.reshape(1, 1, n_t, 1, 1)
        pred = physics.blend(w0, w1, s2.v_0t[:, None], s2.v_1t[:, None], t_g)
        return pred.permute(0, 2, 3, 4, 1).contiguous(), bound  # (B, n_t, H, W, 3)


def _gathered_pairs(x1):
    """Under a spatial grid, ``(pairs, RowWindow)``: the (BW, 6, h, W) pairs
    of this rank's rows gathered to the whole height from the spatial ranks
    of its data row, channels-last, and the window of its rows in them; None
    without a grid."""
    grid = halo.active()
    if grid is None:
        return None
    blocks = halo.frame_blocks(x1.shape[2], grid)
    H = sum(blocks)
    return halo.gather_rows(x1, blocks, grid=grid), halo.RowWindow(block_start(blocks, grid.spatial_index), 0, H, H)


def model_on(spec: ModelSpec, model_or_state, device: torch.device) -> SuperSloMo:
    """``model_or_state`` if it is a ``SuperSloMo`` on ``device``, else a
    model of ``spec`` on ``device`` loaded with those weights
    (``{"stage1": state_dict, "stage2": state_dict}``)."""
    if isinstance(model_or_state, SuperSloMo):
        if model_or_state.device != device:
            raise ValueError(f"model lies on {model_or_state.device}, not on {device}")
        return model_or_state
    return SuperSloMo(spec, device=device).load_state(model_or_state)
