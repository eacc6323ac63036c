"""Interpolation-quality evaluator: PSNR / SSIM / IE over sliding windows.

Protocol of the JAX package's evaluator: /32-aligned padded dims with a
centre crop back to the input size, 8x interpolation (7 t-values; Sintel-HFR
32x; a single t=0.5 for Vimeo), edge-window trimming by per-sample
``n_avail``, and denormalize → unclipped uint8 → skimage-compatible metrics.
All t-values of a sample run in one fused multi-t step, which takes up to
``step_samples`` samples of a batch.

``run`` reads the ``[DATA] DATASET``'s VAL split through ``get_dataset``,
or takes any iterable of ``(frames, targets, n_avail)`` batches as a reader
yields them (frames (B, N_FRAMES, H_REF, W_REF, 3) and targets (B, n_t,
H_REF, W_REF, 3) of the mid window, normalized and padded). A SuperSloMo-R
model scores its 4-frame windows the same way, each window from a zero
recurrent state.

Across ``world`` data-parallel ranks (``parallel.init_data_parallel``) each
batch is padded to a multiple of ``world`` with its last sample (as the JAX
Evaluator pads to its data axis), each rank runs and scores its contiguous
share, and the per-image scores are gathered in sample order with the
padding left out, so ``results()`` is the single-process one on every rank.
"""

from __future__ import annotations

import itertools
import logging
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from superslomo_tpu_torch import parallel
from superslomo_tpu_torch.config import Config
from superslomo_tpu_torch.data.augmentations import Normalize
from superslomo_tpu_torch.data.readers import get_dataset
from superslomo_tpu_torch.device import resolve_device
from superslomo_tpu_torch.models.superslomo import model_on
from superslomo_tpu_torch.utils.metrics import score_image
from superslomo_tpu_torch.utils.validators import check_eval_result_count, check_t_interp

log = logging.getLogger(__name__)

# The most stage-2 pixels (B·n_t·W_n images of H_REF x W_REF) one fused step
# takes: 14 images of 736x1280, the serving step at B=2, which keeps the H100
# busy 0.998 of the step and peaks at 22.92 GiB in f32 (PERF.md §5). A larger
# batch runs as several steps: the shipped B=8 at 720p in one step needs more
# than the card's 80 GB in f32, and every other step shape costs minutes of
# cuDNN's autotuning there.
STEP_PIXELS = 14 * 736 * 1280


class Evaluator:
    """:param cfg: the evaluation config.
    :param model_or_state: a ``SuperSloMo`` on ``device``, or its weights as
        ``{"stage1": state_dict, "stage2": state_dict}``.
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"``.
    """

    def __init__(self, cfg: Config, model_or_state, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = cfg.get("DATA", "DATASET").upper()
        if self.dataset not in ("SINTEL_HFR", "ADOBE", "SLOWFLOW", "VIMEO"):
            raise ValueError(f"Invalid dataset {self.dataset!r}")
        self.model = model_on(cfg.model_spec(), model_or_state, self.device)
        self.interp_factor = 32 if self.dataset == "SINTEL_HFR" else 8
        (self.H_REF, self.W_REF), (self.H_IN, self.W_IN), (self.H_START, self.W_START) = (
            self.get_dims()
        )
        self.normalize = Normalize(cfg.pixel_mean(), cfg.pixel_std())
        self.psnr, self.ssim, self.ie, self.bounds = [], [], [], []
        self.rank, self.world = parallel.rank(), parallel.world()

        if self.dataset == "VIMEO":
            t_values = np.asarray([0.5], dtype=np.float32)
        else:
            t_values = np.arange(1, self.interp_factor, dtype=np.float32) / self.interp_factor
        check_t_interp(t_values)
        self.t_values = torch.from_numpy(t_values).to(self.device)
        # the most samples one fused step takes: its stage-2 batch within
        # STEP_PIXELS (at 720p, B=8 runs as four steps of 2; the flow bound of
        # a batch is the max of its steps')
        n_windows = self.model.spec.n_frames - 1
        self.step_samples = max(1, STEP_PIXELS // (len(t_values) * n_windows * self.H_REF * self.W_REF))

    def get_dims(self):
        """/32-aligned dims, input dims and crop offsets."""
        section = self.dataset + "_DATA"
        h_in = self.cfg.getint(section, "H_IN")
        w_in = self.cfg.getint(section, "W_IN")
        h_ref = int(np.ceil(h_in / 32) * 32)
        w_ref = int(np.ceil(w_in / 32) * 32)
        return (h_ref, w_ref), (h_in, w_in), ((h_ref - h_in) // 2, (w_ref - w_in) // 2)

    def to_uint8(self, batch: np.ndarray) -> np.ndarray:
        """Crop the /32 pad, denormalize, uint8.

        Deliberately no clipping before the uint8 cast: the reference casts
        unclipped, so out-of-range predictions wrap, and published PSNR /
        SSIM / IE numbers bake that in."""
        batch = batch[
            :,
            self.H_START : self.H_START + self.H_IN,
            self.W_START : self.W_START + self.W_IN,
            :,
        ]
        return self.normalize.inverse(batch).astype(np.uint8)

    def _share(self, frames, targets, n_avail):
        """This rank's contiguous share of a batch padded to a multiple of
        ``world`` with its last sample: the frames it runs, and the targets
        and ``n_avail`` of the real samples among them."""
        B = len(frames)
        pad = -B % self.world
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
        per = (B + pad) // self.world
        lo = self.rank * per
        return frames[lo:lo + per], targets[lo:lo + per], np.asarray(n_avail)[lo:lo + per]

    def _submit(self, frames, targets, n_avail):
        """Launch one batch's fused steps (``step_samples`` samples each; this
        rank's share across ranks) and their copy back to the host without
        waiting: the card computes while the host scores the previous batch."""
        if self.world > 1:
            frames, targets, n_avail = self._share(frames, targets, n_avail)
        cuda = self.device.type == "cuda"
        frames = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32))
        if cuda:
            frames = frames.pin_memory()
        frames = frames.to(self.device, non_blocking=True)
        steps = [self.model.interpolate_multi_t(f, self.t_values, with_bounds=True)
                 for f in frames.split(self.step_samples)]
        out = steps[0][0] if len(steps) == 1 else torch.cat([o for o, _ in steps])
        bound = torch.stack([b for _, b in steps]).amax()
        if not cuda:
            return out, bound, None, targets, n_avail
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in (out, bound)]
        for h, x in zip(host, (out, bound)):
            h.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done, targets, n_avail

    def _score(self, pending) -> None:
        """Wait for one submitted batch's copy and score it."""
        out, bound, done, targets, n_avail = pending
        if done is not None:
            done.synchronize()
        out = out.numpy()  # (B, n_t, H, W, 3)
        check_eval_result_count(out.shape[1], self.interp_factor, self.dataset)

        scores = []  # (PSNR, SSIM, IE) an image, in sample order
        n_avail = np.asarray(n_avail).tolist()
        if n_avail:
            preds = self.to_uint8(np.concatenate([out[i, :n] for i, n in enumerate(n_avail)], axis=0))
            gts = self.to_uint8(np.concatenate([targets[i, :n] for i, n in enumerate(n_avail)], axis=0))
            scores = [score_image(g, p) for p, g in zip(preds, gts)]
        bound = float(bound)
        if self.world > 1:  # every rank's share, in rank order
            shares = [None] * self.world
            dist.all_gather_object(shares, (scores, bound))
            scores = [s for share, _ in shares for s in share]
            bound = max(b for _, b in shares)
        self.bounds.append(bound)
        log.debug("flow bound %.2f px", bound)
        for ps, ss, ie in scores:
            self.psnr.append(ps)
            self.ssim.append(ss)
            self.ie.append(ie)

    def eval_batch(self, frames: np.ndarray, targets: np.ndarray, n_avail: np.ndarray):
        """One batch, submitted and scored back to back."""
        self._score(self._submit(frames, targets, n_avail))

    def results(self) -> dict:
        return {
            "PSNR": float(np.mean(self.psnr)),
            "IE": float(np.mean(self.ie)),
            "SSIM": float(np.mean(self.ssim)),
            "n_images": len(self.psnr),
            "max_flow_bound": max(self.bounds),
        }

    def run(self, batches: Optional[Iterable] = None, max_batches: Optional[int] = None) -> dict:
        """Pipelined loop over ``(frames, targets, n_avail)`` batches (by
        default ``get_dataset(cfg, "VAL")``), stopping after ``max_batches``:
        batch k+1 is launched before batch k is copied back and scored."""
        if batches is None:
            batches = get_dataset(self.cfg, "VAL")
        pending = None
        for i, (frames, targets, n_avail) in enumerate(itertools.islice(batches, max_batches)):
            submitted = self._submit(frames, targets, n_avail)
            if pending is not None:
                self._score(pending)
                if (i - 1) % 10 == 0:
                    log.info(
                        "batch %d  PSNR %.3f  IE %.3f  SSIM %.3f",
                        i - 1, np.mean(self.psnr), np.mean(self.ie), np.mean(self.ssim),
                    )
            pending = submitted
        if pending is not None:
            self._score(pending)
        results = self.results()
        log.info("Final: %s", results)
        return results
