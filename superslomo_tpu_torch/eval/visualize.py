"""Slow-motion renderer (reference: scripts/visualize_interpolation.py), as in
the JAX package.

Globs a directory of PNG and JPEG frames, optionally decimates 240 fps
input to 30 fps (``[::8]``), slides an N_FRAMES window with edge clamping,
pads each frame to /32 dims, and writes the original plus
``upsample_rate - 1`` interpolated PNGs a frame pair, made by ONE fused
multi-t step a window. A recurrent model
renders each window from a zero state, as the JAX renderer does. With
``dump_intermediates`` it also writes the visibility map and the estimated
and refined flows' Middlebury colourings of each window at t=0.5.

Frames are read by ``data/image.py`` (PNG or JPEG, no cv2) and written by
``data/png.py``.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional

import numpy as np
import torch

from superslomo_tpu_torch.config import Config
from superslomo_tpu_torch.data.augmentations import Normalize, eval_padding_for
from superslomo_tpu_torch.data.image import imread
from superslomo_tpu_torch.data.png import imwrite
from superslomo_tpu_torch.device import resolve_device
from superslomo_tpu_torch.models.superslomo import model_on
from superslomo_tpu_torch.utils.flo import flow_to_image

log = logging.getLogger(__name__)


class Interpolator:
    """:param cfg: the config (its model, N_FRAMES and pixel statistics).
    :param model_or_state: a ``SuperSloMo`` on ``device``, or its weights.
    :param upsample_rate: frames out per frame pair in (8: 7 renders).
    :param dump_intermediates: also write the visibility map and the flows.
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"``.
    """

    def __init__(self, cfg: Config, model_or_state, upsample_rate: int = 8, dump_intermediates: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.model = model_on(cfg.model_spec(), model_or_state, self.device)
        self.rate = upsample_rate
        self.dump_intermediates = dump_intermediates
        self.n_frames = cfg.getint("TRAIN", "N_FRAMES")
        self.normalize = Normalize(cfg.pixel_mean(), cfg.pixel_std())
        self.t_values = torch.arange(1, self.rate, dtype=torch.float32, device=self.device) / self.rate

    # -- IO ------------------------------------------------------------ #
    def load_frames(self, paths) -> np.ndarray:
        """Decode ``paths`` → (N, H_ref, W_ref, 3) normalized, padded float32;
        keeps the raw uint8 decode in ``last_raw`` (the originals are written
        from it bit for bit: a normalize → denormalize round trip can flip a
        pixel under the truncating cast) and the padding in ``pad``."""
        self.last_raw = np.stack([imread(p) for p in paths])  # (N, H, W, 3) RGB uint8
        frames = self.last_raw.astype(np.float32)
        h, w = frames.shape[1:3]
        self.pad = eval_padding_for(h, w)
        left, right, top, bottom = self.pad
        frames = np.pad(frames, ((0, 0), (top, bottom), (left, right), (0, 0)))
        self.h_in, self.w_in = h, w
        return self.normalize(frames)

    def to_uint8(self, img: np.ndarray) -> np.ndarray:
        """Crop the pad, denormalize, clip to 0-255, cast (truncating)."""
        left, right, top, bottom = self.pad
        img = img[top : top + self.h_in, left : left + self.w_in]
        return np.clip(self.normalize.inverse(img), 0, 255).astype(np.uint8)

    # -- sliding window over the clip ----------------------------------- #
    def sliding_windows(self, n_images: int):
        """Window index lists with edge clamping
        (visualize_interpolation.py:270-288)."""
        half = self.n_frames // 2
        for mid_left in range(n_images - 1):
            yield [min(max(i, 0), n_images - 1) for i in range(mid_left - half + 1, mid_left + half + 1)]

    def frame_paths(self, input_dir: str, decimate: bool = False) -> list:
        """The directory's ``*.png`` and ``*.jpg`` files, sorted; every 8th
        with ``decimate`` (240 fps → 30 fps)."""
        paths = sorted(glob.glob(os.path.join(input_dir, "*.png")) + glob.glob(os.path.join(input_dir, "*.jpg")))
        return paths[::8] if decimate else paths

    def interpolate_directory(self, input_dir: str, output_dir: str, decimate: bool = False,
                              max_windows: Optional[int] = None) -> int:
        """Render ``input_dir``'s clip into ``output_dir`` as ``%06d.png``
        (the first ``max_windows`` windows, then the clip's last frame);
        returns the number of frames written."""
        paths = self.frame_paths(input_dir, decimate)
        os.makedirs(output_dir, exist_ok=True)
        if self.dump_intermediates:
            for d in ("visibility", "flow_est", "flow_refined"):
                os.makedirs(os.path.join(output_dir, d), exist_ok=True)

        count = 0
        n_out = 0
        for idxs in self.sliding_windows(len(paths)):
            frames = self.load_frames([paths[i] for i in idxs])[None]  # (1, N, H, W, 3)
            # the mid window's left original, from the raw decode
            imwrite(os.path.join(output_dir, f"{n_out:06d}.png"), self.last_raw[self.n_frames // 2 - 1])
            n_out += 1
            frames = torch.from_numpy(frames).to(self.device)
            preds = self.model.interpolate_multi_t(frames, self.t_values)[0].cpu().numpy()
            for k in range(preds.shape[0]):
                imwrite(os.path.join(output_dir, f"{n_out:06d}.png"), self.to_uint8(preds[k]))
                n_out += 1
            if self.dump_intermediates:
                self._dump_intermediates(frames, output_dir, count)
            count += 1
            if max_windows is not None and count >= max_windows:
                break
        # the clip's last frame, from the raw decode
        if paths:
            self.load_frames([paths[-1]])
            imwrite(os.path.join(output_dir, f"{n_out:06d}.png"), self.last_raw[0])
            n_out += 1
        return n_out

    def _dump_intermediates(self, frames, output_dir, index):
        """The window's visibility map v_0t (grey, ``v * 255`` truncated) and
        the estimated and refined flows F_t0 (colour-coded), at t=0.5, padded
        dims."""
        t = torch.full((1, self.n_frames - 1), 0.5, device=self.device)
        _, inter, _ = self.model.forward_inference(frames, t)
        vis = inter.v_0t[0, ..., 0].cpu().numpy() * 255.0
        imwrite(os.path.join(output_dir, "visibility", f"{index:06d}.png"), vis.astype(np.uint8))
        imwrite(os.path.join(output_dir, "flow_est", f"{index:06d}.png"),
                flow_to_image(inter.est_flow_t0[0].cpu().numpy()))
        imwrite(os.path.join(output_dir, "flow_refined", f"{index:06d}.png"),
                flow_to_image(inter.refined_flow_t0[0].cpu().numpy()))
