"""Runtime checks of the readers', the trainer's and the evaluator's inputs
and outputs (a copy of the JAX package's validators)."""

from __future__ import annotations

import numpy as np


def check_t_interp(t) -> None:
    """t strictly inside (0, 1)."""
    t = np.asarray(t)
    if not ((t > 0).all() and (t < 1).all()):
        raise ValueError(f"t_interp values out of (0, 1): [{t.min()}, {t.max()}]")


def check_forward_inputs(frames, targets, t_interp, n_frames: int) -> None:
    """The trainer's forward-pass contract."""
    if frames.shape[1] != n_frames:
        raise ValueError(f"expected {n_frames} input frames, got {frames.shape[1]}")
    if targets is not None and targets.shape[1] != n_frames - 1:
        raise ValueError(
            f"expected {n_frames - 1} targets, got {targets.shape[1]}"
        )
    if np.asarray(t_interp).shape[1] != n_frames - 1:
        raise ValueError("t_interp must have n_frames-1 windows")
    check_t_interp(t_interp)


def check_eval_dims(h: int, w: int) -> None:
    """The U-Net needs /32-divisible spatial dims."""
    if h % 32 or w % 32:
        raise ValueError(f"H, W must be divisible by 32; got {h}x{w}")


def check_clip_window(n_paths: int, window_length: int, reqd_images: int, n_selected: int) -> None:
    """Random-window sampling: the clip list entry must hold DATA.WINDOW_LENGTH
    frames, at least reqd_images of them, and the selected window exactly
    reqd_images."""
    if n_paths != window_length:
        raise ValueError(f"clip has {n_paths} frames but DATA.WINDOW_LENGTH={window_length}")
    if n_paths < reqd_images:
        raise ValueError(f"clip too short: {n_paths} < reqd_images={reqd_images}")
    if n_selected != reqd_images:
        raise ValueError(f"incorrect length of input sequence: {n_selected} != {reqd_images}")


def check_eval_result_count(n_outputs: int, interp_factor: int, dataset: str) -> None:
    """Every non-Vimeo eval batch must produce interp_factor-1 interpolated
    frames per window."""
    if dataset != "VIMEO" and n_outputs != interp_factor - 1:
        raise ValueError(
            f"wrong number of interpolation outputs: {n_outputs} != "
            f"{interp_factor - 1}"
        )
