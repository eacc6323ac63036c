"""Runtime checks of the trainer's and the evaluator's inputs and outputs (a
copy of the JAX package's ``check_t_interp``, ``check_forward_inputs`` and
``check_eval_result_count``)."""

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


def check_eval_result_count(n_outputs: int, interp_factor: int, dataset: str) -> None:
    """Every non-Vimeo eval batch must produce interp_factor-1 interpolated
    frames per window."""
    if dataset != "VIMEO" and n_outputs != interp_factor - 1:
        raise ValueError(
            f"wrong number of interpolation outputs: {n_outputs} != "
            f"{interp_factor - 1}"
        )
