"""Runtime checks of the evaluator's inputs and outputs (a copy of the JAX
package's ``check_t_interp`` and ``check_eval_result_count``)."""

from __future__ import annotations

import numpy as np


def check_t_interp(t) -> None:
    """t strictly inside (0, 1)."""
    t = np.asarray(t)
    if not ((t > 0).all() and (t < 1).all()):
        raise ValueError(f"t_interp values out of (0, 1): [{t.min()}, {t.max()}]")


def check_eval_result_count(n_outputs: int, interp_factor: int, dataset: str) -> None:
    """Every non-Vimeo eval batch must produce interp_factor-1 interpolated
    frames per window."""
    if dataset != "VIMEO" and n_outputs != interp_factor - 1:
        raise ValueError(
            f"wrong number of interpolation outputs: {n_outputs} != "
            f"{interp_factor - 1}"
        )
