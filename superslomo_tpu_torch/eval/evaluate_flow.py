"""Optical-flow EPE evaluator (reference:
scripts/evaluate_optical_flow_results.py), as in the JAX package.

Runs the model's forward at t=0.5 over each Sintel window of
``SintelFlowReader``, takes the stage-1 forward flow F_01 of the mid window,
strips the 6-row pad (436 → 448 rows), and scores the end-point error and
the share of pixels more than 3 px off against the ground-truth .flo.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from superslomo_tpu_torch.config import Config
from superslomo_tpu_torch.data.readers import SintelFlowReader
from superslomo_tpu_torch.device import resolve_device
from superslomo_tpu_torch.models.superslomo import mid_window, model_on
from superslomo_tpu_torch.utils.flo import flow_epe, flow_error_percent

log = logging.getLogger(__name__)


def evaluate_flow(cfg: Config, model_or_state, max_samples: Optional[int] = None, device=None) -> dict:
    """``{"EPE", "gt3px_percent", "n_samples"}`` over the config's Sintel
    samples (the first ``max_samples``).

    :param model_or_state: a ``SuperSloMo`` on ``device``, or its weights.
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"``.
    """
    device = resolve_device(device)
    model = model_on(cfg.model_spec(), model_or_state, device)
    reader = SintelFlowReader(cfg)
    t = torch.full((1, cfg.getint("TRAIN", "N_FRAMES") - 1), 0.5, device=device)
    epes, pct3 = [], []
    for i in range(len(reader)):
        frames, gt_flow = reader[i]
        with torch.inference_mode():
            out = model(torch.from_numpy(frames[None]).to(device), t)
            pred = out.flowC_out[0, mid_window(out), ..., 0:2].cpu().numpy()  # F_01
        pred = pred[6 : 6 + gt_flow.shape[0]]  # strip the 436 → 448 pad
        epes.append(flow_epe(gt_flow, pred))
        pct3.append(flow_error_percent(gt_flow, pred))
        if i % 50 == 0:
            log.info("sample %d  EPE %.3f  >3px %.2f%%", i, np.mean(epes), np.mean(pct3))
        if max_samples is not None and i + 1 >= max_samples:
            break
    results = {"EPE": float(np.mean(epes)), "gt3px_percent": float(np.mean(pct3)), "n_samples": len(epes)}
    log.info("Final: %s", results)
    return results
