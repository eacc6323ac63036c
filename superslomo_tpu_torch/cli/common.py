"""What the command lines share: the model's weights per the config's
``[STAGE{1,2}] LOADPREV`` / ``WEIGHTS`` rules."""

from __future__ import annotations

import logging

from superslomo_tpu_torch import weights as wio
from superslomo_tpu_torch.config import Config

log = logging.getLogger(__name__)


def load_model_params(cfg: Config) -> dict:
    """``{"stage1": state_dict, "stage2": state_dict}``: seeded weights
    (``weights.seeded_state`` from ``[SEED] VALUE``), each stage replaced from
    the ``.pt`` that its ``WEIGHTS`` names when ``LOADPREV`` is set (an empty
    path is skipped; a file read once for both stages; a stage the file lacks
    stays seeded). A directory, the JAX package's native checkpoint, raises
    NotImplementedError."""
    state = wio.seeded_state(cfg.model_spec(), seed=cfg.getint("SEED", "VALUE"))
    blobs = {}
    for n, stage in ((1, "stage1"), (2, "stage2")):
        path = cfg.get(f"STAGE{n}", "WEIGHTS")
        if not (cfg.getboolean(f"STAGE{n}", "LOADPREV") and path):
            continue
        if path not in blobs:
            blobs[path] = wio.load_checkpoint(path)
        sd = wio.stage_state_from_checkpoint(blobs[path], stage)
        if sd is not None:
            state[stage] = sd
            log.info("Loaded %s from %s", stage, path)
    return state
