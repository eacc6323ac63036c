"""What the command lines share: the model's weights per the config's
``[STAGE{1,2}] LOADPREV`` / ``WEIGHTS`` rules, and their arguments as
``torch.distributed.run`` passes them on."""

from __future__ import annotations

import logging
import sys

from superslomo_tpu_torch import weights as wio
from superslomo_tpu_torch.config import Config

log = logging.getLogger(__name__)


def load_model_params(cfg: Config) -> dict:
    """``{"stage1": state_dict, "stage2": state_dict}``: seeded weights
    (``weights.seeded_state`` from ``[SEED] VALUE``), each stage replaced from
    the checkpoint that its ``WEIGHTS`` names when ``LOADPREV`` is set: a
    ``.pt``, or the JAX package's native checkpoint directory (an empty path
    is skipped; a checkpoint read once for both stages; a stage it lacks
    stays seeded)."""
    spec = cfg.model_spec()
    state = wio.seeded_state(spec, seed=cfg.getint("SEED", "VALUE"))
    blobs = {}
    for n, stage in ((1, "stage1"), (2, "stage2")):
        path = cfg.get(f"STAGE{n}", "WEIGHTS")
        if not (cfg.getboolean(f"STAGE{n}", "LOADPREV") and path):
            continue
        if path not in blobs:
            blobs[path] = wio.load_checkpoint(path, spec)
        sd = wio.stage_state_from_checkpoint(blobs[path], stage)
        if sd is not None:
            state[stage] = sd
            log.info("Loaded %s from %s", stage, path)
    return state


def command_args(argv=None) -> list:
    """``argv`` (by default the process's) without a leading ``--``. Under
    ``python -m torch.distributed.run ... -m <command line> -- <arguments>``
    the ``--`` ends torchrun's own options: without it, Python 3.12.3's
    argparse reads an argument such as ``--log`` as an ambiguous abbreviation
    of torchrun's ``--log-dir`` and stops; and that version hands the ``--``
    on to the command line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return argv[1:] if argv[:1] == ["--"] else argv
