"""Training command line.

    python -m superslomo_tpu_torch.cli.train -c configs/superslomo_original.ini \
        --expt my_run --log train.log [--msg "notes"] [--max-steps N] [--device cpu]

Data parallel, one process a card (the configured BATCH_SIZE is the global
batch; ``--device cpu`` runs the ranks on the CPU over gloo):

    python -m torch.distributed.run --nproc-per-node N -m superslomo_tpu_torch.cli.train -- \
        -c configs/superslomo_original.ini --expt my_run --log train.log [--dist-backend gloo]

(the ``--`` keeps torchrun from reading ``--log`` as its own option).

Rank 0 logs, writes TensorBoard scalars and images (when tensorboardX is
installed) and checkpoints, and prints the last step's losses as one JSON
line.
"""

from __future__ import annotations

import json
import logging
import os
from argparse import ArgumentParser

import numpy as np


def getargs(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True, help="Path to config.ini file.")
    parser.add_argument("--expt", required=True, help="Experiment Name.")
    parser.add_argument("--log", required=True, help="Path to log file.")
    parser.add_argument("--msg", help="(Optional) experiment notes for TensorBoard.")
    parser.add_argument("--max-steps", type=int, default=None, help="Optional step cap (smoke runs).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="Under torch.distributed.run: the process group's backend (default: nccl on "
                             "the card, gloo on the CPU).")
    from superslomo_tpu_torch.cli.common import command_args

    return parser.parse_args(command_args(argv))


def _writer(cfg, args):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logging.warning("tensorboardX unavailable; scalar logging disabled")
        return None
    log_dir = os.path.join(cfg.get("PROJECT", "LOGDIR"), args.expt, "plots")
    os.makedirs(log_dir, exist_ok=True)
    writer = SummaryWriter(log_dir)
    if args.msg:
        writer.add_text("msg", args.msg, 0)
    return writer


def main(argv=None):
    """Train; returns the Trainer."""
    args = getargs(argv)
    from superslomo_tpu_torch import parallel
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.training.trainer import Trainer

    main_rank = os.environ.get("RANK", "0") == "0"  # torchrun's rank, known before the group forms
    if main_rank:
        logging.basicConfig(filename=args.log, level=logging.INFO)
    with parallel.launched(args.device, args.dist_backend) as device:
        cfg = load_config(args.config)
        cfg.validate()
        np.random.seed(cfg.getint("SEED", "VALUE"))
        writer = _writer(cfg, args) if main_rank else None
        trainer = Trainer(cfg, expt_name=args.expt, writer=writer, device=device)
        try:
            last = trainer.train(max_steps=args.max_steps)
        finally:
            if writer:
                writer.close()
        logging.info("Training complete.")
        if main_rank:
            print(json.dumps({"epoch": trainer.epoch, "step": trainer.step,
                              "loss": None if last is None else np.asarray(last).tolist()}), flush=True)
    return trainer


if __name__ == "__main__":
    main()
