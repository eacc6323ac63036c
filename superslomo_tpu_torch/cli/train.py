"""Training command line.

    python -m superslomo_tpu_torch.cli.train -c configs/superslomo_original.ini \
        --expt my_run --log train.log [--msg "notes"] [--max-steps N] [--device cpu]

Scalars and images go to TensorBoard when tensorboardX is installed.
"""

from __future__ import annotations

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
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the Trainer."""
    args = getargs(argv)
    logging.basicConfig(filename=args.log, level=logging.INFO)
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.training.trainer import Trainer

    cfg = load_config(args.config)
    cfg.validate()
    np.random.seed(cfg.getint("SEED", "VALUE"))

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logging.warning("tensorboardX unavailable; scalar logging disabled")
    else:
        log_dir = os.path.join(cfg.get("PROJECT", "LOGDIR"), args.expt, "plots")
        os.makedirs(log_dir, exist_ok=True)
        writer = SummaryWriter(log_dir)
        if args.msg:
            writer.add_text("msg", args.msg, 0)

    trainer = Trainer(cfg, expt_name=args.expt, writer=writer, device=args.device)
    try:
        trainer.train(max_steps=args.max_steps)
    finally:
        if writer:
            writer.close()
    logging.info("Training complete.")
    return trainer


if __name__ == "__main__":
    main()
