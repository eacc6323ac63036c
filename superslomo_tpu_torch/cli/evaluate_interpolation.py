"""Interpolation evaluation command line: PSNR / SSIM / IE over the config's
VAL split, printed as one JSON line.

    python -m superslomo_tpu_torch.cli.evaluate_interpolation -c eval.ini \
        --expt my_eval --log eval.log [--max-batches N] [--device cpu]

Data parallel, one process a card, each rank scoring its share of every
batch (rank 0 logs and prints; ``--device cpu`` runs the ranks on the CPU
over gloo):

    python -m torch.distributed.run --nproc-per-node N \
        -m superslomo_tpu_torch.cli.evaluate_interpolation -- -c eval.ini --expt e --log eval.log
"""

from __future__ import annotations

import json
import logging
import os
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--expt", required=True)
    parser.add_argument("--log", required=True)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="Under torch.distributed.run: the process group's backend (default: nccl on "
                             "the card, gloo on the CPU).")
    from superslomo_tpu_torch import parallel
    from superslomo_tpu_torch.cli.common import command_args, load_model_params
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.eval.evaluate_interpolation import Evaluator

    args = parser.parse_args(command_args(argv))
    main_rank = os.environ.get("RANK", "0") == "0"  # torchrun's rank, known before the group forms
    if main_rank:
        logging.basicConfig(filename=args.log, level=logging.INFO)
    with parallel.launched(args.device, args.dist_backend) as device:
        cfg = load_config(args.config)
        cfg.validate()
        results = Evaluator(cfg, load_model_params(cfg), device=device).run(max_batches=args.max_batches)
        if main_rank:
            print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
