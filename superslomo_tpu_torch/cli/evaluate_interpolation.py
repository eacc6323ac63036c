"""Interpolation evaluation command line: PSNR / SSIM / IE over the config's
VAL split, printed as one JSON line.

    python -m superslomo_tpu_torch.cli.evaluate_interpolation -c eval.ini \
        --expt my_eval --log eval.log [--max-batches N] [--device cpu]
"""

from __future__ import annotations

import json
import logging
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--expt", required=True)
    parser.add_argument("--log", required=True)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(filename=args.log, level=logging.INFO)

    from superslomo_tpu_torch.cli.common import load_model_params
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.eval.evaluate_interpolation import Evaluator

    cfg = load_config(args.config)
    cfg.validate()
    results = Evaluator(cfg, load_model_params(cfg), device=args.device).run(max_batches=args.max_batches)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
