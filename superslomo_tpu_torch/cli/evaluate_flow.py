"""Optical-flow EPE evaluation command line (reference:
scripts/evaluate_optical_flow_results.py:10-13, :31-77): the config's
Sintel samples scored, printed as one JSON line.

    python -m superslomo_tpu_torch.cli.evaluate_flow -c eval.ini --log epe.log \
        [--max-samples N] [--device cpu]
"""

from __future__ import annotations

import json
import logging
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--log", required=True)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(filename=args.log, level=logging.INFO)

    from superslomo_tpu_torch.cli.common import load_model_params
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.eval.evaluate_flow import evaluate_flow

    cfg = load_config(args.config)
    results = evaluate_flow(cfg, load_model_params(cfg), max_samples=args.max_samples, device=args.device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
