"""Slow-motion rendering command line (reference:
scripts/visualize_interpolation.py:19-44, :291-301).

    python -m superslomo_tpu_torch.cli.visualize -c config.ini \
        --input-dir frames/ --output-dir slomo/ --upsample-rate 8 \
        [--decimate] [--dump-intermediates] [--device cpu]
"""

from __future__ import annotations

import logging
from argparse import ArgumentParser


def main(argv=None):
    """Render; prints and returns ``wrote N frames to DIR``."""
    parser = ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--input-dir", required=True, help="Directory of frames.")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--upsample-rate", type=int, default=8)
    parser.add_argument("--decimate", action="store_true", help="Decimate 240fps input to 30fps first ([::8]).")
    parser.add_argument("--dump-intermediates", action="store_true",
                        help="Also write visibility maps and flow colorings.")
    parser.add_argument("--log", default="visualize.log")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(filename=args.log, level=logging.INFO)

    from superslomo_tpu_torch.cli.common import load_model_params
    from superslomo_tpu_torch.config import load_config
    from superslomo_tpu_torch.eval.visualize import Interpolator

    cfg = load_config(args.config)
    interp = Interpolator(cfg, load_model_params(cfg), upsample_rate=args.upsample_rate,
                          dump_intermediates=args.dump_intermediates, device=args.device)
    n = interp.interpolate_directory(args.input_dir, args.output_dir, decimate=args.decimate)
    message = f"wrote {n} frames to {args.output_dir}"
    print(message, flush=True)
    return message


if __name__ == "__main__":
    main()
