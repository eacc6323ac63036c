"""Convert reference PyTorch checkpoints for the JAX package, with its
converter's arguments and output (``superslomo_tpu/cli/convert_checkpoint.py``).

    python -m superslomo_tpu_torch.cli.convert_checkpoint superslomo.pt out_dir/
    python -m superslomo_tpu_torch.cli.convert_checkpoint --vgg16 vgg16.pth vgg16.npz

The first form writes a native checkpoint directory of the ``.pt``'s weights
(``stage1.msgpack``, ``stage2.msgpack``, and ``meta.json`` naming the
source; a stage the ``.pt`` lacks as an empty map). The second writes
torchvision VGG-16's ``features.*`` of index below 23 (up to relu4_3) to the
``.npz`` that ``[TRAIN] VGG_WEIGHTS`` names. Both read the file as a state
dict (``torch.load(weights_only=True)``) and run on the host only.
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch


def torch_stages(path: str) -> dict:
    """``{stage: state_dict}`` of a reference ``.pt``: its
    ``stage{N}_state_dict`` entries, or the whole file as stage 1's state
    dict; BatchNorm's ``num_batches_tracked`` counters left out."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "stage1_state_dict" in blob or "stage2_state_dict" in blob:
        stages = {s: blob[f"{s}_state_dict"] for s in ("stage1", "stage2") if f"{s}_state_dict" in blob}
    else:
        stages = {"stage1": blob}
    return {s: {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")} for s, sd in stages.items()}


def convert_vgg16(path: str, out_path: str) -> str:
    """torchvision VGG-16's ``features.{i}.*`` with i < 23 → ``out_path`` (.npz)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    arrays = {k: v.numpy() for k, v in sd.items() if k.startswith("features.") and int(k.split(".")[1]) < 23}
    np.savez(out_path, **arrays)
    return out_path


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("src", help="Input .pt/.pth")
    parser.add_argument("dst", help="Output checkpoint dir (or .npz for --vgg16)")
    parser.add_argument("--vgg16", action="store_true", help="Convert a torchvision vgg16 state_dict instead.")
    args = parser.parse_args(argv)

    if args.vgg16:
        print(f"wrote {convert_vgg16(args.src, args.dst)}")
        return
    from superslomo_tpu_torch.training.checkpoint import save_native_checkpoint

    save_native_checkpoint(args.dst, torch_stages(args.src), meta={"source": args.src})
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
