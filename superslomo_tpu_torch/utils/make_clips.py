"""Offline clip-list generation (reference: scripts/utils/make_clips.py; the
port's copy of ``superslomo_tpu/utils/make_clips.py``).

Windows each sequence directory into fixed-length overlapping clips and
writes the length-prefixed txt list that the Adobe / NFS readers read: a
line with the frame count, then that many paths.

    python -m superslomo_tpu_torch.utils.make_clips /data/clips out.txt \
        --clip-length 225 --step 65
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from typing import List


def window_sequence(img_paths: List[str], clip_length: int, step: int) -> List[List[str]]:
    """Fixed-length windows ``step`` frames apart; the last window is
    right-aligned, so trailing frames are never dropped."""
    n = len(img_paths)
    if n < clip_length:
        return []
    starts = list(range(0, n - clip_length + 1, step))
    if starts[-1] != n - clip_length:
        starts.append(n - clip_length)
    return [img_paths[s : s + clip_length] for s in starts]


def process_single_dir(seq_dir: str, clip_length: int, step: int) -> List[List[str]]:
    img_paths = sorted(glob.glob(os.path.join(seq_dir, "*.png")) + glob.glob(os.path.join(seq_dir, "*.jpg")))
    return window_sequence(img_paths, clip_length, step)


def write_clip_list(clips: List[List[str]], out_path: str) -> None:
    with open(out_path, "w") as f:
        for clip in clips:
            f.write(f"{len(clip)}\n")
            f.writelines(p + "\n" for p in clip)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("root", help="Directory of sequence subdirectories.")
    parser.add_argument("out", help="Output clip-list txt.")
    parser.add_argument("--clip-length", type=int, default=225)
    parser.add_argument("--step", type=int, default=65, help="Window stride (reference uses 225-160=65).")
    args = parser.parse_args(argv)

    clips = []
    for seq in sorted(os.listdir(args.root)):
        seq_dir = os.path.join(args.root, seq)
        if os.path.isdir(seq_dir):
            clips.extend(process_single_dir(seq_dir, args.clip_length, args.step))
    write_clip_list(clips, args.out)
    print(f"wrote {len(clips)} clips to {args.out}")


if __name__ == "__main__":
    main()
