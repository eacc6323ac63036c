"""Dataset readers, a copy of the JAX package's: Adobe240fps, NFS, the Vimeo
septuplets, Slowflow, Sintel-HFR and the combined train set, with
``build_reader`` and ``get_dataset``.

* window sampling over 240 fps clips: REQD_IMAGES {2: 9, 4: 25, 6: 41, 8: 57}
  frames a sample, interp_factor 8 (32 for Sintel-HFR);
* train: a random sub-window (ADOBE / NFS), 50% temporal reversal, RANDOM or
  MIDDLE t shared across windows, t = idx / 8;
* eval: sliding windows with edge replication and per-window counts of valid
  targets;
* frames decoded by ``data/image.py`` (PNG or JPEG, EXIF orientation
  applied) to RGB, vertical videos swapped back;
* Vimeo's septuplet index tables for train and eval.

Samples are NHWC float32 arrays; every random draw comes from the
``np.random.Generator`` passed in (the Loader gives each item its own).
``SintelFlowReader`` reads the Sintel optical-flow (EPE) layout: frame
windows and their ground-truth ``.flo``.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np

from superslomo_tpu_torch.data.augmentations import Compose, EvalPad, Normalize, RandomCrop, ToFloatArray
from superslomo_tpu_torch.data.pipeline import Loader
from superslomo_tpu_torch.data.image import imread
from superslomo_tpu_torch.utils.flo import read_flo
from superslomo_tpu_torch.utils.validators import check_clip_window

log = logging.getLogger(__name__)

REQD_IMAGES = {2: 9, 4: 25, 6: 41, 8: 57}  # default_reader.py:36
REQD_IMAGES_HFR = {2: 33, 4: 97, 6: 161, 8: 225}  # sintel_hfr.py:25
REQD_IMAGES_VIMEO = {2: 3, 4: 7}  # vimeo.py:16


def read_clip_list_file(fpath: str) -> List[List[str]]:
    """Parse the length-prefixed clip list format (adobe_240fps.py:20-39):
    a line with the frame count, followed by that many path lines.

    Any bare-integer line is accepted as a count — unlike the reference's
    ``len(line) <= 2`` heuristic, which silently drops clips of >= 100
    frames and therefore cannot read the output of its own make_clips tool
    at the default 225-frame clip length (make_clips.py:67-95). Reference-
    format files (counts of 1-2 digits) parse identically; path lines are
    never all-digits, so the wider rule is unambiguous."""
    with open(fpath) as f:
        lines = [l.strip() for l in f.readlines()]
    clips = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.isdigit():
            n = int(line)
            clips.append(lines[i + 1 : i + 1 + n])
            i += 1 + n
        else:
            i += 1
    return clips


class Reader:
    """Base reader: sampling logic shared by the concrete datasets."""

    def __init__(self, cfg, split: str = "TRAIN", eval_mode: bool = False,
                 rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.split = split
        self.eval_mode = eval_mode
        self.rng = rng or np.random.default_rng()
        self.dataset_name = cfg.get("DATA", "DATASET")
        self.interp_factor = 32 if self.dataset_name == "SINTEL_HFR" else 8
        self.n_frames = cfg.getint("TRAIN", "N_FRAMES")
        self.window_length = cfg.getint("DATA", "WINDOW_LENGTH")
        self.reqd_images = REQD_IMAGES[self.n_frames]
        self.t_sample = cfg.get("DATALOADER", "T_SAMPLE")
        self.clips: list = []
        self.transform = self.build_transform()

    # -- construction helpers ------------------------------------------------
    def build_transform(self):
        mean, std = self.cfg.pixel_mean(), self.cfg.pixel_std()
        if self.eval_mode:
            # ADOBE eval pad 720→736 (default_reader.py:270)
            return Compose([Normalize(mean, std), ToFloatArray(),
                            EvalPad(padding=(0, 0, 8, 8))])
        crop = (self.cfg.getint(self.split, "CROP_IMH"),
                self.cfg.getint(self.split, "CROP_IMW"))
        return Compose([RandomCrop(crop, rng=self.rng), Normalize(mean, std),
                        ToFloatArray()])

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        """``rng``: per-item generator (the Loader spawns one per (seed,
        epoch, index)); falls back to the shared self.rng for direct
        single-threaded use. NumPy Generators are not thread-safe, so
        concurrent loader threads must never share one — the reference's
        analogue is per-worker-process reseeding (default_reader.py:306)."""
        if self.eval_mode:
            return self.get_inference_item(idx)
        return self.get_train_item(idx, rng=rng)

    # -- sample IO -----------------------------------------------------------
    def read_sample(self, img_paths: Sequence[str], indexes: Sequence[int]) -> np.ndarray:
        """Decode the selected frames → (N, H, W, 3) RGB in a float64 buffer:
        Normalize then computes in float64 and rounds to float32 once (bit
        parity with the JAX package's cv2 decode, whose BGR frames it
        reverses to these values)."""
        paths = [img_paths[i] for i in indexes]
        first = imread(paths[0])
        h, w, c = first.shape
        frames = np.empty((len(paths), h, w, c), dtype=np.float64)
        frames[0] = first
        for i, p in enumerate(paths[1:], start=1):
            frames[i] = imread(p)
        if h > w:  # vertical videos are stored flipped
            frames = frames.swapaxes(1, 2)
        return frames

    # -- train sampling --------------------------------------------------------
    def get_random_window_in_clip(
        self, img_paths: Sequence[str], rng: np.random.Generator
    ) -> Sequence[str]:
        start = int(rng.integers(0, len(img_paths) - self.reqd_images + 1))
        window = img_paths[start : start + self.reqd_images]
        # reference validators.py:30-38 (clip lists come from make_clips with
        # a fixed per-entry length; a mismatch means a stale DATA section)
        check_clip_window(len(img_paths), self.window_length,
                          self.reqd_images, len(window))
        return window

    def get_train_item_indexes(self, rng: np.random.Generator):
        """(input indexes, target indexes in clip, sampled t indexes 1..7)
        (default_reader.py:153-180)."""
        assert self.interp_factor == 8, "training expects 240FPS input"
        input_idx = [i * self.interp_factor for i in range(self.n_frames)]
        if self.t_sample == "RANDOM":
            sampled = [int(rng.integers(1, self.interp_factor))] * (self.n_frames - 1)
        elif self.t_sample == "MIDDLE":
            sampled = [self.interp_factor // 2] * (self.n_frames - 1)
        else:
            raise NotImplementedError(f"T_SAMPLE={self.t_sample}")
        target_idx = [t + i * self.interp_factor for i, t in enumerate(sampled)]
        return input_idx, target_idx, sampled

    def get_train_item(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else self.rng
        img_paths = self.clips[idx]
        if self.dataset_name in ("ADOBE", "NFS") or (
            self.dataset_name == "ALL" and len(img_paths) > self.reqd_images
        ):
            img_paths = self.get_random_window_in_clip(img_paths, rng)
        if rng.integers(0, 2) == 1:  # 50% temporal reversal
            img_paths = img_paths[::-1]
        input_idx, target_idx, sampled = self.get_train_item_indexes(rng)
        sample = self.read_sample(img_paths, list(input_idx) + list(target_idx))
        sample = self.transform(sample, rng=rng)
        inputs = sample[: self.n_frames]
        targets = sample[self.n_frames :]
        t_interp = np.asarray(sampled, dtype=np.float32) / 8.0  # (T-1,)
        return inputs, targets, t_interp

    # -- eval sampling ---------------------------------------------------------
    def get_inference_item_indexes(self):
        """Input frames every interp_factor; all mid-window frames are ground
        truth (default_reader.py:130-151)."""
        assert self.t_sample == "NIL"
        input_idx = [i * self.interp_factor for i in range(self.n_frames)]
        mid = len(input_idx) // 2 - 1
        gt_idx = list(range(input_idx[mid] + 1, input_idx[mid + 1]))
        return input_idx, gt_idx

    def get_inference_item(self, idx: int):
        img_paths, n_targets = self.clips[idx]
        input_idx, target_idx = self.get_inference_item_indexes()
        sample = self.read_sample(img_paths, list(input_idx) + list(target_idx))
        sample = self.transform(sample)
        return sample[: self.n_frames], sample[self.n_frames :], int(n_targets)

    def pad_clip_edges(self, indexes: List[int]):
        """Edge replication so every original frame falls inside some window
        (default_reader.py:209-231)."""
        k = self.interp_factor
        left = k * (self.n_frames // 2 - 1)
        right = k * (self.n_frames // 2 - 1)
        last = len(indexes) - 1
        if last % k == 0:
            n_last = k - 1
        else:
            n_last = last % k
            right += k - n_last
        last_input = (last // k) * k
        padded = [0] * left + indexes + [indexes[last_input]] * right
        return padded, n_last

    def generate_sliding_windows(self, img_paths: Sequence[str]):
        """Yield (window paths, n valid targets) with step = interp_factor
        (default_reader.py:233-248)."""
        indexes, n_last = self.pad_clip_edges(list(range(len(img_paths))))
        windows = [
            indexes[i : i + self.reqd_images]
            for i in range(0, len(indexes) - self.reqd_images + 1, self.interp_factor)
        ]
        for wi, window in enumerate(windows):
            paths = [img_paths[i] for i in window]
            yield paths, (n_last if wi == len(windows) - 1 else self.interp_factor - 1)

    def _glob_sliding_clips(self, src_dir: str):
        data = []
        for clip in sorted(glob.glob(os.path.join(src_dir, "*"))):
            img_paths = sorted(glob.glob(os.path.join(clip, "*.png")))
            if not img_paths:
                continue
            data.extend(self.generate_sliding_windows(img_paths))
        return data


class AdobeReader(Reader):
    """Adobe240fps (adobe_240fps.py)."""

    def __init__(self, cfg, split="TRAIN", eval_mode=False, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        if eval_mode:
            with open(cfg.get("ADOBE_DATA", split + "_CLIPS"), "rb") as f:
                clip_names = pickle.load(f)
            src = cfg.get("ADOBE_DATA", "ROOTDIR")
            self.clips = []
            for name in sorted(clip_names):
                img_paths = sorted(glob.glob(os.path.join(src, name, "*.png")))
                self.clips.extend(self.generate_sliding_windows(img_paths))
        else:
            self.clips = read_clip_list_file(cfg.get("ADOBE_DATA", split + "PATHS"))


class NFSReader(Reader):
    """Need-for-Speed 240fps, train only (nfs.py)."""

    def __init__(self, cfg, split="TRAIN", eval_mode=False, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        self.clips = read_clip_list_file(cfg.get("NFS_DATA", "TRAINPATHS"))


class VimeoReader(Reader):
    """Vimeo septuplets (vimeo.py): 7-frame 30fps clips, fixed t = 0.5."""

    def __init__(self, cfg, split="TRAIN", eval_mode=False, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        if self.n_frames not in REQD_IMAGES_VIMEO:
            raise ValueError("Vimeo supports N_FRAMES in {2, 4}")
        self.reqd_images = REQD_IMAGES_VIMEO[self.n_frames]
        self.t_sample_mode = "FIXED"
        self.transform = self.build_transform()
        src = cfg.get("VIMEO_DATA", "ROOTDIR")
        key = "VALPATHS" if eval_mode else "TRAINPATHS"
        with open(cfg.get("VIMEO_DATA", key)) as f:
            sequences = [l.strip() for l in f if l.strip()]
        if eval_mode:
            self.clips = []
            for seq in sequences:
                imgs = [os.path.join(src, "sequences", seq, f"im{i}.png") for i in range(1, 8)]
                if self.n_frames == 4:  # vimeo.py:64-67
                    picks = ([0, 0, 1, 2, 4], [0, 2, 3, 4, 6], [2, 4, 5, 6, 6])
                else:  # vimeo.py:69-71
                    picks = ([0, 1, 2], [2, 3, 4], [4, 5, 6])
                for p in picks:
                    self.clips.append(([imgs[i] for i in p], 1))
        else:
            self.clips = [
                [os.path.join(src, "sequences", seq, f"im{i}.png") for i in range(1, 8)]
                for seq in sequences
            ]

    def build_transform(self):
        mean, std = self.cfg.pixel_mean(), self.cfg.pixel_std()
        if self.eval_mode:
            # 256x448 is already /32-divisible — no pad (vimeo.py:131-140)
            return Compose([Normalize(mean, std), ToFloatArray()])
        crop = (self.cfg.getint(self.split, "CROP_IMH"),
                self.cfg.getint(self.split, "CROP_IMW"))
        return Compose([RandomCrop(crop, rng=self.rng), Normalize(mean, std), ToFloatArray()])

    def get_train_item_indexes(self, rng: np.random.Generator):
        """Septuplet index tables (vimeo.py:79-115): inputs from {0,2,4,6},
        targets from {1,3,5}, edges replicated for n_frames=4; t fixed 4/8."""
        choice = int(rng.choice([1, 3, 5]))
        if self.n_frames == 2:
            return [choice - 1, choice + 1], [choice], [4]
        if self.n_frames == 4:
            table = {
                1: ([0, 0, 2, 4], [0, 1, 3]),
                3: ([0, 2, 4, 6], [1, 3, 5]),
                5: ([2, 4, 6, 6], [3, 5, 6]),
            }
            tr, tg = table[choice]
            return tr, tg, [4, 4, 4]
        raise ValueError("Vimeo supports 2 or 4 frames")

    def get_train_item(self, idx: int, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else self.rng
        img_paths = self.clips[idx]
        if rng.integers(0, 2) == 1:
            img_paths = img_paths[::-1]
        input_idx, target_idx, sampled = self.get_train_item_indexes(rng)
        sample = self.read_sample(img_paths, list(input_idx) + list(target_idx))
        sample = self.transform(sample, rng=rng)
        return (
            sample[: self.n_frames],
            sample[self.n_frames :],
            np.asarray(sampled, dtype=np.float32) / 8.0,
        )

    def get_inference_item_indexes(self):
        # vimeo.py:117-130 — the eval clip already encodes the window.
        if self.n_frames == 4:
            return [0, 1, 3, 4], [2]
        return [0, 2], [1]

    def get_inference_item(self, idx: int):
        img_paths, n_targets = self.clips[idx]
        input_idx, target_idx = self.get_inference_item_indexes()
        sample = self.read_sample(img_paths, list(input_idx) + list(target_idx))
        sample = self.transform(sample)
        return sample[: self.n_frames], sample[self.n_frames :], int(n_targets)


class SlowflowReader(Reader):
    """Slowflow, eval only, padded to 1024x1280 (slowflow.py)."""

    def __init__(self, cfg, split="VAL", eval_mode=True, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        self.clips = self._glob_sliding_clips(cfg.get("SLOWFLOW_DATA", "ROOTDIR"))

    def build_transform(self):
        mean, std = self.cfg.pixel_mean(), self.cfg.pixel_std()
        return Compose([Normalize(mean, std), ToFloatArray(),
                        EvalPad(target_dims=(1024, 1280))])


class SintelHFRReader(Reader):
    """Sintel-HFR, eval only, 31x interpolation (sintel_hfr.py)."""

    def __init__(self, cfg, split="VAL", eval_mode=True, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        self.interp_factor = 32
        self.reqd_images = REQD_IMAGES_HFR[self.n_frames]
        self.clips = self._glob_sliding_clips(cfg.get("SINTEL_HFR_DATA", "ROOTDIR"))

    def build_transform(self):
        mean, std = self.cfg.pixel_mean(), self.cfg.pixel_std()
        # 436 → 448 (sintel_hfr.py:70-72)
        return Compose([Normalize(mean, std), ToFloatArray(),
                        EvalPad(padding=(0, 0, 6, 6))])


class CombinedReader(Reader):
    """Adobe + NFS + Vimeo concatenation for training (combined_dataset.py)."""

    def __init__(self, cfg, split="TRAIN", eval_mode=False, rng=None):
        super().__init__(cfg, split, eval_mode, rng)
        self.readers = {
            "adobe": AdobeReader(cfg, split, eval_mode, rng=self.rng),
            "nfs": NFSReader(cfg, split, eval_mode, rng=self.rng),
            "vimeo": VimeoReader(cfg, split, eval_mode, rng=self.rng),
        }
        self.clips = [
            (name, i)
            for name, r in self.readers.items()
            for i in range(len(r.clips))
        ]

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        name, sub = self.clips[idx]
        return self.readers[name].__getitem__(sub, rng=rng)


class SintelFlowReader:
    """Sintel optical-flow (EPE) reader (sintel_opticalflow.py): windows of
    N_FRAMES adjacent frames a step apart, with the ground-truth .flo of the
    mid pair; N_FRAMES=4 pads the clip's edges with its first and last
    frame. The frames are padded 436 → 448 rows (6 above, 6 below)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_frames = cfg.getint("TRAIN", "N_FRAMES")
        if self.n_frames not in (2, 4):
            raise ValueError("Sintel EPE supports N_FRAMES in {2, 4}")
        src = cfg.get("SINTEL_EPE_DATA", "ROOTDIR")
        setting = cfg.get("SINTEL_EPE_DATA", "SETTING").lower()
        mean, std = cfg.pixel_mean(), cfg.pixel_std()
        self.transform = Compose([Normalize(mean, std), ToFloatArray(), EvalPad(padding=(0, 0, 6, 6))])
        self.samples: List[Tuple[List[str], str]] = []
        for clip in sorted(glob.glob(os.path.join(src, setting, "*"))):
            imgs = sorted(glob.glob(os.path.join(clip, "*.png")))
            flows = sorted(glob.glob(os.path.join(src, "flow", os.path.basename(clip), "*.flo")))
            idxs = list(range(len(imgs)))
            if self.n_frames == 4:
                idxs = [0] + idxs + [idxs[-1]]
            for s in range(len(idxs) - self.n_frames + 1):
                window = idxs[s : s + self.n_frames]
                flow_idx = window[0] if self.n_frames == 2 else window[1]
                if flow_idx < len(flows):
                    self.samples.append(([imgs[i] for i in window], flows[flow_idx]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        """(frames (N_FRAMES, H + 12, W, 3) normalized float32, flow (H, W, 2))."""
        paths, flow_path = self.samples[idx]
        frames = np.stack([imread(p).astype(np.float32) for p in paths])
        return self.transform(frames), read_flo(flow_path)


def build_reader(cfg, split: str, rng: np.random.Generator | None = None) -> Reader:
    """Reader dispatch, matching scripts/utils/dataset.py:10-35."""
    name = cfg.get("DATA", "DATASET").upper()
    eval_mode = cfg.getboolean("EVAL", "EVAL_MODE")
    # reference invariant (validators.py:18-27)
    if eval_mode != (cfg.get("DATALOADER", "T_SAMPLE").upper() == "NIL"):
        raise ValueError("EVAL_MODE requires T_SAMPLE=NIL (and vice versa)")
    if name == "ALL":
        return CombinedReader(cfg, split, eval_mode, rng)
    if name == "ADOBE":
        return AdobeReader(cfg, split, eval_mode, rng)
    if name == "NFS":
        return NFSReader(cfg, split, eval_mode, rng)
    if name == "VIMEO":
        return VimeoReader(cfg, split, eval_mode, rng)
    if name == "SLOWFLOW":
        return SlowflowReader(cfg, split, eval_mode, rng)
    if name == "SINTEL_HFR":
        return SintelHFRReader(cfg, split, eval_mode, rng)
    raise ValueError(f"Unsupported dataset {name}")


def get_dataset(cfg, split: str, rng: np.random.Generator | None = None, rank: int = 0, world: int = 1):
    """Reader + batching loader (reference: dataset.py + get_dataloader,
    default_reader.py:289-311); across ``world`` data-parallel ranks, this
    ``rank``'s slice of each global batch of ``[split] BATCH_SIZE``."""
    reader = build_reader(cfg, split, rng)
    return Loader(
        reader,
        batch_size=cfg.getint(split, "BATCH_SIZE"),
        shuffle=not reader.eval_mode,
        drop_last=not reader.eval_mode,
        num_threads=cfg.getint("DATALOADER", "N_WORKERS"),
        seed=cfg.getint("SEED", "VALUE"),
        rank=rank,
        world=world,
    )
