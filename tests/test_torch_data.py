"""The port's data path on the CPU against the JAX package's: the PNG decoder
against ``cv2.imread`` bit for bit (cv2's, PIL's and a stdlib encoder's files,
each filter type alone, colour types 0, 2, 3, 4 and 6 at 8 bits and 16-bit),
the compiled unfilter against its plain version and its host build, the
readers' index tables and samples, the Loader's batches over two epochs at 1
and 4 threads, the validators, and the CPU device feed."""

import configparser
import os
import pickle
import re
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from superslomo_tpu.config import load_config as jax_load_config
from superslomo_tpu.data import readers as jax_readers
from superslomo_tpu.utils import validators as jax_validators
from superslomo_tpu_torch.config import load_config
from superslomo_tpu_torch.data import Loader, get_dataset, png, prefetch_to_device, readers
from superslomo_tpu_torch.ops import cuda_build
from superslomo_tpu_torch.utils import validators
from tests.test_torch_package import one_torch_thread  # noqa: F401

# --------------------------------------------------------------------------- #
# a stdlib PNG encoder: every row with one filter type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def filter_rows(px: np.ndarray, bpp: int, ft: int) -> np.ndarray:
    """(h, stride) unfiltered bytes → (h, 1 + stride) rows of filter ``ft``."""
    h, stride = px.shape
    x = px.astype(np.int32)
    up = np.vstack([np.zeros((1, stride), np.int32), x[:-1]])
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    c = np.zeros_like(x)
    c[:, bpp:] = up[:, :-bpp]
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = up
    elif ft == 3:
        pred = (a + up) >> 1
    else:
        p = a + up - c
        pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    return np.hstack([np.full((h, 1), ft, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)])


def encode(samples: np.ndarray, ctype: int, depth: int = 8, ft: int = 1, palette=None, interlace: int = 0) -> bytes:
    """(h, w, channels) uint8 (depth 8) or uint16 (depth 16) samples → PNG bytes."""
    h, w, ch = samples.shape
    px = samples.astype(">u2").view(np.uint8) if depth == 16 else samples.astype(np.uint8)
    px = px.reshape(h, -1)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    raw = filter_rows(px, max(1, ch * depth // 8), ft).tobytes()
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = [(ctype, depth, ft) for ctype in CHANNELS for depth in ((8,) if ctype == 3 else (8, 16)) for ft in range(5)]


def _texture(rng, h, w):
    """A smooth uint8 RGB texture (natural-image-like rows for PIL's filter choice)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(4):
        fy, fx = rng.uniform(0.02, 0.3, 2)
        img += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None] * rng.uniform(10, 50, 3)
    return np.clip(img + 128 + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def _filter_types(path):
    (w, h, depth, ctype, _), stream, _, _ = png.read_chunks(path)
    raw = np.frombuffer(zlib.decompress(stream), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("ctype,depth,ft", CASES, ids=[f"type{c}_{d}bit_filter{f}" for c, d, f in CASES])
def test_imread_equals_cv2_for_each_filter_and_colour_type(tmp_path, ctype, depth, ft):
    rng = np.random.default_rng(100 * ctype + 10 * depth + ft)
    high = 65536 if depth == 16 else (40 if ctype == 3 else 256)
    samples = rng.integers(0, high, (13, 17, CHANNELS[ctype])).astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.integers(0, 256, (40, 3)) if ctype == 3 else None
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(encode(samples, ctype, depth, ft, palette))
    got = png.imread(path)
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])
    assert _filter_types(path) == {ft}


def test_imread_equals_cv2_on_cv2_and_pil_files(tmp_path):
    rng = np.random.default_rng(0)
    img = _texture(rng, 48, 80)
    cv2_path, pil_path = str(tmp_path / "cv2.png"), str(tmp_path / "pil.png")
    cv2.imwrite(cv2_path, img[..., ::-1])
    Image.fromarray(img).save(pil_path)
    Image.fromarray(img).convert("RGBA").save(str(tmp_path / "pil_rgba.png"))
    Image.fromarray(img).convert("L").save(str(tmp_path / "pil_grey.png"))
    Image.fromarray(img).convert("P").save(str(tmp_path / "pil_palette.png"))
    assert _filter_types(cv2_path) == {1}
    assert len(_filter_types(pil_path)) > 1  # PIL chooses a filter per row
    np.testing.assert_array_equal(png.imread(cv2_path), img)
    for name in ("pil", "pil_rgba", "pil_grey", "pil_palette"):
        path = str(tmp_path / f"{name}.png")
        np.testing.assert_array_equal(png.imread(path), cv2.imread(path)[..., ::-1], err_msg=name)


def test_compiled_unfilter_equals_plain_on_mixed_rows():
    rng = np.random.default_rng(3)
    for h, w, bpp in ((9, 11, 3), (7, 5, 4), (6, 13, 1), (5, 8, 6), (4, 3, 8)):
        stride = w * bpp
        raw = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        want = png.unfilter_plain(raw.copy(), h, stride, bpp)
        got = png.unfilter(raw.reshape(-1).copy(), h, stride, bpp)
        np.testing.assert_array_equal(got, want)
        # and both invert the stdlib encoder's filters, whatever they are
        for ft in range(5):
            rows = filter_rows(want, bpp, ft)
            np.testing.assert_array_equal(png.unfilter(rows.reshape(-1).copy(), h, stride, bpp), want)


def test_unfilter_rejects_a_bad_filter_byte():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        png.unfilter(raw.reshape(-1).copy(), 3, 6, 3)
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        png.unfilter_plain(raw, 3, 6, 3)


@pytest.mark.parametrize("what", ["interlaced", "4-bit", "16-bit palette"])
def test_imread_raises_on_what_it_does_not_read(tmp_path, what):
    path = str(tmp_path / "x.png")
    samples = np.zeros((4, 4, 1 if what != "interlaced" else 3), np.uint8)
    if what == "interlaced":
        data = encode(samples, 2, interlace=1)
    else:
        depth = 4 if what == "4-bit" else 16
        head = _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, 3 if depth == 16 else 0, 0, 0, 0))
        data = b"\x89PNG\r\n\x1a\n" + head + _chunk(b"IDAT", zlib.compress(bytes(20))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match=re.escape(path)):
        png.imread(path)


def test_host_build_names_by_hash_and_raises_without_a_compiler(tmp_path, monkeypatch):
    assert png.SOURCE in cuda_build.SOURCES and png.SOURCE.suffix == ".cpp"
    assert cuda_build.library_path(png.SOURCE).parent == cuda_build.BUILD_DIR
    src = tmp_path / "routine.cpp"
    src.write_text('extern "C" int f() { return 0; }\n')
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "host_cxx", lambda: "")
    with pytest.raises(RuntimeError, match="c.. not found"):
        cuda_build.load_library(src, lambda lib: None)
    monkeypatch.setattr(cuda_build, "host_cxx", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="c.. failed building routine.cpp"):
        cuda_build.load_library(src, lambda lib: None)
    assert not list(tmp_path.glob("_build/*")), "a failed build leaves no library behind"


# --------------------------------------------------------------------------- #
# readers and loader against the JAX package on tiny PNG clips

H, W = 16, 24


def _write_clip(rng, folder, n, h=H, w=W, names="frame_{:05d}.png"):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(folder, names.format(i))
        cv2.imwrite(p, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def _clip_list(path, clips):
    with open(path, "w") as f:
        for clip in clips:
            f.write(f"{len(clip)}\n" + "".join(p + "\n" for p in clip))
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Adobe train (4 clips of 12, one vertical) and eval (2 clips of 20 and
    13), NFS train (3 clips of 12), Vimeo (3 septuplets), Slowflow (one clip of
    10), Sintel-HFR (one clip of 40)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(7)
    adobe = [_write_clip(rng, str(root / "adobe_train" / f"c{i}"), 12, *((W, H) if i == 2 else (H, W)))
             for i in range(4)]
    for name, n in (("e0", 20), ("e1", 13)):
        _write_clip(rng, str(root / "adobe" / name), n)
    with open(root / "val_clips.pkl", "wb") as f:
        pickle.dump(["e1", "e0"], f)
    nfs = [_write_clip(rng, str(root / "nfs" / f"c{i}"), 12) for i in range(3)]
    seqs = ["00001/0001", "00001/0002", "00002/0001"]
    for s in seqs:
        _write_clip(rng, str(root / "vimeo" / "sequences" / s), 7, names="im{}.png")
        os.replace(root / "vimeo" / "sequences" / s / "im0.png", root / "vimeo" / "sequences" / s / "im7.png")
    (root / "vimeo" / "list.txt").write_text("\n".join(seqs) + "\n")
    _write_clip(rng, str(root / "slowflow" / "s0"), 10, 8, 12)
    _write_clip(rng, str(root / "sintel" / "h0"), 40, 8, 12)
    return {
        "ADOBE_DATA": {"ROOTDIR": root / "adobe", "VAL_CLIPS": root / "val_clips.pkl",
                       "TRAINPATHS": _clip_list(root / "adobe_train.txt", adobe), "H_IN": H, "W_IN": W},
        "NFS_DATA": {"TRAINPATHS": _clip_list(root / "nfs_train.txt", nfs)},
        "VIMEO_DATA": {"ROOTDIR": root / "vimeo", "TRAINPATHS": root / "vimeo" / "list.txt",
                       "VALPATHS": root / "vimeo" / "list.txt"},
        "SLOWFLOW_DATA": {"ROOTDIR": root / "slowflow"},
        "SINTEL_HFR_DATA": {"ROOTDIR": root / "sintel"},
        "root": root,
    }


def _configs(dataset, name, eval_mode, n_frames=2, workers=1, batch=2):
    """The same INI loaded by both packages."""
    parser = configparser.RawConfigParser()
    parser.optionxform = str
    sections = {
        "DATA": {"DATASET": name, "WINDOW_LENGTH": 12},
        "TRAIN": {"N_FRAMES": n_frames, "BATCH_SIZE": batch, "CROP_IMH": 8, "CROP_IMW": 16},
        "VAL": {"BATCH_SIZE": batch},
        "DATALOADER": {"N_WORKERS": workers, "T_SAMPLE": "NIL" if eval_mode else "RANDOM"},
        "EVAL": {"EVAL_MODE": "TRUE" if eval_mode else "FALSE"},
        "SEED": {"VALUE": 5},
        **{k: v for k, v in dataset.items() if k != "root"},
    }
    for section, values in sections.items():
        parser.add_section(section)
        for k, v in values.items():
            parser.set(section, k, str(v))
    path = str(dataset["root"] / f"{name}_{int(eval_mode)}_{n_frames}_{workers}.ini")
    with open(path, "w") as f:
        parser.write(f)
    return load_config(path), jax_load_config(path)


READER_CASES = [
    ("ADOBE", False, 2), ("ADOBE", True, 2), ("NFS", False, 2), ("VIMEO", False, 2), ("VIMEO", False, 4),
    ("VIMEO", True, 2), ("VIMEO", True, 4), ("SLOWFLOW", True, 2), ("SINTEL_HFR", True, 2), ("ALL", False, 2),
]


@pytest.mark.parametrize("name,eval_mode,n_frames", READER_CASES,
                         ids=[f"{n}_{'eval' if e else 'train'}_n{k}" for n, e, k in READER_CASES])
def test_reader_equals_jax(dataset, name, eval_mode, n_frames):
    cfg, jcfg = _configs(dataset, name, eval_mode, n_frames)
    split = "VAL" if eval_mode else "TRAIN"
    ours, theirs = readers.build_reader(cfg, split), jax_readers.build_reader(jcfg, split)
    assert type(ours).__name__ == type(theirs).__name__
    assert len(ours) == len(theirs) > 0
    assert ours.clips == theirs.clips  # index tables, sliding windows and n_avail
    assert (ours.reqd_images, ours.interp_factor) == (theirs.reqd_images, theirs.interp_factor)
    items = range(len(ours)) if name != "SLOWFLOW" else [0]  # Slowflow pads each frame to 1024x1280
    for idx in items:
        got = ours.__getitem__(idx, rng=np.random.default_rng([1, 2, idx]))
        want = theirs.__getitem__(idx, rng=np.random.default_rng([1, 2, idx]))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    if name == "ADOBE" and not eval_mode:  # the vertical clip is swapped back to (H, W)
        sample = ours.read_sample(ours.clips[2], [0, 1])
        assert sample.shape == (2, H, W, 3) and sample.dtype == np.float64


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("name,split", [("ADOBE", "TRAIN"), ("ALL", "TRAIN"), ("ADOBE", "VAL")])
def test_get_dataset_batches_equal_jax_over_two_epochs(dataset, name, split, workers):
    cfg, jcfg = _configs(dataset, name, split == "VAL", workers=workers)
    ours, theirs = get_dataset(cfg, split), jax_readers.get_dataset(jcfg, split)
    assert isinstance(ours, Loader) and len(ours) == len(theirs) > 0
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# validators and the CPU device feed

VALIDATOR_CASES = [
    ("check_eval_dims", (64, 96)), ("check_eval_dims", (720, 1280)), ("check_eval_dims", (736, 1280)),
    ("check_clip_window", (57, 57, 9, 9)), ("check_clip_window", (57, 60, 9, 9)),
    ("check_clip_window", (5, 5, 9, 5)), ("check_clip_window", (57, 57, 9, 8)),
]


@pytest.mark.parametrize("fn,args", VALIDATOR_CASES, ids=[f"{f}{a}" for f, a in VALIDATOR_CASES])
def test_validators_raise_where_jax_raises(fn, args):
    def outcome(module):
        try:
            getattr(module, fn)(*args)
        except ValueError as exc:
            return str(exc)
        return None

    assert outcome(validators) == outcome(jax_validators)


def test_prefetch_to_cpu_yields_the_batches_unchanged():
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((2, 2, 4, 4, 3), dtype=np.float32), rng.standard_normal((2, 1, 4, 4, 3)),
                np.arange(2)) for _ in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in g)
        for t, a in zip(g, w):
            np.testing.assert_array_equal(t.numpy(), a)
            assert t.numpy().dtype == a.dtype


def test_prefetch_raises_the_producers_error_and_stops_when_closed():
    def failing():
        yield (np.zeros(2),)
        raise OSError("unreadable frame")

    feed = prefetch_to_device(failing(), "cpu")
    next(feed)
    with pytest.raises(OSError, match="unreadable frame"):
        next(feed)

    produced = []

    def endless():
        for i in range(10**6):
            produced.append(i)
            yield (np.full(1, i),)

    feed = prefetch_to_device(endless(), "cpu", size=2)
    assert int(next(feed)[0][0]) == 0
    feed.close()  # joins the producer
    n = len(produced)
    assert n <= 6
