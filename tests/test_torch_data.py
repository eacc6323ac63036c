"""The port's data path on the CPU against the JAX package's: the PNG decoder
against ``cv2.imread`` bit for bit (cv2's, PIL's and a stdlib encoder's files,
each filter type alone, colour types 0, 2, 3, 4 and 6 at every bit depth,
1, 2 and 4 bits included, interlaced (Adam7) and not, with a tRNS chunk),
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


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, channels) samples → (h, stride) bytes at ``depth`` bits a
    sample: 16 big-endian, 1, 2 and 4 packed MSB first, each row padded to a byte."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, w * ch).astype(np.int32)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    groups = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(h, -1, per)
    return (groups << np.arange(8 - depth, -1, -depth)).sum(axis=2).astype(np.uint8)


def encode(samples: np.ndarray, ctype: int, depth: int = 8, ft: int = 1, palette=None, interlace: int = 0,
           chunks=()) -> bytes:
    """(h, w, channels) samples (uint16 at depth 16) → PNG bytes, every row
    of every pass with filter ``ft``; interlaced (Adam7) at ``interlace=1``;
    ``chunks``: (type, body) pairs written after PLTE (a tRNS)."""
    h, w, ch = samples.shape
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    out += b"".join(_chunk(kind, body) for kind, body in chunks)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows(pack(sub, depth), max(1, ch * depth // 8), ft).tobytes()
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


DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
DEPTH_CASES = [(ctype, depth) for ctype, depths in DEPTHS.items() for depth in depths]


def _samples(rng, h, w, ctype, depth):
    """Random samples of colour type ``ctype`` at ``depth`` bits, and a
    palette of 2^depth (at most 40) colours for type 3."""
    colours = min(1 << depth, 40)
    high = colours if ctype == 3 else 1 << depth
    samples = rng.integers(0, high, (h, w, CHANNELS[ctype])).astype(np.uint16 if depth == 16 else np.uint8)
    return samples, (rng.integers(0, 256, (colours, 3)) if ctype == 3 else None)


@pytest.mark.parametrize("ctype,depth", DEPTH_CASES, ids=[f"type{c}_{d}bit" for c, d in DEPTH_CASES])
def test_adam7_equals_cv2_and_the_non_interlaced_decode(tmp_path, ctype, depth):
    """Interlaced (Adam7) files of every colour type and bit depth, each
    pass filtered on its own (every filter type), at sizes where passes are
    empty (1x1: all but the first; 5x3: the second; 3x9: the third) and
    not: equal to cv2's decode and to the non-interlaced file of the same
    pixels."""
    rng = np.random.default_rng(10 * ctype + depth)
    for h, w in ((1, 1), (5, 3), (3, 9), (13, 17), (16, 24)):
        samples, palette = _samples(rng, h, w, ctype, depth)
        for ft in range(5):
            path = str(tmp_path / f"i{ft}.png")
            with open(path, "wb") as f:
                f.write(encode(samples, ctype, depth, ft, palette, interlace=1))
            got = png.imread(path)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1], err_msg=f"{h}x{w} filter {ft}")
            plain = encode(samples, ctype, depth, ft, palette)
            np.testing.assert_array_equal(got, png.imread("plain.png", plain))


SUB_BYTE_CASES = [(ctype, depth) for ctype in (0, 3) for depth in (1, 2, 4)]


@pytest.mark.parametrize("ctype,depth", SUB_BYTE_CASES, ids=[f"type{c}_{d}bit" for c, d in SUB_BYTE_CASES])
def test_sub_byte_depths_equal_cv2(tmp_path, ctype, depth):
    """Grey at 1, 2 and 4 bits (scaled to 8 bits by 255, 85 and 17, as
    libpng's ``png_set_expand_gray_1_2_4_to_8``) and palette indices at 1, 2
    and 4 bits (an index past a short PLTE reads black), each filter type,
    rows of widths that do and do not fill their last byte: equal to cv2's
    decode."""
    rng = np.random.default_rng(100 + 10 * ctype + depth)
    for h, w in ((7, 1), (6, 13), (11, 16), (9, 31)):
        samples, palette = _samples(rng, h, w, ctype, depth)
        if ctype == 3 and w == 31:
            palette = palette[: max(1, len(palette) // 2)]
        for ft in range(5):
            path = str(tmp_path / "f.png")
            with open(path, "wb") as f:
                f.write(encode(samples, ctype, depth, ft, palette))
            got = png.imread(path)
            np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1], err_msg=f"{h}x{w} filter {ft}")
    if ctype == 0:
        assert set(np.unique(got)) <= set(range(0, 256, 255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("ctype", [0, 2, 3])
def test_transparency_chunk_is_ignored_as_cv2_ignores_it(tmp_path, ctype):
    """A tRNS chunk (a palette's alphas, a grey or RGB colour key), in plain
    and interlaced files at 8 bits and at 4 for grey and palette: cv2's
    IMREAD_COLOR drops the alpha it would give, and so does the port."""
    rng = np.random.default_rng(200 + ctype)
    for depth in (4, 8) if ctype != 2 else (8, 16):
        samples, palette = _samples(rng, 13, 17, ctype, depth)
        if ctype == 3:
            trns = rng.integers(0, 256, len(palette)).astype(np.uint8).tobytes()
        else:
            trns = struct.pack(">" + "H" * CHANNELS[ctype], *samples[0, 0].tolist())
        for interlace in (0, 1):
            path = str(tmp_path / "t.png")
            with open(path, "wb") as f:
                f.write(encode(samples, ctype, depth, 4, palette, interlace, chunks=[(b"tRNS", trns)]))
            np.testing.assert_array_equal(png.imread(path), cv2.imread(path)[..., ::-1])


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


@pytest.mark.parametrize("what", ["16-bit palette"])
def test_imread_raises_on_what_it_does_not_read(tmp_path, what):
    """A bit depth that the colour type does not allow (a 16-bit palette
    is not a PNG) raises NotImplementedError naming the file."""
    path = str(tmp_path / "x.png")
    head = _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 16, 3, 0, 0, 0))
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
