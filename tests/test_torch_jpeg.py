"""The port's JPEG frames on the CPU against cv2 (the JAX package's decoder)
and PIL: the JPEG decoder against ``cv2.imread`` bit for bit (cv2's files at
four qualities, each sampling, with and without restart intervals, at odd
sizes, on noise and smooth textures; PIL's optimised, grey, CMYK and
progressive files; cv2's progressive files; coefficients past the IDCT's
range), the compiled routine against its plain version, the files of
``chip_smoke.py``'s writer (baseline, progressive, sequential in several
scans, CMYK and YCCK, with restarts), the eight EXIF orientations of JPEG and
PNG files and malformed EXIF blocks, the refusals, the frame reader's choice
by signature, the Adobe reader over a clip list of baseline, progressive and
CMYK JPEG frames against the JAX reader, and the three cv2 transforms against
the JAX package's classes."""

import io
import os
import struct
import zlib
from fractions import Fraction

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from superslomo_tpu.data import augmentations as jax_augmentations
from superslomo_tpu.data import readers as jax_readers
from superslomo_tpu_torch.data import augmentations, exif, get_dataset, image, jpeg, png, readers
from superslomo_tpu_torch.utils import make_clips
from tests.test_torch_data import _configs
from tests.test_torch_package import one_torch_thread  # noqa: F401

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}
SIZES = [(1, 1), (9, 17), (37, 53), (64, 64)]


def _texture(rng, h, w, kind):
    """(h, w, 3) uint8: uniform noise, or a smooth sum of sines."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 6.3, 3)
    return np.stack([128 + 120 * np.sin(xx / (3 + i) + yy / (5 + 2 * i) + phase[i]) for i in range(3)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _decode_both(data: bytes) -> np.ndarray:
    """The compiled decode, after checking that the plain one equals it."""
    header = jpeg.read_header(data)
    got = jpeg.decode(data, header)
    np.testing.assert_array_equal(jpeg.decode_plain(data, header), got)
    return got


# --------------------------------------------------------------------------- #
# the decoder against cv2

DECODE_CASES = [(q, s, r) for q in (50, 75, 95, 100) for s in SAMPLING for r in (0, 3)]


@pytest.mark.parametrize("quality,sampling,restart", DECODE_CASES,
                         ids=[f"q{q}_{s}_rst{r}" for q, s, r in DECODE_CASES])
def test_decoder_equals_cv2(quality, sampling, restart):
    """cv2.imencode's files, noise and smooth, at each odd size: the port's
    decode equals cv2's bit for bit. The matrix also decides the code paths
    of the libjpeg-turbo inside cv2: fancy upsampling (h2v1, h2v2, h1v2; not
    the merged upsampler), box replication where a chroma row is 2 samples
    or less, int_upsample for 4:1:1, and noise at q95-100 overshooting the
    sample range."""
    rng = np.random.default_rng([quality, restart, len(sampling)])
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for h, w in SIZES:
        for kind in ("noise", "smooth"):
            data = cv2.imencode(".jpg", _texture(rng, h, w, kind), params)[1].tobytes()
            assert jpeg.read_header(data).restart == restart
            np.testing.assert_array_equal(_decode_both(data), _cv2_rgb(data), err_msg=f"{h}x{w} {kind}")


def _pil(img, **kwargs) -> bytes:
    """PIL's JPEG of ``img``, an array or a PIL image."""
    buf = io.BytesIO()
    (Image.fromarray(img) if isinstance(img, np.ndarray) else img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


OTHER_FILES = {
    "pil_optimize_444": lambda img: _pil(img, quality=90, optimize=True, subsampling=0),
    "pil_optimize_422": lambda img: _pil(img, quality=90, optimize=True, subsampling=1),
    "pil_optimize_420": lambda img: _pil(img, quality=85, optimize=True, subsampling=2),
    "pil_grey": lambda img: _pil(img[..., 0], quality=90),
    "pil_grey_optimize": lambda img: _pil(img[..., 0], quality=70, optimize=True),
    "pil_rgb_adobe": lambda img: _pil(img, quality=90, keep_rgb=True),
    "cv2_grey_restart": lambda img: cv2.imencode(".jpg", img[..., 1], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes(),
    "pil_cmyk": lambda img: _pil(Image.fromarray(img).convert("CMYK"), quality=90),
    "pil_cmyk_progressive": lambda img: _pil(Image.fromarray(img).convert("CMYK"), quality=80, progressive=True),
    "pil_progressive_optimize": lambda img: _pil(img, quality=85, progressive=True, optimize=True),
}


@pytest.mark.parametrize("source", sorted(OTHER_FILES))
def test_decoder_equals_cv2_on_pil_and_grey_files(source):
    """PIL's optimised Huffman tables and grey files, an RGB (Adobe
    transform 0) file, CMYK files (Adobe transform 0, baseline and
    progressive), and cv2's grey file with restarts: equal to cv2's decode
    (grey comes back as three equal channels)."""
    rng = np.random.default_rng(3)
    for h, w in SIZES[1:]:
        for kind in ("noise", "smooth"):
            data = OTHER_FILES[source](_texture(rng, h, w, kind))
            want = _cv2_rgb(data)
            assert want.shape == (h, w, 3)
            np.testing.assert_array_equal(_decode_both(data), want, err_msg=f"{h}x{w} {kind}")


RANGE_CASES = [(1023, 8), (-1023, 8), (2047, 255), (-2047, 255), (600, 16)]


@pytest.mark.parametrize("dc,q", RANGE_CASES, ids=[f"dc{d}_q{q}" for d, q in RANGE_CASES])
def test_idct_out_of_range_equals_cv2(dc, q):
    """Coefficients whose IDCT leaves the sample range (and, at q=255, the
    16 bits of the SIMD code's dequantisation): cv2 clamps them, as
    libjpeg-turbo's x86 SIMD IDCT does, where jidctint.c's range-limit table
    would wrap DC 1023 at q 8 (+1023) to 127. The port follows cv2."""
    rng = np.random.default_rng(abs(dc) + q)
    blocks = rng.integers(-40, 40, (2, 3, 64))
    blocks[0, 0] = 0
    blocks[0, 0, 0] = dc  # one block of its DC alone
    blocks[1, 1, 0] = dc
    blocks[1, 2, 0], blocks[1, 2, 9] = dc, -dc // 3
    data = chip_smoke.jpeg_from_coefficients(24, 16, [(1, 1, 1, 0)], [blocks], [np.full(64, q)] * 2)
    got = _decode_both(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    if (dc, q) == (1023, 8):
        assert (got[:8, :8] == 255).all()


WRITER_CASES = [(s, r) for s in chip_smoke.JPEG_SAMPLING for r in (0, 1, 5)] + [("grey", 0), ("grey", 4)]


@pytest.mark.parametrize("sampling,restart", WRITER_CASES, ids=[f"{s}_rst{r}" for s, r in WRITER_CASES])
def test_chip_smoke_writer_files_decode_as_cv2(sampling, restart):
    """``chip_smoke.py``'s baseline writer (the card's machine has no cv2):
    cv2 and the port decode its files to the same pixels, compiled and plain,
    and close to what was written."""
    rng = np.random.default_rng(len(sampling) + restart)
    for h, w in ((37, 53), (64, 96)):
        img = chip_smoke.panning_clips(rng, 1, h, w, n=1)[0, 0]  # the phases' frames
        src = img[..., 1] if sampling == "grey" else img
        data = chip_smoke.jpeg_bytes(src, quality=95, restart=restart,
                                     **({} if sampling == "grey" else {"sampling": sampling}))
        got = _decode_both(data)
        np.testing.assert_array_equal(got, _cv2_rgb(data))
        ref = np.repeat(src[..., None], 3, axis=2) if src.ndim == 2 else src
        assert np.abs(got.astype(int) - ref).mean() < 2


def test_writer_tables_are_cv2s():
    """The writer's quantisation tables at each quality and its Huffman
    tables are those cv2.imencode writes (Annex K, libjpeg's scaling)."""
    img = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    for quality in (10, 50, 75, 95, 100):
        header = jpeg.read_header(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes())
        luma, chroma = chip_smoke.quant_tables(quality)
        np.testing.assert_array_equal(header.components[0][2], luma)
        np.testing.assert_array_equal(header.components[1][2], chroma)
    assert header.huffman == {k: (tuple(c), s) for k, (c, s) in chip_smoke.STD_HUFFMAN.items()}


def test_compiled_decode_equals_plain_at_a_larger_size():
    """720x1280-sized work in miniature: a 200x328 noisy 4:2:0 frame with a
    restart every 7 MCUs, compiled and plain bit for bit and equal to cv2."""
    rng = np.random.default_rng(11)
    img = np.clip(_texture(rng, 200, 328, "smooth").astype(int) + rng.integers(-20, 20, (200, 328, 3)), 0, 255)
    data = chip_smoke.jpeg_bytes(img.astype(np.uint8), quality=97, sampling="420", restart=7)
    np.testing.assert_array_equal(_decode_both(data), _cv2_rgb(data))


PROGRESSIVE_CASES = [(q, s) for q in (50, 75, 95) for s in ("444", "422", "420")] + [(90, "grey")]
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


@pytest.mark.parametrize("quality,sampling", PROGRESSIVE_CASES, ids=[f"q{q}_{s}" for q, s in PROGRESSIVE_CASES])
def test_pil_progressive_equals_cv2(quality, sampling):
    """PIL's progressive files (libjpeg's simple progression: 10 scans, 6 in
    grey, with optimal Huffman tables defined before each scan but the DC
    refinement; successive approximation of DC and AC; EOB runs across
    blocks): equal to cv2's decode, compiled and plain, at each odd size."""
    rng = np.random.default_rng([quality, len(sampling)])
    for h, w in SIZES:
        for kind in ("noise", "smooth"):
            img = _texture(rng, h, w, kind)
            if sampling == "grey":
                data = _pil(img[..., 0], quality=quality, progressive=True)
            else:
                data = _pil(img, quality=quality, progressive=True, subsampling=PIL_SUBSAMPLING[sampling])
            header = jpeg.read_header(data)
            assert header.progressive and len(header.scans) == (6 if sampling == "grey" else 10)
            np.testing.assert_array_equal(_decode_both(data), _cv2_rgb(data), err_msg=f"{h}x{w} {kind}")


@pytest.mark.parametrize("restart", [0, 1, 5])
def test_cv2_progressive_equals_cv2(restart):
    """cv2.imencode's IMWRITE_JPEG_PROGRESSIVE files, with a restart interval
    of 1 and 5 MCUs (a DC scan's MCU interleaves the components, an AC
    scan's is one block: EOB runs end at each restart) and without."""
    rng = np.random.default_rng(30 + restart)
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for h, w in SIZES[1:]:
        for kind in ("noise", "smooth"):
            img = _texture(rng, h, w, kind)
            for src in (img, img[..., 0]):
                data = cv2.imencode(".jpg", src, params)[1].tobytes()
                assert {s.restart for s in jpeg.read_header(data).scans} == {restart}
                np.testing.assert_array_equal(_decode_both(data), _cv2_rgb(data), err_msg=f"{h}x{w} {kind}")


MULTISCAN_WRITER_CASES = {  # name → jpeg_bytes' arguments
    "progressive_420": {"scans": "progressive"},
    "progressive_420_rst": {"scans": "progressive", "restart": 3},
    "progressive_444_rst1": {"scans": "progressive", "sampling": "444", "restart": 1},
    "progressive_422_q50": {"scans": "progressive", "sampling": "422", "quality": 50},
    "progressive_grey_rst": {"scans": "progressive", "grey": True, "restart": 2},
    "progressive_dri_between_scans": {"scans": "progressive", "restart": [0, 2, 0, 5, 1, 0, 3, 0, 2, 7]},
    "components_420_rst": {"scans": "components", "restart": 2},
    "luma_chroma_420": {"scans": "luma_chroma"},
    "luma_chroma_411_rst": {"scans": "luma_chroma", "sampling": "411", "restart": 4},
    "cmyk": {"colour": "cmyk"},
    "cmyk_rst": {"colour": "cmyk", "restart": 3},
    "cmyk_progressive": {"colour": "cmyk", "scans": "progressive", "restart": 2},
    "ycck": {"colour": "ycck"},
    "ycck_444_rst": {"colour": "ycck", "sampling": "444", "restart": 2},
    "ycck_progressive": {"colour": "ycck", "scans": "progressive", "restart": 3},
    "ycck_components": {"colour": "ycck", "scans": "components"},
}


@pytest.mark.parametrize("name", sorted(MULTISCAN_WRITER_CASES))
def test_chip_smoke_multiscan_writer_files_decode_as_cv2(name):
    """``chip_smoke.py``'s progressive, multi-scan, CMYK and YCCK files (its
    own optimal tables before each scan, libjpeg's progression script,
    restarts, a DRI between scans): cv2 and the port decode them to the same
    pixels, compiled and plain, and to the pixels of the baseline file of the
    same coefficients; close to what was written."""
    kw = dict(MULTISCAN_WRITER_CASES[name])
    grey = kw.pop("grey", False)
    rng = np.random.default_rng(len(name))
    baseline = {k: v for k, v in kw.items() if k not in ("scans", "restart")}
    for h, w in ((1, 1), (9, 17), (37, 53), (64, 96)):
        pan = chip_smoke.panning_clips(rng, 1, h, w, n=1)[0, 0]
        for img in (pan, _texture(rng, h, w, "noise")):
            src = img[..., 1] if grey else img
            data = chip_smoke.jpeg_bytes(src, **kw)
            header = jpeg.read_header(data)
            assert header.one_pass == ("scans" not in kw) and header.colour == kw.get("colour", "grey" if grey else "ycbcr")
            got = _decode_both(data)
            np.testing.assert_array_equal(got, _cv2_rgb(data), err_msg=f"{h}x{w}")
            np.testing.assert_array_equal(got, jpeg.imread("baseline", chip_smoke.jpeg_bytes(src, **baseline)))
            if img is pan and h > 8:
                ref = np.repeat(src[..., None], 3, axis=2) if grey else src
                assert np.abs(got.astype(int) - ref).mean() < 2


def _dqt(table: int, value: int) -> bytes:
    return chip_smoke._segment(0xDB, bytes([table]) + bytes([value]) * 64)


def test_quantisation_tables_latch_at_the_first_scan():
    """A DQT between scans: a table that a component's first scan already
    latched keeps its values for that component (libjpeg's
    ``latch_quant_tables``); a table first defined after the frame header,
    just before the first scan of the components that use it, is read."""
    rng = np.random.default_rng(8)
    img = _texture(rng, 37, 53, "smooth")
    data = chip_smoke.jpeg_bytes(img, quality=80, scans="progressive")
    at = [m for m in range(len(data)) if data[m : m + 2] == b"\xff\xda"]
    late = data[: at[4]] + _dqt(0, 1) + _dqt(1, 3) + data[at[4] :]  # luma and chroma latched at scan 0
    first_dqt = data.index(b"\xff\xdb")
    chroma = data.index(b"\xff\xdb", first_dqt + 2)
    moved = data[:chroma] + data[chroma + 69 : at[0]] + data[chroma : chroma + 69] + data[at[0] :]
    assert moved.index(b"\xff\xc2") < moved.index(b"\xff\xdb\x00\x43\x01") < at[0]
    want = _decode_both(data)
    for edited in (late, moved):
        np.testing.assert_array_equal(_decode_both(edited), _cv2_rgb(edited))
        np.testing.assert_array_equal(_decode_both(edited), want)
    np.testing.assert_array_equal(jpeg.read_header(late).components[0][2], jpeg.read_header(data).components[0][2])


def test_compiled_progressive_decode_equals_plain_at_a_larger_size():
    """A 200x328 noisy 4:2:0 frame in the progression script with a restart
    every 7 MCUs: compiled and plain bit for bit and equal to cv2."""
    rng = np.random.default_rng(12)
    img = np.clip(_texture(rng, 200, 328, "smooth").astype(int) + rng.integers(-20, 20, (200, 328, 3)), 0, 255)
    data = chip_smoke.jpeg_bytes(img.astype(np.uint8), quality=97, sampling="420", restart=7, scans="progressive")
    np.testing.assert_array_equal(_decode_both(data), _cv2_rgb(data))


# --------------------------------------------------------------------------- #
# EXIF orientation, JPEG and PNG, against cv2


def _png_with_exif(img: np.ndarray, body: bytes, after_idat: bool) -> bytes:
    """``chip_smoke.png_bytes``' file with an eXIf chunk before or after its IDAT."""
    data = chip_smoke.png_bytes(img, 1)
    chunk = struct.pack(">I", len(body)) + b"eXIf" + body + struct.pack(">I", zlib.crc32(b"eXIf" + body))
    at = len(data) - 12 if after_idat else 8 + 25  # before IEND, or after IHDR
    return data[:at] + chunk + data[at:]


EXIF_CASES = ([("jpeg", o, order, "app1") for o in range(1, 9) for order in ("II", "MM")]
              + [("png", o, order, where) for o in range(1, 9) for order in ("II", "MM")
                 for where in ("before_idat", "after_idat")])


@pytest.mark.parametrize("fmt,value,order,where", EXIF_CASES, ids=["_".join(map(str, c)) for c in EXIF_CASES])
def test_exif_orientation_equals_cv2(tmp_path, fmt, value, order, where):
    """cv2.imread turns the frame by its EXIF orientation: for JPEG from the
    APP1 Exif block, for PNG from an eXIf chunk before or after the IDATs;
    values 5-8 transpose it. The port's decoders turn it the same way."""
    img = _texture(np.random.default_rng(value), 37, 53, "noise")
    block = chip_smoke.exif_block(value, big_endian=order == "MM")
    if fmt == "jpeg":
        data = chip_smoke.jpeg_bytes(img, quality=95, sampling="444", orientation=value)
        if order == "MM":
            data = data.replace(chip_smoke.exif_block(value), block)
    else:
        data = _png_with_exif(img, block, after_idat=where == "after_idat")
    path = str(tmp_path / f"frame.{'jpg' if fmt == 'jpeg' else 'png'}")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path)[..., ::-1]
    got = image.imread(path)
    assert got.shape == want.shape == ((53, 37, 3) if value >= 5 else (37, 53, 3))
    np.testing.assert_array_equal(got, want)


def _tiff(entries, order="<", magic=42):
    """A TIFF-structured block whose IFD0 holds ``entries`` (tag, type,
    count, value as 4 bytes)."""
    body = struct.pack(order + "H", len(entries))
    for tag, kind, count, value in entries:
        body += struct.pack(order + "HHI", tag, kind, count) + value
    return (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", magic, 8) + body + b"\0\0\0\0"


MALFORMED = {  # name → (APP1 segments before the frame, or a PNG eXIf body)
    "xmp_app1_first": [b"http://ns.adobe.com/xap/1.0/\x00<x/>", b"Exif\x00\x00" + chip_smoke.exif_block(6)],
    "no_exif_header": [b"Abcd\x00\x00" + chip_smoke.exif_block(6)],
    "truncated_block": [b"Exif\x00\x00" + chip_smoke.exif_block(6)[:15]],
    "value_0": [b"Exif\x00\x00" + chip_smoke.exif_block(0)],
    "value_9": [b"Exif\x00\x00" + chip_smoke.exif_block(9)],
    "long_type": [b"Exif\x00\x00" + _tiff([(0x0112, 4, 1, struct.pack("<I", 6))])],
    "second_entry": [b"Exif\x00\x00" + _tiff([(0x010F, 2, 4, b"abc\0"), (0x0112, 3, 1, struct.pack("<HH", 8, 0))])],
    "bad_magic": [b"Exif\x00\x00" + _tiff([(0x0112, 3, 1, struct.pack("<HH", 6, 0))], magic=43)],
    "png_exif_prefix": b"Exif\x00\x00" + chip_smoke.exif_block(6),
    "png_truncated": chip_smoke.exif_block(7)[:20],
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_or_unusual_exif_as_cv2(tmp_path, name):
    """What cv2 does with an unusual EXIF block, the port does: the first
    APP1 that starts "Exif\\0\\0" counts (an XMP APP1 before it does not
    hide it); a block without that header, truncated, with a bad TIFF magic
    number or a value outside 1-8 leaves the frame as it is; the value's
    first 16 bits count whatever the entry's type; libpng drops an eXIf chunk
    that does not start with the byte order."""
    img = _texture(np.random.default_rng(5), 37, 53, "noise")
    spec = MALFORMED[name]
    if isinstance(spec, bytes):
        data, path = _png_with_exif(img, spec, after_idat=False), str(tmp_path / "frame.png")
    else:
        data = chip_smoke.jpeg_bytes(img, quality=95, sampling="444")
        at = data.index(b"\xff\xdb")  # before the first DQT
        data = data[:at] + b"".join(chip_smoke._segment(0xE1, s) for s in spec) + data[at:]
        path = str(tmp_path / "frame.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path)[..., ::-1]
    got = image.imread(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_apply_orientation_transposes_5_to_8():
    x = np.arange(6).reshape(2, 3, 1)
    assert [exif.apply_orientation(x, v).shape for v in range(1, 9)] == [(2, 3, 1)] * 4 + [(3, 2, 1)] * 4
    np.testing.assert_array_equal(exif.apply_orientation(x, 6)[..., 0], [[3, 0], [4, 1], [5, 2]])
    assert exif.orientation(b"") == exif.orientation(b"XX\0\0") == 1


# --------------------------------------------------------------------------- #
# refusals and the frame reader


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` bytes into marker ``marker``'s segment set to ``value``."""
    at = data.index(bytes([0xFF, marker])) + offset
    return data[:at] + bytes([value]) + data[at + 1 :]


def _huffman_patched(data: bytes, table: int, counts=None, symbol0=None) -> bytes:
    """``data`` with the ``table``-th DHT segment's code counts (of the same
    total) or first symbol replaced; cv2 writes DC 0, AC 0, DC 1, AC 1, one a
    segment."""
    at = -1
    for _ in range(table + 1):
        at = data.index(b"\xff\xc4", at + 1)
    body = bytearray(data[at + 4 :])
    if counts is not None:
        assert sum(counts) == sum(body[1:17]) and len(counts) == 16
        body[1:17] = bytes(counts)
    if symbol0 is not None:
        body[17] = symbol0
    return data[: at + 4] + bytes(body)


# a Huffman table that libjpeg refuses: 162 AC codes of length 1 (which would
# write past a 9-bit lookup table), a DC table whose codes fill their space
# (the all-ones code taken), a DC symbol past 15
CORRUPT_TABLES = {
    "overfull_huffman": lambda d, img: _huffman_patched(d, 1, counts=[162] + [0] * 15),
    "all_ones_code": lambda d, img: _huffman_patched(d, 0, counts=[0, 1, 5, 1, 1, 1, 1, 2] + [0] * 8),
    "dc_symbol_past_15": lambda d, img: _huffman_patched(d, 0, symbol0=16),
}

def _first_scans(data: bytes, n: int) -> bytes:
    """``data`` cut after its ``n``-th scan's entropy-coded data, with an EOI."""
    return data[: jpeg.read_header(data).scans[n - 1].end] + b"\xff\xd9"


CUT_SOURCES = {  # name → the progressive file of an (h, w, 3) image
    "pil_420": lambda img: _pil(img, quality=90, progressive=True),
    "pil_444_q95": lambda img: _pil(img, quality=95, progressive=True, subsampling=0),
    "pil_422_q50": lambda img: _pil(img, quality=50, progressive=True, subsampling=1),
    "pil_grey": lambda img: _pil(img[..., 0], quality=90, progressive=True),
    "pil_cmyk": lambda img: _pil(Image.fromarray(img).convert("CMYK"), quality=90, progressive=True),
    "cv2_420_rst2": lambda img: cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY,
                                                           95, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes(),
    "writer_420": lambda img: chip_smoke.jpeg_bytes(img, scans="progressive"),
    "writer_440_rst3": lambda img: chip_smoke.jpeg_bytes(img, sampling="440", scans="progressive", restart=3),
    "writer_grey_rst1": lambda img: chip_smoke.jpeg_bytes(img[..., 1], scans="progressive", restart=1),
    "writer_cmyk": lambda img: chip_smoke.jpeg_bytes(img, colour="cmyk", scans="progressive"),
    "writer_ycck_rst2": lambda img: chip_smoke.jpeg_bytes(img, colour="ycck", scans="progressive", restart=2),
}


@pytest.mark.parametrize("source", sorted(CUT_SOURCES))
def test_cut_progressive_equals_cv2(tmp_path, source):
    """A progressive file cut after each of its scans but the last (with an
    EOI; the second cut without one, which ``cv2.imread`` reads from a file,
    warning, and ``cv2.imdecode`` refuses), as a file cut off in transfer:
    libjpeg block-smooths it (the coefficients still unknown estimated from
    the 5x5 DC neighbourhood, the DC too where a component has no AC yet),
    and the port's decode, compiled and plain, equals cv2's bit for bit:
    PIL's, cv2's and ``chip_smoke.py``'s files, 4:2:0, 4:4:4, 4:2:2, 4:4:0,
    grey, CMYK and YCCK, with and without restarts, at odd sizes (a 4:2:0
    frame of 37 rows clamps its last MCU row's neighbours by libjpeg's rule)
    and at 200x328 (compiled only)."""
    rng = np.random.default_rng(len(source))
    for h, w in SIZES[1:] + [(200, 328)]:
        for kind in ("noise", "smooth"):
            if (h, w) == (200, 328) and kind == "noise":
                continue  # PIL cannot write a noise frame this large progressively into memory
            data = CUT_SOURCES[source](_texture(rng, h, w, kind))
            scans = jpeg.read_header(data).scans
            for n in range(1, len(scans)):
                cut = _first_scans(data, n) if n != 2 else data[: scans[1].end]
                header = jpeg.read_header(cut)
                got = _decode_both(cut) if h * w < 5000 else jpeg.decode(cut, header)
                if n == 2:
                    (tmp_path / "cut.jpg").write_bytes(cut)
                    want = cv2.imread(str(tmp_path / "cut.jpg"))[..., ::-1]
                else:
                    want = _cv2_rgb(cut)
                np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {kind} after scan {n}")


def _progression_patched(data: bytes) -> bytes:
    """``data`` with its second scan's Ss set past its Se (1-5 → 6-5)."""
    at = data.index(b"\xff\xda", data.index(b"\xff\xda") + 1)
    return data[: at + 5 + 2 * data[at + 4]] + b"\x06" + data[at + 6 + 2 * data[at + 4] :]


REFUSALS = {
    **{name: (make, ValueError, "bad Huffman table") for name, make in CORRUPT_TABLES.items()},
    "lossless": (lambda d, img: _patched(d, 0xC0, 1, 0xC3), NotImplementedError, "lossless"),
    "arithmetic": (lambda d, img: _patched(d, 0xC0, 1, 0xC9), NotImplementedError, "arithmetic"),
    "progressive_arithmetic": (lambda d, img: _patched(_pil(img, quality=90, progressive=True), 0xC2, 1, 0xCA),
                               NotImplementedError, "arithmetic-coded JPEG .SOF10"),
    "12_bit": (lambda d, img: _patched(d, 0xC0, 4, 12), NotImplementedError, "12-bit"),
    "bad_progression": (lambda d, img: _progression_patched(_pil(img, quality=90, progressive=True)), ValueError,
                        "bad progression"),
    "truncated_progressive": (lambda d, img: _pil(img, quality=90, progressive=True)[:1500], ValueError, "truncated"),
    "truncated_scan": (lambda d, img: d[: len(d) // 2], ValueError, "truncated"),
    "truncated_header": (lambda d, img: d[:100], ValueError, "truncated"),
    "not_jpeg": (lambda d, img: b"\xff\xd8\x00" + d[3:], ValueError, "not a JPEG"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_the_file(tmp_path, name):
    """What the decoder does not read raises NotImplementedError naming the
    file and the feature; a scan cut off inside its data, a corrupt file, or a scan of bad
    progression parameters, raises ValueError naming the file; the plain
    decode raises as the compiled one does."""
    make, kind, words = REFUSALS[name]
    img = _texture(np.random.default_rng(2), 37, 53, "noise")
    data = make(cv2.imencode(".jpg", img)[1].tobytes(), img)
    path = str(tmp_path / f"{name}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(kind, match=rf"{name}\.jpg.*{words}"):
        jpeg.imread(path)
    if name in ("truncated_scan", "truncated_progressive", "bad_progression") or name in CORRUPT_TABLES:
        with pytest.raises(kind, match=rf"{name}\.jpg.*{words}"):
            jpeg.decode_plain(data, jpeg.read_header(data, path), path)
    if name in CORRUPT_TABLES or name == "bad_progression":  # refused as libjpeg refuses them
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None


def test_frame_reader_picks_the_decoder_by_signature(tmp_path):
    """A PNG named .jpg and a JPEG named .png are read as cv2 reads them;
    any other file raises ValueError naming it."""
    img = _texture(np.random.default_rng(4), 9, 17, "noise")
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    os.replace(tmp_path / "a.png", tmp_path / "png_named.jpg")
    os.replace(tmp_path / "b.jpg", tmp_path / "jpeg_named.png")
    for name in ("png_named.jpg", "jpeg_named.png"):
        np.testing.assert_array_equal(image.imread(str(tmp_path / name)), cv2.imread(str(tmp_path / name))[..., ::-1])
    (tmp_path / "text.jpg").write_text("not an image")
    with pytest.raises(ValueError, match="text.jpg"):
        image.imread(str(tmp_path / "text.jpg"))
    assert png.SIGNATURE == b"\x89PNG\r\n\x1a\n" and jpeg.SIGNATURE == b"\xff\xd8\xff"


# --------------------------------------------------------------------------- #
# the Adobe reader over a clip list of JPEG frames


JPEG_H, JPEG_W = 16, 24


def _write_frame(path, img, kind, name):
    """One frame of the clip list: cv2's (or PIL's) and the writer's files."""
    if kind == "baseline":
        if name == "exif6":
            data = chip_smoke.jpeg_bytes(img, quality=90, sampling="420", orientation=6)
        else:
            cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
            return
    elif kind == "progressive":
        data = {"landscape": lambda: _pil(img, quality=90, progressive=True),
                "portrait": lambda: cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes(),
                "exif6": lambda: chip_smoke.jpeg_bytes(img, quality=90, orientation=6, scans="progressive",
                                                       restart=2)}[name]()
    else:
        data = {"landscape": lambda: _pil(Image.fromarray(img).convert("CMYK"), quality=90),
                "portrait": lambda: chip_smoke.jpeg_bytes(img, quality=90, colour="ycck"),
                "exif6": lambda: chip_smoke.jpeg_bytes(img, quality=90, colour="cmyk", orientation=6,
                                                       scans="progressive")}[name]()
    with open(path, "wb") as f:
        f.write(data)


@pytest.fixture(scope="module", params=["baseline", "progressive", "cmyk"])
def jpeg_dataset(request, tmp_path_factory):
    """``make_clips``' list of three directories of 12 JPEG frames: landscape
    frames, portrait frames (stored flipped, swapped back by both readers),
    and landscape-stored frames with EXIF orientation 6 (turned portrait on
    decode, then swapped back); baseline (cv2's and the writer's), progressive
    (PIL's, cv2's and the writer's), or four-component (PIL's CMYK, the
    writer's YCCK and progressive CMYK)."""
    root = tmp_path_factory.mktemp(f"jpeg_data_{request.param}")
    h, w = JPEG_H, JPEG_W
    rng = np.random.default_rng(21)
    clips = []
    for name in ("landscape", "portrait", "exif6"):
        folder = root / "adobe_train" / name
        os.makedirs(folder)
        for i in range(12):
            img = _texture(rng, *((w, h) if name == "portrait" else (h, w)), "smooth" if i % 2 else "noise")
            _write_frame(str(folder / f"frame_{i:05d}.jpg"), img, request.param, name)
        clips += make_clips.process_single_dir(str(folder), clip_length=12, step=12)
    assert len(clips) == 3 and all(p.endswith(".jpg") for c in clips for p in c)
    assert cv2.imread(clips[2][0]).shape == (w, h, 3)  # the EXIF turn makes it portrait before the swap
    make_clips.write_clip_list(clips, str(root / "adobe_train.txt"))
    return {"ADOBE_DATA": {"TRAINPATHS": root / "adobe_train.txt", "H_IN": h, "W_IN": w}, "root": root}


def test_adobe_reader_over_jpeg_clip_list_equals_jax(jpeg_dataset):
    """The port's Adobe reader over the JPEG clip list (baseline,
    progressive or four-component frames) equals the JAX reader's samples
    and ``read_sample``, float64 for float64."""
    cfg, jcfg = _configs(jpeg_dataset, "ADOBE", eval_mode=False)
    ours, theirs = readers.build_reader(cfg, "TRAIN"), jax_readers.build_reader(jcfg, "TRAIN")
    assert ours.clips == theirs.clips and len(ours) == 3
    for idx in range(3):
        for a, b in zip(ours.__getitem__(idx, rng=np.random.default_rng([4, idx])),
                        theirs.__getitem__(idx, rng=np.random.default_rng([4, idx]))):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        got, want = ours.read_sample(ours.clips[idx], range(12)), theirs.read_sample(theirs.clips[idx], range(12))
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (12, JPEG_H, JPEG_W, 3)
        np.testing.assert_array_equal(got, want)


def test_loader_over_jpeg_clip_list_equals_jax_on_threads(jpeg_dataset):
    """``get_dataset`` over the JPEG list, 4 loader threads decoding at once
    through the compiled routines (one pass, or the scans' coefficient
    buffers), equals the JAX package's batches over two epochs."""
    cfg, jcfg = _configs(jpeg_dataset, "ADOBE", eval_mode=False, workers=4, batch=1)
    ours, theirs = get_dataset(cfg, "TRAIN"), jax_readers.get_dataset(jcfg, "TRAIN")
    assert len(ours) == len(theirs) == 3
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# the three cv2 transforms against the JAX package's classes


def _frames(rng, n, h, w, integer=True):
    x = rng.random((n, h, w, 3)) * 255
    return np.round(x) if integer else x


@pytest.mark.parametrize("seed", range(6))
def test_random_mirror_rotate_equals_jax(seed):
    """The same draws in the same order (flip, centre, angle) and cv2's
    warpAffine bit for bit, on a reader's float64 frames, landscape and
    portrait, and on non-integer frames."""
    rng = np.random.default_rng(100 + seed)
    for frames in (_frames(rng, 3, 37, 53), _frames(rng, 2, 53, 37), _frames(rng, 2, 24, 40, integer=False)):
        got = augmentations.RandomMirrorRotate(9.0)(frames, rng=np.random.default_rng(seed))
        want = jax_augmentations.RandomMirrorRotate(9.0)(frames, rng=np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == frames.shape
        np.testing.assert_array_equal(got, want)
    assert augmentations.RandomMirrorRotate.stochastic and jax_augmentations.RandomMirrorRotate.stochastic


RESIZE_CASES = [(0.5, (10, 16)), (0.7, (20, 30)), (0.5, (30, 40)), (1.3, (40, 60)), (0.5, (18, 26))]


@pytest.mark.parametrize("dtype", ["float64", "uint8"])
@pytest.mark.parametrize("ratio,crop", RESIZE_CASES, ids=[f"r{r}_{c[0]}x{c[1]}" for r, c in RESIZE_CASES])
def test_resize_crop_equals_jax(ratio, crop, dtype):
    """cv2.resize bit for bit (float64: fused multiply-adds; uint8: fixed
    point), downscales, upscales and the resize to at least the crop, then
    the same crop draw; float64 as a reader gives frames, uint8 as a caller
    may."""
    rng = np.random.default_rng(int(ratio * 10) + crop[0])
    for frames in (_frames(rng, 3, 37, 53), _frames(rng, 2, 36, 52, integer=False)):
        frames = frames.astype(dtype)
        got = augmentations.ResizeCrop(*crop, resize_ratio=ratio)(frames, rng=np.random.default_rng(7))
        want = jax_augmentations.ResizeCrop(*crop, resize_ratio=ratio)(frames, rng=np.random.default_rng(7))
        assert got.dtype == want.dtype == frames.dtype and got.shape == want.shape == (len(frames), *crop, 3)
        np.testing.assert_array_equal(got, want)


def test_binarize_equals_jax():
    """cv2's BGR2GRAY on uint8 (OpenCV 5's 15-bit weights) and threshold 1,
    exactly, on frames near the threshold and on noise; the image buffer
    passes through."""
    rng = np.random.default_rng(9)
    img = _frames(rng, 2, 9, 17)
    gt = np.concatenate([np.round(rng.random((2, 37, 53, 3)) * 3), _frames(rng, 2, 37, 53)])
    got, want = augmentations.Binarize()([img, gt]), jax_augmentations.Binarize()([img, gt])
    assert got[0] is img and want[0] is img
    assert got[1].dtype == want[1].dtype == np.float64 and got[1].shape == want[1].shape == (4, 37, 53, 1)
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < got[1][:2].mean() < 1


def test_grey_weights_equal_cv2_on_every_colour():
    """The Binarize grey level equals cv2.cvtColor(BGR2GRAY) for all 2^24
    colours (OpenCV 5 weighs 3735, 19235, 9798 / 2^15; 4.x used 1868,
    9617, 4899 / 2^14, which differs on 43864 of them)."""
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    img = np.stack([b, g, r], axis=-1).reshape(4096, 4096, 3).astype(np.uint8)
    x = img.astype(np.int32)
    grey = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
    np.testing.assert_array_equal(grey, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


RESIZE_SHAPES = [(37, 53, 18, 26), (37, 53, 40, 60), (29, 41, 13, 30), (20, 20, 10, 10), (30, 45, 64, 96),
                 (2, 3, 9, 11), (57, 91, 224, 224), (5, 5, 4, 6)]


@pytest.mark.parametrize("h,w,nh,nw", RESIZE_SHAPES, ids=[f"{a}x{b}_to_{c}x{d}" for a, b, c, d in RESIZE_SHAPES])
def test_resize_linear_equals_cv2(h, w, nh, nw):
    """``resize_linear`` against cv2.resize on float64 (integer-valued and
    not) and uint8 frames of one and three channels. cv2 5.0 perturbs an
    upscale along an axis of 1 pixel by ~1e-5 (not held: no frame is 1 pixel
    wide or high)."""
    rng = np.random.default_rng(h * w + nh)
    for c in (1, 3):
        for img in (np.round(rng.random((h, w, c)) * 255), rng.random((h, w, c)) * 255,
                    rng.integers(0, 256, (h, w, c), dtype=np.uint8)):
            want = cv2.resize(img, (nw, nh)).reshape(nh, nw, c)
            got = augmentations.resize_linear(img, nw, nh)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(37, 53), (9, 17), (96, 64)])
def test_warp_affine_and_rotation_matrix_equal_cv2(h, w):
    """``rotation_matrix`` equals getRotationMatrix2D and ``warp_affine``
    equals warpAffine (bilinear, zero border) for angles up to 40 degrees,
    on integer-valued and non-integer float64 frames."""
    rng = np.random.default_rng(h + w)
    for _ in range(4):
        cx, cy, theta = int(rng.integers(0, w)), int(rng.integers(0, h)), float(rng.uniform(-40, 40))
        m = augmentations.rotation_matrix(cx, cy, theta)
        np.testing.assert_array_equal(m, cv2.getRotationMatrix2D((cx, cy), theta, 1))
        for img in (np.round(rng.random((h, w, 3)) * 255), rng.random((h, w, 3)) * 255):
            np.testing.assert_array_equal(augmentations.warp_affine(img, m, w, h), cv2.warpAffine(img, m, (w, h)))


def test_fma_rounds_once():
    """The emulated fused multiply-add equals the exact a * b + c rounded
    once, on integers, fractions, tiny products and cancellations."""
    rng = np.random.default_rng(12)
    a, b, c = rng.normal(0, 100, 3000), rng.random(3000), rng.normal(0, 100, 3000)
    a[:1000], c[:1000] = np.round(a[:1000]), np.round(c[:1000])
    b[1000:1500] *= 1e-12
    c[1500:2000] = -np.round(a[1500:2000] * b[1500:2000], 3)
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(augmentations.fma(a, b, c), want)
