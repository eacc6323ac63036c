"""The port's TIFF reader on the kinds cv2 reads through libtiff's RGBA
reader past classic grey, RGB and palette, against ``cv2.imread`` bit for
bit, through the frame reader, compiled and plain:

- BigTIFF: every classic case of ``tests/test_torch_raster.py`` rewritten as
  a BigTIFF in its own byte order, PIL's ``big_tiff`` writer, and LONG8
  offsets;
- JPEG compression (7): grey (MinIsBlack, MinIsWhite), RGB, YCbCr 1x1,
  2x1 and 2x2 and CMYK, in strips and tiles, with the JPEGTables field,
  without it and with both, contiguous and separate planes, a last strip
  whose stream is taller than its rows, streams smaller than their
  segment, a progressive stream, PIL's libtiff files, libtiff's fix-up of a
  missing YCbCrSubSampling from the first strip;
- the YCbCr photometric without JPEG: every subsampling libtiff puts (1x1,
  1x2, 2x1, 2x2, 4x1, 4x2, 4x4) in strips and tiles at odd sizes, with none,
  LZW, Deflate (and its predictor) and PackBits, separate planes at 1x1,
  non-default YCbCrCoefficients and ReferenceBlackWhite, the defaults;
- the CMYK photometric, 8 bits, contiguous and separate;

then what cv2 fails on (each a ValueError naming the file), a byte-flip and
truncation fuzz of a JPEG-in-TIFF and of a YCbCr file, and the readers over
a clip list mixing the kinds against the JAX package's ``read_sample``.
Images are at most 64x80; PyTorch runs on one thread."""

import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from superslomo_tpu.data import readers as jax_readers
from superslomo_tpu_torch.data import image, readers, tiff
from tests.test_torch_data import _configs
from tests.test_torch_package import one_torch_thread  # noqa: F401
from tests.test_torch_raster import TIFF_CASES, _pil, _texture, _tiff, _tiff_case

SIZES = [(9, 17), (37, 53), (64, 80)]


def _plain(data: bytes, path: str = "<bytes>") -> np.ndarray:
    return tiff.decode(data, path, plain=True)


def _cv2(tmp_path, data: bytes, name: str):
    """cv2's read of ``data`` written as ``name`` (RGB), or None."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        got = cv2.imread(str(path))
    except cv2.error:  # a size past cv2's limits
        return None
    return None if got is None else got[..., ::-1]


def _check(tmp_path, data: bytes, name: str):
    """The frame reader's decode of ``data`` equals cv2's bit for bit, and
    the plain twins' decode equals the compiled one."""
    want = _cv2(tmp_path, data, name)
    assert want is not None, f"cv2 does not read {name}"
    got = image.imread(str(tmp_path / name))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(_plain(data), got, err_msg=f"{name}: plain")


def _frames(seed):
    """A smooth and a noise frame at each size."""
    rng = np.random.default_rng(seed)
    return [_texture(rng, h, w, kind) for h, w in SIZES for kind in ("smooth", "noise")]


# --------------------------------------------------------------------------- #
# BigTIFF


def _as_bigtiff(classic: bytes) -> bytes:
    """A classic TIFF rewritten as a BigTIFF in its byte order: its bytes
    after the header moved 8 on, its IFD rewritten at the end with 20-byte
    entries (values of up to 8 bytes inline), the strip and tile offsets as
    LONG8."""
    order = "<" if classic[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", classic, 4)
    (n,) = struct.unpack_from(order + "H", classic, ifd)
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
    body = bytearray(classic[:2] + struct.pack(order + "HHHQ", 43, 8, 0, 0) + classic[8:])
    entries = []
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(order + "HHI4s", classic, ifd + 2 + 12 * i)
        size = sizes[kind] * count
        raw = value[:size] if size <= 4 else classic[struct.unpack(order + "I", value)[0]:][:size]
        if tag in (273, 324):
            values = struct.unpack(order + ("H" if kind == 3 else "I") * count, raw)
            kind, raw = 16, struct.pack(order + "Q" * count, *(v + 8 for v in values))
        entries.append((tag, kind, count, raw))
    at = len(body) + len(body) % 2
    body += bytes(len(body) % 2)
    struct.pack_into(order + "Q", body, 8, at)
    blobs = bytearray()
    blob_at = at + 8 + 20 * len(entries) + 8
    table = bytearray(struct.pack(order + "Q", len(entries)))
    for tag, kind, count, raw in entries:
        table += struct.pack(order + "HHQ", tag, kind, count)
        if len(raw) <= 8:
            table += raw.ljust(8, b"\0")
        else:
            table += struct.pack(order + "Q", blob_at + len(blobs))
            blobs += raw + bytes(len(raw) % 2)
    return bytes(body + table + bytes(8) + blobs)


@pytest.mark.parametrize("name", TIFF_CASES)
def test_bigtiff_equals_cv2(tmp_path, name):
    """Every kind the reader reads as classic TIFF (each compression,
    predictor, depth, photometric, layout, byte order, fill order and
    orientation of ``tests/test_torch_raster.py``), written as a BigTIFF:
    equal to cv2's decode, compiled and plain."""
    rng = np.random.default_rng(len(name))
    for i, (h, w) in enumerate([(9, 17), (37, 53)]):
        img = _texture(rng, h, w, "noise" if i else "smooth")
        _check(tmp_path, _as_bigtiff(_tiff_case(name, img)), f"big_{name}_{i}.tif")


@pytest.mark.parametrize("order", ["<", ">"])
def test_bigtiff_writers_equal_cv2(tmp_path, order):
    """PIL's BigTIFF (little-endian) and the test writer's in both byte
    orders, LZW in strips and Deflate tiles with LONG8 offsets, equal cv2."""
    for i, img in enumerate(_frames(3)):
        files = [_tiff(img, 8, 2, order=order, compression=5, rows_per_strip=7, bigtiff=True),
                 _tiff(img, 8, 2, order=order, compression=8, tile=(16, 16), predictor=2, bigtiff=True)]
        if order == "<":
            files.append(_pil(img, "TIFF", big_tiff=True))
        for k, data in enumerate(files):
            _check(tmp_path, data, f"bigtiff_{i}_{k}.tif")


# --------------------------------------------------------------------------- #
# JPEG compression


def _segments(data: bytes) -> list:
    """[(marker, the segment's bytes)] of a JPEG up to its SOS, then (0xDA,
    the rest)."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        (length,) = struct.unpack_from(">H", data, pos + 2)
        if marker == 0xDA:
            out.append((marker, data[pos:]))
            break
        out.append((marker, data[pos:pos + 2 + length]))
        pos += 2 + length
    return out


def _jpeg_stream(block: np.ndarray, subsampling: int, progressive=False) -> tuple:
    """(its DQT and DHT segments, the stream without them and without APPn)
    of PIL's JPEG of ``block``: (h, w) grey, (h, w, 3) stored as given (PIL's
    YCbCr mode converts nothing), or (h, w, 4) CMYK."""
    mode = {2: "L", 3: "YCbCr", 4: "CMYK"}[block.ndim if block.ndim == 2 else block.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(block, mode).save(buf, "JPEG", quality=90, subsampling=subsampling, progressive=progressive)
    segments = _segments(buf.getvalue())
    tables = b"".join(s for m, s in segments if m in (0xDB, 0xC4))
    return tables, b"\xff\xd8" + b"".join(s for m, s in segments if m not in (0xDB, 0xC4) and not 0xE0 <= m <= 0xEF)


def _jpeg_tiff(img, photometric, subsampling=0, tile=None, rows=None, planar=False, tables="shared", tag=None,
               tall_last=False, progressive=False, **kw):
    """A JPEG-compressed TIFF of ``img``, each strip or tile (padded by
    replication) its own JPEG stream: ``tables`` "shared" (abbreviated
    streams and a JPEGTables field), "inline" (whole streams, no field) or
    "both"; ``tag``: the YCbCrSubSampling field; ``tall_last``: the last
    strip coded at the full strip height, its rows past the image made up."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, spp = img.shape
    planes = [img[..., p:p + 1] for p in range(spp)] if planar else [img]
    cw, ch = tile or (w, rows or h)
    chunks, shared = [], None
    for plane in planes:
        for y in range(0, h, ch):
            for x in range(0, w, cw) if tile else [0]:
                block = plane[y:y + ch, x:x + cw]
                if tile or tall_last:
                    block = np.pad(block, ((0, ch - block.shape[0]), (0, (cw - block.shape[1]) if tile else 0),
                                           (0, 0)), mode="edge")
                t, stream = _jpeg_stream(block[..., 0] if block.shape[2] == 1 else block, subsampling, progressive)
                shared = shared or t
                chunks.append(stream if tables == "shared" else stream[:2] + t + stream[2:])
    extra = dict(kw.pop("tags", {}))
    if tables in ("shared", "both"):
        extra[347] = (7, list(b"\xff\xd8" + shared + b"\xff\xd9"))
    if tag:
        extra[530] = (3, list(tag))
    return _tiff(img, 8, photometric, compression=7, tile=tile, rows_per_strip=rows, planar=planar, chunks=chunks,
                 tags=extra, **kw)


def _jpeg_case(name: str, img: np.ndarray) -> bytes:
    cmyk = np.dstack([img, img[..., 1:2] // 3])
    cases = {
        "grey_strips": lambda: _jpeg_tiff(img[..., 0], 1, rows=16),
        "miniswhite_tiles": lambda: _jpeg_tiff(img[..., 1], 0, tile=(16, 16)),
        "rgb_strips": lambda: _jpeg_tiff(img, 2, rows=8),
        "rgb_tiles": lambda: _jpeg_tiff(img, 2, tile=(32, 16)),
        "rgb_inline_tables": lambda: _jpeg_tiff(img, 2, rows=16, tables="inline"),
        "rgb_both_tables": lambda: _jpeg_tiff(img, 2, rows=16, tables="both"),
        "rgb_separate_planes": lambda: _jpeg_tiff(img, 2, rows=16, planar=True),
        "rgb_progressive": lambda: _jpeg_tiff(img, 2, rows=16, progressive=True, tables="inline"),
        "rgb_big_endian_bigtiff": lambda: _jpeg_tiff(img, 2, rows=16, order=">", bigtiff=True),
        "ycbcr_11_strips": lambda: _jpeg_tiff(img, 6, 0, rows=16, tag=(1, 1)),
        "ycbcr_21_strips": lambda: _jpeg_tiff(img, 6, 1, rows=8, tag=(2, 1)),
        "ycbcr_22_strips": lambda: _jpeg_tiff(img, 6, 2, rows=16, tag=(2, 2)),
        "ycbcr_22_tiles": lambda: _jpeg_tiff(img, 6, 2, tile=(16, 16), tag=(2, 2)),
        "ycbcr_21_tiles_inline": lambda: _jpeg_tiff(img, 6, 1, tile=(32, 32), tag=(2, 1), tables="inline"),
        "ycbcr_22_tall_last_strip": lambda: _jpeg_tiff(img, 6, 2, rows=16, tag=(2, 2), tall_last=True),
        "ycbcr_11_no_tag_fixed_up": lambda: _jpeg_tiff(img, 6, 0, rows=16),
        "ycbcr_21_no_tag_fixed_up": lambda: _jpeg_tiff(img, 6, 1, rows=16),
        "ycbcr_separate_11": lambda: _jpeg_tiff(img, 6, rows=16, planar=True, tag=(1, 1)),
        "ycbcr_22_orientation_3": lambda: _jpeg_tiff(img, 6, 2, rows=16, tag=(2, 2), orientation=3),
        "cmyk_strips": lambda: _jpeg_tiff(cmyk, 5, rows=16),
        "cmyk_tiles": lambda: _jpeg_tiff(cmyk, 5, tile=(16, 32)),
        "cmyk_separate_planes": lambda: _jpeg_tiff(cmyk, 5, rows=32, planar=True),
        "pil_rgb": lambda: _pil(img, "TIFF", compression="jpeg"),
        "pil_ycbcr": lambda: _pil(Image.fromarray(img).convert("YCbCr"), "TIFF", compression="jpeg"),
        "pil_cmyk": lambda: _pil(Image.fromarray(img).convert("CMYK"), "TIFF", compression="jpeg"),
        "pil_grey": lambda: _pil(Image.fromarray(img).convert("L"), "TIFF", compression="jpeg"),
    }
    return cases[name]()


JPEG_CASES = ["grey_strips", "miniswhite_tiles", "rgb_strips", "rgb_tiles", "rgb_inline_tables", "rgb_both_tables",
              "rgb_separate_planes", "rgb_progressive", "rgb_big_endian_bigtiff", "ycbcr_11_strips",
              "ycbcr_21_strips", "ycbcr_22_strips", "ycbcr_22_tiles", "ycbcr_21_tiles_inline",
              "ycbcr_22_tall_last_strip", "ycbcr_11_no_tag_fixed_up", "ycbcr_21_no_tag_fixed_up",
              "ycbcr_separate_11", "ycbcr_22_orientation_3", "cmyk_strips", "cmyk_tiles", "cmyk_separate_planes",
              "pil_rgb", "pil_ycbcr", "pil_cmyk", "pil_grey"]


@pytest.mark.parametrize("name", JPEG_CASES)
def test_jpeg_tiff_equals_cv2(tmp_path, name):
    """JPEG-compressed TIFFs: each strip or tile an abbreviated or whole
    JPEG stream, its colour set by the TIFF (YCbCr turned to RGB by
    libjpeg's fancy upsampling, strip by strip; every other photometric's
    components as stored, then the TIFF's colour routine): equal to cv2."""
    for i, img in enumerate(_frames(len(name))):
        _check(tmp_path, _jpeg_case(name, img), f"{name}_{i}.tif")


def test_jpeg_streams_smaller_than_their_segment_equal_cv2(tmp_path):
    """A strip's stream shorter or narrower than its strip, and a tile's
    smaller than its tile, fill the segment's top left (the rest 0), as
    libtiff reads them."""
    img = _texture(np.random.default_rng(4), 24, 40, "smooth")
    _, t = _jpeg_stream(img[:6], 0)
    tables, _ = _jpeg_stream(img, 0)
    strips = [_jpeg_stream(b, 0)[1] for b in (img[:6], img[8:16, :32], img[16:22])]
    tiles = [_jpeg_stream(b, 0)[1] for b in (img[:16, :16], img[:12, 16:32], img[:16, 24:40], img[8:24, :8],
                                             img[8:24, 16:32], img[8:24, 24:40])]
    field = {347: (7, list(b"\xff\xd8" + tables + b"\xff\xd9"))}
    _check(tmp_path, _tiff(img, 8, 2, compression=7, rows_per_strip=8, chunks=strips, tags=field), "short.tif")
    _check(tmp_path, _tiff(img, 8, 2, compression=7, tile=(16, 16), chunks=tiles, tags=field), "tiles.tif")


# --------------------------------------------------------------------------- #
# YCbCr and CMYK without JPEG


def _ycc(img: np.ndarray) -> np.ndarray:
    """Y, Cb, Cr samples of an RGB frame (JFIF's, rounded)."""
    r, g, b = (img[..., c].astype(np.float64) for c in range(3))
    ycc = [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
           128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
    return np.clip(np.round(np.stack(ycc, axis=-1)), 0, 255).astype(np.uint8)


YCBCR_CASES = [f"{h}{v}_{layout}" for h, v in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
               for layout in ("strips", "tiles")] + [
    "22_lzw", "22_deflate_predictor", "42_packbits_big_endian", "44_odd_units_lzw", "separate_11",
    "coefficients_and_reference", "reference_degenerate", "no_subsampling_tag", "pil_ycbcr", "bigtiff_21"]


def _ycbcr_case(name: str, img: np.ndarray) -> bytes:
    ycc = _ycc(img)
    if name[:2].isdigit() and name[3:] in ("strips", "tiles"):
        hs, vs = int(name[0]), int(name[1])
        layout = {"tile": (16, 16)} if name.endswith("tiles") else {"rows_per_strip": 3 * vs}
        return _tiff(ycc, 8, 6, ycbcr=(hs, vs), **layout)
    cases = {
        "22_lzw": lambda: _tiff(ycc, 8, 6, ycbcr=(2, 2), compression=5, rows_per_strip=6),
        "22_deflate_predictor": lambda: _tiff(ycc, 8, 6, ycbcr=(2, 2), compression=8, predictor=2, rows_per_strip=6),
        "42_packbits_big_endian": lambda: _tiff(ycc, 8, 6, ycbcr=(4, 2), compression=32773, order=">",
                                                tile=(32, 16)),
        "44_odd_units_lzw": lambda: _tiff(ycc[:, :min(ycc.shape[1], 36)], 8, 6, ycbcr=(4, 4), compression=5,
                                          rows_per_strip=8),
        "separate_11": lambda: _tiff(ycc, 8, 6, planar=True, rows_per_strip=5, tags={530: (3, [1, 1])}),
        "coefficients_and_reference": lambda: _tiff(ycc, 8, 6, ycbcr=(2, 1), tags={
            529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
            532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}),
        "reference_degenerate": lambda: _tiff(ycc, 8, 6, ycbcr=(2, 2), tags={
            532: (5, [(15, 1), (236, 3), (127, 2), (127, 2), (1, 3), (128, 1)])}),
        "no_subsampling_tag": lambda: _without_tag(_tiff(ycc, 8, 6, ycbcr=(2, 2)), 530),
        "pil_ycbcr": lambda: _pil(Image.fromarray(img).convert("YCbCr"), "TIFF", compression="tiff_lzw"),
        "bigtiff_21": lambda: _tiff(ycc, 8, 6, ycbcr=(2, 1), bigtiff=True, compression=8, tile=(16, 32)),
    }
    return cases[name]()


def _without_tag(data: bytes, tag: int) -> bytes:
    """A little-endian classic TIFF with ``tag``'s entry renamed to a tag no
    reader knows (65000), so the field takes its default."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    entries = sorted((struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0], data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
                     for i in range(n))
    renamed = [e if t != tag else struct.pack("<H", 65000) + e[2:] for t, e in entries]
    out[ifd + 2:ifd + 2 + 12 * n] = b"".join(sorted(renamed, key=lambda e: struct.unpack_from("<H", e)[0]))
    return bytes(out)


@pytest.mark.parametrize("name", YCBCR_CASES)
def test_ycbcr_tiff_equals_cv2(tmp_path, name):
    """YCbCr TIFFs without JPEG, as libtiff's RGBA reader puts them: data
    units of each subsampling, the chroma replicated, units cut by the
    right or bottom edge, the 4x4 routine's skip past a tile's edge and its
    scanlines 2 bytes short, the tables of TIFFYCbCrToRGBInit from the
    fields or their defaults: equal to cv2."""
    for i, img in enumerate(_frames(len(name))):
        _check(tmp_path, _ycbcr_case(name, img), f"ycbcr_{name}_{i}.tif")


CMYK_CASES = ["contiguous", "contiguous_lzw_tiles", "separate_packbits", "big_endian_deflate_predictor", "pil_cmyk"]


@pytest.mark.parametrize("name", CMYK_CASES)
def test_cmyk_tiff_equals_cv2(tmp_path, name):
    """8-bit CMYK (InkSet CMYK, its default), contiguous and separate,
    turned to RGB as libtiff's put routines turn it: equal to cv2."""
    for i, img in enumerate(_frames(len(name))):
        cmyk = np.dstack([img, (img[..., 0].astype(np.int64) * 7 % 256).astype(np.uint8)])
        data = {"contiguous": lambda: _tiff(cmyk, 8, 5, rows_per_strip=5),
                "contiguous_lzw_tiles": lambda: _tiff(cmyk, 8, 5, compression=5, tile=(16, 16)),
                "separate_packbits": lambda: _tiff(cmyk, 8, 5, compression=32773, planar=True, rows_per_strip=9),
                "big_endian_deflate_predictor": lambda: _tiff(cmyk, 8, 5, order=">", compression=8, predictor=2,
                                                              tags={332: (3, [1])}),
                "pil_cmyk": lambda: _pil(Image.fromarray(img).convert("CMYK"), "TIFF", compression="tiff_lzw")}[name]()
        _check(tmp_path, data, f"cmyk_{name}_{i}.tif")


# --------------------------------------------------------------------------- #
# what cv2 fails on


def _refusals() -> dict:
    rng = np.random.default_rng(12)
    img = _texture(rng, 16, 24, "smooth")
    cmyk = np.dstack([img, img[..., :1]])
    return {
        "ycbcr_16bit": (_tiff(img.astype(np.uint16) * 257, 16, 6, tags={530: (3, [1, 1])}), "16-bit"),
        "cmyk_16bit": (_tiff(cmyk.astype(np.uint16) * 257, 16, 5), "16-bit"),
        "cmyk_5_samples": (_tiff(np.dstack([cmyk, img[..., :1]]), 8, 5, extra=2), "5 channels"),
        "cmyk_inkset_2": (_tiff(cmyk, 8, 5, tags={332: (3, [2])}), "InkSet 2"),
        "ycbcr_14": (_tiff(img, 8, 6, ycbcr=(1, 4)), "1x4"),
        "ycbcr_separate_22": (_tiff(img, 8, 6, planar=True, tags={530: (3, [2, 2])}), "separate planes"),
        "ycbcr_4_samples": (_tiff(np.dstack([img, img[..., :1]]), 8, 6, extra=2, tags={530: (3, [1, 1])}),
                            "YCbCr of 4"),
        "jpeg_sampling_not_the_tag": (_jpeg_tiff(img, 6, 0, rows=8, tag=(2, 2)), "sampling factors"),
        "jpeg_rgb_subsampled": (_jpeg_tiff(img, 2, 2, rows=8), "sampling factors"),
        "jpeg_stream_taller_than_its_strip": (_tiff(img, 8, 2, compression=7, rows_per_strip=8, chunks=[
            _whole_stream(img[:10]), _whole_stream(img[8:16])]), "segment"),
        "jpeg_component_count": (_tiff(img, 8, 2, compression=7, chunks=[_whole_stream(img[..., 0])]), "components"),
        "jpeg_tables_with_a_frame": (_tiff(img, 8, 2, compression=7, chunks=[_jpeg_stream(img, 0)[1]], tags={
            347: (7, list(_pil(img, "JPEG")))}), "not tables alone"),
        "jpeg_12_bit_samples_field": (_tiff(img.astype(np.uint16), 12, 2, compression=7, chunks=[b"\xff\xd8"]),
                                      "12-bit"),
        "bigtiff_offset_size_4": (b"II+\x00\x04\x00\x00\x00" + bytes(40), "offset size 4"),
        "sample_format_4": (_tiff(img, 8, 2, sample_format=4), "SampleFormat 4"),
        "planar_configuration_3": (_tiff(img, 8, 2, raw_tags=((284, 3),)), "PlanarConfiguration 3"),
        "strip_past_the_file": (_set_field(_tiff(img, 8, 2, compression=5), 279, 4000), "past the file's end"),
        "rows_per_strip_past_cv2_buffer": (_set_field(_tiff(img, 8, 2, rows_per_strip=16), 278, 2 ** 24 + 1),
                                           "buffer limits"),
    }


def _whole_stream(block: np.ndarray) -> bytes:
    """PIL's JPEG of ``block`` with its tables, without APPn."""
    tables, stream = _jpeg_stream(block, 0)
    return stream[:2] + tables + stream[2:]


def _set_field(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with the inline value of ``tag``'s entry
    (SHORT or LONG, count 1) set to ``value``."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for i in range(n):
        t, kind = struct.unpack_from("<HH", data, ifd + 2 + 12 * i)
        if t == tag:
            struct.pack_into("<I" if kind == 4 else "<H", out, ifd + 10 + 12 * i, value)
    return bytes(out)


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_name_the_file(tmp_path, name):
    """What cv2 fails on (libtiff's RGBA reader has no routine for it,
    libtiff's JPEG codec refuses the strip, or cv2's own checks) raises
    ValueError naming the file and the fault; cv2 returns None for each."""
    data, words = _refusals()[name]
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=rf"{name}\.tif.*{words}"):
        image.imread(str(path))
    assert _cv2(tmp_path, data, f"{name}.tif") is None


# --------------------------------------------------------------------------- #
# a byte-flip and truncation fuzz


FUZZ_FILES = {"jpeg_ycbcr_22": lambda img: _jpeg_tiff(img, 6, 2, rows=8, tag=(2, 2)),
              "ycbcr_22_deflate": lambda img: _tiff(_ycc(img), 8, 6, ycbcr=(2, 2), rows_per_strip=8, compression=8)}
_SCAN_FAULTS = ("the scan ends before its last block", "a Huffman code not in its table", "restart marker",
                "the scan ends at a marker")  # the JPEG scan faults libjpeg only warns about


def _outcome(data: bytes, plain: bool):
    """The decode's array, or (the exception's type, its message without
    the path)."""
    try:
        return tiff.decode(data, "f", plain=plain)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e).split(": ", 1)[1]


@pytest.mark.parametrize("name", sorted(FUZZ_FILES))
def test_fuzz_compiled_equals_plain_and_refuses_where_cv2_fails(tmp_path, name):
    """160 copies of a 24x40 file, each with one byte flipped or cut short:
    the compiled decode and the plain twins give the same array or the same
    refusal; where the port reads a copy, cv2 reads it to the same array;
    where cv2 returns None, the port refuses. Where cv2 reads a copy and the
    port refuses, the refusal is one of the faults the port does not repair
    as libtiff does (``ROADMAP.md``): a strip whose compressed data fails to
    decode (cv2's RGBA read goes on with the strip as far as it decoded), a
    JPEG strip's entropy-coded data that libjpeg decodes with a warning, or
    a compression code that libtiff has no codec for (cv2 reads it black)."""
    base = FUZZ_FILES[name](_texture(np.random.default_rng(20), 24, 40, "smooth"))
    rng = np.random.default_rng(7)
    for n in range(160):
        data = bytearray(base)
        if n % 4 == 0:
            data = data[:int(rng.integers(8, len(data)))]
        else:
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        data = bytes(data)
        want = _cv2(tmp_path, data, f"fuzz_{n}.tif")
        got, plain = _outcome(data, False), _outcome(data, True)
        if isinstance(got, tuple) or isinstance(plain, tuple):
            assert got == plain, (n, got, plain)
        else:
            np.testing.assert_array_equal(plain, got, err_msg=f"copy {n}: plain")
        if not isinstance(got, tuple):
            assert want is not None, f"copy {n}: the port reads what cv2 fails on"
            np.testing.assert_array_equal(got, want, err_msg=f"copy {n}")
        elif want is not None:
            kind, message = got
            assert (kind == "ValueError" and ("holds too little data" in message or any(
                f in message for f in _SCAN_FAULTS))) or (kind == "NotImplementedError" and "compression" in message), \
                (n, got)


# --------------------------------------------------------------------------- #
# the readers over a clip list of these kinds, against the JAX package's


FRAME_H, FRAME_W = 20, 28
MIXED = [lambda img: _as_bigtiff(_tiff(img, 8, 2, compression=5, rows_per_strip=7)),
         lambda img: _jpeg_tiff(img, 6, 2, rows=16, tag=(2, 2)),
         lambda img: _tiff(_ycc(img), 8, 6, ycbcr=(2, 2), compression=5, rows_per_strip=6),
         lambda img: _tiff(np.dstack([img, img[..., 2] // 4]), 8, 5, compression=8, tile=(16, 16)),
         lambda img: _jpeg_tiff(img, 2, tile=(16, 16)),
         lambda img: _pil(Image.fromarray(img).convert("YCbCr"), "TIFF", compression="jpeg")]


@pytest.fixture(scope="module")
def tiff_list(tmp_path_factory):
    """An ADOBE train list of two 12-frame clips whose frames are, in turn,
    a BigTIFF, JPEG-in-TIFF YCbCr 4:2:0 strips, YCbCr 2x2 with LZW, CMYK
    Deflate tiles, JPEG-in-TIFF RGB tiles and PIL's JPEG-in-TIFF."""
    root = tmp_path_factory.mktemp("tiff_list")
    rng = np.random.default_rng(41)
    clips = []
    for c in range(2):
        os.makedirs(root / f"clip_{c}")
        paths = [str(root / f"clip_{c}" / f"frame_{i:05d}.tif") for i in range(12)]
        for i, path in enumerate(paths):
            with open(path, "wb") as f:
                f.write(MIXED[(i + c) % len(MIXED)](_texture(rng, FRAME_H, FRAME_W, "smooth" if i % 2 else "noise")))
        clips.append(paths)
    (root / "adobe_train.txt").write_text("".join(f"{len(p)}\n" + "".join(q + "\n" for q in p) for p in clips))
    return {"ADOBE_DATA": {"TRAINPATHS": root / "adobe_train.txt", "H_IN": FRAME_H, "W_IN": FRAME_W}, "root": root}


def test_reader_over_tiff_kinds_equals_jax(tiff_list):
    """The port's ADOBE reader over the list equals the JAX package's
    (``read_sample`` through ``cv2.imread``) item for item and float64 for
    float64."""
    cfg, jcfg = _configs(tiff_list, "ADOBE", eval_mode=False)
    ours, theirs = readers.build_reader(cfg, "TRAIN"), jax_readers.build_reader(jcfg, "TRAIN")
    assert ours.clips == theirs.clips and len(ours) == len(theirs) == 2
    for idx in range(2):
        for a, b in zip(ours.__getitem__(idx, rng=np.random.default_rng([8, idx])),
                        theirs.__getitem__(idx, rng=np.random.default_rng([8, idx]))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got, want = ours.read_sample(ours.clips[idx], range(12)), theirs.read_sample(theirs.clips[idx], range(12))
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (12, FRAME_H, FRAME_W, 3)
        np.testing.assert_array_equal(got, want)
