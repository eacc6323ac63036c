"""The port's uncompressed and lossless raster readers on the CPU against
``cv2.imread`` (the JAX package's decoder): BMP, PBM / PGM / PPM, PAM, PFM,
TIFF, Sun raster and Radiance HDR files, bit for bit, as cv2 and PIL write
them and as the byte writers below write what neither does (BMP bit fields,
top-down rows, OS/2 headers and RLE with deltas; ASCII Netpbm with comments
and a maxval of 1000; TIFF tiles, separate planes, big-endian samples, LSB
fill order and MinIsWhite; Sun raster colour maps, 1- and 32-bit; HDR
run-length, flat and mixed scanlines), at odd sizes up to 64x64 and at 200x328; each
compiled routine of ``csrc/raster_decode.cpp`` against its plain twin; the
frame reader's choice by signature; each refusal, which names the file and
the feature; and one file of each kind that a refusal named until the
reader read it (BigTIFF, JPEG-in-TIFF, YCbCr and CMYK TIFF, held in full by
``tests/test_torch_tiff.py``)."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from superslomo_tpu_torch.data import bmp, hdr, image, raster, tiff
from tests.test_torch_package import one_torch_thread  # noqa: F401

SIZES = [(1, 1), (9, 17), (37, 53), (64, 64), (200, 328)]


def _texture(rng, h, w, kind):
    """(h, w, 3) uint8: uniform noise, or a smooth sum of sines."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 6.3, 3)
    return np.stack([128 + 120 * np.sin(xx / (3 + i) + yy / (5 + 2 * i) + phase[i]) for i in range(3)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _check(tmp_path, data: bytes, name: str, plain=None, columns=None):
    """The frame reader's decode of ``data`` (written as ``name``) equals
    ``cv2.imread``'s bit for bit (in the first ``columns`` columns where cv2
    sets no more), and so does ``plain(data)`` where given."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None, f"cv2 does not read {name}"
    want = want[..., ::-1]
    got = image.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got[:, :columns], want[:, :columns], err_msg=name)
    if plain is not None:
        np.testing.assert_array_equal(plain(data), got, err_msg=f"{name}: plain")


def _images(seed):
    """A noise and a smooth frame at each size."""
    rng = np.random.default_rng(seed)
    return [_texture(rng, h, w, kind) for h, w in SIZES for kind in ("noise", "smooth")]


def _small(img) -> bool:
    return img.shape[0] * img.shape[1] <= 64 * 64


def _pil(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    (Image.fromarray(img) if isinstance(img, np.ndarray) else img).save(buf, fmt, **kw)
    return buf.getvalue()


def _palette_image(img, colours):
    """(palette indices (h, w) below ``colours``, the palette (colours, 3) RGB)."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    return (img.astype(np.int64).sum(axis=2) * colours // 766).astype(np.uint8), pal


# --------------------------------------------------------------------------- #
# BMP


def _bmp(pixels: bytes, w, h, bpp, comp=0, header=40, palette=None, used=0, masks=None, top_down=False):
    """A bitmap of the given pixel bytes: BITMAPINFOHEADER (40), V4 (108),
    V5 (124) or OS/2 v1 (12); ``palette`` (n, 3) RGB; ``masks`` (r, g, b)
    written after the header."""
    if palette is not None and not used and len(palette) < 1 << bpp and header != 12:
        used = len(palette)  # else cv2 reads 2^bpp entries, past the file's end in a small one
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        pal = b"" if palette is None else palette[:, ::-1].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, comp, len(pixels), 2835, 2835,
                           used, 0)
        info += bytes(header - 40)
        pal = b"" if palette is None else np.concatenate(
            [palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)], axis=1).tobytes()
    extra = b"" if masks is None else struct.pack("<III", *masks)
    offset = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra + pal + pixels


def _rows(arr: np.ndarray, top_down=False) -> bytes:
    """(h, row bytes) → the rows padded to 4 bytes, bottom-up unless top_down."""
    pad = -arr.shape[1] % 4
    arr = np.pad(arr, ((0, 0), (0, pad)))
    return (arr if top_down else arr[::-1]).tobytes()


def _packed(idx: np.ndarray, bits: int) -> np.ndarray:
    """(h, w) indices packed MSB first, ``bits`` each, rows padded to bytes."""
    h, w = idx.shape
    b = ((idx[..., None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8).reshape(h, w * bits)
    return np.packbits(b, axis=1)


def _rle8(idx: np.ndarray, delta=False, early_eof=False) -> bytes:
    """RLE8 rows (bottom-up): runs of equal indices as encoded runs, others
    as absolute runs of 3 or more, an end of line after each row; with
    ``delta``, a delta over the second row's middle third (its pixels then
    index 0); with ``early_eof``, an end of bitmap after the first half of
    the rows."""
    h, w = idx.shape
    out = bytearray()
    rows = idx[::-1]
    for y, row in enumerate(rows):
        if early_eof and y == h // 2 and y:
            out += b"\x00\x01"
            return bytes(out)
        x = 0
        while x < w:
            if delta and y == 1 and x == w // 3 and w >= 6:
                out += bytes([0, 2, w // 3, 0])
                x += w // 3
                continue
            run = 1
            while x + run < w and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
            else:
                n = 3
                while x + n < w and n < 255 and not (x + n + 1 < w and row[x + n] == row[x + n + 1]):
                    n += 1
                out += bytes([0, n]) + row[x:x + n].tobytes() + (b"\x00" if n % 2 else b"")
                x += n
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def _rle4(idx: np.ndarray, delta=False) -> bytes:
    """RLE4 rows (bottom-up): runs of alternating pairs of indices; with
    ``delta``, a delta over the second row's middle third."""
    h, w = idx.shape
    out = bytearray()
    for y, row in enumerate(idx[::-1]):
        x = 0
        while x < w:
            if delta and y == 1 and x == w // 3 and w >= 6:
                out += bytes([0, 2, w // 3, 0])
                x += w // 3
                continue
            if w - x >= 4 and x % 2 == 0:  # an absolute run of 4
                out += bytes([0, 4, row[x] << 4 | row[x + 1], row[x + 2] << 4 | row[x + 3]])
                x += 4
                continue
            n = 2 if w - x >= 2 and row[x] != row[x + 1] else 1
            while n == 1 and x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            out += bytes([n, row[x] << 4 | (row[x + 1] if n == 2 and x + 1 < w else row[x])])
            x += n
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def _bmp_case(name, img):
    h, w = img.shape[:2]
    bgr = img[..., ::-1]
    idx8, pal8 = _palette_image(img, 200)
    idx4, pal4 = _palette_image(img, 16)
    idx1, pal1 = _palette_image(img, 2)
    v = img.astype(np.uint16)
    if name == "cv2_24":
        return cv2.imencode(".bmp", bgr)[1].tobytes()
    if name == "cv2_grey":
        return cv2.imencode(".bmp", bgr[..., 1])[1].tobytes()
    if name.startswith("pil_"):
        mode = name[4:].upper()
        return _pil(Image.fromarray(img).convert({"P": "P", "1": "1", "L": "L", "RGB": "RGB"}.get(mode, "RGBA"))
                    if mode != "RGBA" else np.dstack([img, img[..., :1]]), "BMP")
    if name == "8bit_used_200":
        return _bmp(_rows(idx8), w, h, 8, palette=pal8, used=200)
    if name == "8bit_indices_past_palette":
        return _bmp(_rows(idx8), w, h, 8, palette=pal8[:100], used=100)
    if name == "4bit":
        return _bmp(_rows(_packed(idx4, 4)), w, h, 4, palette=pal4)
    if name == "1bit_top_down":
        return _bmp(_rows(_packed(idx1, 1), True), w, h, 1, palette=pal1, used=2, top_down=True)
    if name == "16bit_555":
        p = (v[..., 0] >> 3) << 10 | (v[..., 1] >> 3) << 5 | v[..., 2] >> 3
        return _bmp(_rows(p.astype("<u2").view(np.uint8).reshape(h, -1)), w, h, 16)
    if name == "16bit_565_bitfields":
        p = (v[..., 0] >> 3) << 11 | (v[..., 1] >> 2) << 5 | v[..., 2] >> 3
        return _bmp(_rows(p.astype("<u2").view(np.uint8).reshape(h, -1)), w, h, 16, comp=3,
                    masks=(0xF800, 0x7E0, 0x1F))
    if name == "16bit_555_bitfields":
        p = (v[..., 0] >> 3) << 10 | (v[..., 1] >> 3) << 5 | v[..., 2] >> 3
        return _bmp(_rows(p.astype("<u2").view(np.uint8).reshape(h, -1)), w, h, 16, comp=3,
                    masks=(0x7C00, 0x3E0, 0x1F))
    if name == "32bit_bitfields":
        bgra = np.dstack([bgr, img[..., :1]])
        return _bmp(_rows(bgra.reshape(h, -1)), w, h, 32, comp=3, masks=(0xFF0000, 0xFF00, 0xFF))
    if name == "24bit_top_down":
        return _bmp(_rows(bgr.reshape(h, -1), True), w, h, 24, top_down=True)
    if name == "v4_24bit":
        return _bmp(_rows(bgr.reshape(h, -1)), w, h, 24, header=108)
    if name == "v5_32bit":
        return _bmp(_rows(np.dstack([bgr, img[..., 2:]]).reshape(h, -1)), w, h, 32, header=124)
    if name == "os2_8bit":
        return _bmp(_rows(idx8), w, h, 8, header=12, palette=np.resize(pal8, (256, 3)))
    if name == "os2_24bit":
        return _bmp(_rows(bgr.reshape(h, -1)), w, h, 24, header=12)
    if name == "rle8":
        return _bmp(_rle8(idx8), w, h, 8, comp=1, palette=pal8)
    if name == "rle8_delta":
        return _bmp(_rle8(idx8, delta=True), w, h, 8, comp=1, palette=pal8)
    if name == "rle8_early_end":
        return _bmp(_rle8(idx8, early_eof=True), w, h, 8, comp=1, palette=pal8)
    if name == "rle4":
        return _bmp(_rle4(idx4), w, h, 4, comp=2, palette=pal4)
    if name == "rle4_delta":
        return _bmp(_rle4(idx4, delta=True), w, h, 4, comp=2, palette=pal4)
    raise KeyError(name)


BMP_CASES = ["cv2_24", "cv2_grey", "pil_1", "pil_l", "pil_p", "pil_rgb", "pil_rgba", "8bit_used_200",
             "8bit_indices_past_palette", "4bit", "1bit_top_down", "16bit_555", "16bit_565_bitfields",
             "16bit_555_bitfields", "32bit_bitfields", "24bit_top_down", "v4_24bit", "v5_32bit", "os2_8bit",
             "os2_24bit", "rle8", "rle8_delta", "rle8_early_end", "rle4", "rle4_delta"]


@pytest.mark.parametrize("name", BMP_CASES)
def test_bmp_equals_cv2(tmp_path, name):
    """Bitmaps of every header, depth and compression cv2 reads, at each size:
    equal to cv2's decode bit for bit; an RLE file's compiled decode equals
    the plain one."""
    for i, img in enumerate(_images(len(name))):
        data = _bmp_case(name, img)
        plain = (lambda d: bmp.decode(d, plain=True)) if name.startswith("rle") and _small(img) else None
        _check(tmp_path, data, f"{name}_{i}.bmp", plain)


# --------------------------------------------------------------------------- #
# PBM, PGM, PPM, PAM, PFM


def _ascii(values: np.ndarray, per_line=17, comment=False) -> bytes:
    """Numbers, ``per_line`` a line, with a comment line after the first."""
    flat = [str(int(v)) for v in values.reshape(-1)]
    lines = [" ".join(flat[i:i + per_line]) for i in range(0, len(flat), per_line)]
    if comment:
        lines.insert(1, "# a comment 12 34")
    return ("\n".join(lines) + "\n").encode()


def _pam(arr: np.ndarray, maxval, tupltype=None) -> bytes:
    h, w, d = arr.shape
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n"
    head += f"TUPLTYPE {tupltype}\n" if tupltype else ""
    return (head + "ENDHDR\n").encode() + arr.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def _pnm_case(name, img):
    h, w = img.shape[:2]
    bgr = img[..., ::-1]
    wide = img.astype(np.int64) * 257 + img[..., ::-1]
    if name == "cv2_ppm":
        return cv2.imencode(".ppm", bgr)[1].tobytes()
    if name == "cv2_pgm_ascii":
        return cv2.imencode(".pgm", bgr[..., 0], [cv2.IMWRITE_PXM_BINARY, 0])[1].tobytes()
    if name == "cv2_pbm":
        return cv2.imencode(".pbm", (bgr[..., 0] > 127).astype(np.uint8) * 255)[1].tobytes()
    if name == "pbm_ascii":
        return f"P1\n# made by a test\n{w} {h}\n".encode() + _ascii(img[..., 0] > 127, 35)
    if name == "pgm_ascii_maxval_1000_comments":
        return f"P2\n{w} # width\n{h}\n1000\n".encode() + _ascii(img[..., 0].astype(np.int64) * 4 + 3, comment=True)
    if name == "ppm_ascii_maxval_15":
        return f"P3\n{w} {h}\n15\n".encode() + _ascii(img >> 4)
    if name == "pgm_binary_maxval_100":
        return f"P5\n{w} {h}\n100\n".encode() + (img[..., 0] * 100 // 255).astype(np.uint8).tobytes()
    if name == "ppm_binary_16bit":
        return f"P6 {w} {h} 65535\n".encode() + wide.astype(">u2").tobytes()
    if name == "cv2_pam":
        return cv2.imencode(".pam", bgr)[1].tobytes()
    if name == "cv2_pam_grey":
        return cv2.imencode(".pam", bgr[..., 1])[1].tobytes()
    if name == "pam_rgb_16bit":
        return _pam(wide, 65535, "RGB")
    if name == "pam_grayscale_maxval_100":
        return _pam(img[..., :1] * 100 // 255, 100, "GRAYSCALE")
    if name == "pam_blackandwhite":  # a byte a sample, 0 or 1
        return _pam((img[..., :1] > 127).astype(np.uint8), 1, "BLACKANDWHITE")
    if name == "pam_rgb_alpha":
        return _pam(np.dstack([img, img[..., :1]]), 255, "RGB_ALPHA")
    if name == "pam_grayscale_alpha":
        return _pam(img[..., :2], 255, "GRAYSCALE_ALPHA")
    if name == "cv2_pfm":
        return cv2.imencode(".pfm", (bgr / 200.0 - 0.1).astype(np.float32) * 300)[1].tobytes()
    if name == "pfm_big_endian_scale_2":
        v = (img / 100.0).astype(np.float32) * np.float32(2)
        return f"PF\n{w} {h}\n2.0\n".encode() + v[::-1].astype(">f4").tobytes()
    if name == "pfm_halves_and_extremes":
        v = (img.astype(np.float32) - 64) / np.float32(2)
        v[0, 0] = [np.nan, np.inf, 3e9]
        return f"PF\n{w} {h}\n-1.0\n".encode() + v[::-1].astype("<f4").tobytes()
    raise KeyError(name)


PNM_CASES = ["cv2_ppm", "cv2_pgm_ascii", "cv2_pbm", "pbm_ascii", "pgm_ascii_maxval_1000_comments",
             "ppm_ascii_maxval_15", "pgm_binary_maxval_100", "ppm_binary_16bit", "cv2_pam", "cv2_pam_grey",
             "pam_rgb_16bit", "pam_grayscale_maxval_100", "pam_blackandwhite", "pam_rgb_alpha",
             "pam_grayscale_alpha", "cv2_pfm", "pfm_big_endian_scale_2", "pfm_halves_and_extremes"]


@pytest.mark.parametrize("name", PNM_CASES)
def test_netpbm_equals_cv2(tmp_path, name):
    """PBM, PGM, PPM, PAM and PFM files, ASCII and binary, of every maxval
    kind, with comments: equal to cv2's decode bit for bit (a PAM of 2 or 4
    samples a pixel in the first ceil(W / DEPTH) columns of each row, all
    that cv2 sets)."""
    for i, img in enumerate(_images(len(name))):
        depth = {"pam_rgb_alpha": 4, "pam_grayscale_alpha": 2}.get(name)
        columns = None if depth is None else -(-img.shape[1] // depth)
        ext = ".pfm" if "pfm" in name else ".pam" if "pam" in name else ".pnm"
        _check(tmp_path, _pnm_case(name, img), f"{name}_{i}{ext}", columns=columns)


# --------------------------------------------------------------------------- #
# TIFF


def _packbits(raw: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j + 1 < len(raw) and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1)]) + raw[i:i + 1]
            i = j + 1
            continue
        k = i
        while k < len(raw) and k - i < 128 and not (k + 2 < len(raw) and raw[k] == raw[k + 1] == raw[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + raw[i:k]
        i = k
    return bytes(out)


def _ycbcr_units(block: np.ndarray, hs: int, vs: int) -> bytes:
    """(rows, cols, 3) full-size Y, Cb, Cr as TIFF's YCbCr data units of
    ``hs`` x ``vs`` luma samples, then one Cb and one Cr (the mean of the
    unit's pixels, rounded); a partial unit at the right or bottom edge
    padded by replication."""
    rows, cols = block.shape[:2]
    ur, uc = -(-rows // vs), -(-cols // hs)
    full = np.pad(block, ((0, ur * vs - rows), (0, uc * hs - cols), (0, 0)), mode="edge").astype(np.int64)
    units = full.reshape(ur, vs, uc, hs, 3).transpose(0, 2, 1, 3, 4)  # (ur, uc, vs, hs, 3)
    luma = units[..., 0].reshape(ur, uc, vs * hs)
    chroma = (units[..., 1:].reshape(ur, uc, -1, 2).sum(axis=2) + vs * hs // 2) // (vs * hs)
    return np.concatenate([luma, chroma], axis=2).astype(np.uint8).tobytes()


def _tiff(samples: np.ndarray, bits, photometric, order="<", compression=1, tile=None, rows_per_strip=None,
          planar=False, predictor=1, colormap=None, extra=None, orientation=None, fill_lsb=False,
          sample_format=None, width=None, raw_tags=(), bigtiff=False, ycbcr=None, chunks=None, tags=None):
    """A TIFF of (h, w, spp) samples, or of (h, row bytes) rows packed MSB
    first where ``bits`` < 8 (then ``width`` pixels): strips of
    ``rows_per_strip`` or ``tile`` (w, h) tiles, separate planes, compression
    1 (none), 5 (LZW), 8 (Deflate) or 32773 (PackBits), horizontal differencing
    (``predictor`` 2) applied here; ``raw_tags`` (tag, SHORT value) last.
    ``ycbcr`` (hs, vs): the samples are full-size Y, Cb, Cr, written as
    YCbCr data units (``_ycbcr_units``). ``chunks``: the strips' or tiles'
    bytes as given, in place of the samples' (which then give only the
    size). ``tags``: more fields, {tag: (type, values)}, type 3 SHORT, 4
    LONG, 5 RATIONAL ((numerator, denominator) pairs), 7 UNDEFINED (bytes)
    or 16 LONG8. ``bigtiff``: the BigTIFF header and IFD (version 43,
    8-byte offsets and counts, 20-byte entries)."""
    h, W, spp = samples.shape if bits >= 8 else (samples.shape[0], width, 1)
    sdt = np.dtype(order + {16: "u2", 32: "f4"}.get(bits, "u1"))
    planes = [samples[..., p:p + 1] for p in range(spp)] if planar else [samples]
    cw, ch = tile if tile else (W, rows_per_strip or h)
    if chunks is None:
        chunks = []
        for plane in planes:
            for y in range(0, h, ch):
                for x in range(0, W, cw) if tile else [0]:
                    block = plane[y:y + ch, x:x + cw] if bits >= 8 else plane[y:y + ch]
                    if tile:  # tiles are padded to their full size
                        pad = [(0, ch - block.shape[0]), (0, cw - block.shape[1])] + [(0, 0)] * (block.ndim - 2)
                        block = np.pad(block, pad)
                    if ycbcr is not None:
                        raw = _ycbcr_units(block, *ycbcr)
                    else:
                        if predictor == 2:
                            block = block.copy()
                            block[:, 1:] = block[:, 1:] - block[:, :-1]
                        raw = block.astype(sdt).tobytes()
                    if fill_lsb:
                        raw = tiff._REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                    chunks.append(zlib.compress(raw) if compression == 8 else _packbits(raw) if compression == 32773
                                  else chip_smoke.lzw_encode(raw) if compression == 5 else raw)
    fields = {256: (4, [W]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if predictor != 1:
        fields[317] = (3, [predictor])
    if colormap is not None:
        fields[320] = (3, list(colormap.T.reshape(-1)))
    if extra is not None:
        fields[338] = (3, [extra])
    if orientation:
        fields[274] = (3, [orientation])
    if fill_lsb:
        fields[266] = (3, [2])
    if sample_format:
        fields[339] = (3, [sample_format] * spp)
    if ycbcr is not None:
        fields[530] = (3, list(ycbcr))
    for tag, value in raw_tags:
        fields[tag] = (3, [value])
    fields.update(tags or {})
    body = bytearray(b"II" if order == "<" else b"MM")
    body += struct.pack(order + "HHHQ", 43, 8, 0, 0) if bigtiff else struct.pack(order + "HI", 42, 0)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
    size = {3: 2, 4: 4, 16: 8}
    offset_type = 16 if bigtiff else 4
    if tile:
        fields.update({322: (4, [cw]), 323: (4, [ch]), 324: (offset_type, offsets),
                       325: (offset_type, [len(c) for c in chunks])})
    else:
        fields.update({278: (4, [ch]), 273: (offset_type, offsets), 279: (offset_type, [len(c) for c in chunks])})
    ifd = len(body) + len(body) % 2
    body += bytes(len(body) % 2)
    struct.pack_into(order + ("Q" if bigtiff else "I"), body, 8 if bigtiff else 4, ifd)
    entry, inline, count_fmt = (20, 8, "Q") if bigtiff else (12, 4, "I")
    entries, blobs = [], bytearray()
    blob_at = ifd + (8 if bigtiff else 2) + entry * len(fields) + inline
    for tag in sorted(fields):
        kind, values = fields[tag]
        if kind == 5:
            packed, n = struct.pack(order + "I" * 2 * len(values), *[v for pair in values for v in pair]), len(values)
        elif kind == 7:
            packed, n = bytes(values), len(values)
        else:
            packed = struct.pack(order + {2: "H", 4: "I", 8: "Q"}[size[kind]] * len(values), *values)
            n = len(values)
        head = struct.pack(order + "HH" + count_fmt, tag, kind, n)
        if len(packed) <= inline:
            entries.append(head + packed.ljust(inline, b"\0"))
        else:
            entries.append(head + struct.pack(order + ("Q" if bigtiff else "I"), blob_at + len(blobs)))
            blobs += packed + bytes(len(packed) % 2)
    body += struct.pack(order + ("Q" if bigtiff else "H"), len(fields)) + b"".join(entries) + bytes(inline) + blobs
    return bytes(body)


def _tiff_case(name, img):
    h, w = img.shape[:2]
    im = Image.fromarray(img)
    wide = img.astype(np.uint16) * 257 + img[..., ::-1]
    idx4, pal4 = _palette_image(img, 16)
    if name.startswith("pil_"):
        kind = name[4:]
        comp = {"none": None, "lzw": "tiff_lzw", "packbits": "packbits", "deflate": "tiff_adobe_deflate"}
        if kind in comp:
            return _pil(im, "TIFF", compression=comp[kind])
        if kind == "lzw_predictor":
            return _pil(im, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
        if kind == "1bit":
            return _pil(im.convert("1"), "TIFF", compression="packbits")
        if kind == "palette_lzw":
            return _pil(im.convert("P", palette=Image.ADAPTIVE, colors=200), "TIFF", compression="tiff_lzw")
        if kind == "rgba_lzw":
            return _pil(np.dstack([img, img[..., 1]]), "TIFF", compression="tiff_lzw")
        if kind == "grey_alpha":
            return _pil(Image.fromarray(img[..., :2], "LA"), "TIFF", compression="tiff_adobe_deflate")
        if kind == "16bit_grey_lzw_predictor":
            return _pil(Image.fromarray(wide[..., 0]), "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    if name == "cv2_16bit_rgb":
        return cv2.imencode(".tiff", wide[..., ::-1])[1].tobytes()
    if name == "cv2_grey":
        return cv2.imencode(".tiff", img[..., 0])[1].tobytes()
    if name == "tiles_deflate_predictor":
        return _tiff(img, 8, 2, compression=8, tile=(16, 16), predictor=2)
    if name == "tiles_16bit_big_endian":
        return _tiff(wide, 16, 2, order=">", tile=(32, 16))
    if name == "planar_separate_packbits":
        return _tiff(img, 8, 2, compression=32773, planar=True, rows_per_strip=5)
    if name == "planar_separate_rgba_unassociated":
        return _tiff(np.dstack([img, img[..., 2]]), 8, 2, planar=True, rows_per_strip=7, extra=2)
    if name == "rgba_associated_big_endian":
        return _tiff(np.dstack([img, img[..., 2]]), 8, 2, order=">", extra=1, rows_per_strip=3)
    if name == "16bit_rgba_unassociated":
        return _tiff(np.dstack([wide, wide[..., 1]]), 16, 2, extra=2, compression=8)
    if name == "miniswhite_1bit_lsb_fill":
        return _tiff(_packed(img[..., 0] >> 7, 1), 1, 0, fill_lsb=True, width=w)
    if name == "palette_1bit_packbits":
        idx1, pal1 = _palette_image(img, 2)
        return _tiff(_packed(idx1, 1), 1, 3, colormap=pal1.astype(np.uint16) * 257, compression=32773, width=w)
    if name == "miniswhite_8bit":
        return _tiff(img[..., :1], 8, 0, compression=8)
    if name == "palette_4bit_16bit_colormap":
        cmap = pal4.astype(np.uint16) * 257
        return _tiff(_packed(idx4, 4), 4, 3, colormap=cmap, width=w)
    if name == "palette_8bit_8bit_colormap":
        idx, pal = _palette_image(img, 256)
        return _tiff(idx[..., None], 8, 3, colormap=pal.astype(np.uint16), compression=32773)
    if name.startswith("orientation_"):
        o = int(name[-1])
        sq = img[: min(h, w), : min(h, w)] if o > 4 else img
        return _tiff(sq, 8, 2, orientation=o, rows_per_strip=4)
    raise KeyError(name)


TIFF_CASES = ["pil_none", "pil_lzw", "pil_packbits", "pil_deflate", "pil_lzw_predictor", "pil_1bit",
              "pil_palette_lzw", "pil_rgba_lzw", "pil_grey_alpha", "pil_16bit_grey_lzw_predictor", "cv2_16bit_rgb",
              "cv2_grey", "tiles_deflate_predictor", "tiles_16bit_big_endian", "planar_separate_packbits",
              "planar_separate_rgba_unassociated", "rgba_associated_big_endian", "16bit_rgba_unassociated",
              "miniswhite_1bit_lsb_fill", "palette_1bit_packbits", "miniswhite_8bit", "palette_4bit_16bit_colormap",
              "palette_8bit_8bit_colormap"] + [f"orientation_{o}" for o in range(2, 9)]


@pytest.mark.parametrize("name", TIFF_CASES)
def test_tiff_equals_cv2(tmp_path, name):
    """TIFFs of every compression, predictor, depth, photometric, planar
    configuration, byte order, fill order and orientation the reader takes,
    at each size (orientations 5-8 square, as cv2 reads only those): equal to
    cv2's decode bit for bit; an LZW or PackBits file's compiled decode equals
    the plain one."""
    for i, img in enumerate(_images(len(name))):
        data = _tiff_case(name, img)
        compressed = tiff.read_tags(data)[1].get(259, (1,))[0] in (5, 32773)
        plain = (lambda d: tiff.decode(d, plain=True)) if compressed and _small(img) else None
        _check(tmp_path, data, f"{name}_{i}.tif", plain)


# --------------------------------------------------------------------------- #
# Sun raster


def _sun(arr: np.ndarray, depth, kind=1, colormap=None) -> bytes:
    """A Sun raster of (h, row bytes) pixel rows, padded to 16 bits."""
    h = arr.shape[0]
    w = {1: arr.shape[1] * 8, 8: arr.shape[1], 24: arr.shape[1] // 3, 32: arr.shape[1] // 4}[depth]
    body = np.pad(arr, ((0, 0), (0, arr.shape[1] % 2))).tobytes()
    cmap = b"" if colormap is None else colormap.T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind, 1 if cmap else 0, len(cmap)) + cmap + body


def _sun_case(name, img):
    h, w = img.shape[:2]
    idx, pal = _palette_image(img, 256)
    if name == "cv2_24":
        return cv2.imencode(".ras", img[..., ::-1])[1].tobytes()
    if name == "cv2_grey":
        return cv2.imencode(".ras", img[..., 0])[1].tobytes()
    if name == "8bit_colormap":
        return _sun(idx, 8, 1, pal)
    if name == "8bit_short_colormap":
        return _sun(idx, 8, 1, pal[:100])
    if name == "1bit_colormap":
        return _sun(np.packbits(img[..., 0] > 127, axis=1), 1, 1, pal[:2])
    if name == "32bit_xbgr":
        return _sun(np.dstack([img[..., :1], img[..., ::-1]]).reshape(h, -1), 32, 1)
    if name == "1bit":
        return _sun(np.packbits(img[..., 0] > 127, axis=1), 1, 1)
    if name == "8bit_grey_old":
        return _sun(img[..., 1], 8, 0)
    raise KeyError(name)


SUN_CASES = ["cv2_24", "cv2_grey", "8bit_colormap", "8bit_short_colormap", "1bit_colormap", "32bit_xbgr", "1bit",
             "8bit_grey_old"]


@pytest.mark.parametrize("name", SUN_CASES)
def test_sun_raster_equals_cv2(tmp_path, name):
    """Sun rasters of each depth and of the old and standard types, with and
    without a colour map, at each size: equal to cv2's decode bit for bit."""
    for i, img in enumerate(_images(len(name))):
        _check(tmp_path, _sun_case(name, img), f"{name}_{i}.ras")


# --------------------------------------------------------------------------- #
# Radiance HDR


def _rgbe(img, seed):
    """(h, w, 4) RGBE bytes with exponents around 128 (values near 1)."""
    e = np.random.default_rng(seed).integers(126, 131, img.shape[:2] + (1,))
    rgbe = np.concatenate([img, e], axis=2).astype(np.uint8)
    rgbe[0, 0, 3] = 0
    return rgbe


def _hdr_rle_line(row: np.ndarray) -> bytes:
    """A new-style run-length scanline of (w, 4) RGBE bytes."""
    w = row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch, x = row[:, c], 0
        while x < w:
            n = 1
            while x + n < w and ch[x + n] == ch[x] and n < 127:
                n += 1
            if n >= 3:
                out += bytes([128 + n, ch[x]])
                x += n
                continue
            n = 1
            while x + n < w and n < 128 and not (x + n + 2 < w and ch[x + n] == ch[x + n + 1] == ch[x + n + 2]):
                n += 1
            out += bytes([n]) + ch[x:x + n].tobytes()
            x += n
    return bytes(out)


def _hdr_case(name, img):
    h, w = img.shape[:2]
    rgbe = _rgbe(img, w)
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    if name == "cv2":
        return cv2.imencode(".hdr", (img[..., ::-1] / 255.0).astype(np.float32) * 3)[1].tobytes()
    if name == "flat":
        return head + rgbe.tobytes()
    if name == "rle_runs":
        rgbe[:, 1::2] = rgbe[:, ::2][:, : rgbe[:, 1::2].shape[1]]
        return head + b"".join(_hdr_rle_line(r) for r in rgbe)
    if name == "rle_then_flat":
        return head + b"".join(_hdr_rle_line(r) for r in rgbe[: h // 2]) + rgbe[h // 2:].tobytes()
    if name == "rgbe_signature_exposure":
        return f"#?RGBE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\nGAMMA=1\n\n-Y {h} +X {w}\n".encode() + rgbe.tobytes()
    if name == "bright_and_dark":
        rgbe[..., 3] = np.random.default_rng(h).integers(100, 170, (h, w))
        return head + rgbe.tobytes()
    raise KeyError(name)


HDR_CASES = ["cv2", "flat", "rle_runs", "rle_then_flat", "rgbe_signature_exposure", "bright_and_dark"]


@pytest.mark.parametrize("name", HDR_CASES)
def test_hdr_equals_cv2(tmp_path, name):
    """Radiance HDR files, flat, run-length (cv2's own, and with long runs),
    run-length then flat, with other header lines, and with exponents whose
    values pass 2^31 / 255 (cv2's overflow gives 0) or vanish: equal to cv2's
    decode bit for bit; the compiled scanlines equal the plain ones."""
    for i, img in enumerate(_images(len(name))):
        data = _hdr_case(name, img)
        plain = (lambda d: hdr.decode(d, plain=True)) if _small(img) else None
        _check(tmp_path, data, f"{name}_{i}.hdr", plain)


# --------------------------------------------------------------------------- #
# the compiled routines against their plain twins at 200x328


def _routine_case(name):
    img = _texture(np.random.default_rng(7), 200, 328, "smooth")
    idx8, pal8 = _palette_image(img, 200)
    idx4, pal4 = _palette_image(img, 16)
    if name == "lzw":
        data = _pil(img, "TIFF", compression="tiff_lzw", tiffinfo={278: 200})
        tags = tiff.read_tags(data)[1]
        src, cap = data[tags[273][0]:tags[273][0] + tags[279][0]], 200 * 328 * 3
        return raster.stream(src, cap, "lzw_decode"), np.frombuffer(tiff.lzw_plain(src, cap), np.uint8), cap
    if name == "packbits":
        src = _packbits(img.tobytes())
        cap = img.size
        return raster.stream(src, cap, "packbits_decode"), np.frombuffer(tiff.packbits_plain(src, cap), np.uint8), cap
    if name in ("bmp_rle8", "bmp_rle4"):
        data = _bmp(_rle8(idx8, delta=True), 328, 200, 8, comp=1, palette=pal8) if name == "bmp_rle8" else \
            _bmp(_rle4(idx4, delta=True), 328, 200, 4, comp=2, palette=pal4)
        return bmp.decode(data), bmp.decode(data, plain=True), None
    if name == "hdr_scanlines":
        rgbe = _rgbe(img, 3)
        data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 200 +X 328\n" + b"".join(_hdr_rle_line(r) for r in rgbe)
        return hdr.decode(data), hdr.decode(data, plain=True), None
    raise KeyError(name)


@pytest.mark.parametrize("name", ["lzw", "packbits", "bmp_rle8", "bmp_rle4", "hdr_scanlines"])
def test_compiled_routines_equal_plain(name):
    """Each routine of ``csrc/raster_decode.cpp`` on a 200x328 frame's data
    (LZW from PIL's libtiff, the rest from the writers above) equals its
    plain twin bit for bit, whole."""
    got, want, cap = _routine_case(name)
    if cap is not None:
        (out, n) = got
        assert n == cap
        got = out[:n]
    np.testing.assert_array_equal(got, want)


WRITER_CASES = sorted(chip_smoke.RASTER_CASES) + ["loader_" + ext for ext in sorted(chip_smoke.LOADER_FORMATS)]


@pytest.mark.parametrize("name", WRITER_CASES)
def test_chip_smoke_writer_files_decode_as_cv2(tmp_path, name):
    """``chip_smoke.py``'s raster writers (the card's machine has no cv2 or
    PIL): cv2 reads each file to what the script expects of it (where the
    script knows it: not for JPEG-in-TIFF and YCbCr TIFF), and the frame
    reader as cv2, a TIFF's plain decode as its compiled one, on panning
    frames at odd sizes and at 200x328."""
    rng = np.random.default_rng(len(name))
    for h, w in ((9, 17), (37, 53), (200, 328)):
        frame = chip_smoke.panning_clips(rng, 1, h, w, n=1)[0, 0]
        if name.startswith("loader_"):
            kind = name[len("loader_"):]
            data, want = chip_smoke.LOADER_FORMATS[kind](frame), None if kind in chip_smoke.LOSSY_KINDS else frame
        else:
            write, expected, _ = chip_smoke.RASTER_CASES[name]
            data, want = write(frame), expected and expected(frame)
        path = tmp_path / f"{name}_{h}.img"
        path.write_bytes(data)
        if want is not None:  # the lossy kinds: what cv2 reads is what the port reads (_check)
            np.testing.assert_array_equal(cv2.imread(str(path))[..., ::-1], want, err_msg=f"{name} {h}x{w}")
        _check(tmp_path, data, f"{name}_{h}.img", (lambda d: tiff.decode(d, plain=True)) if data[:2] == b"II" else None)


# --------------------------------------------------------------------------- #
# the frame reader and the refusals


def test_frame_reader_picks_the_decoder_by_signature(tmp_path):
    """Each format named with another's extension is read as cv2 reads it."""
    img = _texture(np.random.default_rng(9), 9, 17, "noise")
    files = {"bmp": _bmp_case("cv2_24", img), "ppm": _pnm_case("cv2_ppm", img), "pam": _pnm_case("cv2_pam", img),
             "pfm": _pnm_case("cv2_pfm", img), "tif": _tiff_case("pil_lzw", img), "ras": _sun_case("cv2_24", img),
             "hdr": _hdr_case("cv2", img)}
    for ext, data in files.items():
        _check(tmp_path, data, f"{ext}_named.png")


def _webp_cut(data: bytes) -> bytes:
    """The simple WebP ``data`` with its bitstream's last 24 bytes cut, its
    chunk and RIFF sizes rewritten."""
    (size,) = struct.unpack_from("<I", data, 16)
    cut = data[20:20 + size - 24]
    chunk = b"VP8 " + struct.pack("<I", len(cut)) + cut + bytes(len(cut) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _refusal_files():
    img = _texture(np.random.default_rng(11), 9, 17, "noise")
    return {
        "tiff_old_jpeg": (_tiff(img, 8, 2, raw_tags=((259, 6),)), NotImplementedError, "old-style JPEG"),
        "tiff_ccitt": (_tiff(_packed(img[..., 0] >> 7, 1), 1, 0, width=17, raw_tags=((259, 4),)), NotImplementedError,
                       "CCITT"),
        "tiff_lab": (_tiff(img, 8, 8), NotImplementedError, "CIELab"),
        "webp": (_webp_cut(_pil(img, "WEBP")), ValueError, "VP8 data that ends too soon"),
        "avif": (b"\x00\x00\x00\x1cftypavif" + bytes(40), NotImplementedError, "AVIF"),
        "jpeg_2000": (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40), NotImplementedError, "JPEG 2000"),
        "tiff_float": (_tiff(img.astype(np.float32), 32, 2, sample_format=3, predictor=1), ValueError,
                       "floating-point"),
        "tiff_4bit_grey": (_tiff(_packed(img[..., 0] >> 4, 4), 4, 1, width=17), ValueError, "4-bit"),
        "tiff_2bit_palette": (_tiff(_packed(img[..., 0] >> 6, 2), 2, 3, width=17,
                                    colormap=np.arange(12, dtype=np.uint16).reshape(4, 3)), ValueError, "2-bit"),
        "sun_rle": (_sun(img[..., 0], 8, 2), ValueError, "byte-encoded"),
        "sun_rgb_type": (_sun(img.reshape(9, -1), 24, 3), ValueError, "RGB-type"),
        "tiff_orientation_6_not_square": (_tiff(img, 8, 2, orientation=6), ValueError, "Orientation 6"),
        "tiff_truncated": (_pil(img, "TIFF", compression="tiff_lzw")[:60], ValueError, "truncated"),
        "hdr_xyze": (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 9 +X 17\n" + bytes(9 * 17 * 4), ValueError, "XYZE"),
        "pfm_grey": (b"Pf\n17 9\n-1.0\n" + bytes(9 * 17 * 4), ValueError, "grey PFM"),
        "bmp_truncated": (_bmp_case("cv2_24", img)[:300], ValueError, "truncated"),
        "bmp_rle8_overrun": (_bmp(b"\x20\x01\x00\x01", 17, 9, 8, comp=1, palette=np.zeros((2, 3), np.uint8)),
                             ValueError, "past its row"),
        "ppm_truncated": (_pnm_case("cv2_ppm", img)[:200], ValueError, "truncated"),
        "sun_truncated": (_sun_case("cv2_24", img)[:200], ValueError, "truncated"),
        "hdr_truncated": (_hdr_case("flat", img)[:300], ValueError, "truncated"),
        "exr": (b"\x76\x2f\x31\x01" + bytes(40), ValueError, "not an image file"),
    }


REFUSALS = sorted(_refusal_files())


def _former_refusal(name: str) -> bytes:
    """A valid file of each kind the refusal cases named until the reader
    read it: a BigTIFF, a JPEG-compressed TIFF (as PIL's libtiff writes it),
    a YCbCr TIFF (4:2:0 data units) and a CMYK TIFF."""
    img = _texture(np.random.default_rng(11), 9, 17, "noise")
    if name == "bigtiff":
        return _tiff(img, 8, 2, bigtiff=True)
    if name == "tiff_jpeg":
        return _pil(img, "TIFF", compression="jpeg")
    if name == "tiff_ycbcr":
        return _tiff(img, 8, 6, ycbcr=(2, 2), rows_per_strip=4)
    assert name == "tiff_cmyk", name
    return _tiff(np.dstack([img, img[..., :1]]), 8, 5)


@pytest.mark.parametrize("name", ["bigtiff", "tiff_cmyk", "tiff_jpeg", "tiff_ycbcr"])
def test_former_refusals_read_as_cv2(tmp_path, name):
    """BigTIFF, JPEG compression and the YCbCr and CMYK photometrics, which
    the refusal cases named, now read as cv2 reads them, compiled and plain
    (``tests/test_torch_tiff.py`` holds every case of each kind)."""
    _check(tmp_path, _former_refusal(name), f"{name}.tif", lambda d: tiff.decode(d, plain=True))


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_name_the_file_and_the_feature(tmp_path, name):
    """A format or feature that cv2 reads and the port does not raises
    NotImplementedError naming the file and it; what cv2 cannot read in
    colour either (float TIFF, a transposing orientation of a frame that is
    not square, XYZE, grey PFM) or a truncated or corrupt file raises
    ValueError naming the file (cv2 returns None for those)."""
    data, kind, words = _refusal_files()[name]
    path = tmp_path / f"{name}.img"
    path.write_bytes(data)
    with pytest.raises(kind, match=rf"{name}\.img.*{words}"):
        image.imread(str(path))
    if kind is ValueError and name not in ("exr",):
        assert cv2.imread(str(path)) is None
