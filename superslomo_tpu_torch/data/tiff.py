"""TIFF frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for TIFF files, with no cv2.

cv2 reads a TIFF into 8-bit colour through libtiff's ``TIFFRGBAImage``
(``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), and so does this reader: the
first page (IFD) of a classic TIFF in either byte order, in strips or tiles,
contiguous or separate planes, compressed with none, PackBits, LZW or Deflate
(with the horizontal predictor at 8 and 16 bits), bits filled MSB or LSB
first; MinIsBlack and MinIsWhite at 1, 8 or 16 bits (16 bits keep their high
byte), RGB at 8 or 16 bits (16 bits as (v + 128) // 257), with an associated
alpha dropped and an unassociated one premultiplied into the colour first,
((v * a + 127) // 255), as libtiff does; a palette of 1, 4 or 8 bits through
its colour map (the map's high bytes, unless every entry is below 256).
The Orientation tag is applied as cv2 applies an EXIF orientation
(``data/exif.py``); cv2 fails on 5-8 (a transposition) unless the image is
square.

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit. It refuses with
NotImplementedError, naming the file and the feature, what cv2 reads and it
does not: JPEG, old-style JPEG and CCITT compression (and any other), the
YCbCr, CMYK (separated) and CIELab photometrics, and BigTIFF. What cv2 cannot
read in colour either (floating-point samples, which libtiff's RGBA reader
refuses, so the floating-point predictor never applies; bit depths other
than those above, which cv2's header check refuses; Orientation 5-8 of an
image that is not square), or a truncated or corrupt file, raises ValueError
naming the file.

LZW and PackBits run in the host C++ of ``csrc/raster_decode.cpp``
(``data/raster.py``); ``lzw_plain`` and ``packbits_plain`` are their Python
twins, for the tests. Deflate is ``zlib``; the predictor, the byte order, the
colour conversion and the orientation are numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from superslomo_tpu_torch.data import raster
from superslomo_tpu_torch.data.exif import apply_orientation

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q", 17: "q"}  # integer field types
_REFUSED_COMPRESSION = {2: "CCITT modified Huffman", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax",
                        6: "old-style JPEG", 7: "JPEG"}
_REFUSED_PHOTOMETRIC = {5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab"}
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)  # FillOrder 2: bits LSB first


def read_tags(data: bytes, path: str = "<bytes>") -> tuple:
    """(byte order "<" or ">", {tag: tuple of values}) of the first IFD's
    integer fields."""
    if data[:4] in BIGTIFF:
        raise NotImplementedError(f"{path}: BigTIFF is not read; only classic TIFF")
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack_from(order + "I", data, 4)
        (n,) = struct.unpack_from(order + "H", data, ifd)
        tags = {}
        for i in range(n):
            tag, kind, count, value = struct.unpack_from(order + "HHI4s", data, ifd + 2 + 12 * i)
            if kind not in _TYPES:
                continue
            size = struct.calcsize(_TYPES[kind]) * count
            raw = value if size <= 4 else data[struct.unpack(order + "I", value)[0]:][:size]
            if len(raw) < size:
                raise ValueError(f"{path}: tag {tag}'s values lie past the file's end (truncated)")
            tags[tag] = struct.unpack(order + _TYPES[kind] * count, raw[:size])
    except struct.error:
        raise ValueError(f"{path}: the IFD lies past the file's end (truncated or corrupt)") from None
    return order, tags


def lzw_plain(src: bytes, cap: int) -> bytes:
    """The plain version of the compiled ``lzw_decode``: at most ``cap``
    bytes, ending at the end-of-information code or the data's end."""
    table = [bytes([c]) for c in range(256)] + [b"", b""]
    nbits, out, prev, pos, bits = 9, bytearray(), None, 0, len(src) * 8
    b = bytes(src) + b"\0\0\0"
    while len(out) < cap and pos + nbits <= bits:
        at = pos >> 3
        code = (((b[at] << 16) | (b[at + 1] << 8) | b[at + 2]) >> (24 - (pos & 7) - nbits)) & ((1 << nbits) - 1)
        pos += nbits
        if code == 257:
            break
        if code == 256:
            table, nbits, prev = table[:258], 9, None
            continue
        if prev is None:
            if code > 255:
                raise ValueError("an LZW code past the table")
            out += table[code]
            prev = code
            continue
        if code > len(table):
            raise ValueError("an LZW code past the table")
        entry = table[code] if code < len(table) else table[prev] + table[prev][:1]
        if len(table) < 4096:
            table.append(table[prev] + entry[:1])
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
                nbits += 1
        out += entry
        prev = code
    return bytes(out[:cap])


def packbits_plain(src: bytes, cap: int) -> bytes:
    """The plain version of the compiled ``packbits_decode``."""
    out, pos = bytearray(), 0
    while pos < len(src) and len(out) < cap:
        b = src[pos] - 256 if src[pos] > 127 else src[pos]
        pos += 1
        if b >= 0:
            out += src[pos:pos + b + 1]
            pos += b + 1
        elif b != -128:
            if pos >= len(src):
                break
            out += src[pos:pos + 1] * (1 - b)
            pos += 1
    return bytes(out[:cap])


def _decompress(raw: bytes, cap: int, compression: int, plain: bool) -> np.ndarray:
    """One strip's or tile's ``cap`` bytes; None where its data gives fewer."""
    if compression == 1:
        out = np.frombuffer(raw[:cap], np.uint8)
    elif compression in (8, 32946):
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(raw, cap), np.uint8)
        except zlib.error:
            return None
    elif plain:
        out = np.frombuffer((lzw_plain if compression == 5 else packbits_plain)(raw, cap), np.uint8)
    else:
        out, n = raster.stream(raw, cap, "lzw_decode" if compression == 5 else "packbits_decode")
        if n < 0:
            return None
        out = out[:n]
    return out if out.size == cap else None


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The first page of the TIFF ``data`` as (H, W, 3) uint8 RGB, as cv2
    reads it; ``plain`` runs the Python twins of the compiled routines."""
    order, tags = read_tags(data, path)
    W, H = tags.get(256, (0,))[0], tags.get(257, (0,))[0]
    if W == 0 or H == 0:
        raise ValueError(f"{path}: a TIFF of {W}x{H}")
    compression = tags.get(259, (1,))[0]
    if compression in _REFUSED_COMPRESSION:
        raise NotImplementedError(f"{path}: {_REFUSED_COMPRESSION[compression]} compression is not read; only "
                                  "none, PackBits, LZW and Deflate")
    if compression not in (1, 5, 8, 32773, 32946):
        raise NotImplementedError(f"{path}: TIFF compression {compression} is not read; only none, PackBits, "
                                  "LZW and Deflate")
    if 262 not in tags:
        raise ValueError(f"{path}: no Photometric tag")
    photometric = tags[262][0]
    if photometric in _REFUSED_PHOTOMETRIC:
        raise NotImplementedError(f"{path}: the {_REFUSED_PHOTOMETRIC[photometric]} photometric is not read; only "
                                  "MinIsBlack, MinIsWhite, RGB and Palette")
    if photometric not in (0, 1, 2, 3):
        raise ValueError(f"{path}: photometric {photometric}, which cv2 does not read")
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    bits = bps[0]
    if len(set(bps)) > 1:
        raise ValueError(f"{path}: samples of different sizes {bps}")
    floating = tags.get(339, (1,))[0] == 3
    if floating or bits not in {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8)}[photometric]:
        raise ValueError(f"{path}: {bits}-bit {'floating-point ' if floating else ''}samples of photometric "
                         f"{photometric}, which cv2 does not read in colour")
    if photometric == 2 and spp < 3:
        raise ValueError(f"{path}: RGB of {spp} samples")
    orientation = tags.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8) and W != H:
        raise ValueError(f"{path}: Orientation {orientation} of a {W}x{H} image, whose transposition cv2 does "
                         "not read")
    planar = tags.get(284, (1,))[0] == 2 and spp > 1
    predictor = tags.get(317, (1,))[0]
    if predictor == 2 and bits < 8:
        raise ValueError(f"{path}: the horizontal predictor on {bits}-bit samples")
    if predictor not in (1, 2):
        raise ValueError(f"{path}: predictor {predictor} on integer samples")

    # the chunks: strips or tiles, each plane's after the other's when separate
    tiled = 322 in tags
    if tiled:
        cw, ch = tags[322][0], tags[323][0]
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = W, min(tags.get(278, (2 ** 32 - 1,))[0], H)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or cw == 0 or ch == 0:
        raise ValueError(f"{path}: no strip or tile offsets")
    per_chunk = 1 if planar else spp
    planes = spp if planar else 1
    across, down = -(-W // cw), -(-H // ch)
    if len(offsets) < planes * across * down or len(counts) < len(offsets):
        raise ValueError(f"{path}: {len(offsets)} strips or tiles for {planes * across * down}")
    row_bytes = -(-cw * per_chunk * bits // 8)
    dtype = np.dtype(order + "u2") if bits == 16 else np.dtype(np.uint8)
    samples = np.zeros((planes, down * ch, across * cw, per_chunk), np.uint16 if bits == 16 else np.uint8)
    fill_lsb = tags.get(266, (1,))[0] == 2
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = (p * down + j) * across + i
                rows = ch if tiled else min(ch, H - j * ch)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                if fill_lsb:
                    raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                chunk = _decompress(raw, rows * row_bytes, compression, plain)
                if chunk is None:
                    raise ValueError(f"{path}: {'tile' if tiled else 'strip'} {k} holds too little data "
                                     "(truncated or corrupt)")
                chunk = chunk.reshape(rows, row_bytes)
                if bits < 8:
                    x = np.unpackbits(chunk, axis=1).reshape(rows, -1, bits)[:, : cw * per_chunk]
                    x = (x * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
                else:
                    x = chunk.view(dtype).astype(samples.dtype)
                x = x.reshape(rows, cw, per_chunk)
                if predictor == 2:  # each sample the sum of those to its left, in its own width
                    x = np.cumsum(x, axis=1, dtype=x.dtype)
                samples[p, j * ch:j * ch + rows, i * cw:(i + 1) * cw] = x
    samples = samples[:, :H, :W]
    samples = np.moveaxis(samples, 0, 2)[..., 0] if planar else samples[0]  # (H, W, spp)
    return apply_orientation(_to_rgb(samples, photometric, bits, tags, path), orientation)


def _to_rgb(s: np.ndarray, photometric: int, bits: int, tags: dict, path: str) -> np.ndarray:
    """(H, W, spp) samples → (H, W, 3) uint8 RGB as libtiff's TIFFRGBAImage
    puts them, its alpha dropped as cv2 drops it."""
    if photometric in (0, 1):
        rng = 255 if bits == 16 else (1 << bits) - 1
        v = (s[..., 0] >> 8) if bits == 16 else s[..., 0]
        v = v.astype(np.int64)
        grey = ((rng - v) * 255 // rng if photometric == 0 else v * 255 // rng).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.int64)
        n = 1 << bits
        if cmap.size < 3 * n:
            raise ValueError(f"{path}: a palette TIFF without a {n}-entry colour map")
        cmap = cmap[: 3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[..., 0]]
    rgb = s[..., :3].astype(np.int64)
    if bits == 16:
        rgb = (rgb + 128) // 257
    extra = tags.get(338, ())
    if s.shape[2] > 3 and extra and extra[0] == 2:  # unassociated alpha: premultiplied
        a = s[..., 3:4].astype(np.int64)
        if bits == 16:
            a = (a + 128) // 257
        rgb = (rgb * a + 127) // 255
    return rgb.astype(np.uint8)
