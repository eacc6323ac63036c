"""TIFF frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for TIFF files, with no cv2.

cv2 reads a TIFF into 8-bit colour through libtiff's ``TIFFRGBAImage``
(``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), and so does this reader: the
first page (IFD) of a classic TIFF or a BigTIFF (version 43: 8-byte offsets
and counts, 20-byte entries, LONG8 / SLONG8 / IFD8 values) in either byte
order, in strips or tiles, contiguous or separate planes, compressed with
none, PackBits, LZW, Deflate (with the horizontal predictor at 8 and 16
bits; a field libtiff knows only for those codecs) or JPEG, bits filled MSB
or LSB first; MinIsBlack and MinIsWhite at 1, 8 or 16 bits (16 bits keep
their high byte), RGB at 8 or 16 bits (16 bits as (v + 128) // 257), with an
associated alpha dropped and an unassociated one premultiplied into the
colour first, ((v * a + 127) // 255), as libtiff does; a palette of 1, 4 or
8 bits through its colour map (the map's high bytes, unless every entry is
below 256); 8-bit YCbCr through libtiff's own tables and put routines
(``data/tiff_colour.py``: subsampled 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 or 4x4 in
data units, separate planes at 1x1); 8-bit CMYK (InkSet CMYK, 4 samples).
A JPEG strip or tile is a JPEG stream of its own, its tables from the
JPEGTables field or itself (``jpeg.with_tables``), its colour set by the
TIFF as libtiff sets it: contiguous YCbCr turned to RGB by libjpeg (fancy
upsampling, strip by strip), every other photometric's components as stored
(``jpeg`` colour "raw"), then the TIFF's own colour routine; libtiff's
checks of each stream (its size against its strip or tile, its component
count, its sampling against YCbCrSubSampling, which libtiff takes from the
first strip where the field is absent) fail as libtiff fails.
The Orientation tag is applied as cv2 applies an EXIF orientation
(``data/exif.py``); cv2 fails on 5-8 (a transposition) unless the image is
square.

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit. It refuses with
NotImplementedError, naming the file and the feature, what cv2 reads and it
does not: old-style JPEG and CCITT compression (and any other), and the
CIELab photometrics. What cv2 cannot read in colour either (floating-point
samples, which libtiff's RGBA reader refuses, so the floating-point
predictor never applies; bit depths other than those above, which cv2's
header check refuses; YCbCr subsamplings or layouts libtiff has no put
routine for; CMYK of other ink sets or sample counts; Orientation 5-8 of an
image that is not square; strips past cv2's buffer limits), or a truncated
or corrupt file, raises ValueError naming the file. A strip whose
compressed data fails to decode raises too, where cv2 keeps what libtiff
decoded of it (its RGBA reader runs without stopping on errors), and so
does a JPEG strip's entropy-coded data that libjpeg decodes with a warning.

LZW and PackBits run in the host C++ of ``csrc/raster_decode.cpp``
(``data/raster.py``), a JPEG stream in ``csrc/jpeg_decode.cpp``
(``data/jpeg.py``); ``lzw_plain``, ``packbits_plain`` and
``jpeg.decode_plain`` are their Python twins, for the tests. Deflate is
``zlib``; the predictor, the byte order, the colour conversion and the
orientation are numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from superslomo_tpu_torch.data import jpeg, raster, tiff_colour
from superslomo_tpu_torch.data.exif import apply_orientation

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # classic TIFF, then BigTIFF
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q",
          18: "Q"}  # integer field types (13 IFD, 18 IFD8)
_RATIONALS = {5: "I", 10: "i"}  # RATIONAL, SRATIONAL: read as libtiff reads them into float
_INTEGERS = (1, 3, 4, 6, 8, 9, 16, 17)  # the types libtiff's TIFFReadDirEntryShort / Long take
_CORE = (256, 257, 259, 278, 284, 322, 323, 338)  # the fields whose bad type fails TIFFReadDirectory
_REFUSED_COMPRESSION = {2: "CCITT modified Huffman", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax",
                        6: "old-style JPEG"}
_REFUSED_PHOTOMETRIC = {8: "CIELab", 9: "ICCLab", 10: "ITULab"}
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)  # FillOrder 2: bits LSB first


def read_tags(data: bytes, path: str = "<bytes>") -> tuple:
    """(byte order "<" or ">", {tag: tuple of values}) of the first IFD's
    integer and rational fields, of a classic TIFF or a BigTIFF (8-byte
    offsets and counts, 20-byte entries whose values lie inline up to 8
    bytes). A rational is the float32 libtiff makes of it: numerator /
    denominator in single precision, 0 where the denominator is 0."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:
            offset_size, reserved, ifd = struct.unpack_from(order + "HHQ", data, 4)
            if offset_size != 8 or reserved != 0:
                raise ValueError(f"{path}: a BigTIFF of offset size {offset_size}, reserved {reserved}")
            (n,) = struct.unpack_from(order + "Q", data, ifd)
            entry, inline, head = 20, 8, order + "HHQ8s"
        else:
            (ifd,) = struct.unpack_from(order + "I", data, 4)
            (n,) = struct.unpack_from(order + "H", data, ifd)
            entry, inline, head = 12, 4, order + "HHI4s"
        first = ifd + (8 if big else 2)
        if first + entry * n > len(data):
            raise ValueError(f"{path}: the IFD lies past the file's end (truncated or corrupt)")
        tags = {}
        for i in range(n):
            tag, kind, count, value = struct.unpack_from(head, data, first + entry * i)
            fmt = _TYPES.get(kind) or (2 * _RATIONALS[kind] if kind in _RATIONALS else None)
            if fmt is None:
                if tag in _CORE:
                    raise ValueError(f"{path}: tag {tag} of unknown type {kind}")
                continue
            size = struct.calcsize(fmt) * count
            if size <= inline:
                raw = value
            else:
                (at,) = struct.unpack(order + ("Q" if big else "I"), value)
                raw = data[at:at + size]
            if len(raw) < size:
                raise ValueError(f"{path}: tag {tag}'s values lie past the file's end (truncated)")
            if tag in _CORE and kind not in _INTEGERS:
                raise ValueError(f"{path}: tag {tag} of type {kind}, which libtiff does not read as an integer")
            values = struct.unpack(order + fmt * count, raw[:size])
            if kind in _RATIONALS:
                num, den = np.array(values[0::2], np.float32), np.array(values[1::2], np.float32)
                values = tuple(float(v) for v in np.where(den == 0, np.float32(0), num / np.where(den == 0, 1, den)))
            tags[tag] = values
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


def _jpeg_chunk(raw: bytes, tables, seg: tuple, tail_ok: bool, n: int, sampling: tuple, colour: str, path: str,
                plain: bool) -> np.ndarray:
    """A strip's or tile's JPEG stream as libtiff's ``JPEGPreDecode`` and
    ``JPEGDecode`` read it: its frame checked against the segment (seg_w,
    seg_h) (a smaller frame is read into the segment's top left; a larger
    one fails, but for the last strip's extra rows, ``tail_ok``), against
    the ``n`` components and the ``sampling`` libtiff expects of the first
    (the others 1x1); then decoded with ``colour`` in force, "ycbcr" (to
    RGB by libjpeg) or "raw" (as stored), into (seg_h, seg_w, C) uint8."""
    stream = jpeg.with_tables(raw, tables, path)
    frame = _jpeg_frame(stream)  # JPEGPreDecode's checks, made before libjpeg's own
    if frame is not None and (frame[0] != 8 or frame[1] != n):
        raise ValueError(f"{path}: a {frame[0]}-bit JPEG strip or tile of {frame[1]} components, for 8-bit "
                         f"samples of {n}")
    if frame is not None and len(frame[2]) == n and (frame[2][0] != sampling or
                                                      any(f != (1, 1) for f in frame[2][1:])):
        raise ValueError(f"{path}: JPEG sampling factors {frame[2]}, where libtiff expects {sampling} then 1x1")
    header = jpeg.read_header(stream, path)
    seg_w, seg_h = seg
    w, h = header.width, header.height
    if (w > seg_w or h > seg_h) and not (tail_ok and w == seg_w):
        raise ValueError(f"{path}: a {w}x{h} JPEG strip or tile for a {seg_w}x{seg_h} segment")
    header.colour = colour
    out = (jpeg.decode_plain if plain else jpeg.decode)(stream, header, path)
    chunk = np.zeros((seg_h, seg_w, out.shape[2]), np.uint8)
    chunk[:min(h, seg_h), :w] = out[:seg_h]
    return chunk


def _jpeg_subsampling(stream: bytes):
    """libtiff's ``JPEGFixupTagsSubsampling``: the first component's (h, v)
    sampling in the frame header of a strip's JPEG stream, where every
    other component is 1x1 and h and v are 1, 2 or 4; else None."""
    frame = _jpeg_frame(stream)
    if frame is None or not frame[2]:
        return None
    factors = frame[2]
    if factors[0][0] in (1, 2, 4) and factors[0][1] in (1, 2, 4) and all(f == (1, 1) for f in factors[1:]):
        return factors[0]
    return None


def _jpeg_frame(stream: bytes):
    """(precision, component count, [(h, v) of each component it holds]) of
    the first frame header (SOFn) among a JPEG stream's marker segments, or
    None."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        (length,) = struct.unpack_from(">H", stream, pos + 2)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = stream[pos + 4:pos + 2 + length]
            if len(body) < 6:
                return None
            return body[0], body[5], [(body[7 + 3 * c] >> 4, body[7 + 3 * c] & 15)
                                      for c in range(min(body[5], (len(body) - 6) // 3))]
        if marker in (0xD9, 0xDA):
            return None
        pos += 2 + length
    return None


def _units_chunk(raw: bytes, compression: int, predictor: int, hs: int, vs: int, cw: int, rows: int, seg_rows: int,
                 vis_w: int, tiled: bool, path: str, plain: bool) -> np.ndarray:
    """A strip's or tile's YCbCr data units (``hs`` x ``vs`` subsampling) as
    libtiff's RGBA reader reads them: the bytes ``TIFFScanlineSize`` lets
    it decode (a strip's ceil(rows / vs) * vs scanlines of floor(units * (hs
    * vs + 2) / vs) bytes, which for 4x4 and an odd count of units a row is
    2 bytes short a unit row; those stay 0), the horizontal predictor over
    rows of that size (a tile's rows of cw * 3 bytes; where they do not
    split into 3-byte samples or the chunk into rows, libtiff's predictor
    fails after the codec wrote its bytes, and the RGBA reader, which cv2
    runs without stopping on errors, puts them as they are), then the put routine
    over the visible ``rows`` x ``vis_w``: a (seg_rows, cw, 3) uint8 chunk of
    full-size Y, Cb, Cr."""
    size = hs * vs + 2
    units = -(-cw // hs)
    full = -(-seg_rows // vs) * units * size
    scanline = cw * 3 if tiled else units * size // vs
    read = full if tiled else min(full, -(-rows // vs) * vs * scanline)
    chunk = _decompress(raw, read, compression, plain)
    if chunk is None:
        raise ValueError(f"{path}: a {'tile' if tiled else 'strip'} that holds too little data (truncated or "
                         "corrupt)")
    buf = np.zeros(full, np.uint8)
    buf[:read] = chunk
    if predictor == 2 and not (scanline % 3 or read % scanline):  # horAcc8 over libtiff's rows, stride 3
        buf[:read] = np.cumsum(buf[:read].reshape(-1, scanline // 3, 3), axis=1, dtype=np.uint8).reshape(-1)
    skew = 10 if (hs, vs) == (4, 4) else size  # putcontig8bitYCbCr44tile skips 10 bytes a unit past the edge
    out = np.zeros((seg_rows, cw, 3), np.uint8)
    out[:rows, :vis_w] = tiff_colour.ycbcr_units(buf, hs, vs, rows, vis_w, (cw - vis_w) // hs * skew)
    return out


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The first page of the TIFF ``data`` as (H, W, 3) uint8 RGB, as cv2
    reads it; ``plain`` runs the Python twins of the compiled routines."""
    order, tags = read_tags(data, path)
    W, H = tags.get(256, (0,))[0], tags.get(257, (0,))[0]
    if W == 0 or H == 0 or W > 1 << 20 or H > 1 << 20 or W * H > 1 << 30:  # cv2's validateInputImageSize
        raise ValueError(f"{path}: a TIFF of {W}x{H}")
    compression = tags.get(259, (1,))[0]
    if compression in _REFUSED_COMPRESSION:
        raise NotImplementedError(f"{path}: {_REFUSED_COMPRESSION[compression]} compression is not read; only "
                                  "none, PackBits, LZW, Deflate and JPEG")
    if compression not in (1, 5, 7, 8, 32773, 32946):
        raise NotImplementedError(f"{path}: TIFF compression {compression} is not read; only none, PackBits, "
                                  "LZW, Deflate and JPEG")
    if 262 not in tags:
        raise ValueError(f"{path}: no Photometric tag")
    photometric = tags[262][0]
    if photometric in _REFUSED_PHOTOMETRIC:
        raise NotImplementedError(f"{path}: the {_REFUSED_PHOTOMETRIC[photometric]} photometric is not read; only "
                                  "MinIsBlack, MinIsWhite, RGB, Palette, CMYK and YCbCr")
    if photometric not in (0, 1, 2, 3, 5, 6):
        raise ValueError(f"{path}: photometric {photometric}, which cv2 does not read")
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    bits = bps[0]
    if len(set(bps)) > 1:
        raise ValueError(f"{path}: samples of different sizes {bps}")
    if tags.get(339, (1,))[0] > 3:
        raise ValueError(f"{path}: SampleFormat {tags[339][0]}, which cv2 does not read")
    floating = tags.get(339, (1,))[0] == 3
    depths = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 5: (8,), 6: (8,)}[photometric]
    if floating or bits not in depths or (compression == 7 and bits != 8):
        raise ValueError(f"{path}: {bits}-bit {'floating-point ' if floating else ''}samples of photometric "
                         f"{photometric}{' in JPEG' if compression == 7 else ''}, which cv2 does not read in colour")
    if photometric == 2 and spp < 3:
        raise ValueError(f"{path}: RGB of {spp} samples")
    if photometric == 5 and (spp != 4 or tags.get(332, (1,))[0] != 1):
        raise ValueError(f"{path}: separated samples of {spp} channels, InkSet {tags.get(332, (1,))[0]}: cv2 "
                         "reads 4-channel CMYK only")
    if photometric == 6 and spp != 3:
        raise ValueError(f"{path}: YCbCr of {spp} samples")
    orientation = tags.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8) and W != H:
        raise ValueError(f"{path}: Orientation {orientation} of a {W}x{H} image, whose transposition cv2 does "
                         "not read")
    if tags.get(284, (1,))[0] not in (1, 2):
        raise ValueError(f"{path}: PlanarConfiguration {tags[284][0]}")
    planar = tags.get(284, (1,))[0] == 2 and spp > 1
    predictor = tags.get(317, (1,))[0] if compression in (5, 8, 32946) else 1  # a field of those codecs alone
    if predictor == 2 and bits < 8:
        raise ValueError(f"{path}: the horizontal predictor on {bits}-bit samples")
    if predictor not in (1, 2):
        raise ValueError(f"{path}: predictor {predictor} on integer samples")
    tiled = 322 in tags
    offsets, counts = (tags.get(324), tags.get(325)) if tiled else (tags.get(273), tags.get(279))
    hs, vs = tags.get(530, (2, 2))[:2] if photometric == 6 else (1, 1)
    if compression == 7 and photometric == 6 and not planar and 530 not in tags and offsets and counts:
        hs, vs = _jpeg_subsampling(data[offsets[0]:offsets[0] + counts[0]]) or (hs, vs)  # libtiff's fix-up
    ycbcr_jpeg = compression == 7 and photometric == 6 and not planar
    if ycbcr_jpeg:
        photometric = 2  # libtiff has libjpeg turn the YCbCr to RGB
    elif photometric == 6 and ((hs, vs) not in tiff_colour.UNIT_ROUTINES or planar and (hs, vs) != (1, 1)):
        raise ValueError(f"{path}: YCbCr subsampled {hs}x{vs}{' in separate planes' if planar else ''}, which "
                         "libtiff's RGBA reader has no routine for")
    units = photometric == 6 and (hs, vs) != (1, 1)
    tables = bytes(tags[347]) if 347 in tags else None  # JPEGTables

    # the chunks: strips or tiles, each plane's after the other's when separate
    cw, ch = (tags[322][0], tags[323][0]) if tiled else (W, min(tags.get(278, (2 ** 32 - 1,))[0], H))
    if offsets is None or counts is None or cw == 0 or ch == 0:
        raise ValueError(f"{path}: no strip or tile offsets")
    buffer_rows = ch if tiled else {2 ** 32 - 1: H}.get(tags.get(278, (2 ** 32 - 1,))[0], tags.get(278, (0,))[0])
    if buffer_rows > 1 << 24 or cw * buffer_rows * 4 >= 1 << 30:  # cv2's checks of its strip or tile buffer
        raise ValueError(f"{path}: {cw}x{buffer_rows} strips or tiles, past cv2's buffer limits")
    per_chunk = 1 if planar else spp
    planes = spp if planar else 1
    across, down = -(-W // cw), -(-H // ch)
    if min(len(offsets), len(counts)) < planes * across * down:
        raise ValueError(f"{path}: {min(len(offsets), len(counts))} strips or tiles for {planes * across * down}")
    row_bytes = -(-cw * per_chunk * bits // 8)
    dtype = np.dtype(order + "u2") if bits == 16 else np.dtype(np.uint8)
    samples = np.zeros((planes, down * ch, across * cw, per_chunk), np.uint16 if bits == 16 else np.uint8)
    fill_lsb = tags.get(266, (1,))[0] == 2
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = (p * down + j) * across + i
                rows = ch if tiled else min(ch, H - j * ch)
                if compression != 1 and offsets[k] + counts[k] > len(data):  # libtiff reads a compressed one whole
                    raise ValueError(f"{path}: {'tile' if tiled else 'strip'} {k} runs past the file's end "
                                     "(truncated)")
                raw = data[offsets[k]:offsets[k] + counts[k]]
                if fill_lsb:
                    raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                if compression == 7:
                    x = _jpeg_chunk(raw, tables, (cw, rows), not tiled and j == down - 1, per_chunk,
                                    (hs, vs) if per_chunk == 3 else (1, 1), "ycbcr" if ycbcr_jpeg else "raw", path,
                                    plain)
                elif units:
                    x = _units_chunk(raw, compression, predictor, hs, vs, cw, min(ch, H - j * ch), rows,
                                     min(cw, W - i * cw), tiled, path, plain)
                else:
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
    if photometric == 5:
        return tiff_colour.cmyk_to_rgb(s)
    if photometric == 6:
        return tiff_colour.ycbcr_to_rgb(s, tiff_colour.ycbcr_tables(tags, path))
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
