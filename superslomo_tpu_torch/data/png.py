"""PNG frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for the datasets' PNG frames, with no cv2.

It parses the chunks itself (``IHDR``, the ``IDAT``s joined, ``PLTE``, ``eXIf``; the CRCs
are not checked), inflates with ``zlib`` and undoes the row filters with the
host C++ routine of ``csrc/png_unfilter.cpp`` (built at first use by
``ops/cuda_build.py``, called through ctypes with the GIL released, so the
Loader's threads decode in parallel): once over the image, or, in an
interlaced (Adam7) file, once over each of the seven passes, each a filtered
image of its own size whose pixels are then scattered into the frame.
``unfilter_plain`` is the same function in numpy and Python, for the tests.

``imread`` returns a (H, W, 3) uint8 array in RGB order, equal to
``cv2.imread(path)[..., ::-1]`` bit for bit, for every PNG colour type and bit
depth, interlaced or not: an alpha channel is dropped (not composited) and a
``tRNS`` chunk ignored, grey is replicated to three channels (at 1, 2 and 4
bits scaled to 8 as libpng's ``png_set_expand_gray_1_2_4_to_8`` scales it), a
palette is expanded through ``PLTE`` (an index past it reads black, as in
libpng's zeroed 256-entry palette), and a 16-bit sample keeps its high byte.
A bit depth that the colour type does not allow (a 16-bit palette) raises
NotImplementedError. The EXIF orientation of an ``eXIf`` chunk (the first,
before or after the ``IDAT``s, as cv2 reads it) is applied as cv2 applies it
(``data/exif.py``).

``imwrite`` is the counterpart of ``cv2.imwrite`` for the renderer's frames:
an 8-bit RGB file from a (H, W, 3) RGB array, or an 8-bit grey file from a
(H, W) array, written as cv2 writes them: every row Sub-filtered (filter
type 1, one vectorised numpy pass) and deflated at zlib level 1.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from superslomo_tpu_torch.data.exif import apply_orientation, orientation
from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "png_unfilter.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # colour type → bit depths
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # x0, y0, dx, dy


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img``, (H, W, 3) uint8 RGB or (H, W) uint8 grey, as an 8-bit
    PNG with Sub-filtered rows deflated at zlib level 1 (what
    ``cv2.imwrite(path, img[..., ::-1])`` writes for RGB, and
    ``cv2.imwrite(path, img)`` for grey)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"imwrite takes (H, W, 3) or (H, W) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    x = img.reshape(h, w * bpp)
    rows = np.empty((h, w * bpp + 1), np.uint8)
    rows[:, 0] = 1  # Sub: each byte less the byte one pixel to its left, mod 256
    rows[:, 1 : 1 + bpp] = x[:, :bpp]
    np.subtract(x[:, bpp:], x[:, :-bpp], out=rows[:, 1 + bpp :])
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    data = (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.data, 1))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _declare(lib: ctypes.CDLL) -> None:
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.png_unfilter.restype = ctypes.c_int64


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` (a writable uint8 array of h rows of a
    filter byte and ``stride`` bytes) in place, by the compiled routine;
    returns the (h, stride) view of the unfiltered bytes."""
    if raw.dtype != np.uint8 or not raw.flags.c_contiguous or not raw.flags.writeable or raw.size != h * (stride + 1):
        raise ValueError(f"expected {h} x {stride + 1} writable contiguous uint8 bytes, got {raw.dtype} {raw.shape}")
    lib = cuda_build.load_library(SOURCE, _declare)
    bad = lib.png_unfilter(raw.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}, not 0-4")
    return raw.reshape(h, stride + 1)[:, 1:]


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of ``unfilter``: returns the (h, stride) unfiltered
    bytes as a new array. None, Sub and Up are vectorised; Average and Paeth
    depend on the unfiltered byte to the left and run byte by byte."""
    rows = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ft, x = int(rows[r, 0]), rows[r, 1:]
        if ft == 0:
            cur = x.copy()
        elif ft == 1:  # Sub: a running sum mod 256 over each byte lane of the pixel
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = x
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ft == 2:
            cur = x + prev
        elif ft in (3, 4):
            cur = bytearray(x.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"row {r} has filter type {ft}, not 0-4")
        out[r] = cur
        prev = out[r]
    return out


def read_chunks(path: str, data: bytes | None = None) -> tuple:
    """(IHDR fields (w, h, bit depth, colour type, interlace), the IDATs'
    zlib stream, the PLTE bytes or None, the first eXIf chunk's body or None)
    of the PNG at ``path``, or of its bytes ``data`` where they were read."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, palette, exif = 8, None, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length  # length, type, data, CRC
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            header = (w, h, depth, ctype, interlace)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"eXIf" and exif is None:
            exif = body
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    return header, b"".join(idat), palette, exif


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes → (h, w, channels) uint8 samples: a
    16-bit sample's high byte, 1-, 2- and 4-bit samples unpacked (MSB first)."""
    h = rows.shape[0]
    if depth >= 8:
        return rows.reshape(h, w, channels, depth // 8)[..., 0]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, : w * channels].reshape(h, w, channels)


def imread(path: str, data: bytes | None = None) -> np.ndarray:
    """Decode the PNG at ``path`` (or its bytes ``data``) to a (H, W, 3)
    uint8 RGB array, as ``cv2.imread(path)[..., ::-1]`` does, its EXIF
    orientation applied."""
    (w, h, depth, ctype, interlace), stream, palette, exif = read_chunks(path, data)
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not a PNG colour type")
    if depth not in _DEPTHS[ctype]:
        raise NotImplementedError(f"{path}: bit depth {depth} of colour type {ctype} is not read")
    if interlace > 1:
        raise ValueError(f"{path}: interlace method {interlace} is not a PNG interlace method")
    channels = _CHANNELS[ctype]
    bits = channels * depth  # a pixel's
    passes = [(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in
              (_ADAM7 if interlace else ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] and p[5]]  # a pass of no pixels has no rows at all
    raw = np.frombuffer(bytearray(zlib.decompress(stream)), np.uint8)
    expected = sum(ph * (1 + -(-pw * bits // 8)) for *_, pw, ph in passes)
    if raw.size != expected:
        raise ValueError(f"{path}: {raw.size} bytes inflated, expected {expected}")
    img = np.empty((h, w, channels), np.uint8) if interlace else None
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = -(-pw * bits // 8)
        rows = unfilter(raw[pos : pos + ph * (stride + 1)], ph, stride, max(1, bits // 8))
        pos += ph * (stride + 1)
        if interlace:
            img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        else:
            img = _samples(rows, pw, channels, depth)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: a palette image without PLTE")
        colours = np.zeros((256, 3), np.uint8)  # libpng's palette: 256 entries, zero past PLTE's
        entries = np.frombuffer(palette, np.uint8)[: len(palette) // 3 * 3].reshape(-1, 3)[:256]
        colours[: len(entries)] = entries
        img = colours[img[..., 0]]
    elif channels < 3:  # grey, grey + alpha
        grey = img[..., :1] * np.uint8(255 // ((1 << min(depth, 8)) - 1))  # 1, 2, 4 bits to 8
        img = np.repeat(grey, 3, axis=2)
    else:
        img = img[..., :3]
    return apply_orientation(img, orientation(exif) if exif is not None else 1)
