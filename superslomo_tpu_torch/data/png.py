"""PNG frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for the datasets' PNG frames, with no cv2.

It parses the chunks itself (``IHDR``, the ``IDAT``s joined, ``PLTE``, ``eXIf``; the CRCs
are not checked), inflates with ``zlib`` and undoes the row filters with the
host C++ routine of ``csrc/png_unfilter.cpp`` (built at first use by
``ops/cuda_build.py``, called through ctypes with the GIL released, so the
Loader's threads decode in parallel). ``unfilter_plain`` is the same function
in numpy and Python, for the tests.

``imread`` returns a (H, W, 3) uint8 array in RGB order, equal to
``cv2.imread(path)[..., ::-1]`` bit for bit: an alpha channel is dropped (not
composited), grey is replicated to three channels, a palette is expanded
through ``PLTE``, and a 16-bit sample keeps its high byte. It reads bit depths
8 and 16 (8 for a palette); interlaced files and other depths raise
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


def imread(path: str, data: bytes | None = None) -> np.ndarray:
    """Decode the PNG at ``path`` (or its bytes ``data``) to a (H, W, 3)
    uint8 RGB array, as ``cv2.imread(path)[..., ::-1]`` does, its EXIF
    orientation applied."""
    (w, h, depth, ctype, interlace), stream, palette, exif = read_chunks(path, data)
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG files are not read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not a PNG colour type")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise NotImplementedError(f"{path}: bit depth {depth} of colour type {ctype} is not read")
    channels, nbytes = _CHANNELS[ctype], depth // 8
    bpp = channels * nbytes
    stride = w * bpp
    raw = np.frombuffer(bytearray(zlib.decompress(stream)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes inflated, expected {h * (stride + 1)}")
    img = unfilter(raw, h, stride, bpp).reshape(h, w, channels, nbytes)[..., 0]  # 16-bit: the high byte
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: a palette image without PLTE")
        img = np.frombuffer(palette, np.uint8).reshape(-1, 3)[img[..., 0]]
    elif channels < 3:  # grey, grey + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    else:
        img = img[..., :3]
    return apply_orientation(img, orientation(exif) if exif is not None else 1)
