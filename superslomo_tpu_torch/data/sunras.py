"""Sun raster frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for Sun raster files, with no cv2.

It reads what OpenCV's ``grfmt_sunras.cpp`` reads: the old and standard
types at 1, 8, 24 and 32 bits a pixel, rows padded to 16 bits, 24- and
32-bit pixels stored BGR (XBGR); a colour map (its red, green and blue
thirds; entries past it black) for 1 and 8 bits, else grey levels.

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit. The byte-encoded (RLE)
and RGB types raise ValueError naming the file: cv2 5.0 reads neither (its
header check compares the image type, not the encoding, with them), so a
JAX reader gets no image from such a file. So does any other header cv2
does not read, or data that ends before the image does. Everything is numpy.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x59\xa6\x6a\x95"
_OLD, _STANDARD = 0, 1


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The Sun raster ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it."""
    if data[:4] != SIGNATURE or len(data) < 32:
        raise ValueError(f"{path}: not a Sun raster file")
    _, width, height, depth, _, kind, maptype, maplength = struct.unpack_from(">8i", data)
    palsize = 3 << depth if 0 < depth <= 8 else 0
    ok = (width > 0 and height > 0 and depth in (1, 8, 24, 32) and kind in (_OLD, _STANDARD)
          and ((maptype == 0 and maplength == 0) or (maptype == 1 and 0 < maplength <= palsize and depth <= 8)))
    if not ok:
        raise ValueError(f"{path}: a Sun raster of {width}x{height}, {depth} bits, type {kind}, map type {maptype} "
                         f"of {maplength} bytes, which cv2 does not read"
                         + (" (cv2 reads no byte-encoded or RGB-type Sun raster)" if kind in (2, 3) else ""))
    if 32 + maplength > len(data):
        raise ValueError(f"{path}: the colour map is cut off (truncated)")
    palette = np.zeros((256, 3), np.uint8)  # RGB
    if maplength:
        n = maplength // 3
        palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
    elif depth <= 8:
        palette[: 1 << depth] = (np.arange(1 << depth) * 255 // ((1 << depth) - 1))[:, None]
    pitch = ((width * depth + 15) // 16) * 2
    size = pitch * height
    body = data[32 + maplength:]
    if len(body) < size:
        raise ValueError(f"{path}: the pixels are cut off (truncated)")
    rows = np.frombuffer(body, np.uint8, size).reshape(height, pitch)
    if depth == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :width]]
    if depth == 8:
        return palette[rows[:, :width]]
    return np.ascontiguousarray(rows[:, : width * depth // 8].reshape(height, width, depth // 8)[..., :-4:-1])
