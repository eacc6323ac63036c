"""Radiance HDR frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for ``#?RADIANCE`` / ``#?RGBE`` files, with no cv2.

It reads as OpenCV's ``grfmt_hdr.cpp`` and ``rgbe.cpp`` read: header lines up
to the blank line (``FORMAT=32-bit_rle_rgbe`` required), then the size line
``-Y H +X W`` (the only orientation cv2 reads); scanlines flat (4 bytes a
pixel), or new-style run-length scanlines (2, 2, the width, then each of the
four channels as runs and literals) for widths of 8 to 32767, where a
scanline that does not start so is read flat with every one after it. Each
pixel is m * 2^(e - 136) in float32 (0 where e is 0), then ``convertTo``'s
8-bit value of it times 255: rounded half to even, saturated, and 0 past 2^31
(the integer conversion's overflow value).

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit. An XYZE file
(``FORMAT=32-bit_rle_xyze``), which cv2 fails to read, another size line,
or data that ends before the image does raises ValueError naming the file.
The scanlines are decoded by the host C++ of ``csrc/raster_decode.cpp``
(``data/raster.py``); ``scanlines_plain`` is its Python twin, for the tests.
"""

from __future__ import annotations

import re

import numpy as np

from superslomo_tpu_torch.data import raster
from superslomo_tpu_torch.data.pnm import to_uint8

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")


def scanlines_plain(src: bytes, width: int, height: int) -> np.ndarray:
    """The plain version of the compiled ``hdr_decode``: (height, width, 4)
    RGBE bytes; raises ValueError where the routine returns an error."""
    total, pos = width * height, 0
    out = np.zeros((total, 4), np.uint8)

    def flat(start):
        if pos + 4 * (total - start) > len(src):
            raise ValueError("the pixels are cut off (truncated)")
        out[start:] = np.frombuffer(src, np.uint8, 4 * (total - start), pos).reshape(-1, 4)
        return out.reshape(height, width, 4)

    if not 8 <= width <= 0x7FFF:
        return flat(0)
    for y in range(height):
        if pos + 4 > len(src):
            raise ValueError("the pixels are cut off (truncated)")
        if src[pos] != 2 or src[pos + 1] != 2 or src[pos + 2] & 0x80:
            return flat(y * width)
        if (src[pos + 2] << 8 | src[pos + 3]) != width:
            raise ValueError("a scanline of the wrong width")
        pos += 4
        for c in range(4):
            x = 0
            while x < width:
                if pos + 2 > len(src):
                    raise ValueError("the pixels are cut off (truncated)")
                count = src[pos]
                if count > 128:
                    count -= 128
                    if count > width - x:
                        raise ValueError("bad scanline data")
                    out[y * width + x:y * width + x + count, c] = src[pos + 1]
                    pos += 2
                else:
                    if count == 0 or count > width - x:
                        raise ValueError("bad scanline data")
                    if pos + 1 + count > len(src):
                        raise ValueError("the pixels are cut off (truncated)")
                    out[y * width + x:y * width + x + count, c] = np.frombuffer(src, np.uint8, count, pos + 1)
                    pos += 1 + count
                x += count
    return out.reshape(height, width, 4)


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The HDR ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it; ``plain``
    runs the Python twin of the compiled scanline routine."""
    if not data.startswith(SIGNATURES):
        raise ValueError(f"{path}: not a Radiance HDR file")
    blank = data.find(b"\n\n")
    size = re.match(rb"-Y (\d+) \+X (\d+)\n", data[blank + 2:]) if blank >= 0 else None
    lines = data[:blank].split(b"\n") if blank >= 0 else []
    if b"FORMAT=32-bit_rle_xyze" in lines:
        raise ValueError(f"{path}: an XYZE HDR file, which cv2 does not read")
    if b"FORMAT=32-bit_rle_rgbe" not in lines or size is None:
        raise ValueError(f"{path}: an HDR header without FORMAT=32-bit_rle_rgbe and a -Y H +X W size line")
    height, width = int(size.group(1)), int(size.group(2))
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: an HDR of {width}x{height}")
    body = data[blank + 2 + size.end():]
    if plain:
        try:
            rgbe = scanlines_plain(body, width, height)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    else:
        buf = np.frombuffer(body, np.uint8)
        rgbe = np.empty((height, width, 4), np.uint8)
        n = raster.library().hdr_decode(buf.ctypes.data, buf.size, width, height, rgbe.ctypes.data)
        if n < 0:
            why = "the pixels are cut off (truncated)" if n == raster.TRUNCATED else "bad scanline data"
            raise ValueError(f"{path}: {why}")
    e = rgbe[..., 3:].astype(np.int32)
    value = np.where(e > 0, rgbe[..., :3] * np.ldexp(np.float32(1), e - 136).astype(np.float32), np.float32(0))
    return to_uint8(value.astype(np.float32) * np.float32(255))
