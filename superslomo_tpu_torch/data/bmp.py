"""BMP frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for Windows and OS/2 bitmaps, with no cv2.

It reads what OpenCV's ``grfmt_bmp.cpp`` reads: the BITMAPINFOHEADER, its V4
and V5 extensions and the OS/2 v1 header (12 bytes: 16-bit sizes, a palette
of 3-byte entries); 1, 4 and 8 bits through a palette (entries past
``biClrUsed`` black), 16 bits as 5-5-5 (``BI_RGB``, or ``BI_BITFIELDS`` with
5-5-5 or 5-6-5 masks; the low bits of each 8-bit value zero, as cv2 expands
them), 24 bits, and 32 bits (the fourth byte dropped, whatever the masks of
``BI_BITFIELDS`` say, as cv2 reads it); RLE8 and RLE4 with their
end-of-line, end-of-bitmap and delta codes, the pixels a code skips painted
with palette entry 0 as cv2 paints them (an RLE4 end of bitmap ends only its
row, and an RLE4 delta moves only along the row, as in cv2); rows bottom-up,
or top-down where the height is negative.

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit. A header or a bit depth
and compression that cv2 does not read (16-bit bit fields of other masks, a
16-bit V4 / V5 file with bit fields, which cv2 reads its masks past), an RLE
run past its row, or data that ends before the image does raises ValueError
naming the file. RLE runs in the host C++ of ``csrc/raster_decode.cpp``
(``data/raster.py``); ``rle_plain`` is its Python twin, for the tests.
"""

from __future__ import annotations

import struct

import numpy as np

from superslomo_tpu_torch.data import raster

SIGNATURE = b"BM"
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def rle_plain(src: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """The plain version of the compiled ``bmp_rle_decode``: (height, width)
    palette indices in file row order; raises ValueError where the routine
    returns an error."""
    idx = np.zeros(width * height, np.uint8)
    pos = x = y = 0
    row_ended = False

    def skip(k):
        nonlocal x, y
        while True:
            m = min(width - x, k)
            idx[y * width + x:y * width + x + m] = 0
            x, k = x + m, k - m
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if k <= 0:
                return

    while True:
        if pos + 2 > len(src):
            raise ValueError("the RLE data ends before the image does")
        n, code = src[pos], src[pos + 1]
        pos += 2
        if n:
            if x + n > width:
                raise ValueError("an RLE run past its row")
            at = y * width + x
            idx[at:at + n] = code if bits == 8 else np.resize([code >> 4, code & 15], n)
            x += n
            if bits == 8:
                y0 = y
                if x >= width:
                    x, y = 0, y + 1
                row_ended = y != y0
                if y >= height:
                    break
        elif code > 2:
            if x + code > width:
                raise ValueError("an RLE run past its row")
            size = (code + 1) & ~1 if bits == 8 else (((code + 1) >> 1) + 1) & ~1
            if pos + size > len(src):
                raise ValueError("the RLE data ends before the image does")
            raw = np.frombuffer(src, np.uint8, size, pos)
            at = y * width + x
            idx[at:at + code] = raw[:code] if bits == 8 else np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:code]
            pos += size
            x += code
            row_ended = False
        elif bits == 8:
            k, dy = width - x, height - y
            if code or not row_ended or k < width:
                if code == 2:
                    if pos + 2 > len(src):
                        raise ValueError("the RLE data ends before the image does")
                    k, dy = src[pos], src[pos + 1]
                    pos += 2
                if code:
                    k += dy * width
                if y >= height:
                    break
                skip(k)
                if y >= height:
                    break
            row_ended = False
            if y >= height:
                break
        else:
            k = width - x
            if code == 2:
                if pos + 2 > len(src):
                    raise ValueError("the RLE data ends before the image does")
                k = src[pos]
                pos += 2
            skip(k)
            if y >= height:
                break
    return idx.reshape(height, width)


def _rle(src: bytes, width: int, height: int, bits: int, path: str, plain: bool) -> np.ndarray:
    if plain:
        try:
            return rle_plain(src, width, height, bits)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    buf = np.frombuffer(src, np.uint8)
    idx = np.zeros((height, width), np.uint8)
    err = raster.library().bmp_rle_decode(buf.ctypes.data, buf.size, width, height, bits, idx.ctypes.data)
    if err == raster.OVERRUN:
        raise ValueError(f"{path}: an RLE run past its row")
    if err:
        raise ValueError(f"{path}: the RLE data ends before the image does")
    return idx


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The bitmap ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it; ``plain``
    runs the Python twin of the compiled RLE routine."""
    if data[:2] != SIGNATURE or len(data) < 26:
        raise ValueError(f"{path}: not a BMP file")
    offset, size = struct.unpack_from("<II", data, 10)
    try:
        if size >= 36:
            width, height, bpp, comp = struct.unpack_from("<iiIi", data, 18)
            bpp >>= 16
            (used,) = struct.unpack_from("<i", data, 46)
            ok = ((bpp in (1, 4, 8, 24, 32) and comp == _RGB) or (bpp in (16, 32) and comp == _BITFIELDS)
                  or (bpp == 4 and comp == _RLE4) or (bpp == 8 and comp == _RLE8) or (bpp == 16 and comp == _RGB))
            entry, colours = 4, (used or 1 << bpp) if bpp <= 8 else 0
            if bpp <= 8 and not 0 <= used <= 256:
                ok = False
            if bpp == 16 and comp == _BITFIELDS:  # the masks as cv2 reads them: after the header
                r, g, b = struct.unpack_from("<III", data, 14 + size)
                bpp = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}.get((r, g, b))
                ok = ok and bpp is not None
            elif bpp == 16:
                bpp = 15
        elif size == 12:
            width, height, bpp = struct.unpack_from("<HHI", data, 18)
            bpp >>= 16
            comp, entry, colours = _RGB, 3, 1 << bpp if bpp <= 8 else 0
            ok = bpp in (1, 4, 8, 24, 32)
        else:
            ok = False
    except struct.error:
        raise ValueError(f"{path}: the BMP header is cut off (truncated)") from None
    if not ok or width <= 0 or height == 0:
        raise ValueError(f"{path}: a BMP of {size}-byte header, {bpp} bits, compression {comp}, which cv2 does "
                         "not read")
    bottom_up, height = height > 0, abs(height)
    palette = np.zeros((256, 3), np.uint8)  # BGR
    if colours:
        raw = np.frombuffer(data, np.uint8, colours * entry, 14 + size) if 14 + size + colours * entry <= len(data) \
            else None
        if raw is None:
            raise ValueError(f"{path}: the palette is cut off (truncated)")
        palette[:colours] = raw.reshape(colours, entry)[:, :3]
    pixels = data[offset:]
    if comp in (_RLE8, _RLE4):
        idx = _rle(pixels, width, height, bpp, path, plain)
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if len(pixels) < pitch * height:
            raise ValueError(f"{path}: the pixels are cut off (truncated)")
        rows = np.frombuffer(pixels, np.uint8, pitch * height).reshape(height, pitch)
        if bpp <= 8:
            idx = np.unpackbits(rows, axis=1).reshape(height, -1, bpp)[:, :width] if bpp < 8 else rows[:, :width]
            if bpp < 8:
                idx = (idx * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
        elif bpp in (15, 16):
            v = rows[:, : 2 * width].view("<u2").astype(np.int32)
            bgr = [(v << 3) & 0xF8, (v >> 2) & 0xF8, (v >> 7) & 0xF8] if bpp == 15 else \
                [(v << 3) & 0xF8, (v >> 3) & 0xFC, (v >> 8) & 0xF8]
            idx, out = None, np.stack(bgr[::-1], axis=2).astype(np.uint8)
        else:
            idx, out = None, rows[:, : width * bpp // 8].reshape(height, width, bpp // 8)[..., 2::-1]
    if idx is not None:
        out = palette[idx][..., ::-1]
    return np.ascontiguousarray(out[::-1] if bottom_up else out)
