"""GIF frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for GIF files, with no cv2.

cv2 5.0 reads a GIF with its own decoder (``grfmt_gif.cpp``), and
``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns for it, bit for bit: the first image of
a GIF87a or GIF89a file, animated or not, drawn on a canvas of the logical
screen's size that is filled with the global colour table's background entry
(black without a global table). A pixel takes its colour from the image's
local colour table where its index lies inside it, else from the global
table; a pixel of the transparent index of the Graphic Control Extension
before the image leaves the canvas as it is. A file with neither table reads
through cv2's default table (index i grey i, index 1 white). Interlaced
images are read in their four passes (every 8th row from 0, from 4, every 4th
from 2, every 2nd from 1).

What cv2 fails on raises ValueError naming the file: a file cut short (cv2
walks every block to the trailer before it reads the first image), a block
that is neither an extension nor an image, a background index or a pixel
index past the colour tables, an image past the logical screen, a minimum
code size outside 2-11, and LZW data that is bad (a code past the table),
short of the image, or longer than it (``gif_lzw_decode``'s rules).

The LZW decode runs in the host C++ of ``csrc/raster_decode.cpp``
(``data/raster.py``); ``lzw_plain`` is its Python twin, for the tests.
"""

from __future__ import annotations

import struct

import numpy as np

from superslomo_tpu_torch.data import raster

SIGNATURES = (b"GIF87a", b"GIF89a")
DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)  # cv2's table of a file with none
DEFAULT_TABLE[1] = 255
_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))  # (first row, step) of each pass
_ERRORS = {raster.BAD_CODE: "an LZW code past the table", raster.TRUNCATED: "LZW data short of the image "
           "(truncated)", raster.OVERRUN: "LZW data past the image's end"}


def lzw_plain(src: bytes, min_size: int, cap: int) -> tuple:
    """The plain version of the compiled ``gif_lzw_decode``: (the ``cap``
    palette indices as uint8, cap or the routine's error code)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([c & 255]) for c in range(clear)] + [b"", b""]  # min_size > 8: literals kept mod 256
    table, nbits, prev = list(base), min_size + 1, None
    out = bytearray()
    total, pos = len(src) * 8, 0
    b = bytes(src) + b"\0\0\0"
    while pos + nbits <= total:
        at = pos >> 3
        code = ((b[at] | b[at + 1] << 8 | b[at + 2] << 16) >> (pos & 7)) & ((1 << nbits) - 1)
        pos += nbits
        if code in (clear, end):
            table, nbits, prev = list(base), min_size + 1, None
            continue
        if len(out) == cap:  # the image is full: this code must end in the data's last byte
            return np.frombuffer(bytes(out), np.uint8), cap if -(-pos // 8) == len(src) else raster.OVERRUN
        if prev is None:
            if code > clear:
                return np.zeros(cap, np.uint8), raster.BAD_CODE
            out += table[code]
            prev = code
            continue
        if code > len(table):
            return np.zeros(cap, np.uint8), raster.BAD_CODE
        entry = table[code] if code < len(table) else table[prev] + table[prev][:1]
        if len(out) + len(entry) > cap:
            return np.zeros(cap, np.uint8), raster.OVERRUN
        if len(table) < 4096:
            table.append(table[prev] + entry[:1])
            if len(table) == 1 << nbits and nbits < 12:
                nbits += 1
        out += entry
        prev = code
    if len(out) < cap:
        return np.zeros(cap, np.uint8), raster.TRUNCATED
    return np.frombuffer(bytes(out), np.uint8), cap


def _lzw(src: bytes, min_size: int, cap: int) -> tuple:
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(cap, np.uint8)
    return out, raster.library().gif_lzw_decode(buf.ctypes.data, buf.size, min_size, out.ctypes.data, cap)


class _Reader:
    """Bytes read in order; reading past the end raises ValueError."""

    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.path}: the GIF ends inside a block (truncated)")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def sub_blocks(self) -> list:
        """The data sub-blocks up to the zero-length terminator."""
        blocks = []
        while True:
            n = self.byte()
            if n == 0:
                return blocks
            blocks.append(self.take(n))


def _table(r: _Reader, flags: int):
    """The colour table that ``flags`` announces, as (entries, 3) uint8, or None."""
    if not flags & 0x80:
        return None
    n = 1 << ((flags & 7) + 1)
    return np.frombuffer(r.take(3 * n), np.uint8).reshape(n, 3)


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The first image of the GIF ``data`` as (H, W, 3) uint8 RGB, as cv2
    reads it; ``plain`` runs the Python twin of the compiled LZW decode."""
    if data[:6] not in SIGNATURES:
        raise ValueError(f"{path}: not a GIF file")
    r = _Reader(data, path)
    r.take(6)
    sw, sh, flags, bg, _ = struct.unpack("<HHBBB", r.take(7))
    if sw == 0 or sh == 0:
        raise ValueError(f"{path}: a GIF screen of {sw}x{sh}")
    gct = _table(r, flags)
    if gct is not None and bg >= len(gct):
        raise ValueError(f"{path}: background index {bg} past the {len(gct)}-entry global colour table")
    first = None  # (descriptor, local table, minimum code size, LZW data, transparent index) of the first image
    transparent = None
    while True:  # every block to the trailer, as cv2 walks them before it reads the first image
        kind = r.byte()
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = r.byte()
            blocks = r.sub_blocks()
            if label == 0xF9 and first is None and blocks and len(blocks[0]) >= 4:
                transparent = blocks[0][3] if blocks[0][0] & 1 else None
        elif kind == 0x2C:
            desc = struct.unpack("<HHHHB", r.take(9))
            lct = _table(r, desc[4])
            min_size = r.byte()
            lzw = b"".join(r.sub_blocks())
            if first is None:
                first = (desc, lct, min_size, lzw, transparent)
        else:
            raise ValueError(f"{path}: a GIF block of kind 0x{kind:02x}, neither an extension nor an image")
    if first is None:
        raise ValueError(f"{path}: a GIF without an image")
    (left, top, w, h, iflags), lct, min_size, lzw, transparent = first
    if w == 0 or h == 0 or left + w > sw or top + h > sh:
        raise ValueError(f"{path}: a {w}x{h} image at ({left}, {top}) past the {sw}x{sh} GIF screen")
    if not 2 <= min_size <= 11:
        raise ValueError(f"{path}: an LZW minimum code size of {min_size}")
    idx, n = (lzw_plain if plain else _lzw)(lzw, min_size, w * h)
    if n < 0:
        raise ValueError(f"{path}: {_ERRORS[n]}")
    idx = idx.reshape(h, w)
    if iflags & 0x40:
        rows = np.concatenate([np.arange(start, h, step) for start, step in _INTERLACE])
        idx = idx[np.argsort(rows, kind="stable")]
    # the colours: the local table where an index lies inside it, else the global one; the
    # transparent index shows the canvas, which under the first image is its fill everywhere
    fill = gct[bg] if gct is not None else np.zeros(3, np.uint8)
    table = np.zeros((256, 4), np.uint8)
    known = np.zeros(256, bool)
    if lct is None and gct is None:
        table[:, :3], known[:] = DEFAULT_TABLE, True
    for t in (gct, lct):
        if t is not None:
            table[:len(t), :3], known[:len(t)] = t, True
    if transparent is not None:
        table[transparent, :3], known[transparent] = fill, True
    if not known[np.bincount(idx.reshape(-1), minlength=256) > 0].all():
        raise ValueError(f"{path}: a pixel index past the colour tables")
    canvas = np.empty((sh, sw, 3), np.uint8)
    canvas[:] = fill
    canvas[top:top + h, left:left + w] = np.take(table.view(np.uint32)[:, 0], idx).view(np.uint8).reshape(h, w, 4)[
        ..., :3]
    return canvas
