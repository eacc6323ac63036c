"""Netpbm frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for PBM, PGM, PPM (``P1``-``P6``), PAM (``P7``)
and PFM (``PF``), with no cv2.

Each reads as OpenCV's ``grfmt_pxm.cpp``, ``grfmt_pam.cpp`` and
``grfmt_pfm.cpp`` read it, quirks included:
- PBM: 0 white, 1 black, ASCII digits or packed bits.
- PGM / PPM, maxval up to 65535, comments anywhere in the header: an ASCII
  sample is clipped to maxval, then scaled to 8 bits as ``v * 255 // maxval``
  where maxval < 256, or kept as its high byte (``v >> 8``) where it is
  larger; a binary sample is not scaled at all (``P5`` / ``P6`` at maxval 100
  give their bytes), and a 2-byte one (maxval > 255) keeps its high byte.
- PAM: WIDTH, HEIGHT, DEPTH, MAXVAL and TUPLTYPE, samples unscaled as in a
  binary PGM; DEPTH 3 is read as BGR, whatever its TUPLTYPE (cv2 copies the
  bytes), DEPTH 1 as grey, ``BLACKANDWHITE`` as cv2 reads it: a row of W
  bytes whose first W / 8 are taken as packed bits (1 white); DEPTH 2 and 4 as grey from the first sample, or RGB from
  the first three with ``RGB_ALPHA``. (cv2 converts only the first
  ceil(W / DEPTH) pixels of such a row and leaves the rest of it unset.)
- PFM: 32-bit floats in either byte order (a negative scale: little-endian),
  rows bottom-up, divided by |scale| in float32 and rounded to 8 bits half to
  even without the 255 scale (as cv2's ``convertTo`` without one), where an
  out-of-range value saturates and one past 2^31, or NaN, gives 0. A grey
  ``Pf`` file, which cv2 fails to read in colour, raises ValueError.

``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit; a malformed or
truncated file raises ValueError naming it. Everything is numpy and Python.
"""

from __future__ import annotations

import re

import numpy as np

_SPACE = b" \t\n\v\f\r"


def is_pxm(data: bytes) -> bool:
    return len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"123456" and data[2] in _SPACE


def is_pam(data: bytes) -> bool:
    return len(data) >= 3 and data[:2] == b"P7" and data[2] in _SPACE


def is_pfm(data: bytes) -> bool:
    return len(data) >= 3 and data[:2] in (b"PF", b"Pf") and data[2] in _SPACE


class _Reader:
    """OpenCV's ``ReadNumber`` over the header and the ASCII samples: skips
    white space and ``#`` comments to the end of their line, reads digits,
    and consumes the one byte after them."""

    def __init__(self, data: bytes, pos: int, path: str):
        self.data, self.pos, self.path = data, pos, path

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.path}: ends inside its header or samples (truncated)")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, max_digits: int = 0) -> int:
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{self.path}: byte {code:#x} where a number should be")
        value, digits = 0, 0
        while True:
            value, digits = value * 10 + code - 48, digits + 1
            if value > 2**31 - 1:
                raise ValueError(f"{self.path}: a number past 2^31")
            if max_digits and digits >= max_digits:
                return value
            code = self.byte()
            if not 48 <= code <= 57:
                return value


def _ascii(r: _Reader, n: int, one_digit: bool) -> np.ndarray:
    """``n`` ASCII samples from the reader's position (single digits in a
    PBM), as int64: split at white space where no comment follows, else
    number by number."""
    rest = r.data[r.pos:]
    if b"#" in rest:
        return np.array([r.number(1 if one_digit else 0) for _ in range(n)], np.int64)
    if one_digit:
        tokens = rest.translate(None, _SPACE)[:n]
    else:
        tokens = rest.split(maxsplit=n)[:n]
    if len(tokens) < n or not all(t.isdigit() for t in ([tokens] if one_digit else tokens)):
        raise ValueError(f"{r.path}: fewer than {n} samples, or a byte that is no digit (truncated or corrupt)")
    if not one_digit and rest.rstrip(_SPACE) == rest and len(rest.split(maxsplit=n)) == n:
        raise ValueError(f"{r.path}: the last sample ends the file (truncated)")
    if one_digit:
        return np.frombuffer(tokens, np.uint8).astype(np.int64) - 48
    return np.array(tokens, np.int64)


def _decode_pxm(data: bytes, path: str) -> np.ndarray:
    kind = data[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary, nch = kind >= 4, 3 if bpp == 24 else 1
    r = _Reader(data, 2, path)
    width, height = r.number(), r.number()
    maxval = r.number() if bpp > 1 else 1
    if not (width > 0 and height > 0 and 0 < maxval < 65536):
        raise ValueError(f"{path}: a P{kind} file of {width}x{height}, maxval {maxval}")
    wide = maxval > 255
    n = width * height * nch
    if bpp == 1:
        if binary:
            pitch = (width + 7) // 8
            rows = np.frombuffer(data, np.uint8, pitch * height, r.pos) if r.pos + pitch * height <= len(data) \
                else None
            if rows is None:
                raise ValueError(f"{path}: the samples are cut off (truncated)")
            bits = np.unpackbits(rows.reshape(height, pitch), axis=1)[:, :width]
        else:
            bits = (_ascii(r, n, True) != 0).astype(np.uint8).reshape(height, width)
        grey = np.where(bits == 1, 0, 255).astype(np.uint8)
    else:
        if binary:
            size = 2 * n if wide else n
            if r.pos + size > len(data):
                raise ValueError(f"{path}: the samples are cut off (truncated)")
            v = np.frombuffer(data, ">u2" if wide else np.uint8, n, r.pos)
            v = (v >> 8).astype(np.uint8) if wide else v
        else:
            v = np.minimum(_ascii(r, n, False), maxval)
            v = (v >> 8 if wide else v * 255 // maxval).astype(np.uint8)
        grey = v.reshape(height, width, nch)
        if nch == 3:
            return np.array(grey)  # a writable copy, as cv2 returns
        grey = grey[..., 0]
    return np.repeat(grey[..., None], 3, axis=2)


def _decode_pam(data: bytes, path: str) -> np.ndarray:
    end = re.search(rb"(^|\n)ENDHDR[^\n]*\n", data)
    if end is None:
        raise ValueError(f"{path}: no ENDHDR line (truncated or not a PAM)")
    fields = {}
    for line in data[3:end.start()].split(b"\n"):
        line = line.strip()
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        fields[key.upper()] = value.strip()
    try:
        width, height, depth, maxval = (int(fields[k]) for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError(f"{path}: a PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL") from None
    tupltype = fields.get(b"TUPLTYPE", b"").upper()
    if not (width > 0 and height > 0 and 1 <= depth <= 4 and 0 < maxval < 65536):
        raise ValueError(f"{path}: a PAM of {width}x{height}x{depth}, maxval {maxval}")
    start = end.end()
    if tupltype == b"BLACKANDWHITE" and depth == 1:  # a byte a sample, whose first bytes cv2 reads as packed bits
        if start + width * height > len(data):
            raise ValueError(f"{path}: the samples are cut off (truncated)")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, width * height, start).reshape(height, width), axis=1)
        return np.repeat(np.where(bits[:, :width] == 1, 255, 0).astype(np.uint8)[..., None], 3, axis=2)
    wide = maxval > 255
    n = width * height * depth
    if start + n * (2 if wide else 1) > len(data):
        raise ValueError(f"{path}: the samples are cut off (truncated)")
    v = np.frombuffer(data, ">u2" if wide else np.uint8, n, start)
    v = ((v >> 8) if wide else v).astype(np.uint8).reshape(height, width, depth)
    if depth == 3:
        return np.ascontiguousarray(v[..., ::-1])
    if depth == 4 and tupltype == b"RGB_ALPHA":
        return np.ascontiguousarray(v[..., :3])
    return np.repeat(v[..., :1], 3, axis=2)


def _decode_pfm(data: bytes, path: str) -> np.ndarray:
    head = re.match(rb"P([Ff])\s+(\d+)\s+(\d+)\s+(\S+)\s", data)
    if head is None:
        raise ValueError(f"{path}: a malformed PFM header")
    if head.group(1) == b"f":
        raise ValueError(f"{path}: a grey PFM, which cv2 does not read in colour")
    width, height, scale = int(head.group(2)), int(head.group(3)), float(head.group(4))
    if width <= 0 or height <= 0 or scale == 0:
        raise ValueError(f"{path}: a PFM of {width}x{height}, scale {scale}")
    n = width * height * 3
    if head.end() + 4 * n > len(data):
        raise ValueError(f"{path}: the samples are cut off (truncated)")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, head.end()).astype(np.float32)
    v = v.reshape(height, width, 3)[::-1] * (np.float32(1) / np.float32(abs(scale)))
    return to_uint8(v)


def to_uint8(v: np.ndarray) -> np.ndarray:
    """float32 values to uint8 as OpenCV's ``convertTo`` rounds them: half to
    even, saturated, and 0 where the value is NaN or its magnitude 2^31 or
    more (the integer conversion's overflow value)."""
    with np.errstate(invalid="ignore", over="ignore"):
        bad = ~(np.abs(v) < 2.0**31)
        r = np.rint(np.where(bad, 0, v))
    return np.clip(r, 0, 255).astype(np.uint8)


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PxM, PAM or PFM file's bytes as (H, W, 3) uint8 RGB, as cv2 reads them."""
    if is_pxm(data):
        return _decode_pxm(data, path)
    if is_pam(data):
        return _decode_pam(data, path)
    if is_pfm(data):
        return _decode_pfm(data, path)
    raise ValueError(f"{path}: not a PBM, PGM, PPM, PAM or PFM file")
