"""WebP frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for lossless WebP files, with no cv2.

cv2 5.0 reads a WebP through libwebp: a still image with ``WebPDecode``, an
animated one through libwebp's animation decoder, whose first frame it
returns. ``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit, for:

- the RIFF container: chunks padded to even sizes; the RIFF size must lie
  inside the file (bytes past it are ignored); a file under 32 bytes, which
  cv2 refuses, raises;
- a simple file (one ``VP8L`` chunk), or a ``VP8X`` file (its flags and
  24-bit canvas size, which a still image must match) whose ``ALPH``,
  ``ICCP``, ``XMP `` and unknown chunks are read past;
- the alpha channel dropped, the colour channels as stored (including those
  of pixels whose alpha is 0);
- the EXIF Orientation of a ``VP8X`` file whose EXIF flag is set (its first
  ``EXIF`` chunk, a TIFF-structured block), applied as cv2 applies it
  (``data/exif.py``);
- an animated file (``ANIM`` before the ``ANMF`` frames): the first frame's
  bitstream drawn at its offset on a black canvas, whatever its blend and
  dispose flags; every frame must lie inside the canvas.

A lossy bitstream (a ``VP8 `` chunk, or a first frame that is one) raises
NotImplementedError naming the file and "lossy WebP (VP8)". What cv2 fails on
(a file cut short, a chunk past the RIFF size, a bad VP8L stream) raises
ValueError naming the file.

The VP8L decode runs in the host C++ of ``csrc/webp_decode.cpp``, built at
first use by ``ops/cuda_build.py`` and called through ctypes with the GIL
released; ``data/vp8l.py`` is its plain Python twin (``plain=True``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from superslomo_tpu_torch.data import vp8l
from superslomo_tpu_torch.data.exif import apply_orientation, orientation
from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "webp_decode.cpp"
_ERRORS = {-1: "a VP8L bitstream that libwebp refuses", -2: "VP8L data that ends too soon (truncated)"}
_ANIMATION, _EXIF = 0x02, 0x08  # VP8X flags


def _declare(lib: ctypes.CDLL) -> None:
    lib.vp8l_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.vp8l_decode.restype = ctypes.c_int64


def library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _declare)


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, start: int, end: int, path: str) -> list:
    """[(fourcc, payload start, payload size)] of the chunks in data[start:end]."""
    out = []
    while start + 8 <= end:
        fourcc = data[start:start + 4]
        (size,) = struct.unpack_from("<I", data, start + 4)
        if start + 8 + size > end:
            raise ValueError(f"{path}: a WebP {fourcc.decode('latin-1')!r} chunk past the data's end (truncated)")
        out.append((fourcc, start + 8, size))
        start += 8 + size + (size & 1)
    return out


def _vp8l_size(data: bytes, at: int, size: int, path: str) -> tuple:
    """(width, height) of the VP8L bitstream at data[at:at + size]."""
    if size < 5 or data[at] != 0x2F or data[at + 4] >> 5:
        raise ValueError(f"{path}: a VP8L header that libwebp refuses")
    (bits,) = struct.unpack_from("<I", data, at + 1)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _vp8_size(data: bytes, at: int, size: int, path: str) -> tuple:
    """(width, height) of the lossy VP8 key frame at data[at:at + size]."""
    if size < 10 or data[at] & 1 or data[at + 3:at + 6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: a VP8 frame header that libwebp refuses")
    w, h = struct.unpack_from("<HH", data, at + 6)
    return w & 0x3FFF, h & 0x3FFF


def _frame(data: bytes, chunks: list, path: str) -> tuple:
    """(fourcc, payload start, size, width, height) of the image of ``chunks``:
    its VP8 or VP8L chunk (an ALPH chunk before it is read past)."""
    for fourcc, at, size in chunks:
        if fourcc == b"VP8L":
            return (fourcc, at, size, *_vp8l_size(data, at, size, path))
        if fourcc == b"VP8 ":
            return (fourcc, at, size, *_vp8_size(data, at, size, path))
        if fourcc != b"ALPH":
            break
    raise ValueError(f"{path}: a WebP frame without a VP8 or VP8L bitstream")


def _refuse_lossy(path: str):
    raise NotImplementedError(f"{path}: lossy WebP (VP8) is not read; only lossless WebP (VP8L)")


def _argb(data: bytes, at: int, size: int, w: int, h: int, path: str, plain: bool) -> np.ndarray:
    stream = data[at:at + size]
    if plain:
        try:
            return vp8l.decode(stream, w, h)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    src = np.frombuffer(stream, np.uint8)
    out = np.empty((h, w), np.uint32)
    err = library().vp8l_decode(src.ctypes.data, src.size, w, h, out.ctypes.data)
    if err:
        raise ValueError(f"{path}: {_ERRORS[err]}")
    return out


def _rgb(argb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB → (H, W, 3) uint8 RGB, the alpha dropped."""
    return argb.view(np.uint8).reshape(*argb.shape, 4)[..., 2::-1].copy()


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The lossless WebP ``data`` (its first frame) as (H, W, 3) uint8 RGB,
    as cv2 reads it; ``plain`` runs the Python twin of the compiled decode."""
    if not is_webp(data):
        raise ValueError(f"{path}: not a WebP file")
    if len(data) < 32:
        raise ValueError(f"{path}: a WebP file of {len(data)} bytes, under the 32 that cv2 reads")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or riff + 8 > len(data):
        raise ValueError(f"{path}: a RIFF size of {riff} for a file of {len(data)} bytes (truncated)")
    chunks = _chunks(data, 12, riff + 8, path)
    if not chunks:
        raise ValueError(f"{path}: a WebP file without chunks")
    fourcc, at, size = chunks[0]
    if fourcc != b"VP8X":  # a simple file: the bitstream alone
        kind, at, size, w, h = _frame(data, chunks[:1], path)
        if kind == b"VP8 ":
            _refuse_lossy(path)
        return _rgb(_argb(data, at, size, w, h, path, plain))
    if size != 10:
        raise ValueError(f"{path}: a VP8X chunk of {size} bytes")
    flags = data[at]
    cw = 1 + int.from_bytes(data[at + 4:at + 7], "little")
    ch = 1 + int.from_bytes(data[at + 7:at + 10], "little")
    turn = 1
    if flags & _EXIF:
        exif = [(a, s) for c, a, s in chunks if c == b"EXIF"]
        if exif:
            turn = orientation(data[exif[0][0]:exif[0][0] + exif[0][1]])
    if not flags & _ANIMATION:
        rest = [c for c in chunks[1:] if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        kind, at, size, w, h = _frame(data, rest, path)
        if (w, h) != (cw, ch):
            raise ValueError(f"{path}: a {w}x{h} image on a {cw}x{ch} VP8X canvas")
        if kind == b"VP8 ":
            _refuse_lossy(path)
        return apply_orientation(_rgb(_argb(data, at, size, w, h, path, plain)), turn)
    # animated: ANIM, then every frame inside the canvas; the first frame drawn on black
    frames, anim = [], False
    for fourcc, at, size in chunks[1:]:
        if fourcc == b"ANIM":
            if size < 6:
                raise ValueError(f"{path}: an ANIM chunk of {size} bytes")
            anim = True
        elif fourcc == b"ANMF":
            if not anim or size < 16:
                raise ValueError(f"{path}: an ANMF frame before the ANIM chunk, or under 16 bytes")
            x, y = (2 * int.from_bytes(data[at + k:at + k + 3], "little") for k in (0, 3))
            kind, fat, fsize, w, h = _frame(data, _chunks(data, at + 16, at + size, path), path)
            if x + w > cw or y + h > ch:
                raise ValueError(f"{path}: a {w}x{h} frame at ({x}, {y}) past the {cw}x{ch} canvas")
            frames.append((kind, fat, fsize, w, h, x, y))
        elif fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError(f"{path}: a bitstream outside the frames of an animated WebP")
    if not frames:
        raise ValueError(f"{path}: an animated WebP without frames")
    kind, at, size, w, h, x, y = frames[0]
    if kind == b"VP8 ":
        _refuse_lossy(path)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + h, x:x + w] = _rgb(_argb(data, at, size, w, h, path, plain))
    return apply_orientation(canvas, turn)
