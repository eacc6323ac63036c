"""WebP frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for lossless and lossy WebP files, with no cv2.

cv2 5.0 reads a WebP through libwebp: a still image with ``WebPDecode``, an
animated one through libwebp's animation decoder, whose first frame it
returns. ``decode(data, path)`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit, for:

- the RIFF container: chunks padded to even sizes; the RIFF size must lie
  inside the file (bytes past it are ignored); a file under 32 bytes, which
  cv2 refuses, raises;
- a simple file (one ``VP8L`` or ``VP8 `` chunk), or a ``VP8X`` file (its
  flags and 24-bit canvas size, which a still image must match) whose
  ``ICCP``, ``XMP `` and unknown chunks are read past;
- the alpha channel dropped, the colour channels as stored (including those
  of pixels whose alpha is 0); a lossless image's ``ALPH`` chunks are read
  past, but libwebp decodes a lossy image's ``ALPH`` (a still image's last
  one before the bitstream, a frame's first) with its colour, so a header
  it refuses (compression past 1, pre-processing past 1, reserved bits),
  raw alpha short of the frame, or lossless alpha that fails to decode
  fails the read;
- a lossy bitstream (``data/vp8.py``) with the checks of libwebp's
  ``VP8GetInfo`` (a key frame, version 0-3, shown, a first partition inside
  its chunk, a size that is not 0); libwebp's decoder is given a still
  image's data to the end of the file (past the RIFF size too), so its last
  token partition may run into the bytes after its chunk, and a frame's
  chunk with its pad byte;
- the EXIF Orientation of a ``VP8X`` file whose EXIF flag is set (its first
  ``EXIF`` chunk, a TIFF-structured block), applied as cv2 applies it
  (``data/exif.py``), where the demuxer below reads the file;
- a still image's chunks read up to its bitstream, as libwebp's decode reads
  them: a chunk after the bitstream whose size runs past the data's end does
  not fail the read (one before it does);
- an animated file (``ANIM`` before the ``ANMF`` frames) walked as libwebp's
  demuxer walks it (``_demux``): an ``ANMF`` frame keeps its first ``ALPH``
  and its first ``VP8``/``VP8L`` chunk, the chunks after those are read as
  if outside it, and a frame with neither is passed over (its rectangle
  unchecked); the first frame with a bitstream is drawn at its offset on a
  black canvas, whatever its blend and dispose flags; every frame with a
  bitstream must lie inside the canvas, and any fault the demuxer finds (a
  chunk past the end, fewer than 8 bytes after a chunk, a frame of ``ALPH``
  alone, ``ALPH`` before ``VP8L``, a bitstream outside the frames, a
  reserved VP8X flag) fails the read;
- the EXIF orientation applied only where that demuxer reads the whole file,
  for a still image too (cv2 reads the EXIF chunk through it).

What cv2 fails on (a file cut short, a chunk past the RIFF size before a
still image's bitstream, a bad VP8L or VP8 stream) raises ValueError naming
the file.

The VP8L and VP8 decodes run in the host C++ of ``csrc/webp_decode.cpp`` and
``csrc/vp8_decode.cpp``, built at first use by ``ops/cuda_build.py`` and
called through ctypes with the GIL released; ``data/vp8l.py`` and
``data/vp8.py`` are their plain Python twins (``plain=True``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from superslomo_tpu_torch.data import vp8, vp8l
from superslomo_tpu_torch.data.exif import apply_orientation, orientation
from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "webp_decode.cpp"
VP8_SOURCE = cuda_build.CSRC / "vp8_decode.cpp"
_ERRORS = {-1: "a VP8L bitstream that libwebp refuses", -2: "VP8L data that ends too soon (truncated)"}
_VP8_ERRORS = {-1: "a VP8 frame that libwebp refuses", -2: "VP8 data that ends too soon (truncated)"}
_ALPHA, _ANIMATION, _EXIF = 0x10, 0x02, 0x08  # VP8X flags
_VALID_FLAGS = 0x3E  # ALPHA, ANIMATION, ICCP, EXIF, XMP
_BITSTREAMS = (b"VP8 ", b"VP8L")


def _declare(lib: ctypes.CDLL) -> None:
    for fn in (lib.vp8l_decode, lib.vp8l_decode_alpha):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int64


def _declare_vp8(lib: ctypes.CDLL) -> None:
    lib.vp8_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.vp8_decode.restype = ctypes.c_int64


def library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _declare)


def vp8_library() -> ctypes.CDLL:
    return cuda_build.load_library(VP8_SOURCE, _declare_vp8)


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, start: int, end: int, path: str) -> list:
    """[(fourcc, payload start, payload size)] of the chunks in data[start:end]
    up to the first VP8 or VP8L chunk, as libwebp's still-image decode reads
    them: what follows that bitstream is not read."""
    out = []
    while start + 8 <= end:
        fourcc = data[start:start + 4]
        (size,) = struct.unpack_from("<I", data, start + 4)
        if start + 8 + size > end:
            raise ValueError(f"{path}: a WebP {fourcc.decode('latin-1')!r} chunk past the data's end (truncated)")
        out.append((fourcc, start + 8, size))
        if fourcc in _BITSTREAMS:
            break
        start += 8 + size + (size & 1)
    return out


class _DemuxError(ValueError):
    """Where libwebp's demuxer (``WebPDemux``) refuses the file."""


def _demux(data: bytes, flags: int, cw: int, ch: int, end: int) -> tuple:
    """libwebp's ``WebPDemux`` over the chunks after a VP8X chunk (which ends
    at byte 30 + its padding) up to the RIFF's ``end``: (its frames, as
    [(frame, x, y)] with ``_frame``'s tuples, the first EXIF payload's (start,
    size) or None). The walk is flat, as demux.c's ``ParseVP8XChunks``: an
    ANMF chunk's 16-byte header is read, ``StoreFrame`` takes its first ALPH
    and first VP8 / VP8L chunks, and the chunks after those are walked as if
    they stood outside it; a frame with neither is passed over. Raises
    _DemuxError where the demuxer fails (a chunk past the end, fewer than 8
    bytes left, a bitstream outside the frames of an animation, a frame left
    without its bitstream, a reserved flag, a frame off the canvas)."""
    animated = bool(flags & _ANIMATION)
    if cw * ch >= 1 << 32:
        raise _DemuxError(f"a {cw}x{ch} canvas")
    (size,) = struct.unpack_from("<I", data, 16)
    pos = 20 + size + (size & 1)
    if end - pos < 8:
        raise _DemuxError("fewer than 8 bytes after the VP8X chunk")
    frames, exif, anim = [], None, False

    def header(at):
        fourcc, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
        padded = size + (size & 1)
        if padded > end - at - 8:
            raise _DemuxError(f"a {fourcc.decode('latin-1')!r} chunk past the data's end")
        return fourcc, size, padded

    def store(at, min_size, x, y):
        """StoreFrame from ``at`` (and ParseSingleImage's alpha rule where
        the file is not animated): (where it stopped, the frame or None)."""
        if end - at < max(8, min_size):
            raise _DemuxError("a frame cut short")
        alpha = image = None
        while True:
            fourcc, size, padded = header(at)
            if fourcc == b"ALPH" and alpha is None:
                alpha = (at + 8, size)
            elif fourcc in _BITSTREAMS and image is None:
                if fourcc == b"VP8L" and alpha is not None:
                    raise _DemuxError("an ALPH chunk before a VP8L bitstream")
                try:
                    w, h = (_vp8l_size if fourcc == b"VP8L" else _vp8_size)(data, at + 8, size, "")
                except ValueError as e:
                    raise _DemuxError(str(e)[2:]) from None
                image = (fourcc, at + 8, size, w, h)
            else:
                break
            at += 8 + padded
            if at == end:
                break
            if end - at < 8:
                raise _DemuxError("fewer than 8 bytes after a chunk")
        if alpha is None and image is None:
            return at, None
        if image is None:
            raise _DemuxError("a frame with an ALPH chunk and no bitstream")
        if not animated and not flags & _ALPHA:
            alpha = None
        if alpha is not None and alpha[0] > image[1]:
            raise _DemuxError("an ALPH chunk after its bitstream")
        fourcc, bat, bsize, w, h = image
        if (x + w > cw or y + h > ch) if animated else (w, h) != (cw, ch):
            raise _DemuxError(f"a {w}x{h} frame at ({x}, {y}) past the {cw}x{ch} canvas")
        return at, (fourcc, bat, bsize, w, h, alpha)

    while True:
        fourcc, size, padded = header(pos)
        if fourcc == b"VP8X":
            raise _DemuxError("a second VP8X chunk")
        if fourcc in (b"ALPH", *_BITSTREAMS):
            if anim or animated or frames:
                raise _DemuxError("a bitstream outside the frames of an animated WebP")
            pos, frame = store(pos, 0, 0, 0)
            if frame is not None:
                frames.append((frame, 0, 0))
        elif fourcc == b"ANMF":
            if not anim:
                raise _DemuxError("an ANMF frame before the ANIM chunk")
            if end - pos - 8 < 16 or padded < 16:
                raise _DemuxError("an ANMF chunk under 16 bytes")
            x, y, w, h = (int.from_bytes(data[pos + k:pos + k + 3], "little") for k in (8, 11, 14, 17))
            if (w + 1) * (h + 1) >= 1 << 32:
                raise _DemuxError(f"an ANMF frame of {w + 1}x{h + 1}")
            x, y = 2 * x, 2 * y
            start = pos + 24
            pos, frame = store(start, padded - 16, x, y)
            if pos - start > padded - 16:
                raise _DemuxError("a frame's chunks past its ANMF chunk")
            if frame is not None and animated:
                frames.append((frame, x, y))
        else:
            if fourcc == b"ANIM":
                if padded < 6:
                    raise _DemuxError(f"an ANIM chunk of {size} bytes")
                anim = True
            elif fourcc == b"EXIF" and flags & _EXIF and exif is None:
                exif = (pos + 8, size)
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise _DemuxError("fewer than 8 bytes after a chunk")
    if flags & ~_VALID_FLAGS:
        raise _DemuxError(f"VP8X flags {flags:#04x} with a reserved bit set")
    if not frames:
        raise _DemuxError("no frame")
    return frames, exif


def _vp8l_size(data: bytes, at: int, size: int, path: str) -> tuple:
    """(width, height) of the VP8L bitstream at data[at:at + size]."""
    if size < 5 or data[at] != 0x2F or data[at + 4] >> 5:
        raise ValueError(f"{path}: a VP8L header that libwebp refuses")
    (bits,) = struct.unpack_from("<I", data, at + 1)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _vp8_size(data: bytes, at: int, size: int, path: str) -> tuple:
    """(width, height) of the lossy VP8 key frame at data[at:at + size], with
    the checks of libwebp's VP8GetInfo."""
    if size < 10 or data[at + 3:at + 6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: a VP8 frame header that libwebp refuses")
    key, version, shown, first, w, h = vp8.frame_header(data[at:at + 10])
    if not key:
        raise ValueError(f"{path}: a VP8 frame that is not a key frame")
    if version > 3:
        raise ValueError(f"{path}: a VP8 version of {version}, above 3")
    if not shown:
        raise ValueError(f"{path}: a VP8 frame that is not shown")
    if first >= size:
        raise ValueError(f"{path}: a VP8 first partition of {first} bytes in a {size}-byte chunk")
    if not w or not h:
        raise ValueError(f"{path}: a VP8 frame of size {w}x{h}")
    return w, h


def _frame(data: bytes, chunks: list, path: str) -> tuple:
    """(fourcc, payload start, size, width, height, alpha) of the still image
    of ``chunks``: its VP8 or VP8L chunk after any ALPH chunks; ``alpha`` the
    (payload start, size) of the last ALPH before it, or None."""
    alpha = None
    for fourcc, at, size in chunks:
        if fourcc == b"VP8L":
            return (fourcc, at, size, *_vp8l_size(data, at, size, path), alpha)
        if fourcc == b"VP8 ":
            return (fourcc, at, size, *_vp8_size(data, at, size, path), alpha)
        if fourcc != b"ALPH":
            break
        alpha = (at, size)
    raise ValueError(f"{path}: a WebP frame without a VP8 or VP8L bitstream")


def _check_alpha(data: bytes, alpha: tuple, w: int, h: int, path: str, plain: bool):
    """Fail where libwebp fails to decode a lossy image's ALPH chunk: a
    payload of at most 1 byte, a header whose compression, pre-processing
    or reserved bits it refuses, raw alpha short of w x h bytes, or lossless
    alpha (a VP8L image stream without its header, decoded here behind one
    made for w x h; a stream under 8 bytes reads as 64 bits, as libwebp's
    does; its 8-bit path's rule, ``vp8l._image``) that fails to decode."""
    at, size = alpha
    if size <= 1:
        raise ValueError(f"{path}: an ALPH chunk of {size} bytes")
    head = data[at]
    method, pre, reserved = head & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"{path}: an ALPH header ({head:#04x}) that libwebp refuses")
    if method == 0:
        if size - 1 < w * h:
            raise ValueError(f"{path}: raw ALPH data of {size - 1} bytes for a {w}x{h} frame (truncated)")
        return
    body = data[at + 1:at + size]
    stream = b"\x2f" + ((w - 1) | (h - 1) << 14).to_bytes(4, "little") + body + bytes(max(0, 8 - len(body)))
    try:
        _argb(stream, 0, len(stream), w, h, path, plain, alpha=True)
    except ValueError as e:
        raise ValueError(f"{path}: lossless ALPH data that libwebp fails to decode ({e})") from None


def _vp8_rgb(data: bytes, at: int, end: int, w: int, h: int, path: str, plain: bool) -> np.ndarray:
    """The VP8 key frame at data[at:end] (to where libwebp is given data) as
    (h, w, 3) uint8 RGB."""
    if plain:
        try:
            return vp8.decode(data[at:end], w, h)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    src = np.frombuffer(data, np.uint8)[at:end]
    out = np.empty((h, w, 3), np.uint8)
    err = vp8_library().vp8_decode(src.ctypes.data, src.size, w, h, out.ctypes.data)
    if err:
        raise ValueError(f"{path}: {_VP8_ERRORS[err]}")
    return out


def _image(data: bytes, frame: tuple, end: int, path: str, plain: bool) -> np.ndarray:
    """The (h, w, 3) uint8 RGB of ``_frame``'s image; a lossy one's data runs
    to ``end``."""
    kind, at, size, w, h, alpha = frame
    if kind == b"VP8L":
        return _rgb(_argb(data, at, size, w, h, path, plain))
    if alpha is not None:
        _check_alpha(data, alpha, w, h, path, plain)
    return _vp8_rgb(data, at, end, w, h, path, plain)


def _argb(data: bytes, at: int, size: int, w: int, h: int, path: str, plain: bool, alpha: bool = False) -> np.ndarray:
    """The VP8L stream at data[at:at + size] as (h, w) uint32 ARGB; with
    ``alpha``, decoded as libwebp decodes a lossless ALPH chunk's."""
    stream = data[at:at + size]
    if plain:
        try:
            return vp8l.decode(stream, w, h, alpha)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    src = np.frombuffer(stream, np.uint8)
    out = np.empty((h, w), np.uint32)
    lib = library()
    err = (lib.vp8l_decode_alpha if alpha else lib.vp8l_decode)(src.ctypes.data, src.size, w, h, out.ctypes.data)
    if err:
        raise ValueError(f"{path}: {_ERRORS[err]}")
    return out


def _rgb(argb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB → (H, W, 3) uint8 RGB, the alpha dropped."""
    return argb.view(np.uint8).reshape(*argb.shape, 4)[..., 2::-1].copy()


def decode(data: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """The WebP ``data`` (its first frame) as (H, W, 3) uint8 RGB, as cv2
    reads it; ``plain`` runs the Python twins of the compiled decodes."""
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
        return _image(data, _frame(data, chunks[:1], path), len(data), path, plain)
    if size != 10:
        raise ValueError(f"{path}: a VP8X chunk of {size} bytes")
    flags = data[at]
    cw = 1 + int.from_bytes(data[at + 4:at + 7], "little")
    ch = 1 + int.from_bytes(data[at + 7:at + 10], "little")
    try:
        frames, exif = _demux(data, flags, cw, ch, riff + 8)
    except _DemuxError as e:
        if flags & _ANIMATION:
            raise ValueError(f"{path}: an animated WebP that libwebp's demuxer refuses ({e})") from None
        frames, exif = None, None  # a still image decodes all the same, without its EXIF
    turn = orientation(data[exif[0]:exif[0] + exif[1]]) if exif is not None else 1
    if not flags & _ANIMATION:
        rest = [c for c in chunks[1:] if c[0] in (b"ALPH", *_BITSTREAMS)]
        frame = _frame(data, rest, path)
        if frame[3:5] != (cw, ch):
            raise ValueError(f"{path}: a {frame[3]}x{frame[4]} image on a {cw}x{ch} VP8X canvas")
        return apply_orientation(_image(data, frame, len(data), path, plain), turn)
    # animated: the first frame that holds a bitstream, drawn on a black canvas
    frame, x, y = frames[0]
    at, size, w, h = frame[1:5]
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + h, x:x + w] = _image(data, frame, min(at + size + (size & 1), len(data)), path, plain)
    return apply_orientation(canvas, turn)
