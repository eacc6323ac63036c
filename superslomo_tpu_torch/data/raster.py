"""The compiled codecs of the uncompressed and lossless raster formats
(``csrc/raster_decode.cpp``: TIFF's and GIF's LZW, TIFF's PackBits, BMP's
RLE8 / RLE4, Radiance HDR scanlines), built at first use by ``ops/cuda_build.py`` and
called through ctypes with the GIL released, so the Loader's threads decode
frames in parallel. Each format's reader (``data/tiff.py``, ``data/gif.py``,
``data/bmp.py``, ``data/hdr.py``) keeps the plain Python twin of the routines it calls beside
its caller."""

from __future__ import annotations

import ctypes

import numpy as np

from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "raster_decode.cpp"
BAD_CODE, TRUNCATED, OVERRUN = -1, -2, -3  # the routines' errors
_P = ctypes.c_void_p
_I = ctypes.c_int64


def _declare(lib: ctypes.CDLL) -> None:
    for name, args in (("lzw_decode", [_P, _I, _P, _I]), ("packbits_decode", [_P, _I, _P, _I]),
                       ("gif_lzw_decode", [_P, _I, _I, _P, _I]),
                       ("bmp_rle_decode", [_P, _I, _I, _I, _I, _P]),
                       ("hdr_decode", [_P, _I, _I, _I, _P])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = _I


def library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _declare)


def stream(src: bytes, cap: int, routine: str) -> tuple:
    """``routine`` (``lzw_decode`` or ``packbits_decode``) over ``src`` into
    ``cap`` bytes: (the uint8 output, the bytes written or an error)."""
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(cap, np.uint8)
    return out, getattr(library(), routine)(buf.ctypes.data, buf.size, out.ctypes.data, cap)
