"""The colour routines of libtiff's RGBA reader (``TIFFRGBAImage``, through
which cv2 reads an 8-bit TIFF) for the YCbCr and CMYK (separated)
photometrics, in numpy, equal to libtiff 4.7's bit for bit:

- ``ycbcr_tables`` / ``ycbcr_to_rgb``: ``TIFFYCbCrToRGBInit`` and
  ``TIFFYCbCrtoRGB`` of ``tif_color.c``: integer tables built in single
  precision from the YCbCrCoefficients and ReferenceBlackWhite fields (or
  their defaults), then looked up per pixel;
- ``ycbcr_units``: the ``putcontig8bitYCbCr{11,12,21,22,41,42,44}tile``
  routines of ``tif_getimage.c``: a strip's or tile's data units of h x v
  luma samples and one Cb and one Cr each, the chroma replicated over the
  unit's pixels (not interpolated), a unit cut by the right or bottom edge
  read whole;
- ``cmyk_to_rgb``: ``putRGBcontig8bitCMYKtile`` / ``putCMYKseparate8bittile``:
  R = (255 - K) (255 - C) / 255 in integers, G from M and B from Y alike.
"""

from __future__ import annotations

import numpy as np

UNIT_ROUTINES = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}  # the (h, v) libtiff puts
_LUMA = (0.299, 0.587, 0.114)  # YCbCrCoefficients' default, as libtiff's float32 constants
_REFERENCE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)  # ReferenceBlackWhite's default for YCbCr
_F = np.float32


def _fix(x) -> int:
    """FIX(x) of tif_color.c: (int32)(x * 65536.0f + 0.5), the sum in double."""
    return int(float(_F(x) * _F(65536)) + 0.5)


def _code2v(c: np.ndarray, rb, rw, cr: int) -> np.ndarray:
    """Code2V of tif_color.c in float32: (c - (int32)RB) * CR / (RW - RB, or 1
    where that is 0), then CLAMPw to +-4096 and cast to int32 (toward zero)."""
    den = _F(rw) - _F(rb)
    v = (c - int(_F(rb))).astype(_F) * _F(cr) / (den if den != 0 else _F(1))
    return np.trunc(np.clip(v, _F(-4096), _F(4096))).astype(np.int64)


def ycbcr_tables(tags: dict, path: str) -> tuple:
    """(Y, Cr_r, Cb_b, Cr_g, Cb_g) lookup tables of 256 int64 entries, as
    ``TIFFYCbCrToRGBInit`` builds them from the YCbCrCoefficients (529) and
    ReferenceBlackWhite (532) fields; the values libtiff's
    ``initYCbCrConversion`` refuses raise ValueError."""
    luma = tags[529] if len(tags.get(529, ())) == 3 else _LUMA
    ref = tags[532] if len(tags.get(532, ())) == 6 else _REFERENCE
    lr, lg, lb = (_F(v) for v in luma)
    if lg == 0:
        raise ValueError(f"{path}: YCbCrCoefficients {luma}, whose green is 0")
    if not all(_F(-0x7FFFFFFF + 128) < _F(v) < _F(0x7FFFFFFF) for v in ref):
        raise ValueError(f"{path}: ReferenceBlackWhite {ref} out of range")
    f1 = _F(2) - _F(2) * lr
    f3 = _F(2) - _F(2) * lb
    d1, d3 = _fix(np.clip(f1, 0, 2)), _fix(np.clip(f3, 0, 2))
    d2, d4 = -_fix(np.clip(lr * f1 / lg, 0, 2)), -_fix(np.clip(lb * f3 / lg, 0, 2))
    x = np.arange(-128, 128, dtype=np.int64)
    cr = _code2v(x, _F(ref[4]) - _F(128), _F(ref[5]) - _F(128), 127)
    cb = _code2v(x, _F(ref[2]) - _F(128), _F(ref[3]) - _F(128), 127)
    half = 1 << 15
    return (_code2v(x + 128, ref[0], ref[1], 255), (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def ycbcr_to_rgb(ycc: np.ndarray, tables: tuple) -> np.ndarray:
    """(H, W, 3) uint8 Y, Cb, Cr → (H, W, 3) uint8 RGB by ``TIFFYCbCrtoRGB``:
    R from (Y, Cr) and B from (Y, Cb) through 65536-entry tables of its
    clamped sums, G as Y's entry plus a (Cb, Cr) table's, clamped."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    pair = np.arange(1 << 16)
    hi, lo = pair >> 8, pair & 255
    red, blue = (np.clip(y_tab[hi] + t[lo], 0, 255).astype(np.uint8) for t in (cr_r, cb_b))
    green = ((cb_g[hi] + cr_g[lo]) >> 16).astype(np.int16)
    y, cb, cr = (ycc[..., c].astype(np.uint16) for c in range(3))
    out = np.empty(ycc.shape, np.uint8)
    out[..., 0] = red[(y << 8) | cr]
    out[..., 1] = np.clip(y_tab.astype(np.int16)[y] + green[(cb << 8) | cr], 0, 255)
    out[..., 2] = blue[(y << 8) | cb]
    return out


def ycbcr_units(buf: np.ndarray, hs: int, vs: int, rows: int, cols: int, skew: int) -> np.ndarray:
    """The (rows, cols, 3) Y, Cb, Cr that a ``putcontig8bitYCbCr<hs><vs>tile``
    routine reads from ``buf``, a strip's or tile's decoded bytes: ceil(rows
    / vs) rows of ceil(cols / hs) data units of hs * vs + 2 bytes, each unit
    row followed by ``skew`` bytes (the units of a tile past the image's
    right edge); bytes past ``buf`` read as 0."""
    size = hs * vs + 2
    ur, uc = -(-rows // vs), -(-cols // hs)
    at = (np.arange(ur)[:, None] * (uc * size + skew) + np.arange(uc)[None, :] * size)[..., None]
    at = at + np.arange(size)  # (ur, uc, size)
    units = np.concatenate([buf, np.zeros(max(0, int(at.max()) + 1 - buf.size), np.uint8)])[at]
    luma = units[..., : hs * vs].reshape(ur, uc, vs, hs).transpose(0, 2, 1, 3).reshape(ur * vs, uc * hs)
    chroma = np.repeat(np.repeat(units[..., hs * vs:], vs, axis=0), hs, axis=1)
    return np.concatenate([luma[..., None], chroma], axis=2)[:rows, :cols]


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(H, W, >= 4) uint8 C, M, Y, K (extra samples past them ignored) →
    (H, W, 3) uint8 RGB as libtiff's 8-bit CMYK put routines compute it,
    through a 65536-entry table of (K, C)."""
    pair = np.arange(1 << 16)
    table = ((255 - (pair >> 8)) * (255 - (pair & 255)) // 255).astype(np.uint8)
    k = cmyk[..., 3:4].astype(np.uint16) << 8
    return table[k | cmyk[..., :3]]
