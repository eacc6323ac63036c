"""EXIF orientation, applied to a decoded frame as ``cv2.imread`` applies it
(its default, without ``IMREAD_IGNORE_ORIENTATION``), for the PNG and JPEG
decoders.

``orientation`` reads the Orientation tag (0x0112) from IFD0 of a
TIFF-structured EXIF block in either byte order; ``apply_orientation`` turns
a (H, W, C) frame the way the tag says. A missing or malformed block, or a
value outside 1-8, leaves the frame as it is, as cv2 does.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION_TAG = 0x0112


def orientation(tiff: bytes) -> int:
    """The Orientation value (1-8) in IFD0 of ``tiff``, a TIFF-structured
    EXIF block ("II" or "MM", 42, the offset of IFD0); 1 when the block is
    malformed, holds no such entry or holds a value outside 1-8. Like cv2,
    it reads the value's first 16 bits whatever the entry's type, and takes
    the first Orientation entry."""
    order = {b"II": "<", b"MM": ">"}.get(bytes(tiff[:2]))
    if order is None:
        return 1
    try:
        magic, ifd = struct.unpack_from(order + "HI", tiff, 2)
        if magic != 42:
            return 1
        (count,) = struct.unpack_from(order + "H", tiff, ifd)
        for entry in range(ifd + 2, ifd + 2 + 12 * count, 12):
            (tag,) = struct.unpack_from(order + "H", tiff, entry)
            if tag == ORIENTATION_TAG:
                (value,) = struct.unpack_from(order + "H", tiff, entry + 8)
                return value if 1 <= value <= 8 else 1
    except struct.error:  # an offset or an entry past the block's end
        pass
    return 1


def apply_orientation(img: np.ndarray, value: int) -> np.ndarray:
    """``img`` (H, W, C) turned upright for EXIF ``value``, as cv2 turns it:
    2 mirrors left-right, 3 turns half round, 4 mirrors top-bottom; 5-8
    transpose first (5 alone, then 6 mirrors left-right, 7 turns half round, 8
    mirrors top-bottom), so the result is (W, H, C). Returns a contiguous array."""
    if value in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1), slice(None, None, -1)),
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1), slice(None, None, -1)), 8: (slice(None, None, -1),)}.get(value)
    if flip is not None:
        img = img[flip]
    return np.ascontiguousarray(img)
