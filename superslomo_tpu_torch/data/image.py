"""The frame reader: ``imread`` decodes an image file to the (H, W, 3) uint8
RGB array that ``cv2.imread(path)[..., ::-1]`` returns, choosing the decoder
by the file's first bytes and not by its extension, in the order cv2's
``findDecoder`` tries its decoders: BMP (``data/bmp.py``), GIF
(``data/gif.py``), Radiance HDR (``data/hdr.py``), JPEG (``data/jpeg.py``),
WebP (``data/webp.py``), Sun raster (``data/sunras.py``), PBM / PGM / PPM, PAM
and PFM (``data/pnm.py``), TIFF (``data/tiff.py``), PNG (``data/png.py``); no
two of these signatures overlap, so the order picks the same decoder as any
other would. A JPEG's, PNG's or WebP's EXIF orientation is applied as cv2
applies it, a TIFF's Orientation tag likewise.

WebP is read lossless (VP8L) and lossy (VP8); TIFF classic and BigTIFF,
JPEG-compressed too, in grey, RGB, palette, YCbCr and CMYK. A format that
cv2's build reads and the port does not (AVIF, JPEG 2000) raises
NotImplementedError naming the file and the format; any other file raises
ValueError naming it."""

from __future__ import annotations

import numpy as np

from superslomo_tpu_torch.data import bmp, gif, hdr, jpeg, png, pnm, sunras, tiff, webp

_NOT_READ = (  # (signature test, format): what cv2 reads and the port does not
    (lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis"), "AVIF"),
    (lambda d: d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or d[:4] == b"\xff\x4f\xff\x51", "JPEG 2000"),
)


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image file ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it."""
    if data[:2] == bmp.SIGNATURE:
        return bmp.decode(data, path)
    if data[:6] in gif.SIGNATURES:
        return gif.decode(data, path)
    if data.startswith(hdr.SIGNATURES):
        return hdr.decode(data, path)
    if data[:3] == jpeg.SIGNATURE:
        return jpeg.imread(path, data)
    if webp.is_webp(data):
        return webp.decode(data, path)
    if data[:4] == sunras.SIGNATURE:
        return sunras.decode(data, path)
    if pnm.is_pxm(data) or pnm.is_pam(data) or pnm.is_pfm(data):
        return pnm.decode(data, path)
    if data[:4] in tiff.SIGNATURES:
        return tiff.decode(data, path)
    if data[:8] == png.SIGNATURE:
        return png.imread(path, data)
    for test, name in _NOT_READ:
        if test(data):
            raise NotImplementedError(f"{path}: {name} is not read; only BMP, GIF, HDR, JPEG, WebP (lossless and "
                                      "lossy), Sun raster, PBM, PGM, PPM, PAM, PFM, TIFF (and BigTIFF) and PNG")
    raise ValueError(f"{path}: not an image file that cv2 reads")


def imread(path: str) -> np.ndarray:
    """Decode the image file at ``path`` to (H, W, 3) uint8 RGB; any other
    file raises ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, path)
