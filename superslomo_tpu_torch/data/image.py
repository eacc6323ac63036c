"""The frame reader: ``imread`` decodes a PNG or a JPEG file, chosen by the
file's signature and not by its extension (as ``cv2.imread`` chooses), to the
(H, W, 3) uint8 RGB array that ``cv2.imread(path)[..., ::-1]`` returns, EXIF
orientation applied (``data/png.py``, ``data/jpeg.py``)."""

from __future__ import annotations

import numpy as np

from superslomo_tpu_torch.data import jpeg, png


def imread(path: str) -> np.ndarray:
    """Decode the PNG or JPEG frame at ``path`` to (H, W, 3) uint8 RGB;
    any other file raises ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == png.SIGNATURE:
        return png.imread(path, data)
    if data[:3] == jpeg.SIGNATURE:
        return jpeg.imread(path, data)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
