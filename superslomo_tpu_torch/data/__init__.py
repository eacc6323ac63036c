"""Data pipeline: the image decoders (``image.imread``), dataset readers, transforms,
the threaded batch loader and the pinned, side-stream device feed."""

from superslomo_tpu_torch.data.pipeline import Loader, prefetch_to_device  # noqa: F401
from superslomo_tpu_torch.data.readers import get_dataset  # noqa: F401
