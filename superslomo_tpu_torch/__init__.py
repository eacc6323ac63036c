"""superslomo_tpu_torch: the Super SloMo system in PyTorch and CUDA for an
NVIDIA H100, beside the JAX package ``superslomo_tpu``, which stays the
reference it is tested against.

Entry points: ``SuperSloMo`` (the fused multi-t interpolation step) and
``Evaluator`` (its PSNR / SSIM / IE scoring loop). Both run on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no such request
they raise. The multi-flow warp is a hand-written CUDA kernel
(csrc/warp_multiflow.cu), built with nvcc at first use.
"""

from superslomo_tpu_torch.config import Config, ModelSpec, default_config, load_config  # noqa: F401
from superslomo_tpu_torch.eval.evaluate_interpolation import Evaluator  # noqa: F401
from superslomo_tpu_torch.models.superslomo import SuperSloMo  # noqa: F401
