"""superslomo_tpu_torch: the Super SloMo system in PyTorch and CUDA for an
NVIDIA H100, beside the JAX package ``superslomo_tpu``, which stays the
reference it is tested against.

Entry points: ``SuperSloMo`` (the fused multi-t interpolation step, and the
forward over T-frame windows), ``Evaluator`` (the step's PSNR / SSIM / IE
scoring loop) and ``Trainer`` (the float32 training step with the composite
loss, Adam and StepLR, and ``.pt`` checkpoints). They run on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no such request
they raise. The warps are hand-written CUDA kernels (csrc/warp_multiflow.cu,
and csrc/warp_single.cu with its backward), built with nvcc at first use.
"""

from superslomo_tpu_torch.config import Config, ModelSpec, default_config, load_config  # noqa: F401
from superslomo_tpu_torch.eval.evaluate_interpolation import Evaluator  # noqa: F401
from superslomo_tpu_torch.models.superslomo import SuperSloMo  # noqa: F401
from superslomo_tpu_torch.training.trainer import Trainer  # noqa: F401
