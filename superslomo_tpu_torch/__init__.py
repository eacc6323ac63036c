"""superslomo_tpu_torch: the Super SloMo system in PyTorch and CUDA for an
NVIDIA H100, beside the JAX package ``superslomo_tpu``, which stays the
reference it is tested against.

Entry points: ``SuperSloMo`` (the fused multi-t interpolation step, and the
forward over T-frame windows), ``Evaluator`` (the step's PSNR / SSIM / IE
scoring loop), ``Interpolator`` (the slow-motion renderer), ``evaluate_flow``
(Sintel flow EPE) and ``Trainer`` (the training step of either model, in
float32 or in bfloat16 on float32 master weights, with the composite loss,
Adam and StepLR, and ``.pt`` checkpoints). They run on the CUDA card unless
the caller passes ``device="cpu"``; with no card and no such request they
raise. The warps are hand-written CUDA kernels (csrc/warp_multiflow.cu, and
csrc/warp_single.cu with its backward), built with nvcc at first use.

The command lines ``python -m superslomo_tpu_torch.cli.train``,
``…cli.evaluate_interpolation``, ``…cli.evaluate_flow`` and ``…cli.visualize``
read the configured datasets from disk (``data/``: readers, a threaded
loader, a pinned device feed, and a PNG decoder whose row unfilter is host
C++ in csrc/png_unfilter.cpp; the renderer writes PNG frames with
``data/png.py::imwrite``).
"""

from superslomo_tpu_torch.config import Config, ModelSpec, default_config, load_config  # noqa: F401
from superslomo_tpu_torch.eval.evaluate_flow import evaluate_flow  # noqa: F401
from superslomo_tpu_torch.eval.evaluate_interpolation import Evaluator  # noqa: F401
from superslomo_tpu_torch.eval.visualize import Interpolator  # noqa: F401
from superslomo_tpu_torch.models.superslomo import SuperSloMo  # noqa: F401
from superslomo_tpu_torch.training.trainer import Trainer  # noqa: F401
