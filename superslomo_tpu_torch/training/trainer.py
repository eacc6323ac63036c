"""The trainer: Adam with a StepLR schedule over the non-frozen stage,
per-step loss logging and periodic image dumps to a duck-typed writer,
checkpoints in the reference ``.pt`` layout every SAVE_EVERY epochs and on
SIGTERM, and resume.

One step is ``SuperSloMo.forward`` → ``compute_losses`` → backward → Adam,
with TF32 off (cuDNN and matmul) for the forward and the backward alike. Its
eight single-flow warps (two for the stage-2 input, two for the final image,
four loss terms) run the CUDA kernels forward and backward; every warped
image is data, so the backward computes flow gradients only.

The model is the CONV Super SloMo or the recurrent SuperSloMo-R (a CLSTM /
CGRU bottleneck in either stage), whose recurrence runs over the N_FRAMES-1
windows of a sample from a zero state each step, as the JAX trainer's
``model.apply(p, frames, t)`` does; autograd runs back through it. The
parameters and Adam's moments are float32 under either ``[TPU]
COMPUTE_DTYPE``: under bfloat16 every U-Net conv casts the float32 master
weights to bf16 at each call and computes in bf16 (flax's
``Conv(dtype=...)``), the heads are upcast to f32, the stage-2 input warps
store bf16, and the final warps, the losses and the VGG run in f32, where the
JAX package puts them. ``[TPU] REMAT`` recomputes each U-Net stage in the
backward.

A frozen stage takes ``requires_grad=False`` and stays out of the optimizer,
which equals the JAX package's zero-gradient update from zero moments. The
optimizer's parameters are stage 1's in state-dict order, then stage 2's: the
order the reference's ``.pt`` files index Adam's moments by.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Iterable, Optional

import numpy as np
import torch

from superslomo_tpu_torch import weights as wio
from superslomo_tpu_torch.cli.common import load_model_params
from superslomo_tpu_torch.config import Config
from superslomo_tpu_torch.data import get_dataset, prefetch_to_device
from superslomo_tpu_torch.models.losses import LossWeights, compute_losses
from superslomo_tpu_torch.models.superslomo import SuperSloMo, mid_window, tf32_off
from superslomo_tpu_torch.models.vgg import VGG16Features, vgg_state
from superslomo_tpu_torch.utils.validators import check_forward_inputs

log = logging.getLogger(__name__)

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults


def step_lr(base_lr: float, decay: float, period: float):
    """StepLR(epoch) = base_lr * decay^(epoch // period)."""

    def schedule(epoch: int) -> float:
        return base_lr * (decay ** (int(epoch) // int(period)))

    return schedule


def _host(x) -> np.ndarray:
    """A numpy array, or a tensor's values copied to a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Trainer:
    """Config-driven trainer of the Super SloMo / SuperSloMo-R model, in
    float32 or bfloat16 compute on float32 parameters.

    :param cfg: the INI config (``[TRAIN]``, ``[STAGE1]``, ``[STAGE2]``,
        ``[SEED]``, ``[TPU] COMPUTE_DTYPE``).
    :param writer: optional, with ``add_scalars(tag, {split: value}, step)``
        and ``add_image(tag, chw_array, step)`` (a tensorboard SummaryWriter
        fits; the package never imports one).
    :param device: ``None`` for the CUDA card (raises without one), or
        ``"cpu"``.
    :param vgg_weights: a ``.npz`` of torchvision's VGG-16 ``features.*``;
        defaults to ``[TRAIN] VGG_WEIGHTS``.
    """

    def __init__(self, cfg: Config, expt_name: str = "expt", writer=None, device=None,
                 vgg_weights: Optional[str] = None):
        self.cfg = cfg
        self.expt_name = expt_name
        self.spec = cfg.model_spec()
        self.weights = LossWeights(
            lambda_r=cfg.getfloat("TRAIN", "LAMBDA_R"),
            lambda_w=cfg.getfloat("TRAIN", "LAMBDA_W"),
            lambda_p=cfg.getfloat("TRAIN", "LAMBDA_P"),
        )
        self.n_epochs = cfg.getint("TRAIN", "N_EPOCHS")
        self.save_every = cfg.getint("TRAIN", "SAVE_EVERY")
        self.lr_schedule = step_lr(
            cfg.getfloat("TRAIN", "LEARNING_RATE"),
            cfg.getfloat("TRAIN", "LR_DECAY"),
            cfg.getfloat("TRAIN", "LR_PERIOD"),
        )
        self.ckpt_dir = os.path.join(cfg.get("TRAIN", "CKPT_DIR"), expt_name)
        self.writer = writer

        vgg_path = vgg_weights
        if vgg_path is None and cfg.has("TRAIN", "VGG_WEIGHTS"):
            vgg_path = cfg.get("TRAIN", "VGG_WEIGHTS") or None
        if vgg_path is None and self.weights.lambda_p != 0:
            if not (cfg.has("TRAIN", "ALLOW_RANDOM_VGG") and cfg.getboolean("TRAIN", "ALLOW_RANDOM_VGG")):
                raise ValueError(
                    "No pretrained VGG16 weights configured (TRAIN.VGG_WEIGHTS) "
                    "but LAMBDA_P != 0: the perceptual loss would use random "
                    "features and silently cap quality. Provide converted "
                    "torchvision weights (cli/convert_checkpoint.py --vgg) or "
                    "set TRAIN.ALLOW_RANDOM_VGG=TRUE to opt in for smoke runs."
                )
            log.warning("TRAIN.ALLOW_RANDOM_VGG=TRUE — perceptual loss uses deterministic random "
                        "features. Published-quality training requires the pretrained file.")

        self.model = SuperSloMo(self.spec, device=device, param_dtype=torch.float32)
        self.device = self.model.device
        self.model.load_state(load_model_params(cfg))

        self.vgg = VGG16Features()
        self.vgg.load_state_dict(vgg_state(vgg_path))
        self.vgg.to(device=self.device, memory_format=torch.channels_last)

        frozen = {"stage1": self.spec.stage1_freeze, "stage2": self.spec.stage2_freeze}
        trainable = []
        for stage, is_frozen in frozen.items():
            module = getattr(self.model, stage)
            module.requires_grad_(not is_frozen)
            if not is_frozen:
                named = dict(module.named_parameters())
                trainable += [named[k] for k in module.state_dict() if k in named]
        if not trainable:
            raise ValueError("both stages are frozen: there is nothing to train")
        self.optimizer = torch.optim.Adam(trainable, lr=self.lr_schedule(1), betas=ADAM_BETAS, eps=ADAM_EPS)
        self.epoch, self.step = 1, 0
        self.resume_if_configured()

    # ------------------------------------------------------------------ #
    def resume_if_configured(self) -> None:
        """Resume Adam's state and the epoch from the ``.pt`` of the first
        stage that is loaded and not frozen; a weights-only file warm-starts
        with a fresh optimizer."""
        for n in (1, 2):
            path = self.cfg.get(f"STAGE{n}", "WEIGHTS")
            if not (self.cfg.getboolean(f"STAGE{n}", "LOADPREV")
                    and not self.cfg.getboolean(f"STAGE{n}", "FREEZE") and path):
                continue
            blob = wio.load_checkpoint(path)
            if "self.optimizer" not in blob:
                log.info("No optimizer state in %s; fresh optimizer", path)
                return
            self.optimizer.load_state_dict(blob["self.optimizer"])
            self.epoch = max(int(blob.get("epoch", 1)), 1)
            self.step = int(blob.get("step", 0))
            log.info("Resuming Adam state from %s at epoch %s", path, self.epoch)
            return

    def set_learning_rate(self, epoch: int) -> float:
        lr = self.lr_schedule(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    # ------------------------------------------------------------------ #
    def train_step(self, frames, targets, t) -> torch.Tensor:
        """One optimization step on (B, T, H, W, 3) frames, (B, T-1, H, W, 3)
        targets and (B, T-1) instants (numpy arrays, or tensors, which are
        used in place when they already lie on the model's device); returns
        the (4,) loss vector (total, reconstruction, warp, perceptual),
        averaged over the batch, on the model's device."""
        frames, targets, t = (torch.as_tensor(x, dtype=torch.float32).to(self.device) for x in (frames, targets, t))
        with tf32_off():
            outputs = self.model(frames, t)
            losses = compute_losses(outputs, targets, self.spec, self.weights, self.vgg)
            self.optimizer.zero_grad(set_to_none=True)
            losses[:, 0].mean().backward()
            self.optimizer.step()
        return losses.detach().mean(dim=0)

    def train(self, batches: Optional[Iterable] = None, max_steps: Optional[int] = None) -> np.ndarray:
        """Train from ``self.epoch`` to ``N_EPOCHS``, iterating ``batches``
        (``(frames, targets, t)``, numpy or tensors) once per epoch; by
        default ``get_dataset(cfg, "TRAIN")``, built once and fed through
        ``prefetch_to_device`` each epoch. Stop after ``max_steps`` steps in
        all. Saves every SAVE_EVERY epochs, at the end, at ``max_steps``, and
        on SIGTERM (then exits with 143). Returns the last step's loss
        vector."""
        loader = get_dataset(self.cfg, "TRAIN") if batches is None else None
        loss_vec = None

        def on_sigterm(signum, frame):
            log.warning("SIGTERM: checkpointing before exit")
            self.save()
            raise SystemExit(143)

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        first_step = self.step
        try:
            for epoch in range(self.epoch, self.n_epochs + 1):
                self.epoch = epoch
                lr = self.set_learning_rate(epoch)
                if self.writer:
                    self.writer.add_scalars("Learning_Rate", {"TRAIN": lr}, self.step)
                t0 = time.time()
                feed = batches if loader is None else prefetch_to_device(iter(loader), self.device)
                for frames, targets, t in feed:
                    if self.step == first_step:
                        check_forward_inputs(frames, targets, _host(t), self.spec.n_frames)
                    loss_vec = self.train_step(frames, targets, t)
                    self.step += 1
                    if self.writer and self.step % 10 == 0:
                        self.write_losses(loss_vec.cpu().numpy(), self.step, "TRAIN")
                    if self.writer and self.step % 100 == 0:
                        self.write_image(frames, t, self.step, "TRAIN")
                    if self.step % 100 == 0:
                        log.info("epoch %d step %d loss %.4f (%.2f s)",
                                 epoch, self.step, float(loss_vec[0]), time.time() - t0)
                    if max_steps is not None and self.step >= max_steps:
                        self.save()
                        return loss_vec.cpu().numpy()
                if epoch % self.save_every == 0:
                    self.save()
            self.save()
            return None if loss_vec is None else loss_vec.cpu().numpy()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def write_image(self, frames, t, step, split) -> None:
        """The mid window's interpolation of the first sample, denormalized
        and clipped to [0, 1], as a (3, H, W) image."""
        with torch.no_grad():
            out = self.model(frames[:1], _host(t)[:1])
        img = out.pred_images[0, mid_window(out)].cpu().numpy()
        mean = np.asarray(self.cfg.pixel_mean(), np.float32)
        std = np.asarray(self.cfg.pixel_std(), np.float32)
        img = np.clip(img * std + mean, 0.0, 1.0)
        self.writer.add_image(split, img.transpose(2, 0, 1), step)

    def write_losses(self, loss_vec, step, split) -> None:
        names = ["Total_Loss", "Reconstruction_Loss", "Warping_Loss", "Perceptual_Loss"]
        for i, name in enumerate(names):
            self.writer.add_scalars(name, {split: float(loss_vec[i])}, step)

    # ------------------------------------------------------------------ #
    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"{self.expt_name}_EPOCH_{epoch:04d}.pt")

    def save(self) -> str:
        """Write the reference ``.pt`` layout for the current epoch."""
        path = wio.save_checkpoint(
            self.checkpoint_path(self.epoch), self.model.stage1.state_dict(),
            self.model.stage2.state_dict(), self.optimizer.state_dict(), self.epoch, self.step,
        )
        log.info("Saved checkpoint %s", path)
        return path
