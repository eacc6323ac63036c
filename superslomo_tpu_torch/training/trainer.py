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
order the reference's ``.pt`` files index Adam's moments by. The Trainer
resumes from a ``.pt`` or from the JAX package's native checkpoint directory
(``training/checkpoint.py``), and writes either (``save``, ``save_native``).

Data parallel (``parallel.init_data_parallel`` before the Trainer is built,
one process a card, as ``torch.distributed.run`` launches them): the
configured BATCH_SIZE is the global batch, as on the JAX trainer's data
axis, and each rank steps on its BATCH_SIZE / world samples (the Loader's
slice of each global batch) under ``DistributedDataParallel``, which
averages the gradients; the loss vector is averaged over the ranks, so
every rank returns the single-process loss. Rank 0 alone writes
checkpoints; every rank loads and resumes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Iterable, Optional

import numpy as np
import torch

from superslomo_tpu_torch import parallel
from superslomo_tpu_torch import weights as wio
from superslomo_tpu_torch.cli.common import load_model_params
from superslomo_tpu_torch.config import Config
from superslomo_tpu_torch.data import get_dataset, prefetch_to_device
from superslomo_tpu_torch.models.losses import LossWeights, compute_losses
from superslomo_tpu_torch.models.superslomo import SuperSloMo, mid_window, tf32_off
from superslomo_tpu_torch.models.vgg import VGG16Features, vgg_state
from superslomo_tpu_torch.training.checkpoint import ADAM_BETAS, ADAM_EPS, save_native_checkpoint, trainable_stages
from superslomo_tpu_torch.utils.validators import check_forward_inputs

log = logging.getLogger(__name__)


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
        self.rank, self.world = parallel.rank(), parallel.world()
        batch = cfg.getint("TRAIN", "BATCH_SIZE")
        if batch % self.world:
            raise ValueError(f"[TRAIN] BATCH_SIZE {batch} is not a multiple of the {self.world} data-parallel ranks")

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

        # (stage, state-dict key, parameter) in the optimizer's order
        self.trainable = []
        stages = trainable_stages(self.spec)
        for stage in ("stage1", "stage2"):
            module = getattr(self.model, stage)
            module.requires_grad_(stage in stages)
            if stage in stages:
                named = dict(module.named_parameters())
                self.trainable += [(stage, k, named[k]) for k in module.state_dict() if k in named]
        if not self.trainable:
            raise ValueError("both stages are frozen: there is nothing to train")
        self.optimizer = torch.optim.Adam([p for *_, p in self.trainable], lr=self.lr_schedule(1),
                                          betas=ADAM_BETAS, eps=ADAM_EPS)
        self.epoch, self.step = 1, 0
        self.resume_if_configured()
        # the model the step runs: under DDP across ranks, which all-reduces
        # the gradients of the parameters that require them
        self.step_model = self.model
        if self.world > 1:
            cuda = self.device.type == "cuda"
            self.step_model = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=[self.device.index] if cuda else None)

    # ------------------------------------------------------------------ #
    def resume_if_configured(self) -> None:
        """Resume Adam's state, the epoch and the step from the checkpoint of
        the first stage that is loaded and not frozen: a ``.pt``, or a native
        directory (its ``opt.msgpack``, and ``meta.json``; the learning rate
        is the schedule's for that epoch). A checkpoint without optimizer
        state warm-starts with a fresh optimizer."""
        for n in (1, 2):
            path = self.cfg.get(f"STAGE{n}", "WEIGHTS")
            if not (self.cfg.getboolean(f"STAGE{n}", "LOADPREV")
                    and not self.cfg.getboolean(f"STAGE{n}", "FREEZE") and path):
                continue
            blob = wio.load_checkpoint(path, self.spec)
            if blob.get("adam") is not None:
                self.load_adam_state(blob["adam"])
            elif "self.optimizer" in blob:
                self.optimizer.load_state_dict(blob["self.optimizer"])
            else:
                log.info("No optimizer state in %s; fresh optimizer", path)
                return
            self.epoch = max(int(blob.get("epoch", 1)), 1)
            self.step = int(blob.get("step", 0))
            self.set_learning_rate(self.epoch)
            log.info("Resuming Adam state from %s at epoch %s", path, self.epoch)
            return

    def adam_state(self) -> dict:
        """Adam's state by stage (``training/checkpoint.py``'s form): a
        parameter not stepped yet has zero moments."""
        adam = {"step": 0, "learning_rate": self.optimizer.param_groups[0]["lr"], "exp_avg": {}, "exp_avg_sq": {}}
        for stage, key, p in self.trainable:
            st = self.optimizer.state.get(p, {})
            adam["step"] = max(adam["step"], int(st.get("step", 0)))
            for name in ("exp_avg", "exp_avg_sq"):
                adam[name].setdefault(stage, {})[key] = st.get(name, torch.zeros_like(p))
        return adam

    def load_adam_state(self, adam: dict) -> None:
        """Set Adam's step and moments from ``adam`` (``adam_state``'s form),
        which must hold every trainable parameter."""
        for stage, key, p in self.trainable:
            self.optimizer.state[p] = {
                "step": torch.tensor(float(adam["step"]), dtype=torch.float32),
                **{name: torch.empty_like(p).copy_(adam[name][stage][key]) for name in ("exp_avg", "exp_avg_sq")},
            }

    def set_learning_rate(self, epoch: int) -> float:
        lr = self.lr_schedule(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    # ------------------------------------------------------------------ #
    def train_step(self, frames, targets, t) -> torch.Tensor:
        """One optimization step on (B, T, H, W, 3) frames, (B, T-1, H, W, 3)
        targets and (B, T-1) instants (numpy arrays, or tensors, which are
        used in place when they already lie on the model's device): this
        rank's share of the global batch. Returns the (4,) loss vector
        (total, reconstruction, warp, perceptual), averaged over the global
        batch, on the model's device."""
        frames, targets, t = (torch.as_tensor(x, dtype=torch.float32).to(self.device) for x in (frames, targets, t))
        with tf32_off():
            outputs = self.step_model(frames, t)
            losses = compute_losses(outputs, targets, self.spec, self.weights, self.vgg)
            self.optimizer.zero_grad(set_to_none=True)
            losses[:, 0].mean().backward()
            self.optimizer.step()
        loss_vec = losses.detach().mean(dim=0)
        if self.world > 1:  # SUM, then divide: gloo has no AVG
            torch.distributed.all_reduce(loss_vec)
            loss_vec /= self.world
        return loss_vec

    def train(self, batches: Optional[Iterable] = None, max_steps: Optional[int] = None) -> np.ndarray:
        """Train from ``self.epoch`` to ``N_EPOCHS``, iterating ``batches``
        (``(frames, targets, t)``, numpy or tensors: this rank's share) once
        per epoch; by default ``get_dataset(cfg, "TRAIN")`` (this rank's
        slice of each global batch), built once and fed through
        ``prefetch_to_device`` each epoch. Stop after ``max_steps`` steps in
        all. Saves every SAVE_EVERY epochs, at the end, at ``max_steps``, and
        on SIGTERM (then exits with 143). Returns the last step's loss
        vector."""
        loader = get_dataset(self.cfg, "TRAIN", rank=self.rank, world=self.world) if batches is None else None
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

    def save(self) -> Optional[str]:
        """Write the reference ``.pt`` layout for the current epoch (rank 0
        only; None on the other ranks)."""
        if self.rank != 0:
            return None
        path = wio.save_checkpoint(
            self.checkpoint_path(self.epoch), self.model.stage1.state_dict(),
            self.model.stage2.state_dict(), self.optimizer.state_dict(), self.epoch, self.step,
        )
        log.info("Saved checkpoint %s", path)
        return path

    def save_native(self, ckpt_dir: str) -> Optional[str]:
        """Write the JAX package's native checkpoint directory, with Adam's
        state and the JAX trainer's meta (epoch, step, spec); rank 0 only."""
        if self.rank != 0:
            return None
        state = {stage: getattr(self.model, stage).state_dict() for stage in ("stage1", "stage2")}
        meta = {"epoch": self.epoch, "step": self.step, "spec": dataclasses.asdict(self.spec)}
        save_native_checkpoint(ckpt_dir, state, self.adam_state(), meta)
        log.info("Saved native checkpoint %s", ckpt_dir)
        return ckpt_dir
