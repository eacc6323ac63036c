"""Data parallelism across processes: the counterpart of the JAX package's
``data`` mesh axis (``parallel/mesh.py``), with ``torch.distributed`` in
place of a mesh.

``torch.distributed.run`` (``torchrun``) starts one process a card and
gives each ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
``init_data_parallel`` joins the process group from them. The Trainer and
the Evaluator read ``rank()`` and ``world()``: the Trainer splits each
global batch across the ranks under ``DistributedDataParallel``, the
Evaluator a batch padded to a multiple of ``world`` (as the JAX Evaluator
pads to its data axis). Without a process group every rank function answers
for a single process.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
import torch.distributed as dist

from superslomo_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


def _env(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: launch the ranks with python -m torch.distributed.run")
    return int(os.environ[name])


def init_data_parallel(device=None, backend=None, init_method: str = "env://") -> torch.device:
    """Join the process group of ``torchrun``'s ``RANK`` / ``WORLD_SIZE``
    and return this rank's device.

    :param device: ``None`` or ``"cuda"`` for card ``LOCAL_RANK`` (made the
        current device before ``resolve_device`` reads it), ``"cuda:N"`` for
        card N, ``"cpu"`` for the CPU. A rank with no card that was not
        asked for the CPU raises.
    :param backend: ``"nccl"`` or ``"gloo"``; None for the device's own
        (NCCL on a card, gloo on the CPU). The backend is logged, and named
        as asked or as the device's default.
    :param init_method: where the ranks meet: ``env://`` reads torchrun's
        ``MASTER_ADDR`` / ``MASTER_PORT``; a ``file://`` or ``tcp://`` URL
        for ranks started otherwise.
    """
    rank_, world_, local = _env("RANK"), _env("WORLD_SIZE"), _env("LOCAL_RANK")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank_} has no CUDA device; pass device='cpu' (gloo) to run on the CPU")
        torch.cuda.set_device(local if dev.index is None else dev.index)
    dev = resolve_device(dev)
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(chosen, init_method=init_method, rank=rank_, world_size=world_)
    log.info("rank %d of %d on %s, backend %s (%s)", rank_, world_, dev, chosen,
             "asked for" if backend else "the device's default")
    return dev


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world() > 1:
        dist.barrier()


@contextlib.contextmanager
def launched(device, backend=None):
    """For a command line: under ``torchrun`` (``WORLD_SIZE`` set) join the
    process group (``init_data_parallel``) and leave it at the end; yields
    the device to run on (``device`` itself in a single process)."""
    if "WORLD_SIZE" not in os.environ:
        yield device
        return
    dev = init_data_parallel(device, backend)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
