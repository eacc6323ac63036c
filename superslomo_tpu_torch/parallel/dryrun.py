"""One production train step on a (data, spatial) grid of ranks at a tiny
shape: the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, which jits the Trainer's step over an
n-device (data x spatial) mesh and runs it once.

    from superslomo_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)                # or dryrun_multichip(4, device="cpu")

``dryrun_multichip(n_ranks)`` spawns ``n_ranks`` processes that join one
process group (gloo on the CPU with ``device="cpu"``; otherwise a card a
rank over NCCL, or every rank on card 0 over gloo where there are fewer
cards than ranks), lay them out as JAX does (``n_spatial = 2`` for an even
count of 4 or more, else 1), and run ONE ``Trainer.train_step`` of the
default config on the grid: one sample a data row, 64x64 frames, each
frame's rows split over the spatial ranks. Each rank prints a mark a phase;
the call asserts that every rank's loss is finite and that the ranks'
weights after the step are bit-identical.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

H = W = 64


def grid_shape(n_ranks: int):
    """(n_data, n_spatial) as the JAX dry run lays out ``n_ranks`` devices."""
    n_spatial = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    return n_ranks // n_spatial, n_spatial


def _layout(n_ranks: int, device):
    """(backend, each rank's device)."""
    if device == "cpu":
        return "gloo", ["cpu"] * n_ranks
    if torch.cuda.device_count() >= n_ranks:
        return "nccl", [f"cuda:{r}" for r in range(n_ranks)]
    return "gloo", ["cuda:0"] * n_ranks


def _rank_main(rank: int, n_ranks: int, backend: str, devices, init_method: str, out_dir: str) -> None:
    from superslomo_tpu_torch import Trainer, default_config, parallel

    t0 = time.time()

    def mark(phase: str) -> None:
        print(f"# dryrun rank {rank} {phase}: +{time.time() - t0:.1f}s", flush=True)

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n_ranks), LOCAL_RANK=str(rank))
    if devices[rank] == "cpu":
        torch.set_num_threads(1)
    device = parallel.init_data_parallel(devices[rank], backend, init_method=init_method)
    n_data, n_spatial = grid_shape(n_ranks)
    grid = parallel.make_grid(n_data, n_spatial)
    mark(f"joined {backend} on {device}, grid {n_data} x {n_spatial} at ({grid.data_index}, {grid.spatial_index})")

    cfg = default_config(TRAIN_BATCH_SIZE=n_data, TRAIN_ALLOW_RANDOM_VGG="TRUE",
                         TRAIN_CKPT_DIR=os.path.join(out_dir, "ckpt"))
    trainer = Trainer(cfg, expt_name="dryrun", device=device, grid=grid)
    mark("trainer built")

    rng = np.random.default_rng(0)  # the JAX dry run's batch: one sample a data row
    frames = rng.standard_normal((n_data, 2, H, W, 3), dtype=np.float32)
    targets = rng.standard_normal((n_data, 1, H, W, 3), dtype=np.float32)
    t = np.full((n_data, 1), 0.5, np.float32)
    mine = slice(grid.data_index, grid.data_index + 1)
    loss = trainer.train_step(frames[mine], targets[mine], t[mine]).cpu().numpy()
    mark(f"step done, loss {loss.tolist()}")

    digest = hashlib.sha256()
    for *_, p in trainer.trainable:
        digest.update(p.detach().cpu().contiguous().numpy().tobytes())
    torch.save({"loss": loss, "weights_sha256": digest.hexdigest(), "grid": (grid.data_index, grid.spatial_index)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_ranks: int, device=None, timeout: float = 900.0) -> list:
    """Run one production train step on ``n_ranks`` spawned ranks (see the
    module's docstring); ``device="cpu"`` for gloo ranks on the CPU. Returns
    each rank's ``{"loss", "weights_sha256", "grid"}``; raises AssertionError
    if a rank fails, a loss is not finite or the ranks' weights differ."""
    backend, devices = _layout(n_ranks, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        init = f"file://{os.path.join(out_dir, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, backend, devices, init, out_dir))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"dry run ranks ended with {[p.exitcode for p in procs]}")
        results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(n_ranks)]
    if not all(np.isfinite(r["loss"]).all() for r in results):
        raise AssertionError(f"a dry run loss is not finite: {[r['loss'] for r in results]}")
    if len({r["weights_sha256"] for r in results}) != 1:
        raise AssertionError("the ranks' weights differ after the dry run's step")
    print(f"# dryrun ok: {n_ranks} ranks over {backend}, grid {grid_shape(n_ranks)}, loss {results[0]['loss'].tolist()}",
          flush=True)
    return results
