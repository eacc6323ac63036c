"""Data parallelism across ranks on the CPU: two gloo ranks, spawned and
joined through a ``file://`` rendezvous by ``init_data_parallel``, at
32x32, global batch 4: the Trainer under DDP against the one-process
Trainer on the same global batches (weights and Adam's moments after two
steps, the ranks identical, only rank 0 writing), the Evaluator with a batch
of 3 padded to 4 against the one-process per-image scores, and the train
and eval command lines under torchrun's environment (``--device cpu``).
The Loader's rank slices and the rules of ``init_data_parallel`` run in
this process."""

import configparser
import json
import os
import pickle
import shutil
import socket

import cv2
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from superslomo_tpu_torch import Evaluator, Trainer, default_config, parallel, weights
from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli
from superslomo_tpu_torch.cli import train as train_cli
from superslomo_tpu_torch.data.pipeline import Loader
from tests.test_torch_package import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, HW = 2, 4, 32
# DDP averages the ranks' gradients of their halves of the batch, one process
# takes the gradient of the whole batch: the same float32 sums over the
# batch and the pixels in another order. Measured, of each tensor's max:
# the first step's gradients 2.4e-6 apart, the Adam moments after two steps
# 7.1e-6 (the second step's gradient is taken at weights already apart)
GRAD_REL = 5e-5
# Adam's step is lr * m / (sqrt(v) + eps): where a gradient lies within a few
# eps (1e-8) of zero it passes a rounding of it on to the weight as
# lr * rounding / eps, up to 2 lr a step. Two steps' weights differ by up to
# 1.45e-5 of a tensor's max (conv2b's weight, whose gradient has elements of
# 3e-9); the losses, which are sums, by a few ulps
WEIGHT_REL, LOSS_RTOL = 1e-4, 1e-6
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _train_cfg(ckpt_dir, batch=BATCH):
    return default_config(TRAIN_ALLOW_RANDOM_VGG="TRUE", TRAIN_BATCH_SIZE=batch, TRAIN_CKPT_DIR=ckpt_dir,
                          TRAIN_N_EPOCHS=1)


def _global_batches(n=2):
    rng = np.random.default_rng(21)
    return [(rng.standard_normal((BATCH, 2, HW, HW, 3)).astype(np.float32),
             rng.standard_normal((BATCH, 1, HW, HW, 3)).astype(np.float32),
             rng.uniform(0.1, 0.9, (BATCH, 1)).astype(np.float32)) for _ in range(n)]


def _eval_cfg():
    cfg = default_config()
    cfg.set("ADOBE_DATA", "H_IN", HW)
    cfg.set("ADOBE_DATA", "W_IN", HW)
    return cfg


def _eval_batch():
    """3 samples (padded to 4 across 2 ranks), 7 targets each, the last
    with 4 valid."""
    rng = np.random.default_rng(22)
    frames = rng.standard_normal((3, 2, HW, HW, 3)).astype(np.float32)
    targets = rng.standard_normal((3, 7, HW, HW, 3)).astype(np.float32)
    return frames, targets, np.array([7, 7, 4])


def _state(tr):
    return {"weights": [p.detach().clone() for *_, p in tr.trainable],
            "exp_avg": [tr.optimizer.state[p]["exp_avg"].clone() for *_, p in tr.trainable],
            "exp_avg_sq": [tr.optimizer.state[p]["exp_avg_sq"].clone() for *_, p in tr.trainable]}


def _two_steps(tr, batches):
    """A train step on the first batch, then ``train`` over the second (one
    step, which saves); returns both losses and the first step's gradients."""
    first = tr.train_step(*batches[0]).numpy()
    grads = [p.grad.clone() for *_, p in tr.trainable]
    tr.step = 1
    return [first, tr.train(batches[1:], max_steps=2)], grads


def _rank_main(rank, init_file, work, port, cli_args):
    """One rank: the Trainer and the Evaluator under a file:// group, then
    the two CLIs as torchrun would start them; results to work/rank{r}.pt."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    device = parallel.init_data_parallel(device="cpu", init_method=f"file://{init_file}")
    out = {"device": str(device), "backend": torch.distributed.get_backend(), "rank": parallel.rank(),
           "world": parallel.world()}
    try:
        Trainer(_train_cfg(os.path.join(work, "odd"), batch=3), device=device)
    except ValueError as e:
        out["odd_batch_error"] = str(e)
    tr = Trainer(_train_cfg(os.path.join(work, "ckpt")), expt_name=f"rank{rank}", device=device)
    share = BATCH // WORLD
    local = [tuple(x[rank * share:(rank + 1) * share] for x in b) for b in _global_batches()]
    out["loss"], out["grads"] = _two_steps(tr, local)
    out["saved"] = tr.save()  # the path on rank 0, None on the others
    out.update(_state(tr))
    ev = Evaluator(_eval_cfg(), weights.seeded_state(_eval_cfg().model_spec(), seed=42), device=device)
    ev.run([_eval_batch()])
    out["eval"] = {"psnr": ev.psnr, "ssim": ev.ssim, "ie": ev.ie, "results": ev.results()}
    parallel.barrier()
    torch.distributed.destroy_process_group()

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    out["eval_cli"] = eval_cli.main(["--", *cli_args["eval"]])  # as torchrun passes them after a "--"
    os.environ["MASTER_PORT"] = str(port + 1)
    cli = train_cli.main(cli_args["train"])
    out["train_cli"] = {"step": cli.step, "weights": _state(cli)["weights"]}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_clip(rng, folder, n, h, w):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(folder, f"frame_{i:05d}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    return paths


def _ini(path, base, **sections):
    parser = configparser.RawConfigParser()
    parser.optionxform = str
    parser.read(os.path.join(ROOT, "configs", base))
    for section, values in sections.items():
        for k, v in values.items():
            parser.set(section, k, str(v))
    with open(path, "w") as f:
        parser.write(f)
    return path


def _cli_args(root):
    """An eval CLI run over one 20-frame 48x64 clip (3 windows, the last with
    3 valid targets; batch 3) and
    a train CLI run over 4 clips of 12 64x64 frames (a sample each; 32x32
    crops, global batch 4, 1 step), both seeded and on the CPU."""
    rng = np.random.default_rng(23)
    _write_clip(rng, os.path.join(root, "val", "a"), 20, 48, 64)
    with open(os.path.join(root, "val.pkl"), "wb") as f:
        pickle.dump(["a"], f)
    eval_ini = _ini(os.path.join(root, "eval.ini"), "superslomo_eval.ini",
                    ADOBE_DATA={"ROOTDIR": os.path.join(root, "val"), "VAL_CLIPS": os.path.join(root, "val.pkl"),
                                "H_IN": 48, "W_IN": 64},
                    VAL={"BATCH_SIZE": 3}, DATALOADER={"N_WORKERS": 1}, STAGE1={"LOADPREV": "FALSE"},
                    STAGE2={"LOADPREV": "FALSE"})
    clips = [_write_clip(rng, os.path.join(root, "train", f"c{i}"), 12, 64, 64) for i in range(BATCH)]
    with open(os.path.join(root, "train.txt"), "w") as f:
        for clip in clips:
            f.write(f"{len(clip)}\n" + "".join(p + "\n" for p in clip))
    train_ini = _ini(os.path.join(root, "train.ini"), "superslomo_original.ini",
                     DATA={"DATASET": "ADOBE", "WINDOW_LENGTH": 12},
                     ADOBE_DATA={"TRAINPATHS": os.path.join(root, "train.txt")},
                     TRAIN={"BATCH_SIZE": BATCH, "CROP_IMH": HW, "CROP_IMW": HW, "ALLOW_RANDOM_VGG": "TRUE",
                            "CKPT_DIR": os.path.join(root, "cli_ckpt"), "N_EPOCHS": 1},
                     DATALOADER={"N_WORKERS": 1}, PROJECT={"LOGDIR": os.path.join(root, "logs")})
    return {"eval": ["-c", eval_ini, "--expt", "e", "--log", os.path.join(root, "eval.log"), "--device", "cpu"],
            "train": ["-c", train_ini, "--expt", "t", "--log", os.path.join(root, "train.log"), "--device", "cpu",
                      "--max-steps", "1"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results (``_rank_main``), and the CLI arguments."""
    work = str(tmp_path_factory.mktemp("ddp"))
    cli_args = _cli_args(work)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, os.path.join(work, "rendezvous"), work, port, cli_args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    yield [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)], cli_args, work
    shutil.rmtree(work, ignore_errors=True)  # ~1.5 GB of checkpoints


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """The Trainers here save ~0.45 GB checkpoints, and pytest keeps the
    temporary directories of its last runs: each test's go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_ranks_join_one_gloo_group(ranks):
    results, _, _ = ranks
    assert [(r["rank"], r["world"], r["backend"], r["device"]) for r in results] == [
        (0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]


def test_ddp_train_steps_match_one_process_trainer(ranks, tmp_path):
    """Two steps at global batch 4 (2 a rank) against the one-process
    Trainer on the whole batches: the first step's all-reduced gradients and
    the Adam moments within GRAD_REL of each tensor's max, the weights within
    WEIGHT_REL, the logged (all-reduced) losses within LOSS_RTOL; the two
    ranks bit-identical."""
    results, _, _ = ranks
    tr = Trainer(_train_cfg(str(tmp_path)), device="cpu")
    losses, grads = _two_steps(tr, _global_batches())
    want = {**_state(tr), "grads": grads}
    for key, bar in (("grads", GRAD_REL), ("exp_avg", GRAD_REL), ("exp_avg_sq", GRAD_REL), ("weights", WEIGHT_REL)):
        a, b = results[0][key], results[1][key]
        assert len(a) == len(b) == len(want[key]) == len(tr.trainable)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), key
        worst = max(((x - w).abs().max() / w.abs().max()).item() for x, w in zip(a, want[key]))
        assert worst <= bar, (key, worst)
    for r in results:
        np.testing.assert_allclose(np.stack(r["loss"]), np.stack(losses), rtol=LOSS_RTOL)


def test_only_rank_zero_writes(ranks):
    """Each rank's Trainer has its own experiment name: only rank 0's
    directory exists, holding the checkpoint of ``train``'s last step."""
    results, _, work = ranks
    assert results[1]["saved"] is None and os.path.exists(results[0]["saved"])
    assert os.listdir(os.path.join(work, "ckpt")) == ["rank0"]
    assert os.listdir(os.path.join(work, "ckpt", "rank0")) == [os.path.basename(results[0]["saved"])]


def test_batch_not_a_multiple_of_world_raises(ranks):
    results, _, _ = ranks
    assert all("BATCH_SIZE 3" in r["odd_batch_error"] and "2 data-parallel ranks" in r["odd_batch_error"]
               for r in results)
    with pytest.raises(ValueError, match="not a multiple of the 2"):
        Loader([0] * 8, batch_size=3, world=2)
    with pytest.raises(ValueError, match="drop"):
        Loader([0] * 8, batch_size=4, drop_last=False, world=2)


def test_ddp_evaluator_scores_in_sample_order(ranks):
    """A batch of 3 padded to 4: each rank scores its share (2 samples, the
    second of rank 1 the padding), and the gathered per-image scores are the
    one-process ones in sample order (18 images), equal on both ranks."""
    results, _, _ = ranks
    ev = Evaluator(_eval_cfg(), weights.seeded_state(_eval_cfg().model_spec(), seed=42), device="cpu")
    ev.run([_eval_batch()])
    assert len(ev.psnr) == 18
    for r in results:
        assert r["eval"]["results"] == results[0]["eval"]["results"]
        for key in ("psnr", "ssim", "ie"):
            np.testing.assert_allclose(r["eval"][key], getattr(ev, key), rtol=1e-6, err_msg=key)


def test_clis_under_torchrun_env(ranks, tmp_path, capsys):
    """The eval CLI at two ranks returns the one-process CLI's metrics; the
    train CLI's global batch of 4 on two ranks ends one step at the
    one-process CLI's weights; rank 0 logs."""
    results, cli_args, work = ranks
    assert os.path.getsize(os.path.join(work, "eval.log")) > 0
    single_eval = eval_cli.main(cli_args["eval"][:5] + [str(tmp_path / "e.log"), "--device", "cpu"])
    for r in results:
        assert r["eval_cli"]["n_images"] == single_eval["n_images"] == 17
        for key in ("PSNR", "SSIM", "IE"):
            np.testing.assert_allclose(r["eval_cli"][key], single_eval[key], rtol=1e-6)
    single = train_cli.main(cli_args["train"][:3] + ["single", "--log", str(tmp_path / "t.log"), "--device", "cpu",
                                                     "--max-steps", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["step"] == single.step == 1
    for r in results:
        assert r["train_cli"]["step"] == 1
        for x, w in zip(r["train_cli"]["weights"], _state(single)["weights"]):
            assert ((x - w).abs().max() / w.abs().max()).item() <= WEIGHT_REL


@pytest.mark.parametrize("world", [2, 4])
def test_loader_rank_slices_put_together_equal_the_global_batch(world):
    """Every rank shuffles the same order and decodes its contiguous slice;
    each item draws from its own generator, so the slices in rank order are
    the one-process batch bit for bit, and a rank decodes only its items."""

    class Reader:
        def __init__(self):
            self.seen = []

        def __len__(self):
            return 13

        def __getitem__(self, idx, rng):
            self.seen.append(idx)
            return rng.standard_normal((2, 3)).astype(np.float32), idx

    whole = list(Loader(Reader(), batch_size=4, num_threads=1, seed=5))
    readers = [Reader() for _ in range(world)]
    parts = [list(Loader(r, batch_size=4, num_threads=2, seed=5, rank=k, world=world))
             for k, r in enumerate(readers)]
    assert len(whole) == 3 and all(len(p) == 3 for p in parts)
    for b, batch in enumerate(whole):
        for j, x in enumerate(batch):
            np.testing.assert_array_equal(np.concatenate([p[b][j] for p in parts]), x)
    assert sorted(i for r in readers for i in r.seen) == sorted(int(i) for b in whole for i in b[1])


def test_init_data_parallel_needs_torchrun_and_a_card(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        parallel.init_data_parallel(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            parallel.init_data_parallel(device=device)
    assert (parallel.rank(), parallel.world(), parallel.is_main()) == (0, 1, True)
    parallel.barrier()  # no group: nothing to wait for


@pytest.mark.parametrize("cli", [eval_cli, train_cli], ids=["evaluate_interpolation", "train"])
def test_clis_under_torchrun_need_a_card_unless_told_otherwise(cli, tmp_path, monkeypatch):
    """Under torchrun's environment with no card, a rank not given
    ``--device cpu`` raises before it joins a group."""
    for name, value in zip(TORCHRUN_ENV, ("0", "2", "0", "localhost", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 0 has no CUDA device"):
        cli.main(["--", "-c", os.path.join(ROOT, "configs", "superslomo_eval.ini"), "--expt", "t",
                  "--log", str(tmp_path / "log")])
    assert not torch.distributed.is_initialized()
