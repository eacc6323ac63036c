"""The port's command lines on the CPU (``--device cpu``) over tiny PNG
datasets: the eval CLI's JSON equals the port's Evaluator on the batches of
the JAX package's ``get_dataset``, the train CLI's first loss equals the
port's train step on the first batch of the JAX package's Loader and it
saves its ``.pt``, ``load_model_params`` applies the LOADPREV / WEIGHTS rules,
and the CLIs (these two, and the flow-EPE and render CLIs) ask for the card
unless told otherwise."""

import configparser
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from superslomo_tpu.config import load_config as jax_load_config
from superslomo_tpu.data import get_dataset as jax_get_dataset
from superslomo_tpu_torch import Evaluator, Trainer, weights
from superslomo_tpu_torch.cli import evaluate_flow as flow_cli
from superslomo_tpu_torch.cli import evaluate_interpolation as eval_cli
from superslomo_tpu_torch.cli import train as train_cli
from superslomo_tpu_torch.cli import visualize as render_cli
from superslomo_tpu_torch.cli.common import load_model_params
from superslomo_tpu_torch.config import load_config
from superslomo_tpu_torch.training.checkpoint import save_native_checkpoint
from tests.test_torch_package import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def first_parallel_exp():
    """PyTorch's first parallel ``torch.exp`` in a process sometimes computes
    one intra-op thread's share with a coarser rounding (about 1 process in
    10 on an 8-thread x86 host, up to 6e-5 relative): make that call here,
    so that the model calls compared exactly below all come after it."""
    torch.exp(torch.zeros(1 << 16))


def _write_clip(rng, folder, n, h, w):
    """A panning texture clip (the model then sees some motion)."""
    os.makedirs(folder, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0 : w + 2 * n].astype(np.float32)
    tex = np.zeros(xx.shape + (3,), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.05, 0.3, 2)
        tex += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None] * rng.uniform(20, 60, 3)
    tex = np.clip(tex + 128, 0, 255).astype(np.uint8)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"frame_{i:05d}.png")
        cv2.imwrite(p, tex[:, 2 * i : 2 * i + w])
        paths.append(p)
    return paths


def _config(tmp_path, base, **sections):
    """``configs/<base>`` with ``sections`` ({SECTION: {KEY: value}}) set,
    written to tmp_path; loaded by both packages."""
    parser = configparser.RawConfigParser()
    parser.optionxform = str
    parser.read(os.path.join(ROOT, "configs", base))
    for section, values in sections.items():
        for k, v in values.items():
            parser.set(section, k, str(v))
    path = str(tmp_path / "run.ini")
    with open(path, "w") as f:
        parser.write(f)
    return path


@pytest.fixture(scope="module")
def eval_ini(tmp_path_factory):
    """configs/superslomo_eval.ini over two 48x64 clips (9 and 12 frames:
    3 sliding windows, the last with 3 valid targets), B=2: 2 batches."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(11)
    for name, n in (("a", 9), ("b", 12)):
        _write_clip(rng, str(root / "clips" / name), n, 48, 64)
    with open(root / "val.pkl", "wb") as f:
        pickle.dump(["a", "b"], f)
    return _config(root, "superslomo_eval.ini",
                   ADOBE_DATA={"ROOTDIR": root / "clips", "VAL_CLIPS": root / "val.pkl", "H_IN": 48, "W_IN": 64},
                   VAL={"BATCH_SIZE": 2}, DATALOADER={"N_WORKERS": 2}, STAGE1={"LOADPREV": "FALSE"},
                   STAGE2={"LOADPREV": "FALSE"})


def test_eval_cli_equals_evaluator_on_jax_batches(eval_ini, tmp_path, capsys):
    results = eval_cli.main(["-c", eval_ini, "--expt", "t", "--log", str(tmp_path / "eval.log"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == results
    cfg = load_config(eval_ini)
    batches = list(jax_get_dataset(jax_load_config(eval_ini), "VAL"))
    assert len(batches) == 2 and [b[2].tolist() for b in batches] == [[7, 7], [3]]
    want = Evaluator(cfg, weights.seeded_state(cfg.model_spec(), seed=42), device="cpu").run(batches)
    assert results == want
    assert results["n_images"] == 17 and np.isfinite([results["PSNR"], results["SSIM"], results["IE"]]).all()
    one = eval_cli.main(["-c", eval_ini, "--expt", "t", "--log", str(tmp_path / "eval.log"), "--device", "cpu",
                         "--max-batches", "1"])
    assert one["n_images"] == 14


def test_train_cli_first_loss_equals_train_step_on_jax_first_batch(tmp_path, monkeypatch):
    """configs/superslomo_original.ini over ADOBE: 4 clips of 12 64x64
    frames, 32x32 crops, B=2, 2 steps (one epoch)."""
    rng = np.random.default_rng(12)
    clips = [_write_clip(rng, str(tmp_path / "clips" / f"c{i}"), 12, 64, 64) for i in range(4)]
    with open(tmp_path / "train.txt", "w") as f:
        for clip in clips:
            f.write(f"{len(clip)}\n" + "".join(p + "\n" for p in clip))
    ini = _config(tmp_path, "superslomo_original.ini", DATA={"DATASET": "ADOBE", "WINDOW_LENGTH": 12},
                  ADOBE_DATA={"TRAINPATHS": tmp_path / "train.txt"},
                  TRAIN={"BATCH_SIZE": 2, "CROP_IMH": 32, "CROP_IMW": 32, "ALLOW_RANDOM_VGG": "TRUE",
                         "CKPT_DIR": tmp_path / "ckpt", "N_EPOCHS": 1},
                  DATALOADER={"N_WORKERS": 2}, PROJECT={"LOGDIR": tmp_path / "logs"})
    losses = []
    step = Trainer.train_step

    def recording(self, *batch):
        losses.append(step(self, *batch).cpu().numpy())
        assert all(isinstance(x, torch.Tensor) for x in batch)  # from the device feed
        return torch.from_numpy(losses[-1])

    monkeypatch.setattr(Trainer, "train_step", recording)
    trainer = train_cli.main(["-c", ini, "--expt", "smoke", "--log", str(tmp_path / "train.log"), "--device", "cpu",
                              "--max-steps", "2"])
    monkeypatch.undo()
    assert len(losses) == 2 and trainer.step == 2
    assert os.path.exists(tmp_path / "ckpt" / "smoke" / "smoke_EPOCH_0001.pt")
    first = next(iter(jax_get_dataset(jax_load_config(ini), "TRAIN")))
    want = Trainer(load_config(ini), device="cpu").train_step(*first).numpy()
    np.testing.assert_array_equal(losses[0], want)
    assert np.isfinite(losses).all()


def test_load_model_params_applies_loadprev_and_weights(tmp_path):
    cfg = load_config(os.path.join(ROOT, "configs", "superslomo_original.ini"))
    seeded = weights.seeded_state(cfg.model_spec(), seed=42)
    cfg.set("STAGE1", "LOADPREV", "TRUE")  # an empty WEIGHTS is skipped
    state = load_model_params(cfg)
    assert all(torch.equal(state[s][k], seeded[s][k]) for s in seeded for k in seeded[s])

    other = weights.seeded_state(cfg.model_spec(), seed=3)
    path = weights.save_checkpoint(str(tmp_path / "w.pt"), other["stage1"], other["stage2"], {}, 1, 0)
    cfg.set("STAGE1", "WEIGHTS", path)
    state = load_model_params(cfg)  # stage 1 from the file, stage 2 seeded (LOADPREV off)
    assert all(torch.equal(state["stage1"][k], v) for k, v in other["stage1"].items())
    assert all(torch.equal(state["stage2"][k], v) for k, v in seeded["stage2"].items())
    cfg.set("STAGE2", "LOADPREV", "TRUE")
    cfg.set("STAGE2", "WEIGHTS", path)
    state = load_model_params(cfg)
    assert all(torch.equal(state["stage2"][k], v) for k, v in other["stage2"].items())

    native = save_native_checkpoint(str(tmp_path / "native"), {"stage2": seeded["stage2"]})
    cfg.set("STAGE1", "WEIGHTS", native)  # a native checkpoint directory without stage 1: stage 1 stays seeded
    cfg.set("STAGE2", "WEIGHTS", native)
    state = load_model_params(cfg)
    assert all(torch.equal(state[s][k], v) for s in seeded for k, v in seeded[s].items())


@pytest.mark.parametrize("cli", [eval_cli, train_cli, flow_cli, render_cli],
                         ids=["evaluate_interpolation", "train", "evaluate_flow", "visualize"])
def test_clis_run_on_the_card_unless_told_otherwise(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ini = os.path.join(ROOT, "configs", "superslomo_eval.ini")
    args = ["-c", ini, "--log", str(tmp_path / "log")]
    if cli is train_cli:
        args[1] = _config(tmp_path, "superslomo_original.ini", TRAIN={"ALLOW_RANDOM_VGG": "TRUE"},
                          PROJECT={"LOGDIR": tmp_path / "logs"})
    if cli in (eval_cli, train_cli):
        args += ["--expt", "t"]
    if cli is render_cli:
        args += ["--input-dir", str(tmp_path), "--output-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    assert not os.path.exists(tmp_path / "out")
