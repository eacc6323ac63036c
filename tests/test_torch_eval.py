"""The port's Evaluator on the CPU: its metrics equal the JAX package's
score_image and Normalize.inverse applied to the same predictions, and the
pipelined run() equals sequential eval_batch calls."""

import numpy as np
import pytest
import torch

from superslomo_tpu.data.augmentations import Normalize as JaxNormalize
from superslomo_tpu.utils.metrics import score_image as jax_score_image
from superslomo_tpu_torch import Evaluator, SuperSloMo, default_config, weights
from superslomo_tpu_torch.data.augmentations import Normalize, eval_padding_for
from superslomo_tpu_torch.models import superslomo
from tests.test_torch_package import one_torch_thread  # noqa: F401

H_IN, W_IN = 30, 60  # padded to 32x64: exercises the /32 pad and crop


@pytest.fixture(scope="module", autouse=True)
def first_parallel_exp():
    """PyTorch's first parallel ``torch.exp`` in a process sometimes computes
    one intra-op thread's share with a coarser rounding (about 1 process in
    10 on an 8-thread x86 host, up to 6e-5 relative): make that call here,
    so that the model calls compared exactly below all come after it."""
    torch.exp(torch.zeros(1 << 16))


def _cfg():
    cfg = default_config(DATA_DATASET="ADOBE", EVAL_EVAL_MODE="TRUE", DATALOADER_T_SAMPLE="NIL")
    cfg.set("ADOBE_DATA", "H_IN", H_IN)
    cfg.set("ADOBE_DATA", "W_IN", W_IN)
    cfg.validate()
    return cfg


def _batches(cfg, n_batches=2, B=2, seed=0):
    """Synthetic reader output: uint8 clips normalized, then zero-padded to
    /32 dims; the inner frames are the targets; the second sample of each
    batch is an edge window with 5 of its 7 targets available."""
    rng = np.random.default_rng(seed)
    norm = Normalize(cfg.pixel_mean(), cfg.pixel_std())
    left, right, top, bottom = eval_padding_for(H_IN, W_IN)
    pad = ((0, 0), (0, 0), (top, bottom), (left, right), (0, 0))
    out = []
    for _ in range(n_batches):
        clip = rng.integers(0, 256, (B, 9, H_IN, W_IN, 3)).astype(np.uint8)
        x = np.pad(norm(clip), pad)
        out.append((x[:, [0, 8]], x[:, 1:8], np.array([7, 5])))
    return out


@pytest.fixture(scope="module")
def state():
    return weights.seeded_state(_cfg().model_spec(), seed=0)


def test_metrics_equal_jax_scoring_of_same_predictions(state):
    cfg = _cfg()
    ev = Evaluator(cfg, state, device="cpu")
    assert (ev.H_REF, ev.W_REF, ev.H_START, ev.W_START) == (32, 64, 1, 2)
    np.testing.assert_array_equal(ev.t_values.numpy(), np.arange(1, 8, dtype=np.float32) / 8)
    model = SuperSloMo(cfg.model_spec(), device="cpu").load_state(state)
    jnorm = JaxNormalize(cfg.pixel_mean(), cfg.pixel_std())
    want = []
    for frames, targets, n_avail in _batches(cfg):
        ev.eval_batch(frames, targets, n_avail)
        pred = model.interpolate_multi_t(frames, ev.t_values).numpy()
        for i, n in enumerate(n_avail):
            for k in range(n):
                crop = np.s_[1 : 1 + H_IN, 2 : 2 + W_IN]
                p = jnorm.inverse(pred[i, k][crop]).astype(np.uint8)
                g = jnorm.inverse(targets[i, k][crop]).astype(np.uint8)
                want.append(jax_score_image(g, p))
    assert len(ev.psnr) == len(want) == 2 * (7 + 5)
    np.testing.assert_array_equal(np.array([ev.psnr, ev.ssim, ev.ie]).T, np.array(want))
    assert all(np.isfinite(b) and b > 0 for b in ev.bounds)


def test_run_equals_sequential_eval_batch(state):
    cfg = _cfg()
    batches = _batches(cfg, n_batches=3, seed=1)
    seq = Evaluator(cfg, state, device="cpu")
    for b in batches:
        seq.eval_batch(*b)
    piped = Evaluator(cfg, SuperSloMo(cfg.model_spec(), device="cpu").load_state(state), device="cpu")
    results = piped.run(iter(batches))
    assert (piped.psnr, piped.ssim, piped.ie, piped.bounds) == (seq.psnr, seq.ssim, seq.ie, seq.bounds)
    assert results == seq.results() and results["n_images"] == 3 * 12
    assert all(np.isfinite([results["PSNR"], results["SSIM"], results["IE"]]))


def test_batch_run_as_several_fused_steps_equals_one_step(state, monkeypatch):
    """A batch larger than ``step_samples`` (2 at 720p, 920 at 32x64) runs as
    several fused steps: the predictions within the model's f32 bar of one
    step's, the bound the max of the steps' bounds (each bounds its own
    samples' flows, so it is at most the whole batch's)."""
    cfg = _cfg()
    frames, targets, n_avail = _batches(cfg, n_batches=1, B=3, seed=2)[0]
    whole = Evaluator(cfg, state, device="cpu")
    assert whole.step_samples == 14 * 736 * 1280 // (7 * 32 * 64) == 920
    big = _cfg()
    big.set("ADOBE_DATA", "H_IN", 720)
    big.set("ADOBE_DATA", "W_IN", 1280)
    assert Evaluator(big, whole.model, device="cpu").step_samples == 2
    out, bound, *_ = whole._submit(frames, targets, n_avail)
    monkeypatch.setattr(superslomo, "STEP_PIXELS", 2 * 7 * 32 * 64)
    split = Evaluator(cfg, whole.model, device="cpu")
    assert split.step_samples == 2
    out_split, bound_split, *_ = split._submit(frames, targets, n_avail)
    assert out_split.shape == out.shape == (3, 7, 32, 64, 3)
    np.testing.assert_allclose(out_split.numpy(), out.numpy(), atol=5e-4, rtol=1e-3)
    steps = [whole.model.interpolate_multi_t(f, whole.t_values, with_bounds=True)[1] for f in (frames[:2], frames[2:])]
    assert float(bound_split) == max(float(b) for b in steps) <= float(bound)


# sliced fused step against one call: oneDNN picks its conv algorithm by
# batch (conv3a at 8x16 already sums a sample in another order at batch 1
# than at batch 3), so one call differs from the slices by the f32 step bar
# of tests/test_torch_halo.py (measured 2.2e-5 abs at |pred| ~2.5, CONV and
# SSM-R alike); the slices equal the per-sample calls bit for bit.
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-4


def _sliced_and_whole(monkeypatch, model, frames, t_values, rnn_carry=None):
    """``interpolate_multi_t`` with the budget at one sample a step, then at
    the whole batch: ((pred, bound) sliced, (pred, bound) in one go, the
    batch of each call of the one-go step)."""
    calls = []
    one_go = model._multi_t_planar

    def counted(f, *args):
        calls.append(f.shape[0])
        return one_go(f, *args)

    B, T, H, W, _ = frames.shape
    monkeypatch.setattr(superslomo, "STEP_PIXELS", len(t_values) * (T - 1) * H * W)
    assert superslomo.step_samples(H, W, len(t_values), T - 1) == 1
    monkeypatch.setattr(model, "_multi_t_planar", counted)
    sliced = model.interpolate_multi_t(frames, t_values, rnn_carry=rnn_carry, with_bounds=True)
    slices = list(calls)
    monkeypatch.setattr(superslomo, "STEP_PIXELS", B * len(t_values) * (T - 1) * H * W)
    whole = model.interpolate_multi_t(frames, t_values, rnn_carry=rnn_carry, with_bounds=True)
    assert calls[len(slices):] == [B]
    return sliced, whole, slices


def test_fused_step_slices_a_batch_past_its_budget(state, monkeypatch):
    """``interpolate_multi_t`` over a batch past ``step_samples`` (the budget
    patched to one sample at 32x64) runs one slice a sample: the predictions
    and the bound equal the per-sample calls' (joined, and their max) bit for
    bit, and one call over the whole batch within SLICE_ATOL / SLICE_RTOL.
    The bound is at most the one call's, which adds the batch's largest
    stage-1 flow to its largest residual, maybe of another sample."""
    model = SuperSloMo(_cfg().model_spec(), device="cpu").load_state(state)
    frames = _batches(_cfg(), n_batches=1, B=3, seed=5)[0][0]
    t_values = np.arange(1, 8, dtype=np.float32) / 8
    (pred, bound), (want, want_bound), slices = _sliced_and_whole(monkeypatch, model, frames, t_values)
    assert slices == [1, 1, 1] and pred.shape == want.shape == (3, 7, 32, 64, 3)
    each = [model.interpolate_multi_t(frames[i:i + 1], t_values, with_bounds=True) for i in range(3)]
    assert torch.equal(pred, torch.cat([p for p, _ in each]))
    assert float(bound) == max(float(b) for _, b in each)
    np.testing.assert_allclose(pred.numpy(), want.numpy(), atol=SLICE_ATOL, rtol=SLICE_RTOL)
    assert float(bound) <= float(want_bound) * (1 + 1e-6)


def test_recurrent_fused_step_slices_its_streamed_state(monkeypatch):
    """SuperSloMo-R (configs/superslomo_recurrent.ini) at 32x64 B=3 from a
    streamed-in state: each slice takes its samples' state (the sliced step
    equals the per-sample calls on their own states bit for bit), and the
    sliced step equals one call within SLICE_ATOL / SLICE_RTOL."""
    import os

    from superslomo_tpu_torch import load_config
    spec = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                    "superslomo_recurrent.ini")).model_spec()
    model = SuperSloMo(spec, device="cpu").load_state(weights.seeded_state(spec, seed=3))
    rng = np.random.default_rng(6)
    windows = rng.standard_normal((2, 3, spec.n_frames, 32, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        carry = model(windows[0], np.full((3, spec.n_frames - 1), 0.5, np.float32)).rnn_carry
    t_values = np.arange(1, 8, dtype=np.float32) / 8
    (pred, bound), (want, want_bound), slices = _sliced_and_whole(monkeypatch, model, windows[1], t_values, carry)
    assert slices == [1, 1, 1] and pred.shape == want.shape == (3, 7, 32, 64, 3)
    each = [model.interpolate_multi_t(windows[1][i:i + 1], t_values, with_bounds=True,
                                      rnn_carry=superslomo._carry_samples(carry, i, i + 1)) for i in range(3)]
    assert torch.equal(pred, torch.cat([p for p, _ in each]))
    assert float(bound) == max(float(b) for _, b in each)
    np.testing.assert_allclose(pred.numpy(), want.numpy(), atol=SLICE_ATOL, rtol=SLICE_RTOL)
    assert float(bound) <= float(want_bound) * (1 + 1e-6)


def test_evaluator_takes_the_models_budget(state, monkeypatch):
    """The Evaluator's ``step_samples`` is the model's ``step_samples`` of
    its rows, width, t-grid and windows: patching the model's budget moves it."""
    ev = Evaluator(_cfg(), state, device="cpu")
    assert ev.step_samples == superslomo.step_samples(32, 64, 7, 1) == 920
    monkeypatch.setattr(superslomo, "STEP_PIXELS", 2 * 7 * 32 * 64)
    assert Evaluator(_cfg(), ev.model, device="cpu").step_samples == 2
