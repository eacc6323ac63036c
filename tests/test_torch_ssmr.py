"""SuperSloMo-R in the port against the JAX package, on the CPU: the whole
model at 64x64 (a 2x2 bottleneck, so every tap of the recurrent 3x3 convs
sees data), N_FRAMES=4, the CLSTM bottleneck in both stages, the cross-stage
skip, f32, B=2, with the same weights and frames.

A 7-frame clip streams as two 4-frame windows: window 0 from a zero state,
window 1 from window 0's state. Then the fused multi-t step (n_t=3) runs on
window 1 from that state, which tiles stage 2's state over the t-grid. With
B=2 and n_t=3 a transposed fold or tile gives other numbers. JAX runs two
jitted programs: the forward (called for both windows, window 0 with an
explicit zero state, which the JAX package's own test shows to be
bit-identical to none) and the fused step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu.config import ModelSpec as JaxModelSpec
from superslomo_tpu.models import superslomo as jax_model
from superslomo_tpu.training import checkpoint as jckpt
from superslomo_tpu_torch import Trainer, default_config, weights
from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.models import superslomo as port_model
from superslomo_tpu_torch.models.superslomo import SuperSloMo
from tests.test_torch_package import one_torch_thread  # noqa: F401

SPEC = dict(n_frames=4, stage1_bottleneck="CLSTM", stage2_bottleneck="CLSTM", cross_skip=True)
B, H, W = 2, 64, 64
_rng = np.random.default_rng(0)
CLIP = _rng.standard_normal((B, 7, H, W, 3)).astype(np.float32)
WINDOWS = (CLIP[:, 0:4], CLIP[:, 3:7])
T_INTERP = _rng.uniform(0.1, 0.9, (B, 3)).astype(np.float32)
T_VALUES = np.array([0.25, 0.5, 0.75], np.float32)
# the full-model bar, and the U-Net bar for the state, of the JAX package
# against the executed reference
ATOL, RTOL = 5e-4, 1e-3
CARRY_ATOL, CARRY_RTOL = 2e-4, 1e-3


def _zero_carry():
    """A zero state of both CLSTM stages: per layer and direction (h, c) of
    (B, H/32, W/32, 256) under CONCAT."""
    leaf = np.zeros((B, H // 32, W // 32, 256), np.float32)
    stage = {f"{d}_l{i}": (leaf, leaf) for d in ("fwd", "rev") for i in (0, 1)}
    return {"stage1": stage, "stage2": dict(stage)}


@pytest.fixture(scope="module")
def params():
    """Seeded numpy weights of the port's shapes (fan-in-scaled normal
    kernels, small normal biases), as the JAX package's own converter reads
    them into its tree (``tests/test_torch_bottleneck.py`` holds that tree
    to the one its model initialises). This skips a trace of the JAX model
    that ``jax.eval_shape`` would take."""
    state = weights.seeded_state(ModelSpec(**SPEC), seed=1)
    return {"params": {stage: jckpt.convert_unet_state_dict({k: v.numpy() for k, v in sd.items()})
                       for stage, sd in state.items()}}


@pytest.fixture(scope="module")
def jax_run(params):
    """JAX: both windows' outputs, then the fused step on window 1 from
    window 0's state."""
    model = jax_model.SuperSloMo(spec=JaxModelSpec(**SPEC))
    fwd = jax.jit(lambda p, f, t, c: model.apply(p, f, t, rnn_carry=c))
    out0 = fwd(params, WINDOWS[0], T_INTERP, _zero_carry())
    out1 = fwd(params, WINDOWS[1], T_INTERP, out0.rnn_carry)
    step = jax.jit(lambda p, f, tv, c: model.apply(
        p, f, tv, rnn_carry=c, with_bounds=True, method=jax_model.SuperSloMo.interpolate_multi_t))
    pred, bound = step(params, WINDOWS[1], T_VALUES, out0.rnn_carry)
    return out0, out1, np.asarray(pred), float(bound)


@pytest.fixture(scope="module")
def port(params):
    """The port's model and its two windows' outputs: window 0 from no
    state, window 1 from window 0's."""
    spec = ModelSpec(**SPEC)
    model = SuperSloMo(spec, device="cpu").load_state(weights.torch_state_from_jax(params, spec))
    with torch.no_grad():
        out0 = model(WINDOWS[0], T_INTERP)
        out1 = model(WINDOWS[1], T_INTERP, out0.rnn_carry)
    return model, out0, out1


def _check_carry(got, want):
    got = weights.jax_carry_from_torch(got)
    assert sorted(got) == ["stage1", "stage2"]
    for stage in got:
        assert sorted(got[stage]) == sorted(want[stage]) == ["fwd_l0", "fwd_l1", "rev_l0", "rev_l1"]
        for name, leaves in want[stage].items():
            assert len(got[stage][name]) == len(leaves) == 2
            for g, w in zip(got[stage][name], leaves):
                assert g.shape == (B, H // 32, W // 32, 256)
                np.testing.assert_allclose(g, np.asarray(w), atol=CARRY_ATOL, rtol=CARRY_RTOL,
                                           err_msg=f"{stage}/{name}")


@pytest.mark.parametrize("window", [0, 1])
def test_streamed_forward_matches_jax(jax_run, port, window):
    want = jax_run[window]
    got = port[1 + window]
    for name in ("pred_images", "flowC_out", "flowI_in", "flowI_out"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)
    _check_carry(got.rnn_carry, want.rnn_carry)


def test_zero_state_equals_no_state(port):
    """An explicit zero state gives bit for bit what no state gives."""
    model, out0, _ = port
    zeros = weights.torch_carry_from_jax(_zero_carry())
    with torch.no_grad():
        again = model(WINDOWS[0], T_INTERP, zeros)
    assert torch.equal(again.pred_images, out0.pred_images)
    for stage in ("stage1", "stage2"):
        for name, leaves in out0.rnn_carry[stage].items():
            assert all(torch.equal(a, b) for a, b in zip(again.rnn_carry[stage][name], leaves))


def test_fused_step_with_streamed_state_matches_jax(jax_run, port):
    _, _, want, want_bound = jax_run
    model, out0, _ = port
    pred, bound = model.interpolate_multi_t(WINDOWS[1], T_VALUES, rnn_carry=out0.rnn_carry, with_bounds=True)
    assert pred.shape == (B, 3, H, W, 3) and pred.dtype == torch.float32
    np.testing.assert_allclose(pred.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(bound), want_bound, rtol=1e-4)
    # the state matters: from zeros the step gives other frames
    other = model.interpolate_multi_t(WINDOWS[1], T_VALUES)
    assert (other - pred).abs().max() > 10 * ATOL


def test_sliced_fused_step_with_streamed_state_matches_jax(jax_run, port, monkeypatch):
    """The fused step from the streamed state with its budget patched to one
    sample (B=2 runs as two slices of 1, each with its sample's state)
    against JAX's one call over the batch, at the full-model bar; each slice
    bounds only its own sample's flows, so the bound is at most JAX's."""
    _, _, want, want_bound = jax_run
    model, out0, _ = port
    monkeypatch.setattr(port_model, "STEP_PIXELS", len(T_VALUES) * (SPEC["n_frames"] - 1) * H * W)
    slices, one_go = [], model._multi_t_planar

    def counted(f, *args):
        slices.append(f.shape[0])
        return one_go(f, *args)

    monkeypatch.setattr(model, "_multi_t_planar", counted)
    pred, bound = model.interpolate_multi_t(WINDOWS[1], T_VALUES, rnn_carry=out0.rnn_carry, with_bounds=True)
    assert slices == [1, 1] and pred.shape == (B, 3, H, W, 3)
    np.testing.assert_allclose(pred.numpy(), want, atol=ATOL, rtol=RTOL)
    assert float(bound) <= want_bound * (1 + 1e-4)


def test_forward_inference_matches_jax(jax_run, port):
    """(mid image, Intermediates, state) of window 1 against JAX's
    ``intermediates_for_window`` on its own outputs."""
    _, want_out, _, _ = jax_run
    model, out0, out1 = port
    img, inter, carry = model.forward_inference(WINDOWS[1], T_INTERP, out0.rnn_carry)
    mid = jax_model.mid_window(want_out)
    assert mid == 1
    np.testing.assert_allclose(img.numpy(), np.asarray(want_out.pred_images)[:, mid], atol=ATOL, rtol=RTOL)
    want = jax_model.intermediates_for_window(want_out, mid)
    assert inter._fields == want._fields
    for name, g, w in zip(want._fields, inter, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=name)
    _check_carry(carry, want_out.rnn_carry)
    assert torch.equal(img, out1.pred_images[:, mid])


def test_trainer_refuses_a_recurrent_model():
    """The recurrent model is no longer refused: the Trainer builds it, and
    every parameter, the ``conv6`` gate convs of both stages included, is in
    its optimizer (tests/test_torch_ssmr_train.py holds its step against
    JAX)."""
    cfg = default_config(TRAIN_N_FRAMES=4, STAGE1_BOTTLENECK="CLSTM", STAGE2_BOTTLENECK="CLSTM",
                         TRAIN_ALLOW_RANDOM_VGG="TRUE")
    tr = Trainer(cfg, device="cpu")
    assert tr.model.stage1.recurrent and tr.model.stage2.recurrent
    in_optimizer = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    gates = [p for stage in (tr.model.stage1, tr.model.stage2) for p in stage.conv6.parameters()]
    assert len(gates) == 16 and all(id(p) in in_optimizer for p in gates)
    assert len(in_optimizer) == len(list(tr.model.parameters()))
