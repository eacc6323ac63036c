"""The port's training slice (SuperSloMo.forward, the VGG, the composite loss,
the Trainer's Adam, freezing and .pt checkpoints) against the JAX package's, on
the CPU, with the same weights and inputs made by numpy. The full-model
reference is ONE ``jax.jit(jax.value_and_grad(..., has_aux=True))``: its aux
carries the forward outputs, so one compile serves the outputs, the loss
vector and every parameter's gradient. bf16 training (float32 master
weights, bf16 convs) is held against one more, of the JAX model in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from superslomo_tpu.config import ModelSpec as JaxModelSpec
from superslomo_tpu.models import losses as jlosses
from superslomo_tpu.models.superslomo import SuperSloMo as JaxSuperSloMo
from superslomo_tpu.models.vgg import VGG16Features as JaxVGG
from superslomo_tpu.training import checkpoint as jckpt
from superslomo_tpu.training.trainer import make_optimizer
from superslomo_tpu_torch import Trainer, default_config, weights
from superslomo_tpu_torch import ops as tops
from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.models import losses, physics
from superslomo_tpu_torch.models.layers import Conv2d
from superslomo_tpu_torch.models.superslomo import SuperSloMo
from superslomo_tpu_torch.models.vgg import VGG16Features
from superslomo_tpu_torch.training.checkpoint import save_native_checkpoint
from tests.test_torch_package import one_torch_thread  # noqa: F401

# the full-model bar of the JAX package against the executed reference
OUT_ATOL, OUT_RTOL = 5e-4, 1e-3
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3  # per tensor, of that tensor's max |g|
# the U-Net bar of the JAX package (f32 conv reassociation, XLA vs oneDNN),
# for the 10-conv VGG stack
VGG_ATOL, VGG_RTOL = 2e-4, 1e-3
# bf16 against JAX's bf16, as a multiple of JAX's bf16 distance from its f32:
# two bf16 computations whose roundings are independent lie sqrt(2) times as
# far from each other as each lies from the f32 result
BF16_MARGIN = np.sqrt(2.0)

rng0 = np.random.default_rng(0)
FRAMES = rng0.standard_normal((1, 2, 32, 32, 3)).astype(np.float32)
TARGETS = rng0.standard_normal((1, 1, 32, 32, 3)).astype(np.float32)
T_INTERP = np.array([[0.375]], np.float32)
LW = losses.LossWeights()


def _fill(shapes, rng, kernel_gain=2.0):
    """A JAX param-shape tree filled with fan-in-scaled normals (kernels,
    HWIO) and small normal biases."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(kernel_gain / np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def params():
    shapes = jax.eval_shape(
        JaxSuperSloMo(spec=JaxModelSpec()).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct(FRAMES.shape, jnp.float32), jax.ShapeDtypeStruct(T_INTERP.shape, jnp.float32),
    )
    return _fill(shapes, np.random.default_rng(1))


@pytest.fixture(scope="module")
def vgg_params():
    shapes = jax.eval_shape(JaxVGG().init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    return _fill(shapes, np.random.default_rng(2), kernel_gain=1.0)


def _port_vgg(vgg_params):
    vgg = VGG16Features()
    vgg.load_state_dict(weights.vgg_state_from_jax(vgg_params))
    return vgg


def _jax_value_and_grad(params, vgg_params, compute_dtype="float32"):
    """Loss vector, gradients and forward outputs of the JAX model."""
    spec = JaxModelSpec(compute_dtype=compute_dtype)
    model, vgg = JaxSuperSloMo(spec=spec), JaxVGG()
    weights_j = jlosses.LossWeights(*LW)

    def loss_fn(p, vp, frames, targets, t):
        out = model.apply(p, frames, t)
        per_sample = jlosses.compute_losses(out, targets, spec, weights_j, lambda img: vgg.apply(vp, img))
        aux = per_sample.mean(axis=0), (out.flowC_out, out.flowI_in, out.flowI_out, out.pred_images)
        return per_sample[:, 0].mean(), aux

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (loss_vec, outs)), grads = step(
        params, vgg_params, jnp.asarray(FRAMES), jnp.asarray(TARGETS), jnp.asarray(T_INTERP))
    return np.asarray(loss_vec), [np.asarray(o) for o in outs], grads


@pytest.fixture(scope="module")
def jax_step(params, vgg_params):
    return _jax_value_and_grad(params, vgg_params)


@pytest.fixture(scope="module")
def port_step(params, vgg_params):
    model = SuperSloMo(ModelSpec(), device="cpu").load_state(weights.torch_state_from_jax(params))
    out = model(FRAMES, T_INTERP)
    per_sample = losses.compute_losses(out, torch.from_numpy(TARGETS), model.spec, LW, _port_vgg(vgg_params))
    per_sample[:, 0].mean().backward()
    return model, per_sample.detach().mean(dim=0).numpy(), out


def test_forward_outputs_match_jax(jax_step, port_step):
    _, want, _ = jax_step
    _, _, out = port_step
    got = (out.flowC_out, out.flowI_in, out.flowI_out, out.pred_images)
    for name, g, w in zip(("flowC_out", "flowI_in", "flowI_out", "pred_images"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.detach().numpy(), w, atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=name)
    assert out.image_pairs.shape == (1, 1, 32, 32, 6) and out.t_interp.shape == (1, 1, 1, 1, 1)


def test_loss_vector_matches_jax(jax_step, port_step):
    want, _, _ = jax_step
    _, got, _ = port_step
    assert got.shape == (4,) and np.all(got[1:] > 0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_every_parameter_gradient_matches_jax(jax_step, port_step):
    _, _, grads = jax_step
    model, _, _ = port_step
    want = weights.torch_state_from_jax(grads)
    checked = 0
    for stage in ("stage1", "stage2"):
        for name, p in getattr(model, stage).named_parameters():
            w = want[stage][name].numpy()
            err = np.abs(p.grad.numpy() - w).max()
            assert err <= GRAD_REL * np.abs(w).max(), (stage, name, err, np.abs(w).max())
            checked += 1
    assert checked == len(want["stage1"]) + len(want["stage2"])


def test_bf16_step_matches_jax_bf16(params, vgg_params, jax_step):
    """bf16 compute on float32 master weights against the JAX model's bf16
    step (flax keeps f32 parameters and computes each conv in bf16): the
    loss vector, and each stage's gradient flattened, lie no further from
    JAX's bf16 result than BF16_MARGIN times JAX's bf16 result lies from
    its f32 one (on these inputs the port's lies 0.80 of that distance for
    the loss and 0.95 for the gradients). The gradients are f32."""
    want_loss, _, want_grads = _jax_value_and_grad(params, vgg_params, "bfloat16")
    f32_loss, _, f32_grads = jax_step
    spec = ModelSpec(compute_dtype="bfloat16")
    model = SuperSloMo(spec, device="cpu", param_dtype=torch.float32).load_state(weights.torch_state_from_jax(params))
    assert model.compute_dtype == torch.bfloat16
    out = model(FRAMES, T_INTERP)
    per_sample = losses.compute_losses(out, torch.from_numpy(TARGETS), spec, LW, _port_vgg(vgg_params))
    per_sample[:, 0].mean().backward()
    got = per_sample.detach().mean(dim=0).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.linalg.norm(got - want_loss) <= BF16_MARGIN * np.linalg.norm(want_loss - f32_loss)
    want, ref = weights.torch_state_from_jax(want_grads), weights.torch_state_from_jax(f32_grads)
    for stage in ("stage1", "stage2"):
        named = list(getattr(model, stage).named_parameters())
        assert all(p.dtype == p.grad.dtype == torch.float32 for _, p in named)
        flat = lambda tensors: np.concatenate([t.numpy().ravel() for t in tensors])  # noqa: E731
        g = flat([p.grad for _, p in named])
        w, f = flat([want[stage][n] for n, _ in named]), flat([ref[stage][n] for n, _ in named])
        assert np.linalg.norm(g - w) <= BF16_MARGIN * np.linalg.norm(w - f), stage


def test_bf16_training_quantizes_where_jax_does(tmp_path, monkeypatch):
    """A bf16 Trainer step of the recurrent model (CLSTM in stage 1, CGRU in
    stage 2, so both cells' convs): every U-Net conv, the recurrence's gate
    and candidate convs included, gets a bf16 input and runs on float32
    master weights; the VGG's convs get f32; the stage-2 input warps take
    bf16 images, the final and loss warps f32; the outputs are f32; and the
    parameters, their gradients and Adam's moments stay f32."""
    cfg = _train_cfg(tmp_path, TPU_COMPUTE_DTYPE="bfloat16", TRAIN_N_FRAMES=4, STAGE1_BOTTLENECK="CLSTM",
                     STAGE2_BOTTLENECK="CGRU")
    tr = Trainer(cfg, device="cpu")
    convs = {f"{stage}.{name}": m for stage in ("stage1", "stage2")
             for name, m in getattr(tr.model, stage).named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert all(isinstance(m, Conv2d) for m in convs.values())
    assert sum(".conv6." in k for k in convs) == 12  # 4 CLSTM gate convs, 4 CGRU gate and 4 candidate convs
    seen = {}

    def record(name):
        def hook(module, args):
            seen.setdefault(name, (args[0].dtype, module.weight.dtype))
        return hook

    hooks = [m.register_forward_pre_hook(record(k)) for k, m in convs.items()]
    hooks += [m.register_forward_pre_hook(record(f"vgg.{k}")) for k, m in tr.vgg.features.items()]
    outputs = []
    hooks.append(tr.model.register_forward_hook(lambda module, args, out: outputs.append(out)))
    warps = []

    def recording(img, flow):
        warps.append(img.dtype)
        return tops.warp_auto(img, flow)

    monkeypatch.setattr(physics, "warp_auto", recording)
    monkeypatch.setattr(losses, "warp_auto", recording)
    frames = np.random.default_rng(6).standard_normal((1, 4, 32, 32, 3)).astype(np.float32)
    loss = tr.train_step(frames, frames[:, 1:], np.full((1, 3), 0.5, np.float32))
    for h in hooks:
        h.remove()

    bf16, f32 = torch.bfloat16, torch.float32
    assert torch.isfinite(loss).all() and loss.dtype == f32
    assert {k: v for k, v in seen.items() if not k.startswith("vgg.")} == {k: (bf16, f32) for k in convs}
    assert {k: v for k, v in seen.items() if k.startswith("vgg.")} == {f"vgg.{k}": (f32, f32) for k in tr.vgg.features}
    assert warps == [bf16] * 2 + [f32] * 6  # stage-2 input, final image, four loss terms
    assert all(x.dtype == f32 for x in outputs[0][:6])
    params = [p for g in tr.optimizer.param_groups for p in g["params"]]
    assert len(params) == len(list(tr.model.parameters()))
    assert all(p.dtype == p.grad.dtype == f32 for p in params)
    assert all(tr.optimizer.state[p][k].dtype == f32 for p in params for k in ("exp_avg", "exp_avg_sq"))


def test_vgg_features_match_jax(vgg_params):
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxVGG().apply)(vgg_params, jnp.asarray(x)))
    vgg = _port_vgg(vgg_params)
    assert not any(p.requires_grad for p in vgg.parameters())
    assert set(vgg.state_dict()) == {f"features.{i}.{n}" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
                                     for n in ("weight", "bias")}
    with torch.no_grad():
        got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(got, want, atol=VGG_ATOL, rtol=VGG_RTOL)


@pytest.mark.parametrize("freeze1,freeze2", [(False, False), (True, False), (False, True), (True, True)])
def test_window_losses_freeze_gates_match_jax(vgg_params, freeze1, freeze2):
    """Each frozen stage drops its two warp terms, as in the JAX package."""
    rng = np.random.default_rng(4)
    N, H, W = 2, 16, 16

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = [a(N, H, W, 6), a(N, H, W, 4, scale=2.0), a(N, H, W, 16, scale=2.0),
            a(N, H, W, 5, scale=0.5), a(N, H, W, 3), a(N, H, W, 3)]
    want = np.asarray(jlosses.window_losses(
        *(jnp.asarray(x) for x in args),
        JaxModelSpec(stage1_freeze=freeze1, stage2_freeze=freeze2), jlosses.LossWeights(*LW),
        lambda img: JaxVGG().apply(vgg_params, img),
    ))
    got = losses.window_losses(
        *(torch.from_numpy(x) for x in args),
        ModelSpec(stage1_freeze=freeze1, stage2_freeze=freeze2), LW, _port_vgg(vgg_params),
    ).numpy()
    assert got.shape == (N, 4)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-6)
    assert (got[:, 2] == 0).all() == (freeze1 and freeze2)


def _train_cfg(tmp_path, **overrides):
    cfg = default_config(TRAIN_ALLOW_RANDOM_VGG="TRUE", TRAIN_BATCH_SIZE=1, TRAIN_CKPT_DIR=str(tmp_path),
                         TRAIN_N_EPOCHS=3, TRAIN_SAVE_EVERY=1)
    for key, value in overrides.items():
        section, _, k = key.partition("_")
        cfg.set(section, k, value)
    return cfg


def test_adam_update_matches_optax(tmp_path):
    """One update of the Trainer's optimizer against the JAX trainer's optax
    Adam on the same gradients, which run down to 1e-9 so that eps counts.
    Parameters start at zero, so the updates are compared without the
    rounding of an add to O(1) weights. (After one step the betas cancel
    from the update; they are checked by value.)"""
    tr = Trainer(_train_cfg(tmp_path), device="cpu")
    assert tr.optimizer.defaults["betas"] == (0.9, 0.999) and tr.optimizer.defaults["eps"] == 1e-8
    named = {f"stage1.{k}": p for k, p in tr.model.stage1.named_parameters()}
    named.update({f"stage2.{k}": p for k, p in tr.model.stage2.named_parameters()})
    chosen = ["stage1.conv1a.0.weight", "stage1.conv1a.0.bias", "stage2.final_conv.weight", "stage2.final_conv.bias"]
    rng = np.random.default_rng(5)
    grads = {k: (rng.standard_normal(named[k].shape) * 10.0 ** rng.integers(-9, 1, named[k].shape)).astype(np.float32)
             for k in chosen}
    with torch.no_grad():
        for p in named.values():
            p.zero_()
    for k in chosen:
        named[k].grad = torch.from_numpy(grads[k])
    tr.optimizer.step()

    tx = make_optimizer(None, tr.lr_schedule(1))
    jp = {k: jnp.zeros(named[k].shape, jnp.float32) for k in chosen}
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, tx.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    for k in chosen:
        np.testing.assert_allclose(named[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-12, err_msg=k)
    assert not any(p.any() for k, p in named.items() if k not in chosen)  # no gradient, no update


@pytest.mark.parametrize("frozen", ["STAGE1", "STAGE2"])
def test_frozen_stage_stays_bit_identical(tmp_path, frozen):
    tr = Trainer(_train_cfg(tmp_path, **{f"{frozen}_FREEZE": "TRUE"}), device="cpu")
    stage, other = ("stage1", "stage2") if frozen == "STAGE1" else ("stage2", "stage1")
    before = {k: v.clone() for k, v in getattr(tr.model, stage).state_dict().items()}
    other_before = {k: v.clone() for k, v in getattr(tr.model, other).state_dict().items()}
    loss = tr.train_step(FRAMES, TARGETS, T_INTERP)
    assert torch.isfinite(loss).all()
    assert all(torch.equal(v, before[k]) for k, v in getattr(tr.model, stage).state_dict().items())
    assert not all(torch.equal(v, other_before[k]) for k, v in getattr(tr.model, other).state_dict().items())
    n_trainable = sum(len(g["params"]) for g in tr.optimizer.param_groups)
    assert n_trainable == len(list(getattr(tr.model, other).parameters()))


def test_checkpoint_reads_in_jax_and_resumes(tmp_path):
    """A .pt the port saves after one step: JAX's converters read the port's
    weights and Adam moments from it, and a second Trainer resumes from it
    to identical weights, moments and epoch."""
    tr = Trainer(_train_cfg(tmp_path), expt_name="rt", device="cpu")
    tr.train([(FRAMES, TARGETS, T_INTERP)], max_steps=2)
    assert (tr.step, tr.epoch) == (2, 2)
    path = tr.checkpoint_path(2)

    conv = jckpt.convert_torch_checkpoint(path)
    back = weights.torch_state_from_jax(conv)
    for stage in ("stage1", "stage2"):
        for k, v in getattr(tr.model, stage).state_dict().items():
            assert torch.equal(back[stage][k], v), (stage, k)

    template = jax.tree.map(np.zeros_like, conv)
    opt_state, epoch = jckpt.convert_torch_opt_state(path, template, make_optimizer(None, 1e-4).init(template))
    adam = opt_state.inner_state[0]
    assert epoch == 2 and int(adam.count) == 2
    mu, nu = weights.torch_state_from_jax(adam.mu), weights.torch_state_from_jax(adam.nu)
    state = tr.optimizer.state
    for stage in ("stage1", "stage2"):
        for k, p in getattr(tr.model, stage).named_parameters():
            assert torch.equal(mu[stage][k], state[p]["exp_avg"].contiguous()), (stage, k)
            assert torch.equal(nu[stage][k], state[p]["exp_avg_sq"].contiguous()), (stage, k)

    tr2 = Trainer(_train_cfg(tmp_path, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=path,
                             STAGE2_LOADPREV="TRUE", STAGE2_WEIGHTS=path), expt_name="rt2", device="cpu")
    assert (tr2.epoch, tr2.step) == (2, 2)
    for p, q in zip(tr.optimizer.param_groups[0]["params"], tr2.optimizer.param_groups[0]["params"]):
        assert torch.equal(p, q)
        assert torch.equal(tr.optimizer.state[p]["exp_avg_sq"], tr2.optimizer.state[q]["exp_avg_sq"])


def test_trainer_refuses_bf16_native_checkpoints_and_random_vgg(tmp_path):
    """bf16 and the native checkpoint are no longer refused: the Trainer
    builds the bf16 model on float32 master weights, all of them in its
    optimizer, and loads the weights of the JAX package's native checkpoint
    directory (one without ``opt.msgpack``: a fresh optimizer). Random VGG
    features without the opt-in still raise."""
    tr = Trainer(_train_cfg(tmp_path, TPU_COMPUTE_DTYPE="bfloat16"), device="cpu")
    assert tr.model.compute_dtype == torch.bfloat16 and tr.model.param_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert sum(len(g["params"]) for g in tr.optimizer.param_groups) == len(list(tr.model.parameters()))
    other = weights.seeded_state(ModelSpec(), seed=7)
    native = save_native_checkpoint(str(tmp_path / "native"), other, meta={"epoch": 5})
    tr = Trainer(_train_cfg(tmp_path, STAGE1_LOADPREV="TRUE", STAGE1_WEIGHTS=native), device="cpu")
    assert all(torch.equal(v, other["stage1"][k]) for k, v in tr.model.stage1.state_dict().items())
    assert (tr.epoch, tr.step) == (1, 0) and not tr.optimizer.state
    with pytest.raises(ValueError, match="ALLOW_RANDOM_VGG"):
        Trainer(_train_cfg(tmp_path, TRAIN_ALLOW_RANDOM_VGG="FALSE"), device="cpu")


def test_train_loop_logs_to_a_duck_typed_writer(tmp_path):
    """The loop logs the learning rate each epoch and the four losses every
    10 steps; the image dump is the mid window's frame in [0, 1], CHW."""
    calls = []

    class Writer:
        def add_scalars(self, tag, values, step):
            calls.append(("scalars", tag, dict(values), step))

        def add_image(self, tag, img, step):
            calls.append(("image", tag, img, step))

    tr = Trainer(_train_cfg(tmp_path, TRAIN_N_EPOCHS=1, TRAIN_SAVE_EVERY=5), writer=Writer(), device="cpu")
    last = tr.train([(FRAMES, TARGETS, T_INTERP)] * 10)
    assert tr.step == 10 and last.shape == (4,) and np.isfinite(last).all()
    tags = [c[1] for c in calls]
    assert tags == ["Learning_Rate", "Total_Loss", "Reconstruction_Loss", "Warping_Loss", "Perceptual_Loss"]
    assert calls[0][2] == {"TRAIN": pytest.approx(1e-4)} and calls[1][2]["TRAIN"] == pytest.approx(float(last[0]))
    tr.write_image(FRAMES, T_INTERP, 10, "TRAIN")
    img = calls[-1][2]
    assert calls[-1][:2] == ("image", "TRAIN") and img.shape == (3, 32, 32) and 0 <= img.min() <= img.max() <= 1
    assert [p.name for p in (tmp_path / "expt").iterdir()] == ["expt_EPOCH_0001.pt"]
