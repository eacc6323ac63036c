"""The port's recurrent bottleneck (superslomo_tpu_torch.models.bottleneck)
against the JAX package's flax modules, on the CPU: the ConvLSTM and ConvGRU
cells one step at a time, and the bidirectional two-layer stack over a window
sequence in every layout (cell x merge x gate order), each from a zero and
from a nonzero state. The spatial size is odd (5x7) so that every tap of the
3x3 gate convs sees data and a wrong padding or a flipped kernel shows. Also
the recurrent state dict's names: a ``.pt`` the port writes for a recurrent
model is read by the JAX package's converter into the tree its model
expects, and a checkpoint of the other merge is refused with the config key
to change."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu.models import bottleneck as jbn
from superslomo_tpu.training import checkpoint as jckpt
from superslomo_tpu_torch import weights
from superslomo_tpu_torch.config import ModelSpec, default_config
from superslomo_tpu_torch.models import bottleneck
from superslomo_tpu_torch.models.superslomo import SuperSloMo, stage_unets
from tests.test_torch_package import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4  # f32: a 3x3 conv over 16 channels and the cell's pointwise math
B, T, H, W, C, HIDDEN = 2, 3, 5, 7, 8, 8
# the default gate order and one other permutation, per cell
ORDERS = {"CLSTM": {"default": "ifog", "other": "gfoi"}, "CGRU": {"default": "ifog", "other": "rz"}}


def _fill(shapes, rng):
    """A JAX param-shape tree filled with normals: kernels scaled by
    sqrt(2 / fan_in), biases of std 0.3 so that every gate's bias matters."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _conv_state(tree):
    """A flax cell's {gates, candidate}/{kernel, bias} → the port cell's
    state dict, through the port's converter."""
    sd = {}
    weights._convert_recurrent(sd, {"fwd_l0": tree}, "cell")
    return {k.split("cell_list.0.", 1)[1]: v for k, v in sd.items()}


@pytest.mark.parametrize("order", ["default", "other"])
@pytest.mark.parametrize("cell", ["CLSTM", "CGRU"])
def test_cell_step_matches_flax(cell, order):
    gate_order = ORDERS[cell][order]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    n_state = 2 if cell == "CLSTM" else 1
    if cell == "CLSTM":
        jcell = jbn.ConvLSTMCell(hidden=HIDDEN, gate_order=gate_order)
        port = bottleneck.ConvLSTMCell(C, HIDDEN, gate_order=gate_order)
    else:
        gru_order = "zr" if gate_order == "ifog" else gate_order
        jcell = jbn.ConvGRUCell(hidden=HIDDEN, gate_order=gru_order)
        port = bottleneck.ConvGRUCell(C, HIDDEN, gate_order=gru_order)
    zeros = tuple(np.zeros((B, H, W, HIDDEN), np.float32) for _ in range(n_state))
    shapes = jax.eval_shape(jcell.init, jax.random.PRNGKey(0), zeros, x)["params"]
    params = _fill(shapes, rng)
    port.load_state_dict(_conv_state(params))
    step = jax.jit(lambda c, x: jcell.apply({"params": params}, c, x))

    nonzero = tuple(rng.standard_normal((B, H, W, HIDDEN)).astype(np.float32) for _ in range(n_state))
    for carry in (zeros, nonzero):
        (want_carry, want_h) = step(carry, x)
        with torch.no_grad():
            got_carry, got_h = port(_nchw(x), tuple(_nchw(c) for c in carry))
        np.testing.assert_allclose(got_h.permute(0, 2, 3, 1).numpy(), np.asarray(want_h), atol=ATOL, rtol=RTOL)
        assert len(got_carry) == len(want_carry) == n_state
        for g, w in zip(got_carry, want_carry):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def _jax_stack(cell, merge, gate_order, rng):
    """(flax BiConvRNN, its filled params, its carry's shapes)."""
    module = jbn.BiConvRNN(hidden_channels=HIDDEN, num_layers=2, cell=cell, merge=merge, gate_order=gate_order)
    x = jax.ShapeDtypeStruct((B, T, H, W, C), jnp.float32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    carry_shapes = jax.eval_shape(lambda p, x: module.apply({"params": p}, x)[1], shapes, x)
    return module, _fill(shapes, rng), carry_shapes


def _port_stack(cell, merge, gate_order, params, dtype=torch.float32):
    port = bottleneck.BiConvRNN(C, HIDDEN, num_layers=2, cell=cell, merge=merge, gate_order=gate_order)
    sd = {}
    weights._convert_recurrent(sd, params, "conv6")
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return port.to(dtype)


@pytest.mark.parametrize("order", ["default", "other"])
@pytest.mark.parametrize("merge", ["concat", "sum"])
@pytest.mark.parametrize("cell", ["CLSTM", "CGRU"])
def test_biconvrnn_matches_flax(cell, merge, order):
    """The two-layer bidirectional stack over T=3 windows, from no state and
    from a nonzero one: every output and every layer's final state. JAX runs
    one jitted program for both, its "no state" an explicit zero state (the
    JAX package's own test shows that to be bit-identical to None)."""
    gate_order = ORDERS[cell][order]
    rng = np.random.default_rng(1)
    module, params, carry_shapes = _jax_stack(cell, merge, gate_order, rng)
    port = _port_stack(cell, merge, gate_order, params)
    per_dir = HIDDEN // 2 if merge == "concat" else HIDDEN
    assert port.forward_net.cell_list[1].conv.in_channels == 2 * per_dir  # layer 1 reads its own direction
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    run = jax.jit(lambda c, x: module.apply({"params": params}, x, c))

    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), carry_shapes)
    nonzero = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), carry_shapes)
    x_port = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    for jax_carry, port_carry in ((zeros, None), (nonzero, weights.torch_carry_from_jax(nonzero))):
        want, want_carry = run(jax_carry, x)
        with torch.no_grad():
            got, got_carry = port(x_port, port_carry)
        assert tuple(got.shape) == (B, T, HIDDEN, H, W)
        np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
        got_carry = weights.jax_carry_from_torch(got_carry)
        assert sorted(got_carry) == sorted(want_carry) == ["fwd_l0", "fwd_l1", "rev_l0", "rev_l1"]
        for name in want_carry:
            assert len(got_carry[name]) == len(want_carry[name]) == (2 if cell == "CLSTM" else 1)
            for g, w in zip(got_carry[name], want_carry[name]):
                assert g.shape == (B, H, W, per_dir)
                np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=name)


def test_biconvrnn_bf16_keeps_the_state_in_bf16():
    """In bf16 the state is held in the compute dtype, as in the JAX
    package: from zeros and from a streamed bf16 state, every leaf comes
    back bf16, and the output lies within bf16 rounding of the f32 stack's."""
    rng = np.random.default_rng(2)
    _, params, _ = _jax_stack("CLSTM", "concat", "ifog", rng)
    f32 = _port_stack("CLSTM", "concat", "ifog", params)
    bf16 = _port_stack("CLSTM", "concat", "ifog", params, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((B, T, C, H, W)).astype(np.float32))
    with torch.no_grad():
        want, _ = f32(x)
        got, carry = bf16(x.bfloat16())
        again, carry2 = bf16(x.bfloat16(), carry)
    assert got.dtype == again.dtype == torch.bfloat16
    leaves = [leaf for c in (carry, carry2) for state in c.values() for leaf in state]
    assert len(leaves) == 16 and all(leaf.dtype == torch.bfloat16 for leaf in leaves)
    assert (got.float() - want).abs().max() <= 0.05  # |out| < 1: a few bf16 roundings of 2^-8


def _recurrent_spec(merge):
    return dict(stage1_bottleneck="CLSTM", stage2_bottleneck="CGRU", n_frames=4, clstm_merge=merge)


@pytest.fixture(scope="module")
def concat_checkpoint(tmp_path_factory):
    """Seeded weights of a CONCAT model (CLSTM stage 1, CGRU stage 2) and
    the ``.pt`` the port's ``save_checkpoint`` writes of them."""
    state = weights.seeded_state(ModelSpec(**_recurrent_spec("CONCAT")), seed=3)
    path = tmp_path_factory.mktemp("ckpt") / "ssmr.pt"
    return state, weights.save_checkpoint(str(path), state["stage1"], state["stage2"], {}, 1, 0)


# the layers of a JAX U-Net stage's tree, conv6 being the bottleneck
UNET_LAYERS = {f"conv{i}{ab}" for i in (1, 2, 3, 4, 5, 7, 8, 9, 10, 11) for ab in "ab"} | {
    "conv6", "fuse_conv", "final_conv"}


def test_recurrent_checkpoint_reads_in_jax(concat_checkpoint):
    """JAX's ``convert_torch_checkpoint`` reads the port's recurrent ``.pt``
    into the tree its model initialises: the flax bottleneck's names and
    shapes under ``conv6`` (the other layers are the CONV U-Net's, which
    tests/test_torch_unet.py holds to JAX's). The port's
    converter brings that tree back to the same tensors."""
    state, path = concat_checkpoint
    conv = jckpt.convert_torch_checkpoint(path)
    x = jax.ShapeDtypeStruct((1, 3, 2, 2, 512), jnp.float32)  # the bottleneck's input
    for stage, cell in (("stage1", "CLSTM"), ("stage2", "CGRU")):
        module = jbn.BiConvRNN(hidden_channels=512, num_layers=2, cell=cell, merge="concat")
        template = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
        jckpt.check_converted_shapes(conv["params"][stage]["conv6"], template, stage)
        assert set(conv["params"][stage]) == UNET_LAYERS
    assert set(conv["params"]["stage2"]["conv6"]["rev_l1"]) == {"gates", "candidate"}

    back = weights.torch_state_from_jax(conv, ModelSpec(**_recurrent_spec("CONCAT")))
    for stage in ("stage1", "stage2"):
        assert set(back[stage]) == set(state[stage])
        for k, v in state[stage].items():
            assert torch.equal(back[stage][k], v), (stage, k)
    assert "conv6.reverse_net.cell_list.1.conv_can.weight" in back["stage2"]


def test_checkpoint_of_the_other_merge_is_refused(concat_checkpoint):
    """The CONCAT checkpoint loaded into a SUM model raises, naming
    ``CLSTM_MERGE``, from the ``.pt`` and from the JAX tree; a CONCAT model
    loads it."""
    _, path = concat_checkpoint
    blob = weights.load_checkpoint(path)
    loaded = {stage: weights.stage_state_from_checkpoint(blob, stage) for stage in ("stage1", "stage2")}
    with pytest.raises(ValueError, match="CLSTM_MERGE"):
        SuperSloMo(ModelSpec(**_recurrent_spec("SUM")), device="cpu").load_state(loaded)
    with pytest.raises(ValueError, match="CLSTM_MERGE"):
        weights.torch_state_from_jax(jckpt.convert_torch_checkpoint(path), ModelSpec(**_recurrent_spec("SUM")))
    SuperSloMo(ModelSpec(**_recurrent_spec("CONCAT")), device="cpu").load_state(loaded)


@pytest.mark.parametrize("cell,merge,order,ok", [
    ("CLSTM", "CONCAT", "IFOG", True), ("CLSTM", "SUM", "GFOI", True), ("CGRU", "SUM", "IFOG", True),
    ("CGRU", "CONCAT", "RZ", True), ("CLSTM", "MEAN", "IFOG", False), ("CLSTM", "CONCAT", "IFOX", False),
    ("CLSTM", "CONCAT", "ZR", False), ("CGRU", "CONCAT", "GFOI", False),
])
def test_config_validates_the_recurrent_layout(cell, merge, order, ok):
    """``[TPU] CLSTM_MERGE`` / ``CLSTM_GATE_ORDER`` as the config reads them:
    a valid layout builds the model's bottleneck, a bad one fails in
    ``validate()``, naming its key."""
    cfg = default_config(STAGE1_BOTTLENECK=cell, STAGE2_BOTTLENECK=cell, TRAIN_N_FRAMES=4,
                         TPU_CLSTM_MERGE=merge, TPU_CLSTM_GATE_ORDER=order.lower())
    if not ok:
        with pytest.raises(ValueError, match="CLSTM_MERGE" if merge == "MEAN" else "CLSTM_GATE_ORDER"):
            cfg.validate()
        return
    cfg.validate()
    spec = cfg.model_spec()
    assert (spec.clstm_merge, spec.clstm_gate_order) == (merge, order)
    with torch.device("meta"):
        net = stage_unets(spec)[0]
    assert isinstance(net.conv6, bottleneck.BiConvRNN) and net.conv6.merge == merge.lower()
