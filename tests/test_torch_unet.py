"""The port's U-Net (superslomo_tpu_torch.models.unet) against the JAX
package's UNet.apply, on the CPU, with the same weights carried through
superslomo_tpu_torch.weights.torch_state_from_jax. JAX runs under ``jax.jit``,
which compiles faster than the eager per-op programs (11 s against 19 s for
stage 1 on an 8-core x86 host)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu.models.unet import UNet as JaxUNet
from superslomo_tpu_torch import weights
from superslomo_tpu_torch.models.unet import UNet
from tests.test_torch_package import one_torch_thread  # noqa: F401

# the U-Net bar of the JAX package against the executed reference: f32 conv
# reassociation (XLA vs oneDNN) over the 24-conv stack
ATOL, RTOL = 2e-4, 1e-3
B, H, W = 2, 64, 64


def _fill(shapes, rng):
    """A JAX param-shape tree filled with fan-in-scaled normals (kernels,
    HWIO) and small normal biases."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def stages():
    """Both stages' JAX modules and numpy params (shapes by jax.eval_shape)."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    s1 = JaxUNet(out_channels=4, emit_encoding=True)
    s2 = JaxUNet(out_channels=5, accept_encoding=True)
    x1 = jax.ShapeDtypeStruct((B, 1, H, W, 6), jnp.float32)
    x2 = jax.ShapeDtypeStruct((B, 1, H, W, 16), jnp.float32)
    enc = jax.ShapeDtypeStruct((B, 1, H // 32, W // 32, 512), jnp.float32)
    p1 = _fill(jax.eval_shape(s1.init, key, x1)["params"], rng)
    p2 = _fill(jax.eval_shape(s2.init, key, x2, enc)["params"], rng)
    state = weights.torch_state_from_jax({"params": {"stage1": p1, "stage2": p2}})
    return (s1, p1), (s2, p2), state


def test_stage1_matches_jax(stages):
    (s1, p1), _, state = stages
    x = np.random.default_rng(1).standard_normal((B, 1, H, W, 6)).astype(np.float32)
    want, want_enc, _ = jax.jit(s1.apply)({"params": p1}, jnp.asarray(x))

    net = UNet(6, 4, emit_encoding=True).eval()
    net.load_state_dict(state["stage1"])
    with torch.no_grad():
        out, enc, carry = net(torch.from_numpy(x[:, 0]).permute(0, 3, 1, 2))
    assert carry is None
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(want)[:, 0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(enc.permute(0, 2, 3, 1).numpy(), np.asarray(want_enc)[:, 0], atol=ATOL, rtol=RTOL)


def test_stage2_cross_encoding_matches_jax(stages):
    _, (s2, p2), state = stages
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, H, W, 16)).astype(np.float32)
    enc = rng.standard_normal((B, 1, H // 32, W // 32, 512)).astype(np.float32)
    want, _, _ = jax.jit(s2.apply)({"params": p2}, jnp.asarray(x), jnp.asarray(enc))

    net = UNet(16, 5, accept_encoding=True).to(memory_format=torch.channels_last).eval()
    net.load_state_dict(state["stage2"])
    with torch.no_grad():
        out, none, carry = net(
            torch.from_numpy(x[:, 0]).permute(0, 3, 1, 2),
            torch.from_numpy(enc[:, 0]).permute(0, 3, 1, 2),
        )
    assert none is None and carry is None and net.conv7a[0].in_channels == 1024
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(want)[:, 0], atol=ATOL, rtol=RTOL)


def test_converter_key_set(stages):
    (_, p1), (_, p2), state = stages
    expected = set(UNet(6, 4).state_dict())
    assert set(state["stage1"]) == set(state["stage2"]) == expected
    assert {"conv1a.0.weight", "conv6.0.0.weight", "conv6.1.0.bias", "final_conv.weight"} <= expected
    k = p1["conv1a"]["conv"]["kernel"]
    np.testing.assert_array_equal(state["stage1"]["conv1a.0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    assert tuple(state["stage2"]["conv7a.0.weight"].shape) == (512, 1024, 3, 3)


def test_converter_rejects_unknown_and_missing_keys(stages):
    (_, p1), (_, p2), _ = stages
    unknown = dict(p1, mystery={"conv": dict(p1["conv1a"]["conv"])})
    with pytest.raises(KeyError, match="mystery"):
        weights.torch_state_from_jax({"params": {"stage1": unknown, "stage2": p2}})
    missing = {k: v for k, v in p2.items() if k != "fuse_conv"}
    with pytest.raises(KeyError, match="fuse_conv"):
        weights.torch_state_from_jax({"params": {"stage1": p1, "stage2": missing}})
