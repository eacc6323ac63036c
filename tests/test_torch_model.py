"""The port's fused multi-t step (SuperSloMo.interpolate_multi_t) against the
JAX package's, on the CPU, with the same weights and frames. JAX runs its plain
CPU warp under ``jax.jit``: on an 8-core x86 host the eager step compiles ~750
single-op programs and takes 45 s a dtype, the jitted one 18 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu.config import ModelSpec as JaxModelSpec
from superslomo_tpu.models.superslomo import SuperSloMo as JaxSuperSloMo
from superslomo_tpu_torch import weights
from superslomo_tpu_torch.config import ModelSpec
from superslomo_tpu_torch.models import superslomo as port_model
from superslomo_tpu_torch.models.superslomo import SuperSloMo

FRAMES = np.random.default_rng(0).standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
T_VALUES = np.array([0.25, 0.5, 0.75], np.float32)


def _fill(shapes, rng):
    """A JAX param-shape tree filled with fan-in-scaled normals (kernels,
    HWIO) and small normal biases."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def params():
    shapes = jax.eval_shape(
        JaxSuperSloMo(spec=JaxModelSpec()).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct(FRAMES.shape, jnp.float32), jax.ShapeDtypeStruct((2, 1), jnp.float32),
    )
    return _fill(shapes, np.random.default_rng(1))


def _jax_step(params, dtype):
    model = JaxSuperSloMo(spec=JaxModelSpec(compute_dtype=dtype))
    step = jax.jit(lambda p, f, t: model.apply(
        p, f, t, with_bounds=True, method=JaxSuperSloMo.interpolate_multi_t))
    pred, bound = step(params, jnp.asarray(FRAMES), jnp.asarray(T_VALUES))
    return np.asarray(pred), float(bound)


@pytest.fixture(scope="module")
def jax_f32(params):
    return _jax_step(params, "float32")


@pytest.fixture(scope="module")
def jax_bf16(params):
    return _jax_step(params, "bfloat16")


def _port_step(params, dtype, monkeypatch=None):
    """Run the port; with ``monkeypatch``, also record each warp's dtypes."""
    calls = []
    if monkeypatch is not None:
        warp = port_model.warp_multiflow_planar

        def recording_warp(planes, u, v, out_dtype=None):
            out = warp(planes, u, v, out_dtype=out_dtype)
            calls.append((planes.dtype, u.dtype, out.dtype))
            return out

        monkeypatch.setattr(port_model, "warp_multiflow_planar", recording_warp)
    model = SuperSloMo(ModelSpec(compute_dtype=dtype), device="cpu")
    model.load_state(weights.torch_state_from_jax(params))
    pred, bound = model.interpolate_multi_t(torch.from_numpy(FRAMES), torch.from_numpy(T_VALUES), with_bounds=True)
    return pred, bound, calls


def test_multi_t_f32_matches_jax(params, jax_f32):
    want, want_bound = jax_f32
    pred, bound, _ = _port_step(params, "float32")
    assert pred.shape == (2, 3, 32, 32, 3) and pred.dtype == torch.float32
    assert bound.dtype == torch.float32 and bound.dim() == 0
    # the full-model bar of the JAX package against the executed reference
    np.testing.assert_allclose(pred.numpy(), want, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(float(bound), want_bound, rtol=1e-4)


def test_multi_t_bf16_matches_jax(params, jax_f32, jax_bf16, monkeypatch):
    """bf16 compute: the two frameworks round the 48 bf16 convs differently
    (oneDNN's f32 accumulation and bias add vs XLA's), and JAX's CPU warp of
    the stage-2 input computes in bf16 where the port accumulates in f32. On
    these inputs (|pred| ≤ 2.7) the port's bf16 output lies within 0.056 of
    JAX's bf16 output (mean 0.005), while JAX's own bf16 output lies within
    0.079 of its f32 output. The bar is therefore set from the dtype, not
    from the port: 0.1 at most, 0.01 on average, and no further from JAX's
    bf16 result than JAX's bf16 result is from its f32 one."""
    want, want_bound = jax_bf16
    pred, bound, calls = _port_step(params, "bfloat16", monkeypatch)
    err = np.abs(pred.numpy() - want)
    assert err.max() <= 0.1 and err.mean() <= 0.01
    assert err.max() <= np.abs(want - jax_f32[0]).max()
    np.testing.assert_allclose(float(bound), want_bound, rtol=1e-2)  # one bf16 ulp: 2^-7

    # quantization points: stage-2 input warps bf16 in and out, final warps
    # and the output f32; the flows are always f32
    bf16, f32 = torch.bfloat16, torch.float32
    assert calls == [(bf16, f32, bf16)] * 2 + [(f32, f32, f32)] * 2
    assert pred.dtype == f32 and bound.dtype == f32
