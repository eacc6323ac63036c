"""The port's ops (superslomo_tpu_torch.ops) against the JAX package's, on the
CPU, on the same numpy inputs. On a CPU tensor the port's multi-flow warp runs
its plain PyTorch version, which is also what the CUDA kernel is held against
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu import ops as jops
from superslomo_tpu_torch import ops as tops

# f32 gathers and four products summed in the same order; the two frameworks
# may round the position x + u differently only through op fusion, so the
# bar is a few f32 ulps of O(1) images
WARP_ATOL = 1e-5


def _flows(rng, B, n, H, W, big):
    """u, v (B, n, H, W) f32: smooth-ish flows with std 7 px, plus (when
    ``big``) a patch shifted by more than 128 px and uniform noise up to
    ±200 px, beyond the Pallas kernel's band."""
    u = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    v = rng.normal(0.0, 7.0, (B, n, H, W)).astype(np.float32)
    if big:
        u[:, :, H // 4 : H // 2, W // 4 : W // 2] += 150.0
        v[:, :, H // 2 :, : W // 3] -= 140.0
        mask = rng.random((B, n, H, W)) < 0.1
        u[mask] = rng.uniform(-200, 200, mask.sum()).astype(np.float32)
        v[mask] = rng.uniform(-200, 200, mask.sum()).astype(np.float32)
    return u, v


def test_backward_warp_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 24, 40, 3)).astype(np.float32)
    flow = rng.normal(0.0, 6.0, (2, 24, 40, 2)).astype(np.float32)
    want = np.asarray(jops.backward_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = tops.backward_warp(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize(
    "n,H,W,big",
    [(1, 32, 48, False), (3, 32, 48, False), (7, 32, 48, False), (7, 160, 288, True)],
)
def test_warp_multiflow_planar_matches_jax(n, H, W, big):
    rng = np.random.default_rng(n + H)
    B, C = 2, 3
    planes = rng.standard_normal((B, C, H, W)).astype(np.float32)
    u, v = _flows(rng, B, n, H, W, big)
    if big:
        assert np.abs(u).max() > 190 and np.abs(v).max() > 190
    want = np.asarray(jops.warp_multiflow_planar(jnp.asarray(planes), jnp.asarray(u), jnp.asarray(v)))
    got = tops.warp_multiflow_planar(*(torch.from_numpy(a) for a in (planes, u, v))).numpy()
    assert got.shape == (B, C, n, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def test_warp_multiflow_planar_bf16_store():
    """bf16 planes store bf16: the f32 warp of the same planes upcast, cast, bit
    for bit, and within one bf16 ulp of JAX's f32 warp cast to bf16 (JAX's own
    CPU bf16 path computes in bf16, which is not the kernel's contract, so it
    is not compared)."""
    rng = np.random.default_rng(3)
    B, C, n, H, W = 2, 3, 7, 32, 64
    planes = torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32)).bfloat16()
    u, v = (torch.from_numpy(a) for a in _flows(rng, B, n, H, W, big=True))

    got = tops.warp_multiflow_planar(planes, u, v, out_dtype=torch.bfloat16)
    f32 = tops.warp_multiflow_planar(planes.float(), u, v)
    assert got.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(got.view(torch.int16), f32.bfloat16().view(torch.int16))

    want = torch.from_numpy(np.array(jops.warp_multiflow_planar(
        jnp.asarray(planes.float().numpy()), jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
    ))).bfloat16().float()
    mag = torch.maximum(got.float().abs(), want.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), torch.zeros_like(mag))
    assert bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("pdt,out_dtype", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_warp_multiflow_planar_stores_planes_dtype(pdt, out_dtype):
    """The warp stores the planes' dtype; asking for another one raises, on
    the CPU as on the card."""
    planes = torch.zeros((1, 3, 8, 8), dtype=pdt)
    flow = torch.zeros((1, 2, 8, 8))
    assert tops.warp_multiflow_planar(planes, flow, flow).dtype == pdt
    with pytest.raises(ValueError, match="planes' dtype"):
        tops.warp_multiflow_planar(planes, flow, flow, out_dtype=out_dtype)


def test_avg_pool_and_upsample_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 24, 5)).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view
    pool = tops.avg_pool_2x2(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(pool, np.asarray(jops.avg_pool_2x2(jnp.asarray(x))), rtol=0, atol=1e-6)
    up = tops.upsample_2x_bilinear(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(up, np.asarray(jops.upsample_2x_bilinear(jnp.asarray(x))), rtol=0, atol=1e-6)
