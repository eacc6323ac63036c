"""The port's ops (superslomo_tpu_torch.ops) against the JAX package's, on the
CPU, on the same numpy inputs. On a CPU tensor the port's warps run their plain
PyTorch versions (with PyTorch's autograd for the single-flow warp's
gradients), which are also what the CUDA kernels are held against on the
card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu import ops as jops
from superslomo_tpu_torch import ops as tops
from tests.test_torch_package import one_torch_thread  # noqa: F401

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


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_backward_warp_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 24, 40, 3)).astype(np.float32)
    flow = rng.normal(0.0, 6.0, (2, 24, 40, 2)).astype(np.float32)
    want = np.asarray(jops.backward_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = tops.warp_single_reference(_nchw(img), _nchw(flow)).permute(0, 2, 3, 1).numpy()
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


@pytest.mark.parametrize("channels_last", [False, True])
def test_upsample_in_batch_slices_equals_one_call(monkeypatch, channels_last):
    """An output beyond the CUDA kernels' 32-bit indexing is computed a batch
    slice at a time (here with the limit lowered to 2.5 samples): bit for
    bit the one-call result, in the input's memory format."""
    from superslomo_tpu_torch.ops import resize

    x = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 6, 7, 9)).astype(np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    want = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    monkeypatch.setattr(resize, "_MAX_ELEMENTS", 5 * 6 * 14 * 18 // 2)
    got = tops.upsample_2x_bilinear(x)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last


def test_upsample_under_autograd_matches_one_call():
    """Under autograd (training) the upsample is differentiable: the output
    and the input gradient are those of ``F.interpolate``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 4, 5, 7)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((3, 4, 10, 14)).astype(np.float32))
    got = tops.upsample_2x_bilinear(x)
    (got_grad,) = torch.autograd.grad(got, x, g)
    want = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    (want_grad,) = torch.autograd.grad(want, x, g)
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)


def _single_inputs(seed, B=2, C=3, H=23, W=37):
    """NHWC image and flow at a small odd shape; the flow leaves the frame
    (std 6 px, and a patch shifted 40 px)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = rng.normal(0.0, 6.0, (B, H, W, 2)).astype(np.float32)
    flow[:, H // 3 :, : W // 2, 0] += 40.0
    return img, flow


def test_warp_auto_matches_jax_backward_warp():
    img, flow = _single_inputs(6)
    want = np.asarray(jops.backward_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = tops.warp_auto(_nchw(img), _nchw(flow))
    assert got.shape == (2, 3, 23, 37) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=WARP_ATOL)
    # the channels_last slices the training step passes: the frames of a
    # pair and the flows of a stage head, as strided views
    pair = torch.from_numpy(np.concatenate([np.zeros_like(img), img], -1)).permute(0, 3, 1, 2)
    head = torch.from_numpy(np.concatenate([flow, np.zeros_like(flow)], -1)).permute(0, 3, 1, 2)
    assert pair[:, 3:6].stride(1) == 1 and head[:, 0:2].stride(3) == 4
    assert torch.equal(tops.warp_auto(pair[:, 3:6], head[:, 0:2]), got)


def test_warp_auto_gradients_match_jax_vjp():
    """Both gradients of the plain warp against JAX's VJP of its warp. The
    flow gradient carries zero through floor(), and taps outside the frame
    add nothing to either gradient."""
    img, flow = _single_inputs(7)
    g = np.random.default_rng(8).standard_normal(img.shape).astype(np.float32)
    _, vjp = jax.vjp(jops.backward_warp, jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    ti = _nchw(img).requires_grad_(True)
    tf = _nchw(flow).requires_grad_(True)
    tops.warp_auto(ti, tf).backward(_nchw(g))
    np.testing.assert_allclose(ti.grad.permute(0, 2, 3, 1).numpy(), want_img, rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), want_flow, rtol=0, atol=WARP_ATOL)
    outside = (np.abs(flow).max(-1) > 45)  # every tap of these pixels lies outside
    assert outside.any() and (want_flow[outside] == 0).all()


@functools.lru_cache(maxsize=1)
def _jax_warp_vjp():
    """The inputs, output gradient and JAX's VJP of its warp (NHWC) that the
    gradient tests share."""
    img, flow = _single_inputs(7)
    g = np.random.default_rng(8).standard_normal(img.shape).astype(np.float32)
    _, vjp = jax.vjp(jops.backward_warp, jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    return img, flow, g, want_img, want_flow


def _channels_last_slice(a, channels, first):
    """An NHWC array as channels ``first:first + C`` of a channels_last
    (B, channels, H, W) tensor (zeros elsewhere): the strided views of the
    train step."""
    B, H, W, C = a.shape
    parent = np.zeros((B, H, W, channels), np.float32)
    parent[..., first:first + C] = a
    return torch.from_numpy(parent).permute(0, 3, 1, 2)[:, first:first + C]


@pytest.mark.parametrize(
    "view", ["pair_slice", "head_slice", "grad_out_16_channel_slice", "grad_out_16_channel_nchw_slice"])
def test_warp_auto_gradients_through_step_views_match_jax_vjp(view):
    """Both gradients through the strided views the train step differentiates
    (ops/warp_plan.py plans the kernels for these layouts): the image a
    frame of a 6-channel pair, the flow one of a 4-channel head, the output
    gradient a slice of a 16-channel channels_last or NCHW tensor (the
    stage-2 input's gradient); against JAX's VJP of its warp on the same
    values."""
    img, flow, g, want_img, want_flow = _jax_warp_vjp()
    ti = (_channels_last_slice(img, 6, 3) if view == "pair_slice" else _nchw(img).clone()).requires_grad_(True)
    tf = (_channels_last_slice(flow, 4, 2) if view == "head_slice" else _nchw(flow).clone()).requires_grad_(True)
    tg = _nchw(g)
    if view == "grad_out_16_channel_slice":
        tg = _channels_last_slice(g, 16, 10)
    elif view == "grad_out_16_channel_nchw_slice":
        tg = torch.cat([torch.zeros_like(tg)] * 3 + [tg] + [torch.zeros_like(tg)] * 2, 1).contiguous()[:, 9:12]
    H, W = g.shape[1:3]
    strides = {"pair_slice": (ti, (1, 6)), "head_slice": (tf, (1, 4)), "grad_out_16_channel_slice": (tg, (1, 16)),
               "grad_out_16_channel_nchw_slice": (tg, (H * W, 1))}
    t, (sc, sx) = strides[view]
    assert (t.stride(1), t.stride(3)) == (sc, sx)
    tops.warp_auto(ti, tf).backward(tg)
    np.testing.assert_allclose(ti.grad.permute(0, 2, 3, 1).numpy(), want_img, rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), want_flow, rtol=0, atol=WARP_ATOL)


def test_warp_auto_bf16_store():
    """A bf16 image stores bf16: the f32 warp of the same image upcast, cast,
    bit for bit, and within one bf16 ulp of JAX's f32 warp cast to bf16."""
    img, flow = _single_inputs(9, H=32, W=64)
    ti, tf = _nchw(img).bfloat16(), _nchw(flow)
    got = tops.warp_auto(ti, tf)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), tops.warp_auto(ti.float(), tf).bfloat16().view(torch.int16))
    want = torch.from_numpy(np.array(jops.backward_warp(
        jnp.asarray(ti.float().permute(0, 2, 3, 1).numpy()), jnp.asarray(flow)))).permute(0, 3, 1, 2).bfloat16().float()
    mag = torch.maximum(got.float().abs(), want.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), torch.zeros_like(mag))
    assert bool(((got.float() - want).abs() <= ulp).all())


def test_max_pool_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 16, 24, 5)).astype(np.float32)
    got = tops.max_pool_2x2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.pooling.max_pool_2x2(jnp.asarray(x))))
    with pytest.raises(ValueError, match="even"):
        tops.max_pool_2x2(torch.zeros(1, 1, 5, 4))


@pytest.mark.parametrize("first", [0, 3], ids=["frame0", "frame1"])
def test_warp_multiflow_planar_reads_pair_slices_like_jax(first):
    """The planes the fused step passes: channels_last slices of its 6-channel
    pairs (pixel stride 6), held against the JAX package's planar warp on the
    same values; the result equals the warp of the same planes made dense."""
    rng = np.random.default_rng(20 + first)
    B, n, H, W = 2, 7, 32, 32
    pair = torch.from_numpy(rng.standard_normal((B, H, W, 6)).astype(np.float32)).permute(0, 3, 1, 2)
    planes = pair[:, first:first + 3]
    assert planes.stride()[1:] == (1, 6 * W, 6)
    u, v = _flows(rng, B, n, H, W, big=True)
    want = np.asarray(jops.warp_multiflow_planar(jnp.asarray(planes.contiguous().numpy()), jnp.asarray(u),
                                                 jnp.asarray(v)))
    got = tops.warp_multiflow_planar(planes, torch.from_numpy(u), torch.from_numpy(v))
    assert got.shape == (B, 3, n, H, W) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
    dense = tops.warp_multiflow_planar(planes.contiguous(), torch.from_numpy(u), torch.from_numpy(v))
    assert torch.equal(got, dense)


def _pair_views(B=2, H=32, W=32):
    """The layouts the step hands the single-flow warp, as CPU tensors."""
    pair = torch.zeros(B, H, W, 6).permute(0, 3, 1, 2)
    head = torch.zeros(B, H, W, 4).permute(0, 3, 1, 2)
    images = {
        "pixel_stride_6": pair[:, 3:6],  # a frame of the pair, f32
        "pixel_stride_3": pair[:, 3:6].to(torch.bfloat16),  # that frame cast: dense channels_last
        "nchw": pair[:, 3:6].contiguous(),
    }
    flows = {
        "pixel_stride_4": head[:, 0:2],  # a flow of the stage-1 head
        "pixel_stride_2": head[:, 0:2] + head[:, 2:4],  # est + residual: dense channels_last
        "nchw": head[:, 0:2].contiguous(),
    }
    return images, flows


_IMAGES, _FLOWS = _pair_views()


@pytest.mark.parametrize("flow_name", list(_FLOWS))
@pytest.mark.parametrize("img_name", list(_IMAGES))
def test_single_flow_plan(img_name, flow_name):
    """The forward kernel's plan for each layout the step passes: one 8-byte
    load a pixel for adjacent (u, v), PX-wide loads for planar flows; a
    channels_last output through a shared tile of rows that needs no
    shared-memory opt-in, a planar one in PX-wide stores."""
    from superslomo_tpu_torch.ops import warp_plan as wp
    from superslomo_tpu_torch.ops.warp_single_cuda import _like

    img, flow = _IMAGES[img_name], _FLOWS[flow_name]
    B, C, H, W = img.shape
    assert flow.stride(3) == {"pixel_stride_4": 4, "pixel_stride_2": 2, "nchw": 1}[flow_name]
    out = _like(img, C, img.dtype)
    plan = wp.plan_single(wp.layout(flow), wp.layout(out), C, W)
    assert wp.TILE_W * wp.TILE_H // wp.PX % 32 == 0
    channels_last = img_name != "nchw"
    assert plan.flow_mode == (wp.FLOW_PLANAR_VEC if flow_name == "nchw" else wp.FLOW_PAIR)
    assert plan.out_mode == (wp.OUT_ROWS if channels_last else wp.OUT_PLANAR_VEC)
    tile_bytes = wp.TILE_W * wp.TILE_H * C * img.element_size()
    assert plan.smem == (tile_bytes if channels_last else 0) <= wp.SMEM_DEFAULT
    assert list(wp.as_ints(plan)) == list(plan)


@pytest.mark.parametrize("img_name", list(_IMAGES))
def test_multiflow_plan(img_name):
    """The multi-flow kernel's plan for the planes the step passes (the pair
    slice in f32, that slice cast to bf16, NCHW): u and v and the (B, C, n,
    H, W) output PX-wide, and no shared memory; the planes are read in place
    through their strides whatever their layout."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    planes = _IMAGES[img_name]
    B, C, H, W = planes.shape
    u = torch.zeros(B, 7, H, W)
    out = torch.empty(B, C, 7, H, W, dtype=planes.dtype)
    out_layout = wp.Layout((out.stride(0), out.stride(2), out.stride(3), out.stride(4)), out.data_ptr() % 16,
                           out.element_size())
    plan = wp.plan_multiflow(wp.layout(u), wp.layout(u), out_layout, W)
    assert plan == wp.Plan(wp.FLOW_PLANAR_VEC, wp.OUT_PLANAR_VEC, 0)


@pytest.mark.parametrize("C,dtype", [(3, torch.float32), (24, torch.float32), (25, torch.float32),
                                     (48, torch.bfloat16), (49, torch.bfloat16)])
def test_single_flow_plan_row_tile_fits_default_smem(C, dtype):
    """The channels_last output goes through the shared row tile only while
    the tile (64 x 8 pixels of C values) fits 48 KB, the shared memory a
    launch may take without an opt-in; beyond that each thread stores its
    own pixels."""
    from superslomo_tpu_torch.ops import warp_plan as wp
    from superslomo_tpu_torch.ops.warp_single_cuda import _like

    img = torch.zeros(1, 32, 32, C, dtype=dtype).permute(0, 3, 1, 2)
    flow = torch.zeros(1, 2, 32, 32)
    plan = wp.plan_single(wp.layout(flow), wp.layout(_like(img, C, dtype)), C, 32)
    tile_bytes = wp.TILE_W * wp.TILE_H * C * img.element_size()
    fits = tile_bytes <= wp.SMEM_DEFAULT
    assert fits == (C <= (24 if dtype == torch.float32 else 48))
    assert (plan.out_mode, plan.smem) == ((wp.OUT_ROWS, tile_bytes) if fits else (wp.OUT_SCALAR, 0))


def test_plans_fall_back_to_scalar_access():
    """Where a layout allows no vector access the plans read and write one
    element at a time: a width that the pixels of a thread do not divide, an
    (u, v) pair off 8-byte alignment, strides that hold another width."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    W = 33
    planar = wp.Layout((3 * 32 * W, 32 * W, W, 1), 0, 4)
    flow = wp.Layout((2 * 32 * W, 32 * W, W, 1), 0, 4)
    odd_pair = wp.Layout((4 * 32 * W, 1, 4 * W, 4), 4, 4)  # (u, v) not 8-byte aligned
    assert wp.flow_mode(flow, W) == wp.FLOW_SCALAR
    assert wp.flow_mode(flow, 32) == wp.FLOW_SCALAR  # the strides hold W = 33
    assert wp.flow_mode(odd_pair, W) == wp.FLOW_SCALAR
    assert wp.flow_mode(odd_pair._replace(ptr=8), W) == wp.FLOW_PAIR
    dense = wp.Layout((2 * 32 * 32, 32 * 32, 32, 1), 0, 4)
    assert wp.flow_mode(dense, 32) == wp.FLOW_PLANAR_VEC
    assert wp.flow_mode(dense._replace(ptr=4), 32) == wp.FLOW_SCALAR  # u off 8-byte alignment
    plan = wp.plan_single(flow, planar, 3, W)
    assert (plan.flow_mode, plan.out_mode) == (wp.FLOW_SCALAR, wp.OUT_SCALAR)
    plan = wp.plan_multiflow(flow, flow, planar, W)
    assert (plan.flow_mode, plan.out_mode) == (wp.FLOW_SCALAR, wp.OUT_SCALAR)


def _grad_views(dtype=torch.float32, B=2, H=32, W=32):
    """The (flow, output gradient) layouts of the train step's backward
    launches, as CPU tensors: the flow a head's (pixel stride 4), a dense
    channels_last sum (2) or NCHW; the output gradient NCHW (the warp
    losses), a slice of the NCHW gradient of the 16-channel stage-2 input at
    either of its warp channels, or dense channels_last (the final warps'
    blend)."""
    head = torch.zeros(B, H, W, 4).permute(0, 3, 1, 2)
    stage2 = torch.zeros(B, 16, H, W, dtype=dtype)
    flows = {"pixel_stride_4": head[:, 0:2], "pixel_stride_2": head[:, 0:2] + head[:, 2:4],
             "nchw": head[:, 0:2].contiguous()}
    grads = {"nchw": torch.zeros(B, 3, H, W, dtype=dtype), "stage2_slice_3": stage2[:, 3:6],
             "stage2_slice_10": stage2[:, 10:13],
             "pixel_stride_3": torch.zeros(B, H, W, 3, dtype=dtype).permute(0, 3, 1, 2)}
    return flows, grads


_GRAD_FLOWS, _GRAD_OUTS = _grad_views()


@pytest.mark.parametrize("grad_name", list(_GRAD_OUTS))
@pytest.mark.parametrize("flow_name", list(_GRAD_FLOWS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_plans(flow_name, grad_name, dtype):
    """The gradient kernels' plans for each layout the train step passes.
    The flow gradient's threads own pixels 32 apart: (u, v) in one 8-byte
    load and (du, dv) in one 8-byte store a pixel where the pair is adjacent
    (channels_last), by element where NCHW; the output gradient by element.
    The image gradient's threads own adjacent pixels: its output gradient
    PX-wide where planar (NCHW and the stage-2 input's slices), by element
    where channels_last."""
    from superslomo_tpu_torch.ops import warp_plan as wp
    from superslomo_tpu_torch.ops.warp_single_cuda import _like

    flows, grads = _grad_views(dtype)
    flow, g = flows[flow_name], grads[grad_name]
    assert g.dtype == dtype
    W = g.shape[3]
    grad_flow = _like(flow, 2, torch.float32)
    plan = wp.plan_flow_grad(wp.layout(flow), wp.layout(grad_flow))
    pair = wp.FLOW_SCALAR if flow_name == "nchw" else wp.FLOW_PAIR
    assert plan == wp.GradPlan(pair, wp.IN_SCALAR, wp.OUT_SCALAR if flow_name == "nchw" else wp.OUT_PAIR)
    img_plan = wp.plan_img_grad(wp.layout(flow), wp.layout(g), W)
    assert img_plan.flow_mode == (wp.FLOW_PLANAR_VEC if flow_name == "nchw" else wp.FLOW_PAIR)
    assert img_plan.grad_mode == (wp.IN_SCALAR if grad_name == "pixel_stride_3" else wp.IN_PLANAR_VEC)
    assert img_plan.out_mode == wp.OUT_SCALAR
    assert list(wp.as_ints(plan)) == list(plan)


def test_gradient_plans_fall_back_for_ragged_and_misaligned_layouts():
    """Where a layout allows no vector access the gradient plans read and
    write by element: an odd width (37x53, ragged tiles), a flow, flow
    gradient or output gradient off its vector alignment."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    H, W = 37, 53
    flow_nchw = wp.Layout((2 * H * W, H * W, W, 1), 0, 4)
    g_nchw = wp.Layout((3 * H * W, H * W, W, 1), 0, 4)
    pair = wp.Layout((2 * H * W, 1, 2 * W, 2), 0, 4)  # (du, dv) of an odd width: 8-byte aligned pairs
    assert wp.plan_img_grad(flow_nchw, g_nchw, W) == wp.GradPlan(wp.FLOW_SCALAR, wp.IN_SCALAR, wp.OUT_SCALAR)
    assert wp.plan_flow_grad(flow_nchw, flow_nchw) == wp.GradPlan(wp.FLOW_SCALAR, wp.IN_SCALAR, wp.OUT_SCALAR)
    assert wp.plan_flow_grad(pair, pair) == wp.GradPlan(wp.FLOW_PAIR, wp.IN_SCALAR, wp.OUT_PAIR)
    assert wp.plan_flow_grad(pair._replace(ptr=4), pair._replace(ptr=12)) == wp.GradPlan(
        wp.FLOW_SCALAR, wp.IN_SCALAR, wp.OUT_SCALAR)
    head = wp.Layout((4 * H * W, 1, 4 * W, 4), 8, 4)  # a head's second flow: offset 2 values
    assert wp.plan_flow_grad(head, pair) == wp.GradPlan(wp.FLOW_PAIR, wp.IN_SCALAR, wp.OUT_PAIR)
    g_even = wp.Layout((16 * 32 * 32, 32 * 32, 32, 1), 4, 4)  # a stage-2 slice off PX-element alignment
    assert wp.grad_mode(g_even, 32) == wp.IN_SCALAR
    assert wp.grad_mode(g_even._replace(ptr=8), 32) == wp.IN_PLANAR_VEC
    assert wp.grad_mode(g_even._replace(ptr=8, esize=2), 32) == wp.IN_PLANAR_VEC  # bf16: 4-byte pairs
    assert wp.grad_mode(g_even._replace(ptr=2, esize=2), 32) == wp.IN_SCALAR


@pytest.mark.parametrize("C,H,W,fits", [(3, 224, 224, True), (16, 736, 1280, True), (3, 4320, 7680, True),
                                        (3, 30000, 30000, False)])
def test_flow_grad_offsets_fit_int32(C, H, W, fits):
    """The flow-gradient kernel indexes inside one image with 32-bit ints:
    every shape the system runs fits, channels_last or NCHW, and an image
    beyond 2^31 elements does not (the wrapper raises for it)."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    nchw = (C * H * W, H * W, W, 1)
    channels_last = (C * H * W, 1, C * W, C)
    assert wp.offsets_fit_int32(nchw, C, H, W) == fits
    assert wp.offsets_fit_int32(channels_last, C, H, W) == fits


@pytest.mark.parametrize("C", [1, 3, 4, 6])
def test_multiflow_grad_plan(C):
    """The multi-flow backward's plan: its tile is whole warps along x, two
    rows a thread, within the kernel's block size; the window (the tile, the
    margin on each side and one more column and row) holds min(C, 4) f32
    channels (a block sums one group of 4) and fits a block's default shared
    memory; the plan passes as its 4 ints."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    plan = wp.plan_multiflow_grad(C)
    tile_w, tile_h = wp.MF_GRAD_TILE
    assert (plan.tile_w, plan.tile_h, plan.margin) == (tile_w, tile_h, wp.MF_GRAD_MARGIN)
    assert tile_w % 32 == 0 and tile_h % 2 == 0 and tile_w * tile_h // 2 <= wp.MF_GRAD_THREADS
    window = (tile_w + 2 * plan.margin + 1) * (tile_h + 2 * plan.margin + 1)
    assert wp.mf_grad_window(wp.MF_GRAD_TILE, wp.MF_GRAD_MARGIN) == window
    assert plan.smem == min(C, 4) * window * 4 <= wp.SMEM_DEFAULT
    assert list(wp.as_ints(plan)) == list(plan) and len(plan) == 4


@pytest.mark.parametrize("tile,margin,match", [((48, 8), 4, "whole warps"), ((64, 7), 4, "whole warps"),
                                               ((64, 16), 4, "whole warps"), ((64, 8), 40, "exceeds")])
def test_multiflow_grad_plan_refuses_what_the_kernel_does_not_take(monkeypatch, tile, margin, match):
    """A tile that is not whole warps along x (48 columns), an odd height, a
    block of more threads than the kernel's launch bound (64x16: 512), or a
    window beyond the default shared memory raises instead of launching."""
    from superslomo_tpu_torch.ops import warp_plan as wp

    monkeypatch.setattr(wp, "MF_GRAD_TILE", tile)
    monkeypatch.setattr(wp, "MF_GRAD_MARGIN", margin)
    wp.plan_multiflow_grad.cache_clear()
    try:
        with pytest.raises(ValueError, match=match):
            wp.plan_multiflow_grad(3)
    finally:
        wp.plan_multiflow_grad.cache_clear()


# the multi-flow warp's gradients: f32 sums of a few products per tap over n
# flows, in another order than XLA's; 1e-5 of each gradient's largest value
MF_GRAD_REL = 1e-5


@functools.lru_cache(maxsize=1)
def _jax_multiflow_vjp():
    """Inputs (B=2, C=3, n=3, 19x24; flows beyond the frame), an output
    gradient, and JAX's VJP of ``ops.warp_multiflow_planar`` on the CPU (the
    XLA warp that the Pallas kernel's custom VJP differentiates) in f32."""
    rng = np.random.default_rng(21)
    B, C, n, H, W = 2, 3, 3, 19, 24
    planes = rng.standard_normal((B, C, H, W)).astype(np.float32)
    u, v = _flows(rng, B, n, H, W, big=False)
    u[:, :, : H // 2, : W // 3] += 30.0  # taps outside the frame
    g = rng.standard_normal((B, C, n, H, W)).astype(np.float32)
    _, vjp = jax.vjp(jops.warp_multiflow_planar, *(jnp.asarray(a) for a in (planes, u, v)))
    return (planes, u, v, g), tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


def _assert_mf_grads(got, want, names=("planes", "u", "v"), extra=None):
    for name, a, w in zip(names, got, want):
        bar = MF_GRAD_REL * np.abs(w).max() + (0.0 if extra is None or name != "planes" else extra(w))
        err = np.abs(a.detach().float().numpy() - w)
        assert (err <= bar).all(), (name, err.max(), np.abs(w).max())


def test_warp_multiflow_planar_gradients_match_jax_vjp():
    """The plain multi-flow warp's gradients (planes, u, v) by PyTorch's
    autograd against JAX's VJP, f32."""
    (planes, u, v, g), want = _jax_multiflow_vjp()
    args = [torch.from_numpy(a).requires_grad_(True) for a in (planes, u, v)]
    tops.warp_multiflow_planar(*args).backward(torch.from_numpy(g))
    _assert_mf_grads([a.grad for a in args], want)
    assert (want[1] == 0).any()  # the outside taps carry no flow gradient


@functools.lru_cache(maxsize=1)
def _jax_multiflow_vjp_bf16():
    """JAX's f32 VJP (``_mfu_p_bwd``'s) at the inputs of ``_jax_multiflow_vjp``
    with the planes and the output gradient rounded to bf16 (their exact
    values upcast)."""
    (planes, u, v, g), _ = _jax_multiflow_vjp()
    p16 = torch.from_numpy(planes).bfloat16().float().numpy()
    g16 = torch.from_numpy(g).bfloat16().float().numpy()
    _, vjp = jax.vjp(jops.warp_multiflow_planar, *(jnp.asarray(a) for a in (p16, u, v)))
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g16)))


_NEEDS = {"all": (True, True, True), "flows": (False, True, True), "planes": (True, False, False)}
_BF16_ROUNDING = lambda w: 2.0**-8 * np.abs(w)  # noqa: E731  half a bf16 ulp: the one rounding of the planes' gradient


@pytest.mark.parametrize("needs", list(_NEEDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_multiflow_backward_reference_matches_jax_vjp(needs, dtype):
    """The plain version of the backward kernel, asked for all three
    gradients, the flows' alone or the planes' alone, against JAX's VJP of
    ``warp_multiflow_planar`` (flows beyond the frame). bf16 planes and
    output gradient: JAX's f32 VJP of their values, the planes' gradient
    rounded once to bf16."""
    (planes, u, v, g), want = _jax_multiflow_vjp()
    if dtype == torch.bfloat16:
        want = _jax_multiflow_vjp_bf16()
    need_planes, need_flow, _ = _NEEDS[needs]
    got = tops.warp_multiflow_backward_reference(
        torch.from_numpy(planes).to(dtype), torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(g).to(dtype), need_planes, need_flow)
    asked = [need_planes, need_flow, need_flow]
    assert [x is not None for x in got] == asked
    if need_planes:
        assert got[0].dtype == dtype and got[0].shape == planes.shape
    if need_flow:
        assert got[1].dtype == got[2].dtype == torch.float32 and got[1].shape == u.shape
    names = [name for name, need in zip(("planes", "u", "v"), asked) if need]
    _assert_mf_grads([x for x in got if x is not None], [w for w, need in zip(want, asked) if need], names,
                     extra=_BF16_ROUNDING if dtype == torch.bfloat16 else None)


def _plain_multiflow_backward(calls):
    """A stand-in for ``warp_multiflow_backward_cuda`` that takes CPU tensors:
    its plain version, with the wrapper's counts (one kernel launch a call; 3
    device operations with the planes' gradient, else 1); ``calls`` records
    each call's planes and output gradient layouts and the gradients asked
    for."""
    def bwd(planes, u, v, grad_out, need_planes, need_flow):
        calls.append((tuple(planes.stride()), planes.dtype, tuple(grad_out.stride()), grad_out.dtype,
                      need_planes, need_flow))
        bwd.launches += 1
        bwd.operations += 3 if need_planes else 1
        return tops.warp_multiflow_backward_reference(planes, u, v, grad_out, need_planes, need_flow)
    bwd.launches = bwd.operations = 0
    return bwd


@pytest.mark.parametrize("needs", ["all", "flows", "planes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_multiflow_function_backward_matches_jax_vjp(monkeypatch, needs, dtype):
    """The card's autograd.Function for the multi-flow warp, on CPU tensors
    with its kernel wrappers replaced by their plain versions: its backward,
    one call of the backward kernel for all n flows, against JAX's VJP. The
    planes (a channels_last pair slice) and the output gradient reach the
    kernel as they are, bf16 included (no upcast copy): bf16 planes are
    differentiated as the f32 warp of the planes upcast for the output
    gradient upcast (JAX's ``_mfu_p_bwd``), so their gradient is JAX's f32
    one rounded once to bf16 (half a bf16 ulp, at most 2^-8 of the value,
    beyond the f32 bar). One kernel launch whatever n: 3 device operations
    with the planes' gradient, 1 without, and only the gradients asked for."""
    (planes, u, v, g), want = _jax_multiflow_vjp()
    n = u.shape[1]
    needs = _NEEDS[needs]
    # the planes as the step passes them: a channels_last pair slice
    pair = torch.from_numpy(np.concatenate([np.zeros_like(planes), planes], 1)).to(dtype)
    pair = pair.contiguous(memory_format=torch.channels_last)
    calls = []
    monkeypatch.setattr(tops, "warp_multiflow_planar_cuda",
                        lambda p, uu, vv: tops.warp_multiflow_planar_reference(p, uu, vv, p.dtype))
    monkeypatch.setattr(tops, "warp_multiflow_backward_cuda", _plain_multiflow_backward(calls))
    if dtype == torch.bfloat16:  # JAX's f32 VJP of the bf16 planes' values
        want = _jax_multiflow_vjp_bf16()
    leaves = [pair.requires_grad_(needs[0]), torch.from_numpy(u).requires_grad_(needs[1]),
              torch.from_numpy(v).requires_grad_(needs[2])]
    out = tops._WarpMultiflow.apply(leaves[0][:, 3:6], leaves[1], leaves[2])
    assert out.dtype == dtype and out.shape == (2, 3, n, 19, 24)
    monkeypatch.setattr(tops._WarpMultiflow, "launches", 0)
    out.backward(torch.from_numpy(g).to(dtype))

    got = [leaves[0].grad[:, 3:6] if needs[0] else None, leaves[1].grad, leaves[2].grad]
    asked = [(name, x, w) for name, x, w, need in zip(("planes", "u", "v"), got, want, needs) if need]
    assert all(x is None for x, need in zip(got, needs) if not need)
    _assert_mf_grads([x for _, x, _ in asked], [w for _, _, w in asked], [name for name, _, _ in asked],
                     extra=_BF16_ROUNDING if dtype == torch.bfloat16 else None)
    if needs[0]:
        assert leaves[0].grad.dtype == dtype and not leaves[0].grad[:, 0:3].any()
    # one kernel call for all n flows, the fixed count of device operations;
    # the planes read in place (the pair's strides) and the output gradient as
    # autograd hands it, both in the planes' dtype
    assert len(calls) == 1 and tops._WarpMultiflow.launches == (3 if needs[0] else 1)
    assert calls[0] == (tuple(pair.stride()), dtype, (3 * n * 19 * 24, n * 19 * 24, 19 * 24, 24, 1), dtype,
                        needs[0], needs[1] or needs[2])
