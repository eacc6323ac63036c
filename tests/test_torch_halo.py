"""Height sharding for serving on the CPU: four gloo ranks on a (2 x 2)
(data, spatial) grid, spawned once for the module, each on one torch thread,
run the layers, the warps, the fused step and the Evaluator with each
frame's rows split over the two spatial ranks of their data row; this
process holds what they return against the one-process port on the same
numpy inputs, and the warps and the f32 step against the JAX package. The
grid's rules, ``row_blocks``, ``halo_reach`` and the autograd refusals that
remain run here. JAX is imported only inside test functions, so the spawned ranks never
import it.

Bars, with what was measured here (oneDNN on this host's CPU):
- the convs (k = 7, 5, 3) and the upsample: f32 CONV_RTOL of each output's
  max |x|, bf16 one bf16 rounding (2^-8) of it, as the extended blocks are
  new conv shapes for which oneDNN may sum in another order (measured: bit
  for bit); the pools bit for bit;
- the warps: bit for bit (the row window takes each position in frame rows,
  as one process does), and within 1e-5 of JAX's ``warp_multiflow_sharded``
  on frame-like planes. JAX's halo path takes positions from the halo's
  first row, so they round apart from one process's by an f32 ulp of a
  position: on white-noise planes (steps up to ~5 between pixels) that put
  JAX's sharded warp 1.8-2.4e-5 from its own single-device warp, which the
  port's matches within 2.4e-7 (64x96, |v| up to 20 px, 32-row blocks);
- the fused step of a data row against one process's on its sample:
  STEP_ATOL / STEP_RTOL in f32 (measured 2.5e-5 and 2.9e-5 on the CONV
  step, where oneDNN sums some of the 512-channel convs of the blocks in
  another order; the SSM-R step bit for bit), bf16 within BF16_STEP_ATOL,
  one bf16 rounding at |pred| ~ 2.5 (measured bit for bit); the bound within
  BOUND_RTOL (measured 1.9e-7); the f32 step within the model bar of JAX's
  (5e-4 / 1e-3);
- the Evaluator's per-image scores: rtol SCORE_RTOL of one process's
  (measured bit for bit; a prediction that rounds across a uint8 step moves
  an image's PSNR by ~1.5e-6 of it).
"""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from superslomo_tpu_torch import Evaluator, ModelSpec, SuperSloMo, default_config, ops, parallel, weights
from superslomo_tpu_torch.config import load_config
from superslomo_tpu_torch.models import superslomo as port_model
from superslomo_tpu_torch.models.layers import Conv2d
from superslomo_tpu_torch.parallel import halo
from superslomo_tpu_torch.parallel.mesh import Grid, make_grid, row_blocks
from tests.test_torch_package import one_torch_thread  # noqa: F401

N_DATA, N_SPATIAL = 2, 2
WORLD = N_DATA * N_SPATIAL
H, W = 64, 96  # 32-row blocks: 32 + 32
T3 = np.asarray([0.25, 0.5, 0.75], np.float32)
CONV_RTOL = 1e-6
STEP_ATOL, STEP_RTOL = 1e-4, 1e-4
BF16_STEP_ATOL = 1e-2
SCORE_RTOL = 1e-5
BOUND_RTOL = 1e-6
FLOW_AMP = {"halo": 20.0, "full": 40.0}  # |v| up to, px: within reach (31) and beyond it


def _layer_inputs():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((4, 8, H, 40)).astype(np.float32),
            rng.standard_normal((4, 8, 16, 12)).astype(np.float32))


def _conv(k):
    conv = Conv2d(8, 8, k, padding=k // 2, bias=True)
    rng = np.random.default_rng(k)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal(conv.weight.shape).astype(np.float32) * 0.1))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(conv.bias.shape).astype(np.float32) * 0.1))
    return conv.to(memory_format=torch.channels_last)


def _warp_inputs(case):
    """A 6-channel pair (4, 6, H, W) as the step passes it (a channels_last
    view of frame-like planes: smooth textures of unit scale, as normalized
    frames are) and flows for both frames, (4, 3, H, W) each: u noise, v
    uniform up to FLOW_AMP[case] px, so flows cross the block boundary both
    ways."""
    rng = np.random.default_rng(41 if case == "halo" else 42)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pair = np.zeros((4, H, W, 6), np.float32)
    for b in range(4):
        for c in range(6):
            for _ in range(6):
                fy, fx = rng.uniform(0.02, 0.2, 2)
                pair[b, :, :, c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3)) * rng.uniform(0.2, 0.6)
    amp = FLOW_AMP[case]
    flows = [(rng.normal(0, 3, (4, 3, H, W)).astype(np.float32),
              rng.uniform(-amp, amp, (4, 3, H, W)).astype(np.float32)) for _ in range(2)]
    return pair, flows


def _pair_view(pair):
    return torch.from_numpy(pair).permute(0, 3, 1, 2)


def _frames(n_frames, h, w, seed):
    return np.random.default_rng(seed).standard_normal((2, n_frames, h, w, 3)).astype(np.float32)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ssmr_spec():
    """configs/superslomo_recurrent.ini's model (CLSTM, N_FRAMES=4)."""
    return load_config(os.path.join(ROOT, "configs", "superslomo_recurrent.ini")).model_spec()


STEPS = {  # name → (spec, frames (2, T, h, w, 3))
    "conv_f32": (lambda: ModelSpec(), lambda: _frames(2, H, W, 51)),
    "conv_bf16": (lambda: ModelSpec(compute_dtype="bfloat16"), lambda: _frames(2, H, W, 51)),
    "ssmr_f32": (_ssmr_spec, lambda: _frames(4, 64, 64, 52)),
}


def _eval_cfg():
    cfg = default_config()
    cfg.set("ADOBE_DATA", "H_IN", H)
    cfg.set("ADOBE_DATA", "W_IN", W)
    return cfg


def _eval_batch():
    """3 samples (padded to 4 over the 2 data rows), 7 targets each, the
    last with 4 valid."""
    rng = np.random.default_rng(53)
    return (rng.standard_normal((3, 2, H, W, 3)).astype(np.float32),
            rng.standard_normal((3, 7, H, W, 3)).astype(np.float32), np.array([7, 7, 4]))


def _mine(x, grid, rows_dim=2):
    """This rank's share of a batch (a half: its data row) and its block of
    rows (dim ``rows_dim``): what it holds of a global tensor."""
    per = x.shape[0] // grid.n_data
    x = x[grid.data_index * per:(grid.data_index + 1) * per]
    h = x.shape[rows_dim] // grid.n_spatial
    return x.narrow(rows_dim, grid.spatial_index * h, h) if torch.is_tensor(x) else \
        np.take(x, range(grid.spatial_index * h, (grid.spatial_index + 1) * h), axis=rows_dim)


def _rank_layers(grid):
    x, up = _layer_inputs()
    out = {}
    with halo.spatial(grid), torch.inference_mode():
        for k in (7, 5, 3):
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                xl = _mine(torch.from_numpy(x), grid).to(dt).contiguous(memory_format=torch.channels_last)
                out[f"conv{k}_{tag}"] = _conv(k).to(dt)(xl)
        ul = _mine(torch.from_numpy(up), grid).contiguous(memory_format=torch.channels_last)
        out["upsample"] = ops.upsample_2x_bilinear(ul)
        out["avg_pool"] = ops.avg_pool_2x2(ul)
        out["max_pool"] = ops.max_pool_2x2(ul)
        blocks = halo.frame_blocks(H // grid.n_spatial)
        for case in FLOW_AMP:
            pair, flows = _warp_inputs(case)
            local = [tuple(_mine(torch.from_numpy(f), grid) for f in uv) for uv in flows]
            with halo.full_height_warps() if case == "full" else contextlib.nullcontext():
                out[f"warp_{case}"] = port_model._halo_pair_warps(_mine(_pair_view(pair), grid), blocks, *local)
    out["blocks"] = blocks
    return out


def _rank_steps(grid):
    out = {}
    for name, (spec, frames) in STEPS.items():
        spec = spec()
        model = SuperSloMo(spec, device="cpu").load_state(weights.seeded_state(spec, seed=7))
        halo.reset_counts()
        with halo.spatial(grid):
            pred, bound = model.interpolate_multi_t(_mine(frames(), grid), T3, with_bounds=True)
        out[name] = {"pred": pred, "bound": float(bound), "exchanges": halo.counts["exchanges"]}
    return out


def _rank_evaluator(grid, halo_rows=None):
    if halo_rows is not None:
        halo.HALO_ROWS = halo_rows
    ev = Evaluator(_eval_cfg(), weights.seeded_state(_eval_cfg().model_spec(), seed=42), device="cpu", grid=grid)
    ev.run([_eval_batch()])
    return {"psnr": ev.psnr, "ssim": ev.ssim, "ie": ev.ie, "results": ev.results(), "reruns": ev.reruns,
            "threshold": ev.bound_threshold}


def _rank_main(rank, init_file, work):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    parallel.init_data_parallel(device="cpu", init_method=f"file://{init_file}")
    out = {}
    try:
        make_grid(3, 2)
    except ValueError as e:
        out["bad_grid"] = str(e)
    grid = make_grid(N_DATA, N_SPATIAL)
    out["grid"] = (grid.data_index, grid.spatial_index, grid.data_ranks, grid.spatial_ranks)
    out["layers"] = _rank_layers(grid)
    out["steps"] = _rank_steps(grid)
    out["eval"] = _rank_evaluator(grid)
    out["eval_rerun"] = _rank_evaluator(grid, halo_rows=2)
    parallel.barrier()
    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, in rank order."""
    work = str(tmp_path_factory.mktemp("halo"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, os.path.join(work, "rendezvous"), work)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    yield [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    shutil.rmtree(work, ignore_errors=True)


def _assemble(parts, rows_dim=2):
    """The ranks' outputs (rank order: data-major) put together: each data
    row's blocks along ``rows_dim``, the data rows along the batch."""
    rows = [torch.cat([torch.as_tensor(p).float() for p in parts[d * N_SPATIAL:(d + 1) * N_SPATIAL]], dim=rows_dim)
            for d in range(N_DATA)]
    return torch.cat(rows, dim=0)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# ----------------------------------------------------------------------------- in this process


def test_row_blocks_are_whole_32_row_units():
    assert row_blocks(736, 2) == (384, 352)
    assert row_blocks(736, 4) == (192, 192, 192, 160)
    assert row_blocks(2176, 2) == (1088, 1088) and row_blocks(64, 2) == (32, 32)
    assert row_blocks(96, 1) == (96,)
    with pytest.raises(ValueError, match="fewer than 4"):
        row_blocks(96, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        row_blocks(720, 2)


def test_halo_reach_and_the_grid_refusals():
    assert halo.HALO_ROWS == 136
    assert halo.halo_reach(row_blocks(736, 2)) == 135 == halo.halo_reach(row_blocks(736, 4))
    assert halo.halo_reach((32, 32)) == 31 and halo.halo_reach((64, 96, 64)) == 63
    assert halo.active() is None
    with pytest.raises(RuntimeError, match="process group"):
        make_grid(1, 2)
    with pytest.raises(RuntimeError, match="no spatial grid"):
        halo.exchange_rows(torch.zeros(1, 1, 4, 4), 1, 1)
    one_row = Grid(2, 1, 0, None, None, (0, 1), (0,))  # a data-only grid splits no rows
    with halo.spatial(one_row):
        assert halo.active() is None


def test_halo_ops_refuse_autograd():
    """What stays refused under autograd, with a tensor that needs a
    gradient: ``gather_rows``, the row-window multi-flow warp and the
    single-flow warp's image under a row window, which no path
    differentiates; each raises before it talks to another rank (this grid
    has no groups to talk over). The convs, the upsample, ``exchange_rows``
    and the forward train under a grid (``tests/test_torch_halo_train.py``)."""
    grid = Grid(1, 2, 0, None, None, (0,), (0, 1))
    x = torch.zeros(1, 8, 32, 16, requires_grad=True)
    with halo.spatial(grid), pytest.raises(NotImplementedError, match="no path differentiates"):
        halo.gather_rows(x, (32, 32))
    planes, flow = torch.zeros(1, 3, 8, 8, requires_grad=True), torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="no path differentiates"):
        ops.warp_multiflow_planar(planes, flow, flow, rows=halo.RowWindow(2, 0, 8, 8))
    img, flow2 = torch.zeros(1, 3, 8, 8, requires_grad=True), torch.zeros(1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="no path differentiates"):
        ops.warp_auto(img, flow2, rows=halo.RowWindow(2, 0, 8, 8))
    assert ops.warp_auto(img.detach(), flow2.requires_grad_(True), rows=halo.RowWindow(2, 0, 8, 8)).requires_grad


def test_row_window_warp_is_the_one_process_warp_on_its_rows():
    """The plain warp under a row window: frame rows [16, 40) of a 64-row
    frame against planes of rows [8, 48), flows up to 7 px, bit for bit the
    one-process warp's rows; past the planes' rows the taps read 0."""
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.standard_normal((2, 3, 64, 40)).astype(np.float32))
    u, v = (torch.from_numpy(rng.uniform(-7, 7, (2, 2, 64, 40)).astype(np.float32)) for _ in range(2))
    want = ops.warp_multiflow_planar(planes, u, v)[:, :, :, 16:40]
    got = ops.warp_multiflow_planar(planes[:, :, 8:48], u[:, :, 16:40], v[:, :, 16:40],
                                    rows=halo.RowWindow(16, 8, 40, 64))
    assert torch.equal(got, want)
    far = ops.warp_multiflow_planar(planes[:, :, 8:48], u[:, :, 16:40], v[:, :, 16:40] + 30,
                                    rows=halo.RowWindow(16, 8, 40, 64))
    assert torch.equal(far[:, :, :, -6:], torch.zeros_like(far[:, :, :, -6:]))


# ----------------------------------------------------------------------------- the ranks


def test_ranks_form_the_grid(ranks):
    assert [r["grid"] for r in ranks] == [(0, 0, (0, 2), (0, 1)), (0, 1, (1, 3), (0, 1)),
                                          (1, 0, (0, 2), (2, 3)), (1, 1, (1, 3), (2, 3))]
    assert all("grid 3 x 2 != 4 ranks" in r["bad_grid"] for r in ranks)
    assert all(r["layers"]["blocks"] == (32, 32) for r in ranks)


@pytest.mark.parametrize("k", [7, 5, 3])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_sharded_conv_equals_one_process(ranks, k, tag):
    x, _ = _layer_inputs()
    dt = torch.float32 if tag == "f32" else torch.bfloat16
    with torch.inference_mode():
        want = _conv(k).to(dt)(torch.from_numpy(x).to(dt).contiguous(memory_format=torch.channels_last)).float()
    got = _assemble([r["layers"][f"conv{k}_{tag}"] for r in ranks])
    assert got.shape == want.shape
    assert _rel(got, want) <= (CONV_RTOL if tag == "f32" else 2.0**-8)


def test_sharded_upsample_and_pools_equal_one_process(ranks):
    _, up = _layer_inputs()
    x = torch.from_numpy(up).contiguous(memory_format=torch.channels_last)
    got = _assemble([r["layers"]["upsample"] for r in ranks])
    assert _rel(got, ops.upsample_2x_bilinear(x)) <= CONV_RTOL
    assert torch.equal(_assemble([r["layers"]["avg_pool"] for r in ranks]), ops.avg_pool_2x2(x))
    assert torch.equal(_assemble([r["layers"]["max_pool"] for r in ranks]), ops.max_pool_2x2(x))


@pytest.mark.parametrize("case", ["halo", "full"])
def test_sharded_warps_equal_one_process_and_jax(ranks, case):
    """The halo warp (|v| up to 20 px, within the reach of 31 rows) and the
    full-height warp (up to 40 px, beyond it): bit for bit one process's
    warp, and within 1e-5 of JAX's ``warp_multiflow_sharded`` on a (2 x 2)
    mesh of the conftest's virtual CPU devices (its halo path unguarded for
    the halo case; its guarded path, which all-gathers beyond the reach, for
    the full case)."""
    import jax
    import jax.numpy as jnp

    from superslomo_tpu.parallel.mesh import make_mesh
    from superslomo_tpu.parallel.warp_spmd import halo_reach, warp_multiflow_sharded

    pair, flows = _warp_inputs(case)
    planes = _pair_view(pair)
    mesh = make_mesh(n_data=N_DATA, n_spatial=N_SPATIAL, devices=jax.devices()[:WORLD])
    assert halo_reach(N_SPATIAL, H) == halo.halo_reach((32, 32)) == 31
    for i, (u, v) in enumerate(flows):
        got = _assemble([r["layers"][f"warp_{case}"][i] for r in ranks], rows_dim=3)
        want = ops.warp_multiflow_planar(planes[:, 3 * i:3 * i + 3], torch.from_numpy(u), torch.from_numpy(v))
        assert torch.equal(got, want)
        fl = jnp.asarray(np.stack([u, v], axis=-1))  # (B, n, H, W, 2)
        theirs = warp_multiflow_sharded(jnp.asarray(pair[..., 3 * i:3 * i + 3]), fl, mesh, unguarded=case == "halo")
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)


def _one_process_step(name, d):
    """One process's fused step on data row ``d``'s sample."""
    spec, frames = STEPS[name]
    spec = spec()
    model = SuperSloMo(spec, device="cpu").load_state(weights.seeded_state(spec, seed=7))
    pred, bound = model.interpolate_multi_t(frames()[d:d + 1], T3, with_bounds=True)
    return pred, float(bound)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_fused_step_equals_one_process(ranks, name):
    """Every conv and upsample of both U-Nets and both warp pairs exchange
    halo rows (the CONV step: 48 convs, 10 upsamples, 2 pairs = 60
    exchanges); each data row's predictions, its blocks put together, equal
    one process's on that row's sample, and the row's bound (MAX over its
    spatial ranks) is one process's."""
    for d in range(N_DATA):
        want, want_bound = _one_process_step(name, d)
        row = ranks[d * N_SPATIAL:(d + 1) * N_SPATIAL]
        got = torch.cat([r["steps"][name]["pred"] for r in row], dim=2)
        assert got.shape == want.shape
        if name == "conv_bf16":
            assert (got - want).abs().max().item() <= BF16_STEP_ATOL
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STEP_ATOL, rtol=STEP_RTOL)
        assert [r["steps"][name]["bound"] for r in row] == [pytest.approx(want_bound, rel=BOUND_RTOL)] * N_SPATIAL
    if name.startswith("conv"):
        assert all(r["steps"][name]["exchanges"] == 60 for r in ranks)


def test_sharded_f32_step_equals_jax(ranks):
    """The f32 sharded step against the JAX package's fused step
    (``interpolate_multi_t(with_bounds=True)`` under ``jax.jit``, the one
    model-sized JAX program of this file) at the same weights and frames:
    the full-model bar."""
    import jax
    import jax.numpy as jnp

    from superslomo_tpu.config import ModelSpec as JaxModelSpec
    from superslomo_tpu.models.superslomo import SuperSloMo as JaxSuperSloMo

    spec, frames = STEPS["conv_f32"]
    params = weights.jax_tree_from_torch_state(weights.seeded_state(spec(), seed=7))
    model = JaxSuperSloMo(spec=JaxModelSpec())
    step = jax.jit(lambda p, f, t: model.apply(p, f, t, with_bounds=True, method=JaxSuperSloMo.interpolate_multi_t))
    want, want_bound = step(params, jnp.asarray(frames()), jnp.asarray(T3))
    got = _assemble([r["steps"]["conv_f32"]["pred"] for r in ranks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    # the bound of the batch is over both samples' stage-1 and stage-2 maxima
    # together; each data row's bound is over its own sample's, so at most it
    assert max(r["steps"]["conv_f32"]["bound"] for r in ranks) <= float(want_bound) * (1 + 1e-4)


@pytest.mark.parametrize("key", ["eval", "eval_rerun"])
def test_sharded_evaluator_scores_equal_one_process(ranks, key):
    """A batch of 3 padded to 4 over the data rows, each sample's rows over
    the spatial ranks: the gathered per-image scores are one process's, in
    sample order, on every rank. With ``HALO_ROWS`` set to 2 inside the
    ranks the reach is 1 px, the batch's bound exceeds it, and the batch
    reruns under full-height warps, counted, to the same scores."""
    ev = Evaluator(_eval_cfg(), weights.seeded_state(_eval_cfg().model_spec(), seed=42), device="cpu")
    ev.run([_eval_batch()])
    assert len(ev.psnr) == 18
    for r in ranks:
        got = r[key]
        assert got["results"]["n_images"] == 18
        assert got["results"]["max_flow_bound"] == pytest.approx(ev.results()["max_flow_bound"], rel=1e-6)
        for k in ("psnr", "ssim", "ie"):
            np.testing.assert_allclose(got[k], getattr(ev, k), rtol=SCORE_RTOL, err_msg=k)
        if key == "eval":
            assert got["threshold"] == 31 and got["reruns"] == 0 < 31 - got["results"]["max_flow_bound"]
        else:
            assert got["threshold"] == 1 and got["reruns"] == 1
