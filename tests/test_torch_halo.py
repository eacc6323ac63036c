"""Height sharding on the CPU: four gloo ranks on a (2 x 2) (data, spatial)
grid, spawned once for the module, each on one torch thread, run the layers,
the warps, the fused step and the Evaluator with each frame's rows split
over the two spatial ranks of their data row, and differentiate the sharded
warps (``parallel/warp_spmd.py``), ``gather_rows`` and the fused step; this
process holds what they return against the one-process port on the same
numpy inputs, and the warps, their gradients and the f32 step against the
JAX package. The grid's rules, ``row_blocks``, ``halo_reach`` and the
windowed warps' gradients over two blocks of one frame run here. JAX is
imported only inside test functions, so the spawned ranks never import it.

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
  an image's PSNR by ~1.5e-6 of it);
- the windowed warps' gradients in one process, two blocks of a frame
  against their halo planes or the whole height: the image's summed at
  its planes' first row within WINDOW_GRAD_REL of the whole frame's max
  (measured 1.0e-7 single-flow, 1.5e-7 multi-flow), the flows' bit for bit
  its rows;
- the sharded warps' gradients assembled from the ranks against one
  process's: the outputs bit for bit; f32 within SHARD_GRAD_REL of each
  gradient's max (measured 1.5e-7 for the image's and the planes', the
  flows' bit for bit); the planes' gradient of bf16 planes within
  BF16_SHARD_GRAD_REL, two bf16 roundings (2^-7) of its max: one process
  rounds each row's sum once, the ranks round the halo rows' part on the
  rank that warps them, the owner's own part on the owner, and their sum
  again (``exchange_rows``' backward adds in the gradient's dtype), each
  rounding up to 2^-9 of its value (measured 4.8e-3 halo, 5.4e-3 beyond
  the reach); the flows' gradients of bf16 planes within SHARD_GRAD_REL
  (measured bit for bit); within the reach within 1e-4 of JAX's
  ``warp_sharded`` / ``warp_multiflow_sharded`` gradients (its ``g_bwd``;
  measured 1.5e-5, JAX's halo path taking positions from the halo's first
  row), beyond it of JAX's single-device ``backward_warp`` gradient
  (measured 1.4e-6), the bar of ``tests/test_parallel.py``;
- the fused step's gradient under the grid (f32 CONV, panning textures),
  each parameter's summed over a data row's ranks and the frames' put
  together, against one process's: all parameters' together and the
  frames' within STEP_GRAD_REL by the relative L2 distance, the gradient
  bar of ``chip_smoke.py``'s train phases over all parameters together
  (measured 1.8e-4 for the parameters, 6.0e-5 for the frames; each
  tensor's max error up to 5.8e-2). Not each tensor by its max, as
  ``tests/test_torch_halo_train.py`` holds the train step: the fused step's
  gradient is discontinuous (every conv's leaky ReLU, the warps' floor), and
  at 64x96 the deep convs' weights sum over few positions, so frames
  nudged by 1e-7 of their max moved one process's own gradients by up to
  1.9e-2 of a tensor's max and 1.8e-4 by the L2 distance (one thread;
  on 16 panning pairs tried, most moved a tensor by more than 1e-3), and the
  one-process reference on one thread and on several lay 1e-3 apart.
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
from superslomo_tpu_torch.models import superslomo
from superslomo_tpu_torch.models.layers import Conv2d
from superslomo_tpu_torch.parallel import halo, warp_spmd
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
WINDOW_GRAD_REL = 1e-6
SHARD_GRAD_REL = 1e-5
BF16_SHARD_GRAD_REL = 2.0**-7
JAX_GRAD_ATOL = 1e-4  # tests/test_parallel.py's bar
STEP_GRAD_REL = 1e-3  # tests/test_torch_halo_train.py's GRAD_REL


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
                out[f"warp_{case}"] = warp_spmd.warp_multiflow_sharded(_mine(_pair_view(pair), grid), local, blocks,
                                                                         unguarded=True)
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
    out["sliced"] = _sliced_step(lambda f: _mine(f, grid), grid)
    return out


def _sliced_frames():
    """Four samples: two a data row."""
    return np.random.default_rng(54).standard_normal((4, 2, H, W, 3)).astype(np.float32)


def _sliced_step(cut, grid=None):
    """The CONV f32 fused step over ``cut`` of ``_sliced_frames()`` with the
    budget at one sample of the largest block's rows (every rank's alike):
    the predictions, the bound, and each slice's batch."""
    spec = ModelSpec()
    model = SuperSloMo(spec, device="cpu").load_state(weights.seeded_state(spec, seed=7))
    calls, one_go = [], model._multi_t_planar
    model._multi_t_planar = lambda f, *args: calls.append(f.shape[0]) or one_go(f, *args)
    budget, superslomo.STEP_PIXELS = superslomo.STEP_PIXELS, len(T3) * max(row_blocks(H, N_SPATIAL)) * W
    try:
        with halo.spatial(grid) if grid else contextlib.nullcontext():
            pred, bound = model.interpolate_multi_t(cut(_sliced_frames()), T3, with_bounds=True)
    finally:
        superslomo.STEP_PIXELS = budget
    return {"pred": pred, "bound": float(bound), "slices": calls}


def _rank_evaluator(grid, halo_rows=None):
    if halo_rows is not None:
        halo.HALO_ROWS = halo_rows
    ev = Evaluator(_eval_cfg(), weights.seeded_state(_eval_cfg().model_spec(), seed=42), device="cpu", grid=grid)
    ev.run([_eval_batch()])
    return {"psnr": ev.psnr, "ssim": ev.ssim, "ie": ev.ie, "results": ev.results(), "reruns": ev.reruns,
            "threshold": ev.bound_threshold}


def _grad_inputs(case):
    """The sharded warps' inputs and output gradients, global: frame 0 of
    ``_warp_inputs``' pair (4, 3, H, W) with the flow (4, 2, H, W) of its
    first flow pair's first field, and frame 1 (4, 3, H, W) with the second
    pair's three fields (4, 3, H, W) each; standard normal output gradients
    (4, 3, H, W) and (4, 3, 3, H, W)."""
    pair, flows = _warp_inputs(case)
    rng = np.random.default_rng(61 if case == "halo" else 62)
    planes = _pair_view(pair)
    (u0, v0), (u1, v1) = ((torch.from_numpy(u), torch.from_numpy(v)) for u, v in flows)
    return {"img": planes[:, 0:3], "flow": torch.stack([u0[:, 0], v0[:, 0]], 1),
            "g1": torch.from_numpy(rng.standard_normal((4, 3, H, W)).astype(np.float32)),
            "planes": planes[:, 3:6], "u": u1, "v": v1,
            "g3": torch.from_numpy(rng.standard_normal((4, 3, 3, H, W)).astype(np.float32))}


def _guard_flows():
    """Flows within 5 px everywhere but one |v| of 40 px in data row 0's
    second block (sample 0, frame row 50): only that rank's flows pass the
    reach of 31."""
    x = _grad_inputs("halo")
    flow = x["flow"] / 4
    flow[0, 1, 50, 10] = 40.0
    return x["img"], flow, x["g1"]


def _panning(n_frames, shift, seed):
    """(n_frames, H, W, 3) f32: five seeded sinusoids panning ``shift`` px a
    frame right and half that down."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    clip = np.zeros((n_frames, H, W, 3), np.float32)
    for _ in range(5):
        (fy, fx), phase, amp = rng.uniform(-0.3, 0.3, 2), rng.uniform(0, 6.3), rng.uniform(0.3, 1.0, 3)
        for i in range(n_frames):
            clip[i] += np.sin(fy * (yy - 0.5 * shift * i) + fx * (xx - shift * i) + phase)[..., None] * amp
    return clip


def _step_frames():
    """(2, 2, H, W, 3): one panning pair a data row."""
    return np.stack([_panning(2, 2.0 + d, 71 + d) for d in range(N_DATA)])


def _step_grads(model, frames):
    """The fused step (f32 CONV) differentiated: the gradients of the sum of
    its prediction's squares by every parameter and by the frames, and its
    bound."""
    frames = frames.detach().requires_grad_(True)
    params = [p for _, p in model.named_parameters()]
    pred, bound = model._multi_t_planar(frames, torch.from_numpy(T3))
    grads = torch.autograd.grad((pred ** 2).sum(), params + [frames])
    return {"params": list(grads[:-1]), "frames": grads[-1], "bound": float(bound.detach())}


def _rank_grads(grid):
    """Every gradient of the sharded paths on this rank: the sharded warps
    in both branches (and ``ops.warp_auto`` without rows, routed to
    ``warp_sharded``), the guard with one rank's flows beyond the reach, the
    unguarded multi-flow warp, ``gather_rows`` to every rank (and its
    refusal to differentiate a gather to ``dst=0``), and the fused step;
    with this rank's halo counts."""
    def leaves(*ts, dtype=None):
        return [_mine(t if dtype is None else t.to(dtype), grid).detach().requires_grad_(True) for t in ts]

    def run(fn, xs, g):
        halo.reset_counts()
        out = fn(*xs)
        grads = torch.autograd.grad(out, xs, g)
        return {"out": out.detach(), "grads": [x.detach() for x in grads], "counts": dict(halo.counts)}

    blocks = (32, 32)

    def multi(unguarded=False):
        return lambda p, u, v: warp_spmd.warp_multiflow_sharded(p, [(u, v)], blocks, unguarded=unguarded)[0]

    out = {}
    with halo.spatial(grid):
        for case in FLOW_AMP:
            x = _grad_inputs(case)
            g1 = _mine(x["g1"], grid)
            out[f"single_{case}"] = run(warp_spmd.warp_sharded, leaves(x["img"], x["flow"]), g1)
            out[f"auto_{case}"] = run(ops.warp_auto, leaves(x["img"], x["flow"]), g1)
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                xs = leaves(x["planes"], dtype=dt) + leaves(x["u"], x["v"])
                out[f"multi_{case}_{tag}"] = run(multi(), xs, _mine(x["g3"], grid, rows_dim=3).to(dt))
        img, flow, g1 = _guard_flows()
        out["guard"] = run(warp_spmd.warp_sharded, leaves(img, flow), _mine(g1, grid))
        for case in FLOW_AMP:
            x = _grad_inputs(case)
            out[f"unguarded_{case}"] = run(multi(unguarded=True), leaves(x["planes"], x["u"], x["v"]),
                                           _mine(x["g3"], grid, rows_dim=3))
        x = leaves(_grad_inputs("halo")["img"])[0]
        halo.reset_counts()
        whole = halo.gather_rows(x, blocks)
        g = torch.full_like(whole, float(grid.rank + 1))  # each rank's gradient of the whole height
        torch.autograd.backward(whole, g)
        out["gather"] = {"rows": whole.shape[2], "grad": x.grad, "counts": dict(halo.counts)}
        with pytest.raises(ValueError, match="no gradient"):
            halo.gather_rows(x, blocks, dst=0)
        with torch.no_grad():
            one = halo.gather_rows(x, blocks, dst=0)
        out["gather_dst"] = None if one is None else one.shape[2]
        model = SuperSloMo(ModelSpec(), device="cpu").load_state(weights.seeded_state(ModelSpec(), seed=7))
        frames = _mine(torch.from_numpy(_step_frames()), grid, rows_dim=2)
        for branch in ("halo", "full"):
            halo.reset_counts()
            with halo.full_height_warps() if branch == "full" else contextlib.nullcontext():
                out[f"step_{branch}"] = {**_step_grads(model, frames), "counts": dict(halo.counts)}
    return out


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
    halo.HALO_ROWS = 136
    out["grads"] = _rank_grads(grid)
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


def _rel_l2(got, want):
    """The L2 distance of the tensors ``got`` from ``want``, all together,
    over the L2 norm of ``want``."""
    return (sum(((a - w) ** 2).sum() for a, w in zip(got, want)) / sum((w ** 2).sum() for w in want)).sqrt().item()


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


def test_halo_ops_refuse_autograd(ranks):
    """What no path differentiated before now carries gradients, on the CPU
    as on the card: the row-window multi-flow warp (planes, u and v), the
    single-flow warp's image under a row window, and ``gather_rows`` to
    every rank, whose backward (four gloo ranks, a 2 x 2 grid) sends each
    block of every rank's whole-height gradient (``rank + 1`` everywhere)
    to its owner, so a rank's block takes the sum over its data row's ranks.
    A gather to one rank (``dst=0``, the Evaluator's) serves inference only:
    under autograd it raises on every rank before it sends anything (the
    other ranks would hold nothing to backpropagate through); under
    ``torch.no_grad`` spatial rank 0 gets the whole height, the other None."""
    window = halo.RowWindow(2, 0, 8, 8)
    ramp = torch.arange(3 * 8 * 8, dtype=torch.float32).reshape(1, 3, 8, 8) ** 2 / 100
    planes, u = ramp.clone().requires_grad_(True), torch.full((1, 1, 4, 8), 0.25, requires_grad=True)
    v = torch.full((1, 1, 4, 8), 0.5, requires_grad=True)
    grads = torch.autograd.grad(ops.warp_multiflow_planar(planes, u, v, rows=window).sum(), (planes, u, v))
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
    img, flow = ramp.clone().requires_grad_(True), torch.full((1, 2, 4, 8), 0.5, requires_grad=True)
    gi, gf = torch.autograd.grad(ops.warp_auto(img, flow, rows=window).sum(), (img, flow))
    assert gi.shape == img.shape and gi[:, :, 2:7].sum() > 0 and gi[:, :, :2].abs().sum() == 0 and gf.shape == flow.shape
    for r in ranks:
        grid_row = r["grid"][3]
        every = r["grads"]["gather"]
        assert every["rows"] == H and every["counts"]["gathers"] == every["counts"]["backward_gathers"] == 1
        assert torch.equal(every["grad"], torch.full_like(every["grad"], float(sum(k + 1 for k in grid_row))))
        assert r["grads"]["gather_dst"] == (H if r["grid"][1] == 0 else None)


def _halo_planes(x, y0, h, hv):
    """Frame rows [y0 - hv, y0 + h + hv) of x (dim 2), zeros past the frame."""
    ext = x.new_zeros(x.shape[:2] + (h + 2 * hv,) + x.shape[3:])
    lo, hi = max(0, y0 - hv), min(x.shape[2], y0 + h + hv)
    ext[:, :, lo - (y0 - hv):hi - (y0 - hv)] = x[:, :, lo:hi]
    return ext


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("source", ["halo", "whole"])
def test_windowed_warp_gradients_of_two_blocks_sum_to_one_process(kind, source):
    """One process, no ranks: a 64-row frame split into two 32-row blocks,
    each warped through a row window against its halo planes (31 rows each
    side, zeros past the frame) or against the whole height, |v| up to 20
    px; each block's image gradient, added into the frame at its planes'
    first row, sums to the whole-frame warp's image gradient within
    WINDOW_GRAD_REL of its max, and each block's flow gradient is the
    whole-frame one's rows bit for bit."""
    x = _grad_inputs("halo")
    img, g = (x["img"], x["g1"][:, :, None]) if kind == "single" else (x["planes"], x["g3"])
    flows = (x["flow"][:, 0:1], x["flow"][:, 1:2]) if kind == "single" else (x["u"], x["v"])

    def grads(im, fl, g_, rows=None):
        leaves = [im.detach().clone().requires_grad_(True)] + [f.detach().clone().requires_grad_(True) for f in fl]
        if kind == "single":
            out = ops.warp_auto(leaves[0], torch.cat(leaves[1:], 1), rows=rows)[:, :, None]
        else:
            out = ops.warp_multiflow_planar(*leaves, rows=rows)
        return torch.autograd.grad(out, leaves, g_)

    want = grads(img, flows, g)
    total = torch.zeros_like(want[0])
    for y0 in (0, 32):
        hv = 31 if source == "halo" else None
        planes = _halo_planes(img, y0, 32, hv) if hv else img
        window = halo.RowWindow(y0, y0 - hv, 32 + 2 * hv, H) if hv else halo.RowWindow(y0, 0, H, H)
        got = grads(planes, [f[:, :, y0:y0 + 32] for f in flows], g[:, :, :, y0:y0 + 32], window)
        lo = max(0, window.p_base)
        total[:, :, lo:window.p_base + window.p_rows] += got[0][:, :, lo - window.p_base:H - window.p_base]
        for a, w in zip(got[1:], want[1:]):
            assert torch.equal(a, w[:, :, y0:y0 + 32])
    assert _rel(total, want[0]) <= WINDOW_GRAD_REL


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


def test_sharded_fused_step_slices_alike_on_every_rank(ranks):
    """Past its budget (one sample of the largest block's 32 rows) the fused
    step under the grid runs a data row's two samples as two slices on each
    of its ranks, so every rank makes the same halo exchanges; the row's
    predictions, its blocks put together, equal one process's sliced step on
    its samples within STEP_ATOL / STEP_RTOL, and its bound one process's."""
    for d in range(N_DATA):
        want = _sliced_step(lambda f: f[2 * d:2 * d + 2])
        row = ranks[d * N_SPATIAL:(d + 1) * N_SPATIAL]
        assert want["slices"] == [1, 1] and all(r["steps"]["sliced"]["slices"] == [1, 1] for r in row)
        got = torch.cat([r["steps"]["sliced"]["pred"] for r in row], dim=2)
        assert got.shape == want["pred"].shape == (2, 3, H, W, 3)
        np.testing.assert_allclose(got.numpy(), want["pred"].numpy(), atol=STEP_ATOL, rtol=STEP_RTOL)
        assert [r["steps"]["sliced"]["bound"] for r in row] == [pytest.approx(want["bound"], rel=BOUND_RTOL)] * 2


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


def _one_process_warp_grads(kind, case):
    """One process's warp of the global inputs of ``_grad_inputs(case)`` and
    its gradients (image or planes first, then the flows)."""
    x = _grad_inputs(case)
    if kind == "single":
        leaves = [x["img"].detach().requires_grad_(True), x["flow"].detach().clone().requires_grad_(True)]
        out = ops.warp_auto(*leaves)
        g = x["g1"]
    else:
        dt = torch.float32 if kind == "multi_f32" else torch.bfloat16
        leaves = [x["planes"].to(dt).detach().requires_grad_(True)] + [
            x[k].detach().clone().requires_grad_(True) for k in ("u", "v")]
        out = ops.warp_multiflow_planar(*leaves)
        g = x["g3"].to(dt)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("kind", ["single", "auto", "multi_f32", "multi_bf16"])
@pytest.mark.parametrize("case", ["halo", "full"])
def test_sharded_warp_gradients_equal_one_process(ranks, kind, case):
    """``warp_spmd.warp_sharded`` (and ``ops.warp_auto`` without rows under
    ``halo.spatial``, which routes to it) and ``warp_multiflow_sharded`` in
    f32 and bf16, |v| up to 20 px (the halo branch: one exchange forward and
    one back, no gather) and up to 40 px (beyond the reach of 31: one gather
    forward and one back, no exchange): the output bit for bit one
    process's, and the image's and the flows' gradients assembled from the
    ranks within SHARD_GRAD_REL (f32) or one bf16 rounding (bf16 planes) of
    each gradient's max."""
    key = {"single": f"single_{case}", "auto": f"auto_{case}", "multi_f32": f"multi_{case}_f32",
           "multi_bf16": f"multi_{case}_bf16"}[kind]
    want_out, want = _one_process_warp_grads("single" if kind == "auto" else kind, case)
    parts = [r["grads"][key] for r in ranks]
    out_dim = 3 if kind.startswith("multi") else 2
    assert torch.equal(_assemble([p["out"] for p in parts], rows_dim=out_dim), want_out.float())
    for i, w in enumerate(want):
        got = _assemble([p["grads"][i] for p in parts])
        assert got.shape == w.shape
        bar = BF16_SHARD_GRAD_REL if kind == "multi_bf16" and i == 0 else SHARD_GRAD_REL
        assert _rel(got, w.float()) <= bar, (i, _rel(got, w.float()))
    counts = [p["counts"] for p in parts]
    halo_branch = case == "halo"
    assert all((c["exchanges"], c["backward_exchanges"], c["gathers"], c["backward_gathers"])
               == ((1, 1, 0, 0) if halo_branch else (0, 0, 1, 1)) for c in counts), counts


def _jax_warp_grads(kind, case):
    """JAX's gradients of the same warps: within the reach its sharded
    warp's on a (2 x 2) mesh of the conftest's virtual CPU devices (the
    guard takes the halo branch, whose VJP is ``g_bwd``), beyond it its
    single-device ``backward_warp``'s; NCHW, image or planes first."""
    import jax
    import jax.numpy as jnp

    from superslomo_tpu.ops.warp import backward_warp
    from superslomo_tpu.parallel.mesh import make_mesh
    from superslomo_tpu.parallel.warp_spmd import warp_multiflow_sharded, warp_sharded

    x = _grad_inputs(case)
    mesh = make_mesh(n_data=N_DATA, n_spatial=N_SPATIAL, devices=jax.devices()[:WORLD])

    def nhwc(t):
        return jnp.asarray(t.permute(0, 2, 3, 1).contiguous().numpy())

    if kind == "single":
        fn = (lambda im, fl: warp_sharded(im, fl, mesh)) if case == "halo" else backward_warp
        _, vjp = jax.vjp(fn, nhwc(x["img"]), nhwc(x["flow"]))
        gi, gf = vjp(nhwc(x["g1"]))
        return [torch.from_numpy(np.asarray(t)).permute(0, 3, 1, 2) for t in (gi, gf)]

    def tiled(im, fl):  # the single-device multi-flow warp: the image warped by each flow
        B, n, h, w, _ = fl.shape
        out = backward_warp(jnp.broadcast_to(im[:, None], (B, n) + im.shape[1:]).reshape((B * n,) + im.shape[1:]),
                            fl.reshape(B * n, h, w, 2))
        return out.reshape(B, n, h, w, -1)

    fn = (lambda im, fl: warp_multiflow_sharded(im, fl, mesh)) if case == "halo" else tiled
    flows = jnp.asarray(torch.stack([x["u"], x["v"]], -1).numpy())  # (B, n, H, W, 2)
    _, vjp = jax.vjp(fn, nhwc(x["planes"]), flows)
    gp, gfl = vjp(jnp.asarray(x["g3"].permute(0, 2, 3, 4, 1).contiguous().numpy()))
    gfl = torch.from_numpy(np.asarray(gfl))
    return [torch.from_numpy(np.asarray(gp)).permute(0, 3, 1, 2), gfl[..., 0], gfl[..., 1]]


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("case", ["halo", "full"])
def test_sharded_warp_gradients_equal_jax(ranks, kind, case):
    """The f32 sharded warps' gradients assembled from the ranks against
    JAX's: within the reach its ``warp_sharded`` / ``warp_multiflow_sharded``
    gradients, beyond it its single-device ``backward_warp`` gradient (its
    sharded backward there is still the halo path's, which drops the far
    taps; the port's is the exact gradient of the path it ran); within
    JAX_GRAD_ATOL, the bar of ``tests/test_parallel.py``."""
    key = f"single_{case}" if kind == "single" else f"multi_{case}_f32"
    got = [_assemble([r["grads"][key]["grads"][i] for r in ranks]) for i in range(2 if kind == "single" else 3)]
    for i, (a, w) in enumerate(zip(got, _jax_warp_grads(kind, case))):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=JAX_GRAD_ATOL, rtol=JAX_GRAD_ATOL, err_msg=str(i))


def test_sharded_warp_guard_is_coherent(ranks):
    """The guard reduces |flow| by MAX over the spatial group: data row 0,
    whose second block alone holds a |v| of 40 px (beyond the reach of 31),
    takes the gathered branch on both its ranks; data row 1 (within 5 px)
    the halo branch on both. Either way the warp and its gradients are one
    process's."""
    img, flow, g1 = _guard_flows()
    leaves = [img.detach().requires_grad_(True), flow.detach().clone().requires_grad_(True)]
    out = ops.warp_auto(*leaves)
    want = torch.autograd.grad(out, leaves, g1)
    branch = [(r["grads"]["guard"]["counts"]["gathers"], r["grads"]["guard"]["counts"]["exchanges"]) for r in ranks]
    assert branch == [(1, 0), (1, 0), (0, 1), (0, 1)]
    assert torch.equal(_assemble([r["grads"]["guard"]["out"] for r in ranks]), out.detach())
    for i, w in enumerate(want):
        assert _rel(_assemble([r["grads"]["guard"]["grads"][i] for r in ranks]), w) <= SHARD_GRAD_REL


def test_unguarded_sharded_warp_takes_the_halo_branch(ranks):
    """``warp_multiflow_sharded(..., unguarded=True)`` (the fused step's)
    reduces no bound and reads the halo rows whatever the flows: within the
    reach bit for bit the guarded warp and its gradients; beyond it (|v| up
    to 40 px against a reach of 31) still one exchange and no gather, so a
    caller checks the bound itself."""
    for r in ranks:
        halo_case, guarded = r["grads"]["unguarded_halo"], r["grads"]["multi_halo_f32"]
        assert torch.equal(halo_case["out"], guarded["out"])
        assert all(torch.equal(a, b) for a, b in zip(halo_case["grads"], guarded["grads"]))
        for case in FLOW_AMP:
            c = r["grads"][f"unguarded_{case}"]["counts"]
            assert (c["exchanges"], c["backward_exchanges"], c["gathers"], c["backward_gathers"]) == (1, 1, 0, 0)


@pytest.mark.parametrize("branch", ["halo", "full"])
def test_sharded_fused_step_gradient_equals_one_process(ranks, branch):
    """The f32 CONV fused step differentiated under the grid, each data row
    on its panning pair: the sum of its prediction's squares by every
    parameter (summed over the row's two ranks) and by the frames (the
    rows put together) within STEP_GRAD_REL of one process's by the
    relative L2 distance, all parameters together and the frames apart (why
    not each tensor against its max: the module docstring's nudge
    measurement); through the halo warps (the bound within the reach)
    and under ``halo.full_height_warps()`` (the pairs gathered, their
    gradient sent back: 2 gathers forward and back). Every exchange has its
    backward."""
    model = SuperSloMo(ModelSpec(), device="cpu").load_state(weights.seeded_state(ModelSpec(), seed=7))
    frames = torch.from_numpy(_step_frames())
    for d in range(N_DATA):
        want = _step_grads(model, frames[d:d + 1])
        row = [r["grads"][f"step_{branch}"] for r in ranks[d * N_SPATIAL:(d + 1) * N_SPATIAL]]
        got = [sum(r["params"][i] for r in row) for i in range(len(want["params"]))]
        assert _rel_l2(got, want["params"]) <= STEP_GRAD_REL
        assert _rel_l2([torch.cat([r["frames"] for r in row], dim=2)], [want["frames"]]) <= STEP_GRAD_REL
        assert all(r["bound"] == pytest.approx(want["bound"], rel=BOUND_RTOL) for r in row)
        if branch == "halo":
            assert want["bound"] <= halo.halo_reach((32, 32))
        counts = [r["counts"] for r in row]
        gathers = 2 if branch == "full" else 0
        assert all(c["exchanges"] == c["backward_exchanges"] == 60 - gathers and
                   c["gathers"] == c["backward_gathers"] == gathers for c in counts), counts
