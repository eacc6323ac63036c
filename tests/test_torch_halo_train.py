"""Training under a spatial grid on the CPU: four gloo ranks on a (2 x 2)
(data, spatial) grid, spawned once for the module, each on one torch
thread, differentiate the halo exchange, a conv stack, the upsample and the
VGG, and run the Trainer's step with each 64x32 frame's rows split into two
32-row blocks; this process holds what they return against the one-process
port on the same numpy inputs, and the f32 step against one jitted JAX
``value_and_grad``. The row-window plain warp, the Trainer's batch check and
the port's dry run (``parallel/dryrun.py``) run here. JAX is imported only
inside test functions, so the spawned ranks never import it.

The train steps run on a panning texture (five seeded sinusoids moving 2-3
px a frame, as video moves; the clip's odd frames are the targets). The
step's gradient is discontinuous (the warp's floor, the leaky ReLU's and the
max pool's switches, the L1 kinks), and at 64x32 the deep layers' weight
gradients sum over few positions: on white-noise frames one process's own
gradients moved by up to 2.4e-2 of a tensor's max when the frames were
nudged by 1e-6, so the f32 halo step (4.1e-3 from one process there) cannot
be told from one process on noise. Bars, with what was measured (oneDNN on
an x86 CPU, one thread):
- ``exchange_rows``' backward: f32 within EXCHANGE_REL of the max |g| (the
  halo rows' gradients added in another order; measured bit for bit), bf16
  within one bf16 rounding (2^-8) of it (measured bit for bit: the
  replicated rows' gradients are summed in f32 and rounded once);
- the conv stack (k = 7, 5, 3), the upsample (both edge rows) and the VGG,
  the input's gradient and the convs' weight gradients summed over the ranks:
  f32 within LAYER_REL of each tensor's max (the blocks' sums over positions
  in another order; measured ≤ 2.7e-6), bf16 within BF16_LAYER_REL, two bf16
  ulps of the max (each conv rounds to bf16, and a value that the blocks'
  convs sum in another order rounds one ulp, 2^-7 of its binade, apart,
  which the chain carries on; measured 6.1e-3 / 5.2e-3 / 7.8e-3);
- the CONV f32 step against the one-process port: the forward outputs within
  STEP_ATOL (measured 4.6e-6), the loss vector within LOSS_RTOL (measured
  9.6e-8), every parameter's gradient within GRAD_REL of its max (measured
  2.5e-6), the weights after one Adam step within two learning rates
  of one process's everywhere (Adam's first update, lr · g / (|g| + eps),
  passes a rounding of a gradient within a few eps of zero on to the weight
  as lr · rounding / eps: measured 0.40 lr, 5.5e-4 of a tensor's max), and
  within ADAM_SAME of a learning rate plus two f32 ulps where the gradient
  exceeds 1e-5 (measured 7.5e-5 lr), and the four ranks' gradients and
  weights bit-identical;
- the same step against JAX's ``value_and_grad`` (each data row's sample at
  (1, 2, 64, 32, 3), one compile, two calls), at the bars of
  ``tests/test_torch_train.py``: outputs 5e-4 / 1e-3, loss 1e-4, each
  gradient 1e-3 of its max (measured 7.6e-6 abs, 4.8e-7 and 9.9e-7);
- the bf16 step: the loss within LOSS_RTOL (measured 3.8e-7), each stage's
  gradient, flattened, within BF16_MARGIN times the one-process bf16
  gradient's distance from its f32 one (measured 0.12 and 0.16 of it);
- the SSM-R step (``configs/superslomo_recurrent.ini``'s model, N_FRAMES=4,
  with ``[TPU] REMAT``): loss within LOSS_RTOL (measured 2.4e-7), each
  gradient within GRAD_REL of its max (measured 7.0e-4: one process's own
  gradients move by up to 7.3e-4 when its frames are nudged by 1e-6).
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from superslomo_tpu_torch import ModelSpec, SuperSloMo, Trainer, default_config, ops, parallel, weights
from superslomo_tpu_torch.config import load_config
from superslomo_tpu_torch.models.layers import Conv2d
from superslomo_tpu_torch.models.vgg import VGG16Features, vgg_state
from superslomo_tpu_torch.parallel import halo
from superslomo_tpu_torch.parallel.dryrun import dryrun_multichip
from superslomo_tpu_torch.parallel.mesh import Grid, make_grid
from tests.test_torch_package import one_torch_thread  # noqa: F401

N_DATA, N_SPATIAL = 2, 2
WORLD = N_DATA * N_SPATIAL
H, W = 64, 32  # 32-row blocks: 32 + 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXCHANGE_REL = 1e-6
LAYER_REL, BF16_LAYER_REL = 1e-5, 2.0**-6
STEP_ATOL = 1e-4
OUT_ATOL, OUT_RTOL = 5e-4, 1e-3  # the bars of tests/test_torch_train.py
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
ADAM_SAME = 1e-3  # of the learning rate: two first Adam updates of a gradient far above eps
BF16_MARGIN = np.sqrt(2.0)
EXCHANGES = [(3, 3, "zeros"), (1, 1, "replicate"), (2, 1, "replicate")]  # (top, bottom, edge)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _clip(rng, n, shift):
    """(n, H, W, 3) f32: five seeded sinusoids, the texture moving ``shift``
    px a frame to the right and half that down."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    clip = np.zeros((n, H, W, 3), np.float32)
    for _ in range(5):
        (fy, fx), phase, amp = rng.uniform(-0.3, 0.3, 2), rng.uniform(0, 6.3), rng.uniform(0.3, 1.0, 3)
        for i in range(n):
            clip[i] += np.sin(fy * (yy - 0.5 * shift * i) + fx * (xx - shift * i) + phase)[..., None] * amp
    return clip


def _batch(n_frames):
    """The global batch, one sample a data row: (frames (2, T, H, W, 3),
    targets (2, T-1, H, W, 3): the frames between, instants (2, T-1))."""
    rng = np.random.default_rng(5)
    clips = np.stack([_clip(rng, 2 * n_frames - 1, 2.0 + b) for b in range(N_DATA)])
    return clips[:, 0::2].copy(), clips[:, 1::2].copy(), np.full((N_DATA, n_frames - 1), 0.5, np.float32)


def _cfg(tmp, name):
    cfg = load_config(os.path.join(ROOT, "configs", "superslomo_recurrent.ini")) if name == "ssmr" else default_config()
    overrides = {"TRAIN_ALLOW_RANDOM_VGG": "TRUE", "TRAIN_BATCH_SIZE": N_DATA, "TRAIN_CKPT_DIR": str(tmp),
                 "TRAIN_N_EPOCHS": 1}
    if name == "bf16":
        overrides["TPU_COMPUTE_DTYPE"] = "bfloat16"
    if name == "ssmr":
        overrides["TPU_REMAT"] = "TRUE"
    for key, value in overrides.items():
        section, _, k = key.partition("_")
        cfg.set(section, k, value)
    return cfg


STEPS = ("conv_f32", "bf16", "ssmr")


def _n_frames(name):
    return 4 if name == "ssmr" else 2


def _conv(k, dtype=torch.float32):
    conv = Conv2d(8, 8, k, padding=k // 2, bias=True)
    rng = np.random.default_rng(k)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal(conv.weight.shape).astype(np.float32) * 0.1))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(conv.bias.shape).astype(np.float32) * 0.1))
    return conv.to(dtype=dtype, memory_format=torch.channels_last)


def _vgg(dtype=torch.float32):
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state(None, seed=3))
    return vgg.to(dtype=dtype, memory_format=torch.channels_last)


LAYERS = {  # name → (input (4, C, rows, cols), the layers to run, the output gradient's seed)
    "convs": ((4, 8, H, 24), lambda dt: [_conv(k, dt) for k in (7, 5, 3)]),
    "upsample": ((4, 8, 16, 12), lambda dt: [ops.upsample_2x_bilinear]),
    "vgg": ((2, 3, H, W), lambda dt: [_vgg(dt)]),
}


def _layer_input(name):
    shape, _ = LAYERS[name]
    return np.random.default_rng(31).standard_normal(shape).astype(np.float32)


def _out_grad(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32))


def _run_layers(name, dt, x):
    """``x``'s gradient and each conv's weight and bias gradients for the
    loss sum(out · G), G a seeded gradient over the whole output."""
    _, make = LAYERS[name]
    layers = make(dt)
    x = x.to(dt).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = x
    for layer in layers:
        out = layer(out)
    return out, x, [p for layer in layers if isinstance(layer, torch.nn.Module) for p in layer.parameters()]


def _mine(x, grid, rows_dim=2):
    """This rank's share of a batch (its data row's half) and its block of rows."""
    per = x.shape[0] // grid.n_data
    x = x[grid.data_index * per:(grid.data_index + 1) * per]
    h = x.shape[rows_dim] // grid.n_spatial
    return x.narrow(rows_dim, grid.spatial_index * h, h)


def _rank_layers(grid):
    out = {}
    with halo.spatial(grid):
        for i, (top, bottom, edge) in enumerate(EXCHANGES):
            for tag, dt in DTYPES.items():
                x = _mine(torch.from_numpy(_layer_input("convs")), grid).to(dt).requires_grad_(True)
                y = halo.exchange_rows(x, top, bottom, edge)
                g = _out_grad((4, 8, N_SPATIAL, H // N_SPATIAL + top + bottom, 24), i)
                per = g.shape[0] // grid.n_data  # this rank's share of the extended blocks' gradient
                (y.float() * g[grid.data_index * per:(grid.data_index + 1) * per, :, grid.spatial_index]).sum().backward()
                out[f"exchange{i}_{tag}"] = x.grad
        for name in LAYERS:
            for tag, dt in DTYPES.items():
                halo.reset_counts()
                y, x, params = _run_layers(name, dt, _mine(torch.from_numpy(_layer_input(name)), grid))
                g = _out_grad((y.shape[0] * N_DATA, y.shape[1], y.shape[2] * N_SPATIAL, y.shape[3]), 7)
                (y.float() * _mine(g, grid)).sum().backward()
                out[f"{name}_{tag}"] = {"x": x.grad, "params": [p.grad for p in params if p.grad is not None],
                                        "exchanges": dict(halo.counts)}
    return out


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_steps(grid, tmp):
    """Each step's loss, exchange counts, outputs (this rank's rows) and the
    digests of the gradients and the weights after the step; rank 0 also
    returns the gradients and, for the f32 step, the weights."""
    out = {}
    for name in STEPS:
        tr = Trainer(_cfg(tmp, name), device="cpu", grid=grid)
        outputs = []
        hook = tr.model.register_forward_hook(lambda module, args, o: outputs.append(o))
        frames, targets, t = (x[grid.data_index:grid.data_index + 1] for x in _batch(_n_frames(name)))
        halo.reset_counts()
        loss = tr.train_step(frames, targets, t)
        hook.remove()
        o = outputs[0]
        grads, params = [p.grad for *_, p in tr.trainable], [p for *_, p in tr.trainable]
        out[name] = {"loss": loss, "counts": dict(halo.counts), "digests": (_digest(grads), _digest(params)),
                     "outputs": [x.detach() for x in (o.flowC_out, o.flowI_in, o.flowI_out, o.pred_images)],
                     "pair_rows": (tuple(o.pair_rows[0].shape), tuple(o.pair_rows[1]))}
        if grid.rank == 0:
            out[name]["grads"] = [g.clone() for g in grads]
            if name == "conv_f32":
                out[name]["weights"] = [p.detach().clone() for p in params]
    return out


def _rank_main(rank, init_file, work):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    parallel.init_data_parallel(device="cpu", init_method=f"file://{init_file}")
    grid = make_grid(N_DATA, N_SPATIAL)
    out = {"layers": _rank_layers(grid), "steps": _rank_steps(grid, work)}
    parallel.barrier()
    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, in rank order."""
    work = str(tmp_path_factory.mktemp("halo_train"))
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


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """One process's Trainer step of each kind on the global batch: the
    loss vector, every gradient, the weights after the step, the forward's
    outputs."""
    tmp = tmp_path_factory.mktemp("halo_train_one")
    out = {}
    for name in STEPS:
        tr = Trainer(_cfg(tmp, name), device="cpu")
        state = {s: {k: v.clone() for k, v in getattr(tr.model, s).state_dict().items()} for s in ("stage1", "stage2")}
        outputs = []
        hook = tr.model.register_forward_hook(lambda module, args, o: outputs.append(o))
        loss = tr.train_step(*_batch(_n_frames(name)))
        hook.remove()
        o = outputs[0]
        out[name] = {"loss": loss, "grads": [p.grad.clone() for *_, p in tr.trainable],
                     "names": [f"{stage}.{key}" for stage, key, _ in tr.trainable],
                     "stages": [stage for stage, *_ in tr.trainable]}
        if name == "conv_f32":
            out[name].update(
                weights=[p.detach().clone() for *_, p in tr.trainable], lr=tr.optimizer.param_groups[0]["lr"],
                outputs=[x.detach() for x in (o.flowC_out, o.flowI_in, o.flowI_out, o.pred_images)],
                state=state, vgg=tr.vgg.state_dict())  # state: the weights before the step
    return out


def _assemble(parts, rows_dim=2):
    """The ranks' tensors (rank order: data-major) put together: each data
    row's blocks along ``rows_dim``, the data rows along the batch."""
    rows = [torch.cat([p.float() for p in parts[d * N_SPATIAL:(d + 1) * N_SPATIAL]], dim=rows_dim)
            for d in range(N_DATA)]
    return torch.cat(rows, dim=0)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# ----------------------------------------------------------------------------- in this process


def test_row_window_single_flow_warp_and_its_flow_gradient_are_one_process_rows():
    """The plain single-flow warp under a row window: frame rows [24, 56) of
    a 64-row frame against the whole frame (the train step's window: the
    pair's view, pixel stride 6), flows up to 9 px: the output and the
    flow's gradient bit for bit one process's rows; a window of planes that
    ends at row 48 reads zeros past it."""
    rng = np.random.default_rng(3)
    pair = torch.from_numpy(rng.standard_normal((2, 64, 40, 6)).astype(np.float32)).permute(0, 3, 1, 2)
    flow = torch.from_numpy(rng.uniform(-9, 9, (2, 2, 64, 40)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 64, 40)).astype(np.float32))
    whole = flow.clone().requires_grad_(True)
    want = ops.warp_auto(pair[:, 3:6], whole)
    want.backward(g)
    block = flow[:, :, 24:56].clone().requires_grad_(True)
    got = ops.warp_auto(pair[:, 3:6], block, rows=halo.RowWindow(24, 0, 64, 64))
    got.backward(g[:, :, 24:56])
    assert torch.equal(got, want[:, :, 24:56]) and torch.equal(block.grad, whole.grad[:, :, 24:56])
    cut = ops.warp_auto(pair[:, 3:6, :48], flow[:, :, 24:56] + torch.tensor([0.0, 30.0])[:, None, None],
                        rows=halo.RowWindow(24, 0, 48, 64))
    assert torch.equal(cut[:, :, -8:], torch.zeros_like(cut[:, :, -8:]))


def test_trainer_checks_the_batch_against_the_data_rows(tmp_path):
    """Under a grid the global batch is shared over the data rows only."""
    grid = Grid(2, 3, 0, None, None, (0, 3), (0, 1, 2))
    with pytest.raises(ValueError, match="multiple of the 2 data-parallel ranks"):
        Trainer(default_config(TRAIN_ALLOW_RANDOM_VGG="TRUE", TRAIN_BATCH_SIZE=3, TRAIN_CKPT_DIR=str(tmp_path)),
                device="cpu", grid=grid)


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    """The port's ``dryrun_multichip``: one production Trainer step on a 2 x
    2 grid of gloo ranks, the loss finite and the ranks' weights
    bit-identical, a mark a phase."""
    results = dryrun_multichip(4, device="cpu")
    assert [r["grid"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r["weights_sha256"] for r in results}) == 1
    printed = capfd.readouterr().out
    assert "trainer built" in printed and "step done" in printed and "# dryrun ok: 4 ranks over gloo" in printed


# ----------------------------------------------------------------------------- the ranks


@pytest.mark.parametrize("case", range(len(EXCHANGES)))
@pytest.mark.parametrize("tag", list(DTYPES))
def test_exchange_rows_backward_is_one_process_autograd(ranks, case, tag):
    """The halo exchange's backward: each rank's gradient keeps its own rows'
    and adds the halo gradients its neighbours send back; at the frame's
    edges zero rows drop theirs and replicated rows sum into the edge row.
    One process: the frame padded the same way, each rank's extended block a
    slice of it, the same loss."""
    top, bottom, edge = EXCHANGES[case]
    dt = DTYPES[tag]
    x = torch.from_numpy(_layer_input("convs")).to(dt).requires_grad_(True)
    pad = torch.nn.functional.pad(x.float(), (0, 0, top, bottom), mode="constant" if edge == "zeros" else "replicate")
    g = _out_grad((4, 8, N_SPATIAL, H // N_SPATIAL + top + bottom, 24), case)
    h = H // N_SPATIAL
    loss = sum((pad[:, :, s * h:s * h + h + top + bottom].to(dt).float() * g[:, :, s]).sum() for s in range(N_SPATIAL))
    loss.backward()
    got = _assemble([r["layers"][f"exchange{case}_{tag}"] for r in ranks])
    assert got.shape == x.shape
    assert _rel(got, x.grad) <= (EXCHANGE_REL if tag == "f32" else 2.0**-8)


@pytest.mark.parametrize("name", list(LAYERS))
@pytest.mark.parametrize("tag", list(DTYPES))
def test_sharded_layer_gradients_equal_one_process(ranks, name, tag):
    """The conv stack (k = 7, 5, 3), the upsample (both edge rows: the first
    row taken from the frame's first row alone, the last clamped through a
    replicated halo row) and the VGG, each under the grid: the input's
    gradient and each conv's weight and bias gradient (summed over the four
    ranks) against one process's autograd on the whole batch; the VGG's ten
    convs exchange halo rows, forward and back."""
    dt = DTYPES[tag]
    want_y, want_x, params = _run_layers(name, dt, torch.from_numpy(_layer_input(name)))
    (want_y.float() * _out_grad(want_y.shape, 7)).sum().backward()
    bar = LAYER_REL if tag == "f32" else BF16_LAYER_REL
    got = [r["layers"][f"{name}_{tag}"] for r in ranks]
    assert _rel(_assemble([r["x"] for r in got]), want_x.grad) <= bar
    want_params = [p.grad for p in params if p.grad is not None]
    assert all(len(r["params"]) == len(want_params) for r in got)
    for i, w in enumerate(want_params):
        assert _rel(sum(r["params"][i].float() for r in got), w) <= bar, i
    n_convs = {"convs": 3, "upsample": 1, "vgg": 10}[name]
    assert all(r["exchanges"]["exchanges"] == r["exchanges"]["backward_exchanges"] == n_convs for r in got)


def test_sharded_forward_outputs_equal_one_process(ranks, one_process):
    """``SuperSloMo.forward`` under the grid (the CONV f32 step's): each
    rank's rows of the four outputs against one process's, and the gathered
    pairs at the whole height with the window of this rank's rows."""
    for i, want in enumerate(one_process["conv_f32"]["outputs"]):
        got = _assemble([r["steps"]["conv_f32"]["outputs"][i] for r in ranks])
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= STEP_ATOL, i
    for r in ranks:
        (shape, window) = r["steps"]["conv_f32"]["pair_rows"]
        assert shape == (1, 6, H, W) and window[1:] == (0, H, H)
    assert [r["steps"]["conv_f32"]["pair_rows"][1][0] for r in ranks] == [0, 32, 0, 32]


@pytest.mark.parametrize("name", STEPS)
def test_sharded_train_step_equals_one_process(ranks, one_process, name):
    """The Trainer's step on the grid against one process's on the global
    batch: the loss vector (every rank's), every parameter's gradient (the
    spatial ranks' parts summed, the data rows averaged), and in f32 the
    weights after the Adam step; the four ranks' weights bit-identical."""
    want = one_process[name]
    for r in ranks:
        np.testing.assert_allclose(r["steps"][name]["loss"].numpy(), want["loss"].numpy(), rtol=LOSS_RTOL)
    got = ranks[0]["steps"][name]
    assert all(r["steps"][name]["digests"] == got["digests"] for r in ranks[1:])  # gradients and weights
    if name == "bf16":  # each stage's gradient against the bf16 gradient's distance from f32
        f32 = one_process["conv_f32"]
        for stage in ("stage1", "stage2"):
            idx = [i for i, s in enumerate(want["stages"]) if s == stage]
            flat = lambda ts: torch.cat([ts[i].reshape(-1) for i in idx])  # noqa: E731
            dist = (flat(got["grads"]) - flat(want["grads"])).norm().item()
            assert dist <= BF16_MARGIN * (flat(want["grads"]) - flat(f32["grads"])).norm().item(), stage
        return
    for n, g, w in zip(want["names"], got["grads"], want["grads"]):
        assert _rel(g, w) <= GRAD_REL, n
    if name == "conv_f32":  # Adam's first update, lr · g / (|g| + eps), of each weight
        lr = want["lr"]
        for n, w_got, w_want, g in zip(want["names"], got["weights"], want["weights"], want["grads"]):
            stage, key = n.split(".", 1)
            apart = (w_got - w_want).abs()
            assert apart.max().item() <= 2 * lr, n
            far = g.abs() > 1e-5
            assert apart[far].max().item() <= ADAM_SAME * lr + 2 * float(np.spacing(np.float32(1.0))) * (
                want["state"][stage][key].abs().max().item() + lr), n


def test_exchange_counts_of_a_train_step(ranks):
    """A CONV step a rank: 78 exchanges forward (both U-Nets' 24 convs and 5
    upsamples, the VGG's 10 convs on the prediction and 10 on the target),
    67 backward (all but stage 1's first conv, whose input is the frames, and
    the target's VGG, under no_grad), one gather of the pairs; with REMAT the
    U-Nets' exchanges run again in the backward's recompute, the gather does
    not."""
    for r in ranks:
        conv = r["steps"]["conv_f32"]["counts"]
        assert (conv["exchanges"], conv["backward_exchanges"], conv["gathers"]) == (78, 67, 1)
        assert r["steps"]["bf16"]["counts"]["exchanges"] == 78
        ssmr = r["steps"]["ssmr"]["counts"]
        assert ssmr["gathers"] == 1 and ssmr["backward_exchanges"] == 87
        assert ssmr["exchanges"] == 98 + (98 - 20)  # the U-Nets' (not the VGG's) recomputed


def test_sharded_f32_step_equals_jax(ranks, one_process):
    """The sharded CONV f32 step against ONE jitted JAX ``value_and_grad``
    of the model and the composite loss at (1, 2, 64, 32, 3), called on each
    data row's sample, at the same weights and VGG features: the outputs,
    the loss vector and every gradient (the two calls averaged, as the
    global batch's mean loss) at the bars of ``tests/test_torch_train.py``."""
    import jax
    import jax.numpy as jnp

    from superslomo_tpu.config import ModelSpec as JaxModelSpec
    from superslomo_tpu.models import losses as jlosses
    from superslomo_tpu.models.superslomo import SuperSloMo as JaxSuperSloMo
    from superslomo_tpu.models.vgg import VGG16Features as JaxVGG

    ref = one_process["conv_f32"]
    params = weights.jax_tree_from_torch_state(ref["state"])
    vgg_params = {"params": {f"features_{k.split('.')[1]}": {
        "kernel": ref["vgg"][k].numpy().transpose(2, 3, 1, 0), "bias": ref["vgg"][k[:-6] + "bias"].numpy()}
        for k in ref["vgg"] if k.endswith("weight")}}
    spec = JaxModelSpec()
    model, vgg = JaxSuperSloMo(spec=spec), JaxVGG()

    def loss_fn(p, vp, frames, targets, t):
        out = model.apply(p, frames, t)
        per_sample = jlosses.compute_losses(out, targets, spec, jlosses.LossWeights(60.0, 10.0, 20.0),
                                            lambda img: vgg.apply(vp, img))
        return per_sample[:, 0].mean(), (per_sample.mean(axis=0),
                                         (out.flowC_out, out.flowI_in, out.flowI_out, out.pred_images))

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    frames, targets, t = _batch(2)
    calls = [step(params, vgg_params, *(jnp.asarray(x[d:d + 1]) for x in (frames, targets, t))) for d in range(N_DATA)]
    got = ranks[0]["steps"]["conv_f32"]
    for i in range(4):
        want = np.concatenate([np.asarray(c[0][1][1][i]) for c in calls])
        out = _assemble([r["steps"]["conv_f32"]["outputs"][i] for r in ranks]).numpy()
        np.testing.assert_allclose(out, want, atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=str(i))
    np.testing.assert_allclose(got["loss"].numpy(), np.mean([np.asarray(c[0][1][0]) for c in calls], axis=0),
                               rtol=LOSS_RTOL)
    mean_grads = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, calls[0][1], calls[1][1])
    want = weights.torch_state_from_jax(mean_grads)
    for n, g in zip(ref["names"], got["grads"]):
        stage, key = n.split(".", 1)
        w = want[stage][key]
        assert _rel(g, w) <= GRAD_REL, n


def test_a_grid_of_one_spatial_rank_splits_no_rows():
    """Under a data-only grid the forward splits no rows and gathers
    nothing: no ``pair_rows``, the whole frame out."""
    model = SuperSloMo(ModelSpec(), device="cpu").load_state(weights.seeded_state(ModelSpec(), seed=7))
    with torch.no_grad(), halo.spatial(Grid(2, 1, 0, None, None, (0, 1), (0,))):
        out = model(_batch(2)[0][:1], np.full((1, 1), 0.5, np.float32))
    assert out.pair_rows is None and out.pred_images.shape == (1, 1, H, W, 3)
