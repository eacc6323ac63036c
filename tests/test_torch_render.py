"""The port's slow-motion renderer and Sintel flow evaluator on the CPU,
against the JAX package run live on the same inputs: ``.flo`` files, EPE and
the flow colouring (``utils/flo.py``), the PNG writer against cv2 and the
port's decoder, ``SintelFlowReader``, the ``Interpolator`` end to end and its
intermediates dump, ``evaluate_flow``, and both command lines with
``--device cpu``; and the fused multi-t step that renders a window
(``SuperSloMo.interpolate_multi_t``) against the JAX package's at 32x32, in
f32 and bf16.

Four model-sized JAX programs run here, all under ``jax.jit`` (on an 8-core
x86 host the eager step compiles ~750 single-op programs and takes 45 s a
dtype, the jitted one 18 s): the renderer's fused step and the flow
evaluator's forward at 64x96, and the fused step at 32x32 in both dtypes.
They share this file of many cheap tests because xdist's ``loadfile``
schedule hands out the files with the most tests first: a file of a few
tests, each a JAX compile, would start last and outlast the suite. The
renderer's weights are the port's seeded weights, saved as a reference
``.pt`` that the JAX package converts.
"""

import json
import os
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superslomo_tpu.config import ModelSpec as JaxModelSpec
from superslomo_tpu.config import load_config as jax_load_config
from superslomo_tpu.data.readers import SintelFlowReader as JaxSintelFlowReader
from superslomo_tpu.eval import visualize as jax_visualize
from superslomo_tpu.eval.evaluate_flow import evaluate_flow as jax_evaluate_flow
from superslomo_tpu.models.superslomo import SuperSloMo as JaxSuperSloMo
from superslomo_tpu.training.checkpoint import convert_torch_checkpoint
from superslomo_tpu.utils import flo as jax_flo
from superslomo_tpu_torch import weights
from superslomo_tpu_torch.cli import evaluate_flow as flow_cli
from superslomo_tpu_torch.cli import visualize as render_cli
from superslomo_tpu_torch.config import ModelSpec, load_config
from superslomo_tpu_torch.data import png
from superslomo_tpu_torch.data.readers import SintelFlowReader
from superslomo_tpu_torch.eval.evaluate_flow import evaluate_flow
from superslomo_tpu_torch.eval.visualize import Interpolator
from superslomo_tpu_torch.models import superslomo as port_model
from superslomo_tpu_torch.models.superslomo import SuperSloMo
from superslomo_tpu_torch.utils import flo
from tests.test_torch_cli import ROOT, _config, _write_clip
from tests.test_torch_package import one_torch_thread  # noqa: F401

H, W = 60, 96  # the renderer's clip, padded to 64x96 (tests/test_eval.py's shape)
SINTEL_H = 52  # Sintel frames padded 6 + 6 rows to 64


@pytest.fixture(scope="module", autouse=True)
def first_parallel_exp():
    """PyTorch's first parallel ``torch.exp`` in a process sometimes computes
    one intra-op thread's share with a coarser rounding (about 1 process in
    10 on an 8-thread x86 host, up to 6e-5 relative): make that call here,
    so that the model calls compared exactly below all come after it."""
    torch.exp(torch.zeros(1 << 16))


def _clip(folder, n, h, w, seed):
    """``n`` frames of a panning texture written by cv2 into ``folder``
    (``_write_clip``); returns them (n, h, w, 3) RGB uint8."""
    paths = _write_clip(np.random.default_rng(seed), str(folder), n, h, w)
    return np.stack([cv2.imread(p)[..., ::-1] for p in paths])


SEEDED = {"STAGE1": {"LOADPREV": "FALSE"}, "STAGE2": {"LOADPREV": "FALSE"}}  # seeded weights, no file


def _decode(path):
    """A PNG through cv2, RGB (colour) or 2-D (grey)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.fixture(scope="module")
def weights_pt(tmp_path_factory):
    """The port's seeded weights of configs/superslomo_eval.ini's model (seed
    42, as its command lines make them) and the same weights in the JAX
    package's tree, through its converter of the reference ``.pt``."""
    cfg = load_config(os.path.join(ROOT, "configs", "superslomo_eval.ini"))
    state = weights.seeded_state(cfg.model_spec(), seed=cfg.getint("SEED", "VALUE"))
    path = weights.save_checkpoint(str(tmp_path_factory.mktemp("w") / "seeded.pt"), state["stage1"],
                                   state["stage2"], {}, 0, 0)
    return state, convert_torch_checkpoint(path)


# --------------------------------------------------------------------------- #
# (a) utils/flo.py


def _flows(seed, h=13, w=17):
    """A ground truth with unknown pixels (1e7 and beyond) and a prediction."""
    rng = np.random.default_rng(seed)
    gt = (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)
    gt[rng.random((h, w)) < 0.1, rng.integers(0, 2)] = 1e7
    gt[0, 0] = [1e9, 0.0]
    pred = (gt + rng.standard_normal((h, w, 2)) * 2.5).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flo_files_read_back_in_the_other_package(tmp_path, writer):
    flow, _ = _flows(0)
    path = str(tmp_path / "f.flo")
    (jax_flo if writer == "jax" else flo).write_flo(flow, path)
    reader = flo if writer == "jax" else jax_flo
    got = reader.read_flo(path)
    assert got.dtype == np.float32 and got.shape == flow.shape
    np.testing.assert_array_equal(got, flow)
    other = str(tmp_path / "g.flo")
    (flo if writer == "jax" else jax_flo).write_flo(flow, other)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_read_flo_refuses_a_bad_magic(tmp_path):
    path = tmp_path / "bad.flo"
    path.write_bytes(np.array([1.0, 2, 2], np.float32).tobytes())
    with pytest.raises(ValueError, match="magic"):
        flo.read_flo(str(path))
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        flo.write_flo(np.zeros((2, 2, 3), np.float32), str(tmp_path / "x.flo"))


@pytest.mark.parametrize("seed", [1, 2])
def test_epe_and_gt3px_equal_jax_with_unknown_pixels(seed):
    gt, pred = _flows(seed)
    assert (np.abs(gt) >= 1e7).any()
    assert flo.flow_epe(gt, pred) == jax_flo.flow_epe(gt, pred)
    assert np.isfinite(flo.flow_epe(gt, pred))
    for thresh in (3.0, 1.0):
        assert flo.flow_error_percent(gt, pred, thresh) == jax_flo.flow_error_percent(gt, pred, thresh)
    assert 0 < flo.flow_error_percent(gt, pred) < 100


@pytest.mark.parametrize("max_flow", [None, 0, 2.0, 50.0])
def test_flow_to_image_equals_jax_bit_for_bit(max_flow):
    gt, pred = _flows(3, 31, 40)
    for flow in (gt, pred, np.zeros((4, 5, 2), np.float32)):
        got = flo.flow_to_image(flow, max_flow)
        assert got.dtype == np.uint8 and got.shape == flow.shape[:2] + (3,)
        np.testing.assert_array_equal(got, jax_flo.flow_to_image(flow, max_flow))
    np.testing.assert_array_equal(flo._WHEEL, jax_flo._WHEEL)


# --------------------------------------------------------------------------- #
# (b) data/png.py::imwrite


@pytest.mark.parametrize("shape", [(60, 96, 3), (7, 5, 3), (1, 1, 3), (60, 96), (3, 1)],
                         ids=["rgb", "rgb_odd", "rgb_1px", "grey", "grey_column"])
def test_imwrite_decodes_bit_for_bit_through_cv2_and_png(tmp_path, shape):
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.imwrite(path, img)
    np.testing.assert_array_equal(_decode(path), img)
    ours = png.imread(path)
    np.testing.assert_array_equal(ours, img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2))
    (w, h, depth, ctype, interlace), stream, _, _ = png.read_chunks(path)
    assert (w, h, depth, ctype, interlace) == (shape[1], shape[0], 8, 2 if img.ndim == 3 else 0, 0)
    stride = w * (3 if img.ndim == 3 else 1)
    rows = np.frombuffer(zlib.decompress(stream), np.uint8).reshape(h, stride + 1)
    assert (rows[:, 0] == 1).all()  # every row Sub-filtered, as cv2 writes them


@pytest.mark.parametrize("img", [np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8),
                                 np.zeros(4, np.uint8)], ids=["float", "four_channels", "one_dim"])
def test_imwrite_refuses_other_arrays(tmp_path, img):
    with pytest.raises(ValueError, match="uint8"):
        png.imwrite(str(tmp_path / "x.png"), img)
    assert not os.path.exists(tmp_path / "x.png")


# --------------------------------------------------------------------------- #
# (c) SintelFlowReader


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    """The Sintel EPE layout (tests/test_eval.py's): final/<clip>/ frames at
    52x96 and flow/<clip>/ .flo files, two clips (4 frames and 3 flows; 3
    frames and 2 flows); ground truths of a few px with unknown pixels."""
    root = tmp_path_factory.mktemp("sintel")
    rng = np.random.default_rng(5)
    for clip, n, seed in (("alley_1", 4, 6), ("bamboo_2", 3, 7)):
        _clip(root / "final" / clip, n, SINTEL_H, W, seed)
        os.makedirs(root / "flow" / clip)
        for i in range(n - 1):
            gt = (rng.standard_normal((SINTEL_H, W, 2)) * 2.5).astype(np.float32)
            gt[rng.random((SINTEL_H, W)) < 0.02] = 1e10
            flo.write_flo(gt, str(root / "flow" / clip / f"frame_{i + 1:04d}.flo"))
    return root


@pytest.mark.parametrize("n_frames", [2, 4])
def test_sintel_reader_equals_jax(sintel, n_frames, tmp_path):
    ini = _config(tmp_path, "superslomo_eval.ini", SINTEL_EPE_DATA={"ROOTDIR": sintel},
                  TRAIN={"N_FRAMES": n_frames})
    ours, theirs = SintelFlowReader(load_config(ini)), JaxSintelFlowReader(jax_load_config(ini))
    assert ours.samples == theirs.samples and len(ours) == 5
    for i in range(len(ours)):
        (frames, flow), (want_frames, want_flow) = ours[i], theirs[i]
        assert frames.shape == (n_frames, SINTEL_H + 12, W, 3) and frames.dtype == np.float32
        np.testing.assert_array_equal(frames, want_frames)
        np.testing.assert_array_equal(flow, want_flow)


def test_sintel_reader_refuses_three_frames(sintel, tmp_path):
    ini = _config(tmp_path, "superslomo_eval.ini", SINTEL_EPE_DATA={"ROOTDIR": sintel}, TRAIN={"N_FRAMES": 3})
    with pytest.raises(ValueError, match="N_FRAMES"):
        JaxSintelFlowReader(jax_load_config(ini))
    with pytest.raises(ValueError, match="N_FRAMES"):
        SintelFlowReader(load_config(ini))


# --------------------------------------------------------------------------- #
# (d), (e) the renderer


@pytest.fixture(scope="module")
def renders(tmp_path_factory, weights_pt):
    """A 5-frame 60x96 panning clip rendered at upsample_rate 4 for 2 windows
    by the JAX package's Interpolator and by the port's on the CPU, from the
    same weights."""
    state, jax_params = weights_pt
    root = tmp_path_factory.mktemp("render")
    frames = _clip(root / "clip", 5, H, W, seed=8)
    cfg_path = _config(root, "superslomo_eval.ini", **SEEDED)
    jax_interp = jax_visualize.Interpolator(jax_load_config(cfg_path), jax_params, upsample_rate=4)
    n_jax = jax_interp.interpolate_directory(str(root / "clip"), str(root / "jax"), max_windows=2)
    interp = Interpolator(load_config(cfg_path), state, upsample_rate=4, device="cpu")
    n_port = interp.interpolate_directory(str(root / "clip"), str(root / "port"), max_windows=2)
    return {"root": root, "frames": frames, "n": (n_jax, n_port), "jax_interp": jax_interp, "interp": interp}


def test_renderer_matches_jax(renders):
    root, frames = renders["root"], renders["frames"]
    n_jax, n_port = renders["n"]
    names = sorted(os.listdir(root / "port"))
    assert n_port == n_jax == len(names) == 2 * 4 + 1
    assert names == sorted(os.listdir(root / "jax")) == [f"{i:06d}.png" for i in range(9)]
    originals = {0: frames[0], 4: frames[1], 8: frames[4]}  # each window's left frame, then the clip's last
    flipped = 0
    for i, name in enumerate(names):
        ours, theirs = png.imread(str(root / "port" / name)), _decode(str(root / "jax" / name))
        assert ours.shape == theirs.shape == (H, W, 3)
        if i in originals:
            np.testing.assert_array_equal(ours, originals[i])
            np.testing.assert_array_equal(theirs, originals[i])
            continue
        diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
        assert diff.max() <= 1, name  # the model's 5e-4 bar is ~0.03 levels; the truncating cast flips a few
        flipped += int((diff > 0).sum())
    assert flipped <= 0.01 * 6 * H * W * 3
    assert len({png.imread(str(root / "port" / n)).tobytes() for n in names}) == len(names)


@pytest.mark.parametrize("n_frames", [2, 4])
def test_sliding_windows_equal_jax(n_frames):
    """Edge-clamped windows: N_FRAMES=4 repeats the clip's first and last
    frame."""
    ours = Interpolator.sliding_windows(type("I", (), {"n_frames": n_frames})(), 5)
    theirs = jax_visualize.Interpolator.sliding_windows(type("I", (), {"n_frames": n_frames})(), 5)
    ours, theirs = list(ours), list(theirs)
    assert ours == theirs and len(ours) == 4
    assert ours[0] == ([0, 1] if n_frames == 2 else [0, 0, 1, 2]) and ours[-1][-1] == 4


def test_renderer_reads_jpeg_as_jax(renders, tmp_path):
    """A .jpg copy of the fixture's clip (cv2's files, q95 4:2:0) rendered
    by the fixture's JAX and port interpolators for 2 windows: the originals
    equal cv2's decode bit for bit on both sides, the renders are held to the
    bars of ``test_renderer_matches_jax``."""
    os.makedirs(tmp_path / "clip")
    for i, frame in enumerate(renders["frames"]):
        cv2.imwrite(str(tmp_path / "clip" / f"frame_{i:05d}.jpg"), frame[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    decoded = [cv2.imread(str(tmp_path / "clip" / f"frame_{i:05d}.jpg"))[..., ::-1] for i in range(5)]
    n_jax = renders["jax_interp"].interpolate_directory(str(tmp_path / "clip"), str(tmp_path / "jax"), max_windows=2)
    n_port = renders["interp"].interpolate_directory(str(tmp_path / "clip"), str(tmp_path / "port"), max_windows=2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert n_port == n_jax == len(names) == 9 and names == sorted(os.listdir(tmp_path / "jax"))
    originals = {0: decoded[0], 4: decoded[1], 8: decoded[4]}
    flipped = 0
    for i, name in enumerate(names):
        ours, theirs = png.imread(str(tmp_path / "port" / name)), _decode(str(tmp_path / "jax" / name))
        assert ours.shape == theirs.shape == (H, W, 3)
        if i in originals:
            np.testing.assert_array_equal(ours, originals[i])
            np.testing.assert_array_equal(theirs, originals[i])
            continue
        diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
        assert diff.max() <= 1, name
        flipped += int((diff > 0).sum())
    assert flipped <= 0.01 * 6 * H * W * 3


def test_renderer_decimates_as_jax(renders, tmp_path):
    """18 frames decimated are frames 0, 8 and 16: one window of 0 and 8,
    then frame 16 as the last frame (not 17)."""
    frames = _clip(tmp_path / "clip", 18, H, W, seed=10)
    interp = renders["interp"]
    paths = sorted(str(tmp_path / "clip" / f"frame_{i:05d}.png") for i in range(18))
    assert interp.frame_paths(str(tmp_path / "clip"), decimate=True) == paths[::8]
    n = interp.interpolate_directory(str(tmp_path / "clip"), str(tmp_path / "out"), decimate=True, max_windows=1)
    assert n == 5 and sorted(os.listdir(tmp_path / "out")) == [f"{i:06d}.png" for i in range(5)]
    np.testing.assert_array_equal(png.imread(str(tmp_path / "out" / "000000.png")), frames[0])
    np.testing.assert_array_equal(png.imread(str(tmp_path / "out" / "000004.png")), frames[16])


def test_dump_intermediates_equal_jax_writer(renders, tmp_path, monkeypatch):
    """The port's visibility and flow PNGs of a window equal what the JAX
    renderer's ``_dump_intermediates`` writes of the port's intermediates
    (the intermediates themselves are held against JAX by the forward
    tests)."""
    interp, jax_interp = renders["interp"], renders["jax_interp"]
    frames = interp.load_frames(sorted(str(renders["root"] / "clip" / f"frame_{i:05d}.png") for i in (1, 2)))[None]
    frames = torch.from_numpy(frames)
    t = torch.full((1, 1), 0.5)
    _, inter, _ = interp.model.forward_inference(frames, t)
    inter_np = type(inter)(*(x.numpy() for x in inter))
    monkeypatch.setattr(jax_visualize, "forward_inference", lambda model, params, f, t: (None, inter_np, None))
    dirs = ("visibility", "flow_est", "flow_refined")
    for side in ("jax", "port"):
        for d in dirs:
            os.makedirs(tmp_path / side / d)
    jax_interp._dump_intermediates(frames.numpy(), str(tmp_path / "jax"), 3)
    interp._dump_intermediates(frames, str(tmp_path / "port"), 3)
    for d in dirs:
        path = str(tmp_path / "port" / d / "000003.png")
        got, want = _decode(path), _decode(str(tmp_path / "jax" / d / "000003.png"))
        assert got.shape == want.shape == ((64, W) if d == "visibility" else (64, W, 3)), d
        np.testing.assert_array_equal(got, want)
        assert png.read_chunks(path)[0][3] == (0 if d == "visibility" else 2)  # grey, RGB
    assert 0 < _decode(str(tmp_path / "port" / "visibility" / "000003.png")).max() < 255


# --------------------------------------------------------------------------- #
# (f) evaluate_flow


def test_evaluate_flow_matches_jax(sintel, weights_pt, tmp_path):
    state, jax_params = weights_pt
    ini = _config(tmp_path, "superslomo_eval.ini", **SEEDED, SINTEL_EPE_DATA={"ROOTDIR": sintel})
    want = jax_evaluate_flow(jax_load_config(ini), jax_params, max_samples=2)
    got = evaluate_flow(load_config(ini), state, max_samples=2, device="cpu")
    assert set(got) == {"EPE", "gt3px_percent", "n_samples"} and got["n_samples"] == want["n_samples"] == 2
    assert abs(got["EPE"] - want["EPE"]) <= 1e-3  # px; the flows agree within the model's 5e-4 bar
    one_pixel = 100.0 / (SINTEL_H * W)  # one pixel's share of a sample, in percent
    assert abs(got["gt3px_percent"] - want["gt3px_percent"]) <= one_pixel
    assert 0 < got["gt3px_percent"] < 100 and np.isfinite(got["EPE"])


# --------------------------------------------------------------------------- #
# (g) the command lines


def test_visualize_cli_equals_interpolator(weights_pt, tmp_path, capsys):
    state, _ = weights_pt
    _clip(tmp_path / "clip", 3, H, W, seed=11)
    ini = _config(tmp_path, "superslomo_eval.ini", **SEEDED)
    message = render_cli.main(["-c", ini, "--input-dir", str(tmp_path / "clip"), "--output-dir", str(tmp_path / "cli"),
                               "--upsample-rate", "3", "--dump-intermediates", "--log", str(tmp_path / "v.log"),
                               "--device", "cpu"])
    assert message == f"wrote 7 frames to {tmp_path / 'cli'}"
    assert capsys.readouterr().out.strip().splitlines()[-1] == message
    Interpolator(load_config(ini), state, upsample_rate=3, dump_intermediates=True, device="cpu").interpolate_directory(
        str(tmp_path / "clip"), str(tmp_path / "module"))
    for sub in ("", "visibility", "flow_est", "flow_refined"):
        names = sorted(n for n in os.listdir(tmp_path / "cli" / sub) if n.endswith(".png"))
        assert names == sorted(n for n in os.listdir(tmp_path / "module" / sub) if n.endswith(".png"))
        assert len(names) == (7 if not sub else 2)
        for n in names:
            assert open(tmp_path / "cli" / sub / n, "rb").read() == open(tmp_path / "module" / sub / n, "rb").read()


def test_evaluate_flow_cli_equals_evaluate_flow(sintel, weights_pt, tmp_path, capsys):
    state, _ = weights_pt
    ini = _config(tmp_path, "superslomo_eval.ini", **SEEDED, SINTEL_EPE_DATA={"ROOTDIR": sintel})
    results = flow_cli.main(["-c", ini, "--log", str(tmp_path / "epe.log"), "--device", "cpu", "--max-samples", "3"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results
    assert results == evaluate_flow(load_config(ini), state, max_samples=3, device="cpu")
    assert results["n_samples"] == 3


# --------------------------------------------------------------------------- #
# the fused multi-t step against JAX's (f32 and bf16)

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


def test_multi_t_f32_sliced_matches_jax(params, jax_f32, monkeypatch):
    """The fused step with its budget patched to one sample (B=2 runs as two
    slices of 1) against JAX's one call over the batch, at the full-model bar.
    Each slice bounds only its own sample's flows, so the bound is at most
    JAX's, which adds the batch's largest stage-1 flow to its largest
    residual, maybe of the other sample."""
    monkeypatch.setattr(port_model, "STEP_PIXELS", len(T_VALUES) * 32 * 32)
    model = SuperSloMo(ModelSpec(), device="cpu")
    model.load_state(weights.torch_state_from_jax(params))
    slices, one_go = [], model._multi_t_planar

    def counted(f, *args):
        slices.append(f.shape[0])
        return one_go(f, *args)

    monkeypatch.setattr(model, "_multi_t_planar", counted)
    want, want_bound = jax_f32
    pred, bound = model.interpolate_multi_t(torch.from_numpy(FRAMES), torch.from_numpy(T_VALUES), with_bounds=True)
    assert slices == [1, 1] and pred.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(pred.numpy(), want, atol=5e-4, rtol=1e-3)
    assert float(bound) <= want_bound * (1 + 1e-4)
