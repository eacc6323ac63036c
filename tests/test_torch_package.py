"""Package rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, nor cv2 or PIL, its entry points refuse to run on the CPU unless
asked to, its CUDA wrappers take only CUDA tensors, its nvcc build names
libraries by source hash and raises without a working nvcc, and it reads the
repo's configs as the JAX package does."""

import ast
import dataclasses
import glob
import hashlib
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

from superslomo_tpu.config import load_config as jax_load_config
from superslomo_tpu_torch import Evaluator, Interpolator, SuperSloMo, Trainer, default_config, evaluate_flow
from superslomo_tpu_torch.config import load_config
from superslomo_tpu_torch.ops import cuda_build
from superslomo_tpu_torch.ops.warp_cuda import warp_multiflow_backward_cuda, warp_multiflow_planar_cuda
from superslomo_tpu_torch.ops.warp_single_cuda import warp_single_backward_cuda, warp_single_cuda
from superslomo_tpu_torch.parallel.halo import RowWindow
from superslomo_tpu_torch.parallel.mesh import Grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "superslomo_tpu_torch")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.ini")))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Every port test module runs PyTorch on one intra-op thread (each
    imports this fixture). The suite runs as 6 xdist workers on the host's
    cores beside XLA's compiles; at PyTorch's default of a thread a core the
    host is oversubscribed and the OpenMP threads spin at each barrier while
    a sibling waits for a core, so a port module burned several cores and
    slowed the JAX package's single-threaded compiles beside it. The port's
    CPU results do not depend on the thread count beyond float rounding,
    and every exact comparison in these tests is made within one module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="superslomo_tpu_torch.")
    )


FORBIDDEN = ("jax", "flax", "msgpack", "superslomo_tpu", "cv2", "PIL")


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in FORBIDDEN)


def test_importing_every_port_module_leaves_jax_out():
    modules = _port_modules()
    assert {
        "superslomo_tpu_torch.ops.warp_cuda", "superslomo_tpu_torch.ops.warp_single_cuda",
        "superslomo_tpu_torch.ops.cuda_build", "superslomo_tpu_torch.models.vgg",
        "superslomo_tpu_torch.models.losses", "superslomo_tpu_torch.training.trainer",
        "superslomo_tpu_torch.models.bottleneck", "superslomo_tpu_torch.data.png",
        "superslomo_tpu_torch.data.readers", "superslomo_tpu_torch.data.pipeline",
        "superslomo_tpu_torch.cli.common", "superslomo_tpu_torch.cli.train",
        "superslomo_tpu_torch.cli.evaluate_interpolation", "superslomo_tpu_torch.utils.flo",
        "superslomo_tpu_torch.eval.evaluate_flow", "superslomo_tpu_torch.eval.visualize",
        "superslomo_tpu_torch.cli.evaluate_flow", "superslomo_tpu_torch.cli.visualize",
        "superslomo_tpu_torch.parallel", "superslomo_tpu_torch.parallel.distributed",
        "superslomo_tpu_torch.cli.convert_checkpoint", "superslomo_tpu_torch.utils.make_clips",
        "superslomo_tpu_torch.utils.msgpack", "superslomo_tpu_torch.training.checkpoint",
        "superslomo_tpu_torch.parallel.mesh", "superslomo_tpu_torch.parallel.halo",
    } <= set(modules) and len(modules) >= 46
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_jax_imports_in_port_sources_or_chip_smoke():
    files = glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert os.path.exists(files[-1])
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders
    assert not _forbidden("superslomo_tpu_torch") and _forbidden("superslomo_tpu.ops") and _forbidden("PIL.Image")
    assert _forbidden("msgpack") and not _forbidden("superslomo_tpu_torch.utils.msgpack")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuperSloMo()
    cfg = default_config()
    cfg.set("ADOBE_DATA", "H_IN", 32)
    cfg.set("ADOBE_DATA", "W_IN", 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(cfg, {"stage1": {}, "stage2": {}})
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the sharded Evaluator's grid changes nothing there
        Evaluator(cfg, {"stage1": {}, "stage2": {}}, grid=Grid(1, 2, 0, None, None, (0,), (0, 1)))
    with pytest.raises(RuntimeError):
        SuperSloMo(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(default_config(TRAIN_ALLOW_RANDOM_VGG="TRUE"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Interpolator(default_config(), {"stage1": {}, "stage2": {}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_flow(default_config(), {"stage1": {}, "stage2": {}})


def test_cuda_wrapper_raises_on_cpu_tensors():
    planes = torch.zeros(1, 3, 8, 8)
    flow = torch.zeros(1, 2, 8, 8)
    counts = lambda: (warp_multiflow_planar_cuda.launches, warp_single_cuda.launches,  # noqa: E731
                      warp_single_backward_cuda.launches, warp_multiflow_backward_cuda.launches,
                      warp_multiflow_backward_cuda.operations)
    counters = counts()
    with pytest.raises(ValueError, match="CUDA"):
        warp_multiflow_planar_cuda(planes, flow, flow)
    with pytest.raises(ValueError, match="CUDA"):  # the halo warp's row window
        warp_multiflow_planar_cuda(planes, flow[:, :, 2:6], flow[:, :, 2:6], rows=RowWindow(2, 0, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        warp_single_cuda(planes, flow)
    with pytest.raises(ValueError, match="CUDA"):
        warp_single_backward_cuda(planes, flow, planes, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        warp_multiflow_backward_cuda(planes, flow, flow, torch.zeros(1, 3, 2, 8, 8), True, True)
    assert counters == counts()


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """The name hashes the source and every header in csrc/, so an edited
    source or header builds a new library."""
    src = tmp_path / "kern.cu"
    src.write_text("// one\n")
    first = cuda_build.library_path(src)
    assert first.parent == cuda_build.BUILD_DIR
    headers = b"".join(h.read_bytes() for h in cuda_build.HEADERS)
    assert first.name == f"kern_{hashlib.sha256(b'// one' + bytes([10]) + headers).hexdigest()[:16]}.so"
    src.write_text("// two\n")
    second = cuda_build.library_path(src)
    assert second != first
    header = tmp_path / "kern.cuh"
    header.write_text("// a header\n")
    monkeypatch.setattr(cuda_build, "HEADERS", (*cuda_build.HEADERS, header))
    third = cuda_build.library_path(src)
    assert third != second
    header.write_text("// the header edited\n")
    assert cuda_build.library_path(src) != third
    assert {p.name for p in cuda_build.SOURCES} >= {"warp_multiflow.cu", "warp_single.cu"}
    assert {p.name for p in cuda_build.HEADERS} >= {"warp_tile.cuh"}


@pytest.mark.parametrize("compiler,message", [("/nonexistent/bin/nvcc", "nvcc not found"), ("/bin/false", "nvcc failed")])
def test_build_raises_without_a_working_nvcc(tmp_path, monkeypatch, compiler, message):
    src = tmp_path / "kern.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: compiler)
    with pytest.raises(RuntimeError, match=message):
        cuda_build.load_library(src, lambda lib: None)
    assert not list(tmp_path.glob("_build/*")), "a failed build leaves no library behind"


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_as_in_jax(path):
    ours, theirs = load_config(path), jax_load_config(path)
    ours.validate()
    theirs.validate()
    spec, jspec = ours.model_spec(), theirs.model_spec()
    for field in dataclasses.fields(spec):
        assert getattr(spec, field.name) == getattr(jspec, field.name), field.name
    assert ours.pixel_mean() == theirs.pixel_mean() and ours.pixel_std() == theirs.pixel_std()
    model = SuperSloMo(spec, device="cpu")
    assert next(model.parameters()).dtype == getattr(torch, spec.compute_dtype)
    assert model.stage1.recurrent == (spec.stage1_bottleneck != "CONV")
    if spec.stage1_bottleneck != "CONV":  # the recurrent model trains too, conv6 in the optimizer
        ours.set("TRAIN", "ALLOW_RANDOM_VGG", "TRUE")
        tr = Trainer(ours, device="cpu")
        in_optimizer = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
        gates = list(tr.model.stage1.conv6.parameters())
        assert gates and all(id(p) in in_optimizer for p in gates)
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())


def test_bfloat16_compute_dtype_is_honoured():
    spec = default_config(TPU_COMPUTE_DTYPE="bfloat16").model_spec()
    model = SuperSloMo(spec, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.stage1.conv1a[0].weight.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        default_config(TPU_COMPUTE_DTYPE="float16").validate()
