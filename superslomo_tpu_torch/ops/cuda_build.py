"""The build of the port's native sources: the CUDA kernels (``csrc/*.cu``,
nvcc for ``sm_90a``) and the host routines (``csrc/*.cpp``, the host C++
compiler, the one nvcc itself drives).

Each source compiles into a shared library with a plain C interface, at first
use, into the git-ignored ``superslomo_tpu_torch/_build/``. The library's file
name carries a hash of its source and of the headers in ``csrc/``, so an
edited source or header is rebuilt. ``build`` starts one compiler per source
that is not built yet, all at once, and waits for all of them. A missing or
failing compiler raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu"))) + tuple(sorted(CSRC.glob("*.cpp")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))  # included by the sources
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

build_logs: dict = {}  # source file name → its compiler's output (nvcc's: register and spill counts)
_libs: dict = {}  # source path → loaded, declared library
_libs_lock = threading.Lock()  # the Loader's threads load the PNG unfilter at once


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def host_cxx() -> str:
    """The host C++ compiler: ``c++``, else ``g++`` on PATH ("" when neither)."""
    return shutil.which("c++") or shutil.which("g++") or ""


def _compiler(source: Path) -> tuple:
    """(name, path, flags) of the compiler that builds ``source``."""
    if source.suffix == ".cu":
        return "nvcc", nvcc(), NVCC_FLAGS
    return "c++", host_cxx(), HOST_CXX_FLAGS


def library_path(source: Path) -> Path:
    """``_build/<stem>_<first 16 hex digits of a sha256>.so``, hashing the
    source and every header in csrc/, so an edited header rebuilds too."""
    digest = hashlib.sha256()
    for path in (Path(source), *HEADERS):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{tag}.so"


def build(sources: Iterable[Path] = SOURCES) -> None:
    """Compile every source whose library is missing, one compiler each, all
    started together; raise when a compiler is missing or any build fails."""
    todo = [(Path(s), library_path(s)) for s in sources]
    todo = [(src, so, *_compiler(src)) for src, so in todo if not so.exists()]
    if not todo:
        return
    for src, so, name, compiler, flags in todo:
        if not (compiler and os.access(compiler, os.X_OK)):
            raise RuntimeError(f"{name} not found (looked on PATH{f' and at {compiler}' if compiler else ''})")
    BUILD_DIR.mkdir(exist_ok=True)
    running = []
    for src, so, name, compiler, flags in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((src, so, name, tmp, proc))
    failed = []
    for src, so, name, tmp, proc in running:
        build_logs[src.name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} failed building {src.name}:\n{build_logs[src.name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build ``source`` if needed, load it once per process, and let
    ``declare`` set the ``argtypes`` / ``restype`` of its functions."""
    source = Path(source)
    with _libs_lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))  # CDLL: each call releases the GIL
            declare(lib)
            _libs[source] = lib
    return lib
