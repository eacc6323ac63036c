"""The nvcc build of the port's CUDA sources (``csrc/*.cu``).

Each source compiles for ``sm_90a`` into a shared library with a plain C
interface, at first use, into the git-ignored ``superslomo_tpu_torch/_build/``.
The library's file name carries a hash of its source and of the headers in
``csrc/``, so an edited source or header is rebuilt. ``build`` starts one nvcc
per source that is not built yet, all at once, and waits for all of them. A
missing or failing nvcc raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))  # included by the sources
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

build_logs: dict = {}  # source file name → nvcc's output (register and spill counts) in this process
_libs: dict = {}  # source path → loaded, declared library


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path(source: Path) -> Path:
    """``_build/<stem>_<first 16 hex digits of a sha256>.so``, hashing the
    source and every header in csrc/, so an edited header rebuilds too."""
    digest = hashlib.sha256()
    for path in (Path(source), *HEADERS):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{tag}.so"


def build(sources: Iterable[Path] = SOURCES) -> None:
    """Compile every source whose library is missing, one nvcc each, all
    started together; raise when nvcc is missing or any build fails."""
    todo = [(Path(s), library_path(s)) for s in sources]
    todo = [(src, so) for src, so in todo if not so.exists()]
    if not todo:
        return
    compiler = nvcc()
    if not os.access(compiler, os.X_OK):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {compiler})")
    BUILD_DIR.mkdir(exist_ok=True)
    running = []
    for src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in running:
        build_logs[src.name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src.name}:\n{build_logs[src.name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build ``source`` if needed, load it once per process, and let
    ``declare`` set the ``argtypes`` / ``restype`` of its functions."""
    source = Path(source)
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        declare(lib)
        _libs[source] = lib
    return lib
