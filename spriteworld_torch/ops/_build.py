"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source `spriteworld_torch/csrc/<name>.cu` compiles, at first use, into
a shared library with a plain C interface under `spriteworld_torch/build/`
(listed in .gitignore). The file name carries a hash of the source, of every
header `csrc/*.cuh` and of the flags, so an edited source or header builds
anew and an unchanged one is reused.
`build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("scene_raster", "strip_raster", "packed_raster", "lane_random",
           "scene_tables", "task_eval")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one kernel; None when its library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, lib


def _finish(name: str, started) -> str:
    proc, tmp, lib = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library
    lib.with_suffix(".log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel in parallel; returns the compiler log of each
    kernel that was built now (register and shared-memory use)."""
    started = {n: _start(n) for n in KERNELS}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(str(library_path(name)))
    lib.sw_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sw_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.sw_cuda_error_string(err).decode()
