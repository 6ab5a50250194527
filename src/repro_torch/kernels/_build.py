"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
is compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>.so``
at the root of the checkout the first time a wrapper needs it, and is
loaded with ``ctypes``. Nothing is built when a module is imported, and
nothing but the sources in this package goes into the library. A build
that fails raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

__all__ = ["BuildInfo", "build_dir", "load", "build_info"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What one library's build reported."""

    library: str  # path of the shared library
    seconds: float  # compile time; 0.0 when an up-to-date library was reused
    ptxas: str  # ``-Xptxas -v`` output (registers, shared memory, spills)


_libs: Dict[str, ctypes.CDLL] = {}
_info: Dict[str, BuildInfo] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch/`` beside ``src/`` (listed in ``.gitignore``)."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch cannot be built without it"
    )


def _compile(name: str) -> BuildInfo:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    log = out_dir / f"lib{name}.ptxas.txt"
    if (
        lib.exists()
        and log.exists()
        and lib.stat().st_mtime >= src.stat().st_mtime
    ):
        return BuildInfo(str(lib), 0.0, log.read_text())
    tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    log.write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildInfo(str(lib), seconds, proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        info = _compile(name)
        lib = ctypes.CDLL(info.library)
        _info[name] = info
        _libs[name] = lib
    return lib


def build_info(name: str) -> BuildInfo:
    """Build report of ``name`` (builds and loads it if needed)."""
    load(name)
    return _info[name]
