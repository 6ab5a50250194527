"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
is compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>.so``
at the root of the checkout the first time a wrapper needs it, and is
loaded with ``ctypes``. Nothing is built when a module is imported, and
nothing but the sources in this package goes into the library. A library
is rebuilt when its ``.cu`` or any shared header ``csrc/*.cuh`` is newer
than it. ``build_all`` starts one ``nvcc`` per source at once and waits
for all. A build that fails raises with the compiler's output; there is
no fallback. ``LIB_FLAGS`` adds flags to one library's command only:
``flash_attention_wgmma`` links libcuda (``-lcuda``) for
``cuTensorMapEncodeTiled``.
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

__all__ = ["BuildInfo", "build_dir", "load", "build_info", "build_all"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_FLAGS = {"flash_attention_wgmma": ("-lcuda",)}


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


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out_dir = build_dir()
    return src, out_dir / f"lib{name}.so", out_dir / f"lib{name}.ptxas.txt"


def _up_to_date(name: str) -> bool:
    src, lib, log = _paths(name)
    if not (lib.exists() and log.exists()):
        return False
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime >= newest


def _start(name: str):
    """Launch ``nvcc`` for one source; returns what ``_finish`` needs."""
    src, lib, _ = _paths(name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src),
           *LIB_FLAGS.get(name, ())]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return name, cmd, tmp, proc, time.perf_counter()


def _finish(started) -> BuildInfo:
    name, cmd, tmp, proc, t0 = started
    out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    src, lib, log = _paths(name)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n"
            f"{' '.join(cmd)}\n{out}\n{err}"
        )
    log.write_text(err)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildInfo(str(lib), seconds, err)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


def build_all(names) -> Dict[str, BuildInfo]:
    """Build and load every named library: one ``nvcc`` per source that
    needs it, all started together, then wait for each. This is the only
    build path; ``load`` calls it for one name."""
    todo = [n for n in names if n not in _libs]
    started = [_start(n) for n in todo if not _up_to_date(n)]
    built, errors = {}, []
    for s in started:  # wait for every process, even after a failure
        try:
            built[s[0]] = _finish(s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for n in todo:
        _, lib, log = _paths(n)
        info = built.get(n) or BuildInfo(str(lib), 0.0, log.read_text())
        _libs[n] = ctypes.CDLL(info.library)
        _info[n] = info
    return {n: _info[n] for n in names}


def build_info(name: str) -> BuildInfo:
    """Build report of ``name`` (builds and loads it if needed)."""
    load(name)
    return _info[name]
