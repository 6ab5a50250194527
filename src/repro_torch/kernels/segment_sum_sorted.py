"""Segment sum over sorted segment ids: the hand-written CUDA kernel
(``csrc/segment_sum_sorted.cu``, B9), its wrapper and its plain torch
version.

The GNN message-passing reduction (``models/gnn/common.py::segment_sum``
computes its function; the edges are sorted by destination once per batch):

  in:   values [E, ...] fp32; seg_ids [E] int32 (int64 is narrowed),
        ascending, padding id N
  out:  [N, ...] fp32, out[n] = sum of values[e] over e with seg_ids[e] == n

Ids outside ``[0, N)`` are dropped, as ``jax.ops.segment_sum`` drops them.
The kernel is exact for any order of ids (one atomic per change of id);
sorted ids make it cheap. ``segment_sum_sorted`` launches the kernel for
CUDA tensors and takes the plain version for CPU tensors — the choice
follows the tensors' device and nothing else. The kernel takes fp32 values
only (every GNN config is fp32); on the CPU the plain version also takes
float64, so that the gradient can be checked with ``gradcheck``. Any E is
accepted (the reference needs a multiple of ``block_e``, dropped here with
``rows`` and ``interpret``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "segment_sum_sorted",
    "segment_sum_sorted_ref",
    "launches",
    "reset_launches",
]

_LIB = "segment_sum_sorted"
EDGES_PER_RUN = 256  # edges a thread walks in order (its register sum's run)
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def _check(values, seg_ids, num_segments) -> None:
    for name, t in (("values", values), ("seg_ids", seg_ids)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if values.dim() < 1 or not values.dtype.is_floating_point:
        raise TypeError(f"values: expected a float [E, ...] tensor, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if (seg_ids.dtype not in (torch.int32, torch.int64)
            or seg_ids.shape != values.shape[:1]):
        raise TypeError(f"seg_ids: expected int32 {tuple(values.shape[:1])}, "
                        f"got {seg_ids.dtype} {tuple(seg_ids.shape)}")
    if values.device != seg_ids.device:
        raise ValueError(f"devices differ: {values.device}, {seg_ids.device}")
    if int(num_segments) < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


def segment_sum_sorted_ref(values, seg_ids, *, num_segments: int):
    """Plain torch version: ``index_add_`` of the rows whose id lies in
    ``[0, N)`` into zeros, in the values' dtype (fp32 on the path)."""
    _check(values, seg_ids, num_segments)
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids[ok].long(), values[ok])


def _function():
    fn = _build.load(_LIB).segment_sum_sorted_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _vec(values: torch.Tensor, d: int) -> int:
    """Floats per load: the widest of 4, 2, 1 that divides a row and the
    values' alignment."""
    for vec in (4, 2):
        if d % vec == 0 and values.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def segment_sum_sorted(values, seg_ids, *, num_segments: int):
    """Segment sums ``[N, ...]`` on the tensors' device. Launches on the
    current stream and does not synchronise."""
    _check(values, seg_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_sorted_ref(values, seg_ids,
                                      num_segments=num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"values: the kernel takes float32, got "
                        f"{values.dtype}")
    n = int(num_segments)
    e = values.shape[0]
    rest = tuple(values.shape[1:])
    d = math.prod(rest)
    flat = values.reshape(e, d)
    if flat.stride() != (d, 1):
        flat = flat.contiguous()
    if seg_ids.dtype == torch.int64:  # ids outside [0, N) stay outside
        seg_ids = torch.where((seg_ids >= 0) & (seg_ids < n), seg_ids,
                              -1).to(torch.int32)
    seg_ids = seg_ids.contiguous()
    out = torch.zeros((n, d), dtype=torch.float32, device=values.device)
    if e == 0 or d == 0 or n == 0:
        return out.reshape((n,) + rest)
    fn = _function()
    with torch.cuda.device(values.device):
        err = fn(flat.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), e, d,
                 n, _vec(flat, d), EDGES_PER_RUN,
                 torch.cuda.current_stream().cuda_stream)
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"segment_sum_sorted kernel launch failed: cudaError {err} "
            f"(values {tuple(values.shape)}, N {n})"
        )
    return out.reshape((n,) + rest)
