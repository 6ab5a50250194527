"""Batched sorted-row intersection count: the hand-written CUDA kernel
(``csrc/intersect_count.cu``), its wrapper and its plain torch version.

The compute hot-spot of the paper (edge-centric |adj(u) ∩ adj(v)|):

  in:   rows_a [E, WA] i32, rows_b [E, WB] i32 — sorted ascending,
        deduplicated, padded with ids >= sentinel
  out:  counts [E] i32, counts[e] = #{(s,t): a[e,s]==b[e,t], a[e,s]<sentinel}

``intersect_count`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — the choice follows the tensor's device and
nothing else. A build or launch failure raises. The kernel itself (one
warp per pair: each row's valid length by rounds of 32 probes, then the
merge or search of ``csrc/pair_intersect.cuh`` by the hybrid rule; see the
note in the ``.cu`` file) masks the ragged edge, so any ``E >= 0`` and any
widths ``>= 0`` are accepted without phantom-row padding.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.intersect import count_pairwise_torch
from . import _build

__all__ = [
    "intersect_count",
    "intersect_count_ref",
    "launches",
    "reset_launches",
]

_LIB = "intersect_count"
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def intersect_count_ref(
    rows_a: torch.Tensor, rows_b: torch.Tensor, *, sentinel: int
) -> torch.Tensor:
    """Plain torch version: the all-pairs compare of the reference kernel
    (``core.intersect.count_pairwise_torch``, chunked over B's columns)."""
    return count_pairwise_torch(rows_a, rows_b, sentinel)


def _check(rows_a: torch.Tensor, rows_b: torch.Tensor) -> None:
    for name, t in (("rows_a", rows_a), ("rows_b", rows_b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected [E, W], got {tuple(t.shape)}")
    if rows_a.device != rows_b.device:
        raise ValueError(
            f"rows on different devices: {rows_a.device} vs {rows_b.device}"
        )
    if rows_a.shape[0] != rows_b.shape[0]:
        raise ValueError(
            f"pair counts differ: {rows_a.shape[0]} vs {rows_b.shape[0]}"
        )


def _function():
    fn = _build.load(_LIB).intersect_count_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def intersect_count(
    rows_a: torch.Tensor, rows_b: torch.Tensor, *, sentinel: int
) -> torch.Tensor:
    """``|rows_a[e] ∩ rows_b[e]|`` per pair, int32 ``[E]`` on the rows'
    device. Launches on the current stream and does not synchronise."""
    _check(rows_a, rows_b)
    if rows_a.device.type == "cpu":
        return intersect_count_ref(rows_a, rows_b, sentinel=sentinel)
    if rows_a.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_a.device}")
    if not (rows_a.is_contiguous() and rows_b.is_contiguous()):
        raise ValueError("rows_a and rows_b must be contiguous")
    e, wa = rows_a.shape
    wb = rows_b.shape[1]
    counts = torch.empty((e,), dtype=torch.int32, device=rows_a.device)
    if e == 0:
        return counts
    fn = _function()
    with torch.cuda.device(rows_a.device):
        err = fn(
            rows_a.data_ptr(), rows_b.data_ptr(), counts.data_ptr(),
            e, wa, wb, int(sentinel),
            torch.cuda.current_stream().cuda_stream,
        )
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"intersect_count kernel launch failed: cudaError {err} "
            f"(E={e}, WA={wa}, WB={wb})"
        )
    return counts
