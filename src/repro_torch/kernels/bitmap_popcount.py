"""Bitmap AND + popcount intersection count: the hand-written CUDA kernel
(``csrc/bitmap_popcount.cu``, B2), its wrapper and its plain torch version.

The dense-community regime of the hybrid (paper §III-C adapted): rows are
pre-packed into 32-bit bitmap words over a vertex window
(``core.csr.rows_to_bitmap_words``); the count ANDs the word streams and
popcounts — O(n/32) word operations per pair regardless of degree skew.

  in:   words_a [E, W], words_b [E, W] — int32 bit patterns
        (``uint32_array.view(np.int32)``) or uint32 tensors
  out:  counts [E] i32, counts[e] = Σ_w popcount(words_a[e,w] & words_b[e,w])

``bitmap_intersect_count`` launches the kernel for CUDA tensors and takes
the plain version (``core.intersect.count_bitmap_torch``) for CPU tensors.
Numpy words (uint32, as the reference takes them, or int32) are first
moved to ``device`` (default ``"cuda"``; raises when it is missing). Any E
and any W are accepted (the reference asks for E % block_e == 0).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.intersect import count_bitmap_torch
from ..device import resolve_device
from . import _build

__all__ = [
    "bitmap_intersect_count",
    "bitmap_intersect_count_ref",
    "launches",
    "reset_launches",
]

_LIB = "bitmap_popcount"
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def _as_i32(name: str, t) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 (or uint32), got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected [E, W], got {tuple(t.shape)}")
    return t


def bitmap_intersect_count_ref(
    words_a: torch.Tensor, words_b: torch.Tensor
) -> torch.Tensor:
    """Plain torch version: SWAR popcount of the AND, summed per row."""
    return count_bitmap_torch(_as_i32("words_a", words_a),
                              _as_i32("words_b", words_b))


def _function():
    fn = _build.load(_LIB).bitmap_popcount_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _from_numpy(words, device) -> torch.Tensor:
    if not isinstance(words, np.ndarray):
        return words
    if words.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected uint32 or int32 words, got {words.dtype}")
    bits = np.ascontiguousarray(words).view(np.int32)
    return torch.from_numpy(bits).to(resolve_device(device))


def bitmap_intersect_count(words_a, words_b, *, device="cuda") -> torch.Tensor:
    """Per-pair popcount of ``words_a & words_b``, int32 ``[E]`` on the
    words' device. Tensors stay where they are; numpy words are moved to
    ``device`` first. Launches on the current stream and does not
    synchronise."""
    words_a = _as_i32("words_a", _from_numpy(words_a, device))
    words_b = _as_i32("words_b", _from_numpy(words_b, device))
    if words_a.device != words_b.device:
        raise ValueError(
            f"words on different devices: {words_a.device} vs "
            f"{words_b.device}")
    if words_a.shape != words_b.shape:
        raise ValueError(
            f"shapes differ: {tuple(words_a.shape)} vs {tuple(words_b.shape)}")
    if words_a.device.type == "cpu":
        return count_bitmap_torch(words_a, words_b)
    if words_a.device.type != "cuda":
        raise ValueError(f"unsupported device {words_a.device}")
    if not (words_a.is_contiguous() and words_b.is_contiguous()):
        raise ValueError("words_a and words_b must be contiguous")
    e, w = words_a.shape
    counts = torch.empty((e,), dtype=torch.int32, device=words_a.device)
    if e == 0:
        return counts
    # 16-byte loads need every row start 16-byte aligned
    vec = int(w % 4 == 0 and words_a.data_ptr() % 16 == 0
              and words_b.data_ptr() % 16 == 0)
    fn = _function()
    with torch.cuda.device(words_a.device):
        err = fn(
            words_a.data_ptr(), words_b.data_ptr(), counts.data_ptr(),
            e, w, vec, torch.cuda.current_stream().cuda_stream,
        )
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"bitmap_popcount kernel launch failed: cudaError {err} "
            f"(E={e}, W={w})"
        )
    return counts
