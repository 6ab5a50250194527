"""Public wrappers over the hand-written kernels.

A wrapper launches its CUDA kernel for tensors on the card and takes the
kernel's plain torch version for tensors on the CPU; there is no interpret
mode and no switch besides the tensors' device. Every Pallas kernel of
the reference has its counterpart here.
"""
from __future__ import annotations

from .bitmap_popcount import bitmap_intersect_count
from .embedding_bag import embedding_bag
from .flash_attention import flash_attention_gqa
from .intersect_count import intersect_count
from .segment_sum_sorted import segment_sum_sorted

__all__ = [
    "intersect_count",
    "bitmap_intersect_count",
    "embedding_bag",
    "segment_sum_sorted",
    "flash_attention_gqa",
]
