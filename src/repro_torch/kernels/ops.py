"""Public wrappers over the hand-written kernels.

A wrapper launches its CUDA kernel for tensors on the card and takes the
kernel's plain torch version for tensors on the CPU; there is no interpret
mode and no switch besides the tensors' device. Kernels of the reference
that are not ported yet raise ``NotImplementedError`` — never a stock
torch stand-in.
"""
from __future__ import annotations

from .bitmap_popcount import bitmap_intersect_count
from .embedding_bag import embedding_bag
from .flash_attention import flash_attention_gqa
from .intersect_count import intersect_count

__all__ = [
    "intersect_count",
    "bitmap_intersect_count",
    "embedding_bag",
    "segment_sum_sorted",
    "flash_attention_gqa",
]


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"not ported yet: {name}")

    stub.__name__ = name
    stub.__doc__ = f"``{name}`` of the reference; not ported yet."
    return stub


segment_sum_sorted = _not_ported("segment_sum_sorted")
