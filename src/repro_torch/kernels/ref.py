"""Plain torch versions of the kernels (the oracles the hand-written
kernels are held against). Each lives beside its kernel and is re-exported
here."""
from __future__ import annotations

from .bitmap_popcount import bitmap_intersect_count_ref
from .embedding_bag import embedding_bag_ref
from .flash_attention import flash_attention_ref
from .intersect_count import intersect_count_ref
from .resident_intersect import resident_intersect_ref
from .segment_sum_sorted import segment_sum_sorted_ref

__all__ = [
    "intersect_count_ref",
    "resident_intersect_ref",
    "bitmap_intersect_count_ref",
    "embedding_bag_ref",
    "segment_sum_sorted_ref",
    "flash_attention_ref",
]
