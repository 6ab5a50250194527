"""Shared power-of-2 width-bucketing helpers for the ragged-row kernels.

Every batched intersection wrapper faces the same ragged-input problem:
row widths (and pair counts) are data-dependent, but a compiled kernel
wants a small, bounded set of padded shapes. The repo-wide answer is
power-of-2 ceilings — padding waste is bounded by 2x per dimension while
the number of distinct compiled variants stays logarithmic. This module
is the single home of that logic; ``point_query`` (pair widths),
``delta_intersect`` (edge-block clamp), and ``resident_intersect``
(query-side widths + grid padding) all bucket through it instead of
each keeping a private copy.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

__all__ = [
    "pow2_ceil",
    "width_classes",
    "pack_rows",
    "iter_width_buckets",
    "split_width_buckets",
]


def pow2_ceil(x: int, floor: int = 1) -> int:
    """Smallest power of two >= max(x, floor) (scalar)."""
    x = max(int(x), int(floor))
    return 1 << int(np.ceil(np.log2(x)))


def width_classes(widths: Sequence[int]) -> np.ndarray:
    """Power-of-2 ceiling per width, min 1 (vectorized)."""
    w = np.maximum(np.asarray(widths, np.int64), 1)
    exp = np.ceil(np.log2(w)).astype(np.int64)
    return (np.int64(1) << exp).astype(np.int64)


def pack_rows(
    rows: Sequence[np.ndarray], width: int, sentinel: int
) -> np.ndarray:
    """Scatter ragged rows into a padded [E, width] matrix (vectorized)."""
    out = np.full((len(rows), width), sentinel, np.int32)
    if not rows:
        return out
    lens = np.fromiter((r.size for r in rows), np.int64, len(rows))
    total = int(lens.sum())
    if total == 0:
        return out
    flat = np.concatenate(rows)
    ei = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    out[ei, np.arange(total, dtype=np.int64) - starts] = flat
    return out


def iter_width_buckets(
    widths_a: Sequence[int], widths_b: Sequence[int]
) -> Iterator[Tuple[np.ndarray, int, int]]:
    """Group pair indices by their (pow2(|a|), pow2(|b|)) width class.

    Yields ``(indices, wa, wb)`` per distinct padded shape — the bucketed
    batches the pair-intersection wrappers run one kernel call each on.
    """
    wa_cls = width_classes(widths_a)
    wb_cls = width_classes(widths_b)
    key = wa_cls << 32 | wb_cls
    for k in np.unique(key):
        yield np.flatnonzero(key == k), int(k >> 32), int(k & 0xFFFFFFFF)


def split_width_buckets(
    widths: Sequence[int], max_buckets: int = 4
) -> List[Tuple[np.ndarray, int]]:
    """Partition items into at most ``max_buckets`` width groups.

    Each group's padded width is the pow-2 ceiling of its widest member,
    so per-item padding waste stays < 2x *within* a bucket while the
    number of padded shapes (and therefore compiled variants /
    collective launches) stays bounded. When more than ``max_buckets``
    pow-2 classes occur, the class with the fewest members is merged
    into the next-larger class (repeatedly) — a deterministic rule that
    sacrifices the least total padding. Returns ``[(indices, width)]``
    sorted by width ascending; empty input yields ``[]``; a single
    width class yields the degenerate one-bucket split.
    """
    assert max_buckets >= 1
    widths = np.asarray(widths, np.int64)
    if widths.size == 0:
        return []
    cls = width_classes(widths)
    uniq = [int(c) for c in np.unique(cls)]
    while len(uniq) > max_buckets:
        counts = [int(np.count_nonzero(cls == c)) for c in uniq]
        # never merge the top class upward — it has no larger neighbor
        i = int(np.argmin(counts[:-1]))
        cls[cls == uniq[i]] = uniq[i + 1]
        uniq.pop(i)
    return [(np.flatnonzero(cls == c), c) for c in uniq]
