"""Width-bucketed batched pair intersection for point-query serving.

The serving engine's unit of work is a *ragged* list of row pairs: one
microbatch mixes a hub query (rows of width ~max degree) with leaf
queries (width 2-3). Padding every pair to the global max width would
make the all-pairs compare pay O(W_max^2) for every pair, so this
wrapper:

- buckets pairs by the power-of-2 ceiling of their (|a|, |b|) widths, so
  padding waste is bounded by 2x per side while keeping the number of
  distinct padded shapes (= compiled kernel variants) at most
  log2(max degree)^2, and
- runs one batched intersection per bucket — the CUDA
  ``intersect_count`` kernel via ``delta_intersect_counts`` when
  ``use_kernel`` (on ``device``), else the vectorized host binary-search
  path — and scatters counts back to the original pair order.

Rows follow the repo-wide invariant: sorted ascending, deduplicated,
ids < sentinel (padding slots never match).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..device import resolve_device
from .bucketing import iter_width_buckets, pack_rows
from .delta_intersect import delta_intersect_counts, delta_intersect_masks

__all__ = ["batched_pair_counts"]


def batched_pair_counts(
    rows_a: Sequence[np.ndarray],
    rows_b: Sequence[np.ndarray],
    *,
    sentinel: int,
    use_kernel: bool = False,
    device="cuda",
) -> np.ndarray:
    """``|rows_a[i] ∩ rows_b[i]|`` per pair of sorted 1-D rows.

    Returns int64 ``[len(rows_a)]`` in the input order. ``device`` is
    read only when ``use_kernel``; the host path touches no device.
    """
    n_pairs = len(rows_a)
    if len(rows_b) != n_pairs:
        raise ValueError(f"pair counts differ: {n_pairs} vs {len(rows_b)}")
    if use_kernel:
        resolve_device(device)  # a missing card raises even for no pairs
    out = np.zeros(n_pairs, np.int64)
    if n_pairs == 0:
        return out
    for idxs, wa, wb in iter_width_buckets(
        [r.size for r in rows_a], [r.size for r in rows_b]
    ):
        a = pack_rows([rows_a[i] for i in idxs], wa, sentinel)
        b = pack_rows([rows_b[i] for i in idxs], wb, sentinel)
        if use_kernel:
            cnt = delta_intersect_counts(
                a, b, sentinel=sentinel, device=device
            )
        else:
            cnt = delta_intersect_masks(a, b, sentinel=sentinel).sum(1)
        out[idxs] = cnt
    return out
