"""Batched delta-intersect wrapper over the ``intersect_count`` kernel.

The streaming engine's hot loop is the same primitive as the static
pipeline — |adj(u) ∩ adj(v)| over padded sorted rows — but a streaming
batch has a data-dependent number of row pairs. The CUDA kernel masks the
ragged edge itself, so this wrapper only moves the numpy pair batch to the
device, counts, and brings int64 counts back; no phantom-row padding.

``delta_intersect_masks`` is the companion membership primitive: the
incremental LCC update needs the *identities* of the closing vertices
(every common neighbor w of a new edge (u,v) gains a triangle), not just
the count. It is a vectorized binary-search membership over the same
padded-row layout; counts derived from the mask equal the kernel counts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .intersect_count import intersect_count as _intersect

__all__ = ["delta_intersect_counts", "delta_intersect_masks"]


def delta_intersect_counts(
    rows_a: np.ndarray,  # [E, WA] int32 sorted, sentinel-padded
    rows_b: np.ndarray,  # [E, WB]
    *,
    sentinel: int,
    device="cuda",
) -> np.ndarray:
    """|rows_a[e] ∩ rows_b[e]| per pair, any E >= 0. Returns int64 [E]."""
    dev = resolve_device(device)
    rows_a = np.ascontiguousarray(rows_a, np.int32)
    rows_b = np.ascontiguousarray(rows_b, np.int32)
    e = rows_a.shape[0]
    if rows_b.shape[0] != e:
        raise ValueError(f"pair counts differ: {e} vs {rows_b.shape[0]}")
    if e == 0:
        return np.zeros((0,), np.int64)
    cnt = _intersect(
        torch.from_numpy(rows_a).to(dev),
        torch.from_numpy(rows_b).to(dev),
        sentinel=sentinel,
    )
    return cnt.cpu().numpy().astype(np.int64)


def delta_intersect_masks(
    rows_a: np.ndarray,  # [E, WA]
    rows_b: np.ndarray,  # [E, WB]
    *,
    sentinel: int,
) -> np.ndarray:
    """Membership mask [E, WA]: mask[e, s] == (rows_a[e, s] ∈ rows_b[e]).

    Padding slots (>= sentinel) are always False. Vectorized host-side
    binary search (numpy), so the streaming engine can scatter triangle
    credit to the matched ids without a device round-trip.
    """
    rows_a = np.asarray(rows_a, np.int64)
    rows_b = np.asarray(rows_b, np.int64)
    e, wa = rows_a.shape
    if e == 0 or rows_b.shape[1] == 0:
        return np.zeros((e, wa), bool)
    # per-row searchsorted via rank trick: offset each row into its own
    # disjoint key space, then one global searchsorted.
    span = int(sentinel) + 1
    off = np.arange(e, dtype=np.int64)[:, None] * span
    flat_b = (rows_b + off).ravel()  # sorted within rows, rows ascending
    keys = (rows_a + off).ravel()
    idx = np.searchsorted(flat_b, keys)
    idx = np.minimum(idx, flat_b.size - 1)
    hit = flat_b[idx] == keys
    hit &= (rows_a < sentinel).ravel()
    return hit.reshape(e, wa)
