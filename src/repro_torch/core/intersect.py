"""Adjacency-list intersection (paper §II-C, Algorithms 1 & 2, Eq. 3).

Three layers:

1. **Scalar reference** (`ssi_scalar`, `binary_search_scalar`) — literal
   transcriptions of the paper's Algorithms 1/2. Used as oracles and for
   the Table III benchmark.
2. **Vectorized host versions** (`*_np`) — numpy batch implementations used
   by the benchmarks (the CPU stand-ins for the OpenMP parallel region of
   §III-C).
3. **Device versions** (`*_torch`) — plain torch implementations for
   padded sorted rows with sentinel padding: the SSI regime as an
   all-pairs compare (chunked so the ``[E, WA, WB]`` cube never
   materialises whole) and the binary-search regime as a batched
   ``searchsorted`` membership count. They are the plain versions the
   hand-written kernels are held against (``kernels/``); the hybrid
   decision rule (Eq. 3) for this cost model is `regime_rule`.

Rows are sorted ascending; any id >= ``sentinel`` is padding and never
counted (the sentinel is chosen > every real id, so sorted order holds).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ssi_scalar",
    "binary_search_scalar",
    "hybrid_scalar",
    "eq3_ssi_faster",
    "count_bsearch_np",
    "count_pairwise_np",
    "count_bsearch_torch",
    "count_pairwise_torch",
    "count_bitmap_torch",
    "regime_rule",
    "count_hybrid_torch",
]


# --------------------------------------------------------------------------
# 1. Scalar references — Algorithms 1 and 2, verbatim semantics.
# --------------------------------------------------------------------------
def ssi_scalar(a: np.ndarray, b: np.ndarray) -> int:
    """Sorted set intersection (Algorithm 2): O(|A| + |B|)."""
    counter = 0
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        if a[i] == b[j]:
            counter += 1
            i += 1
            j += 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return counter


def binary_search_scalar(a: np.ndarray, b: np.ndarray) -> int:
    """Binary search (Algorithm 1): |A| lookups in B, O(|A| log |B|)."""
    counter = 0
    nb = len(b)
    for x in a:
        lo, hi = 0, nb
        while lo < hi:
            mid = (lo + hi) // 2
            if b[mid] < x:
                lo = mid + 1
            else:
                hi = mid
        if lo < nb and b[lo] == x:
            counter += 1
    return counter


def eq3_ssi_faster(len_a: int, len_b: int) -> bool:
    """Paper Eq. 3: SSI is (theoretically) faster iff |B|/|A| <= log2|B|-1.

    ``a`` is the shorter list.
    """
    if len_a == 0 or len_b == 0:
        return True
    if len_a > len_b:
        len_a, len_b = len_b, len_a
    return (len_b / len_a) <= max(np.log2(max(len_b, 2)) - 1.0, 0.0)


def hybrid_scalar(a: np.ndarray, b: np.ndarray) -> int:
    """Hybrid method (§III-C): pick by Eq. 3, always search the longer list."""
    if len(a) > len(b):
        a, b = b, a
    if eq3_ssi_faster(len(a), len(b)):
        return ssi_scalar(a, b)
    return binary_search_scalar(a, b)


# --------------------------------------------------------------------------
# 2. Vectorized host (numpy) versions — used by the shared-memory benchmarks.
# --------------------------------------------------------------------------
def count_bsearch_np(a: np.ndarray, b: np.ndarray) -> int:
    """Vectorized binary-search membership |a ∩ b| for 1-D sorted arrays."""
    if a.size == 0 or b.size == 0:
        return 0
    idx = np.searchsorted(b, a)
    idx = np.minimum(idx, b.size - 1)
    return int((b[idx] == a).sum())


def count_pairwise_np(a: np.ndarray, b: np.ndarray) -> int:
    """All-pairs compare (the SIMD-friendly SSI substitute), O(|A||B|)."""
    if a.size == 0 or b.size == 0:
        return 0
    return int((a[:, None] == b[None, :]).sum())


# --------------------------------------------------------------------------
# 3. Device (torch) versions on padded sorted rows.
#    rows_a: [..., Wa] int32 sorted w/ sentinel padding; rows_b: [..., Wb].
# --------------------------------------------------------------------------
def count_bsearch_torch(
    rows_a: torch.Tensor, rows_b: torch.Tensor, sentinel: int
) -> torch.Tensor:
    """Membership count via batched binary search of A's elements in B.

    Batched over leading dims. Padding (>= sentinel) never matches.
    """
    if rows_b.shape[-1] == 0:
        return torch.zeros(rows_a.shape[:-1], dtype=torch.int32,
                           device=rows_a.device)
    idx = torch.searchsorted(rows_b.contiguous(), rows_a.contiguous())
    idx.clamp_(max=rows_b.shape[-1] - 1)
    hit = torch.gather(rows_b, -1, idx) == rows_a
    hit &= rows_a < sentinel
    return hit.sum(dim=-1, dtype=torch.int32)


# elements of the boolean compare cube one chunk of B may materialise
_PAIRWISE_CHUNK_ELEMS = 1 << 27


def count_pairwise_torch(
    rows_a: torch.Tensor, rows_b: torch.Tensor, sentinel: int
) -> torch.Tensor:
    """All-pairs compare: counts[e] = sum_{s,t} (A[e,s] == B[e,t]).

    O(Wa*Wb) compares; B is walked in column chunks so at most
    ``_PAIRWISE_CHUNK_ELEMS`` booleans are live at once.
    """
    wa, wb = rows_a.shape[-1], rows_b.shape[-1]
    acc = torch.zeros(rows_a.shape[:-1], dtype=torch.int32,
                      device=rows_a.device)
    a = rows_a[..., :, None]
    valid_a = a < sentinel
    step = max(1, _PAIRWISE_CHUNK_ELEMS // max(acc.numel() * wa, 1))
    for lo in range(0, wb, step):
        eq = a == rows_b[..., None, lo:lo + step]
        eq &= valid_a
        acc += eq.sum(dim=(-1, -2), dtype=torch.int32)
    return acc


def _popcount_i32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit patterns held in int32 (SWAR)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def count_bitmap_torch(
    words_a: torch.Tensor, words_b: torch.Tensor
) -> torch.Tensor:
    """Bitmap AND + popcount over 32-bit words (batched). The words are
    carried as int32 bit patterns (``uint32_array.view(np.int32)``)."""
    both = torch.bitwise_and(words_a, words_b)
    return _popcount_i32(both).sum(dim=-1).to(torch.int32)


def regime_rule(
    deg_a: torch.Tensor, deg_b: torch.Tensor, width_b: int, g: float = 8.0
) -> torch.Tensor:
    """Eq. 3 re-derived for the vectorized cost model.

    bsearch-regime cost ~ |A| * ceil(log2 Wb) gathers; pairwise-regime
    cost ~ |A| * Wb lane-compares, cheaper per op by ~``g`` (the
    gather-vs-compare cost ratio of the device; the reference fixes 8).
    pairwise (SSI regime) wins iff Wb <= g * log2(Wb)  ==  the same
    log-ratio structure as paper Eq. 3 with the constant re-fit.
    """
    log_wb = float(np.ceil(np.log2(np.float32(max(width_b, 2)))))
    lo = torch.minimum(deg_a, deg_b).to(torch.float32)
    hi = torch.maximum(deg_a, deg_b).to(torch.float32)
    # ratio rule, mirroring |B|/|A| <= log2|B| - 1 with vector constants
    bound = np.float32(g) * np.float32(max(log_wb - 1.0, 1.0))
    return (hi / lo.clamp(min=1.0)) <= float(bound)


def count_hybrid_torch(
    rows_a: torch.Tensor,
    rows_b: torch.Tensor,
    deg_a: torch.Tensor,
    deg_b: torch.Tensor,
    sentinel: int,
) -> torch.Tensor:
    """Hybrid device intersection: per-edge regime select (paper §III-C).

    Both regimes are computed on the padded rows and selected by the
    rule, as the epoch engine does — see ``core/async_engine.py``.
    """
    use_pairwise = regime_rule(deg_a, deg_b, rows_b.shape[-1])
    c_pw = count_pairwise_torch(rows_a, rows_b, sentinel)
    c_bs = count_bsearch_torch(rows_a, rows_b, sentinel)
    return torch.where(use_pairwise, c_pw, c_bs)
