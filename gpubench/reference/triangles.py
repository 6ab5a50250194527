"""Plain reference: exact per-vertex triangle counts and LCC of a raw edge
list, in PyTorch on any device.

Independent of the program: it rebuilds the simple undirected graph itself
(self loops dropped, repeats merged, both directions of an edge the same
edge), orders the vertices by (degree, id), and enumerates every wedge
``(u; x, y)`` whose two edges both leave ``u`` upwards in that order. A wedge
closes iff ``{x, y}`` is an edge; each triangle is found exactly once, at its
lowest vertex, and adds one to each of its three corners. LCC is Eq. 2 in
float64: ``2 t / (d (d - 1))``, 0 where ``d < 2``.

Wedges are enumerated in blocks of at most ``block`` pairs, so the peak
memory stays bounded at any graph size.
"""
from __future__ import annotations

import torch

__all__ = ["simple_graph", "triangles_per_vertex", "lcc_float64",
           "lcc_lower_precision"]


def simple_graph(edges, n: int, device="cpu"):
    """``(lo, hi, deg)``: the distinct undirected edges ``lo < hi`` (int64,
    sorted by ``lo * n + hi``) and every vertex's degree."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device).reshape(-1, 2)
    u, v = e[:, 0], e[:, 1]
    keep = u != v
    lo = torch.minimum(u, v)[keep]
    hi = torch.maximum(u, v)[keep]
    key = torch.unique(lo * n + hi)  # sorted
    lo, hi = key // n, key % n
    deg = torch.bincount(torch.cat([lo, hi]), minlength=n)
    return lo, hi, deg


def triangles_per_vertex(edges, n: int, device="cpu", block: int = 1 << 25):
    """``(t, deg)``: int64 ``[n]`` each, the triangles through each vertex
    and its degree in the simple graph."""
    lo, hi, deg = simple_graph(edges, n, device)
    dev = lo.device
    key_sorted = lo * n + hi
    # rank by (degree, id); orient every edge from the lower rank up
    order = torch.argsort(deg * n + torch.arange(n, device=dev))
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    up = rank[lo] < rank[hi]
    src = torch.where(up, lo, hi)
    dst = torch.where(up, hi, lo)
    perm = torch.argsort(src * n + dst)
    src, dst = src[perm], dst[perm]
    out_deg = torch.bincount(src, minlength=n)
    starts = torch.cumsum(out_deg, 0) - out_deg
    # edge i pairs with the later edges of its own source's list
    later = starts[src] + out_deg[src] - 1 - torch.arange(src.numel(),
                                                          device=dev)
    t = torch.zeros(n, dtype=torch.int64, device=dev)
    ends = torch.cumsum(later, 0)
    i = 0
    while i < src.numel():
        # the longest run of edges from i whose wedges fit one block
        base = int(ends[i - 1]) if i else 0
        j = int(torch.searchsorted(ends, base + block, right=True))
        j = max(j, i + 1)
        cnt = later[i:j]
        first = torch.repeat_interleave(torch.arange(i, j, device=dev), cnt)
        csum = torch.cumsum(cnt, 0)
        step = torch.arange(first.numel(), device=dev) \
            - torch.repeat_interleave(csum - cnt, cnt)
        second = first + 1 + step
        x, y = dst[first], dst[second]
        k = torch.minimum(x, y) * n + torch.maximum(x, y)
        pos = torch.searchsorted(key_sorted, k).clamp(max=key_sorted.numel()
                                                      - 1)
        closed = key_sorted[pos] == k
        ones = closed.to(torch.int64)
        t.index_add_(0, src[first], ones)
        t.index_add_(0, x, ones)
        t.index_add_(0, y, ones)
        i = j
    return t, deg


def lcc_float64(t: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Eq. 2 in float64."""
    d = deg.to(torch.float64)
    denom = d * (d - 1.0)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, 2.0 * t.to(torch.float64) / safe,
                       torch.zeros_like(denom))


def lcc_lower_precision(t: torch.Tensor, deg: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """Eq. 2 computed in ``dtype`` (the control: the precision below the
    float32 that the configurations state), returned as float64."""
    d = deg.to(dtype)
    denom = d * (d - 1.0)
    ok = deg > 1
    safe = torch.where(ok, denom, torch.ones_like(denom))
    two_t = t.to(dtype) * 2.0
    return torch.where(ok, two_t / safe, torch.zeros_like(denom)).to(
        torch.float64)
