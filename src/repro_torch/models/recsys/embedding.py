"""Embedding lookups and bags: the counterpart of
``repro.models.recsys.embedding``.

Two layouts, as in the reference:

- fixed-shape bags ``[B, L]`` with a mask (the DIN history layout), and
- ragged bags (ids + offsets, ``torch.nn.EmbeddingBag`` semantics).

``bag_fixed`` with no per-position weights and mode ``sum`` or ``mean``
computes the function of kernel B10 and goes through
``kernels.ops.embedding_bag`` (the hand-written kernel on the card, its
plain version on the CPU); ``max`` and weighted bags stay plain torch, as
they are plain jnp in the reference. The reference's ``embedding_specs``
(a sharding spec) has no counterpart on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels import ops
from ..common import trunc_normal

__all__ = [
    "embedding_init",
    "lookup",
    "bag_fixed",
    "bag_ragged",
]


def embedding_init(generator: torch.Generator, n_rows: int, dim: int,
                   dtype=torch.float32) -> torch.Tensor:
    return trunc_normal(generator, (n_rows, dim), scale=1.0, dtype=dtype)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def bag_fixed(
    table: torch.Tensor,
    ids: torch.Tensor,  # [B, L]
    mask: Optional[torch.Tensor] = None,  # [B, L] bool
    *,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,  # [B, L]
) -> torch.Tensor:
    """Pooled bags ``[B, D]`` in the table's dtype. A ``None`` mask is all
    ones. The reference divides a mean after summing and B10 before, so the
    two agree up to rounding; an all-masked bag is 0 in both."""
    if weights is None and mode in ("sum", "mean"):
        if mask is None:
            mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        return ops.embedding_bag(table, ids, mask, mode=mode).to(table.dtype)
    emb = lookup(table, ids)  # [B, L, D]
    w = (torch.ones(ids.shape, dtype=emb.dtype, device=emb.device)
         if weights is None else weights)
    if mask is not None:
        w = w * mask.to(emb.dtype)
    s = (emb * w[..., None]).sum(dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        return s / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    if mode == "max":
        neg = torch.where((w > 0)[..., None], emb, float("-inf"))
        m = neg.amax(dim=1)
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(mode)


def bag_ragged(
    table: torch.Tensor,
    ids: torch.Tensor,  # [NNZ]
    offsets: torch.Tensor,  # [B] start offsets (torch convention)
    n_bags: int,
    *,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,  # [NNZ]
) -> torch.Tensor:
    """torch.nn.EmbeddingBag semantics: bag b = reduce(ids[off[b]:off[b+1]]).
    Positions before ``offsets[0]`` belong to no bag and are dropped, as
    ``jax.ops.segment_*`` drops negative segment ids."""
    nnz = ids.shape[0]
    pos = torch.arange(nnz, device=ids.device)
    seg = torch.searchsorted(offsets.to(pos.dtype), pos, right=True) - 1
    keep = (seg >= 0) & (seg < n_bags)
    seg = seg[keep]
    emb = lookup(table, ids[keep])  # [NNZ', D]
    if weights is not None:
        emb = emb * weights[keep][:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    if mode == "sum":
        return out.index_add_(0, seg, emb)
    if mode == "mean":
        s = out.index_add_(0, seg, emb)
        cnt = torch.zeros((n_bags, 1), dtype=emb.dtype, device=emb.device)
        cnt.index_add_(0, seg, torch.ones((seg.shape[0], 1), dtype=emb.dtype,
                                          device=emb.device))
        return s / torch.clamp(cnt, min=1e-9)
    if mode == "max":
        out.fill_(float("-inf"))
        m = out.scatter_reduce(0, seg[:, None].expand_as(emb), emb, "amax")
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(mode)
