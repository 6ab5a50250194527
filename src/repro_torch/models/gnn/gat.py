"""GAT (Velickovic et al., arXiv:1710.10903), the counterpart of
``repro.models.gnn.gat`` — gat-cora assigned config: 2 layers,
d_hidden=8, 8 heads, attention aggregator.

Layer: per-edge score e_ij = LeakyReLU(a_src . Wh_i + a_dst . Wh_j), then
segment-softmax over each destination's incoming edges and a weighted
segment-sum (the softmax denominator and the aggregation are B9). First
layer concatenates heads, final layer averages them.

A batch with ``edge_src_cold`` is hub-split (the paper's degree-score cache
applied to the feature reads; ``distributed/hub_gather.py`` plans it): its
edges come as two streams, cold (``edge_src_cold``, ``edge_dst_cold``,
``edge_mask_cold``: sources read from the node table) and hot
(``edge_src_hub_pos`` into the hub table of the nodes ``hub_ids``,
``edge_dst_hot``, ``edge_mask_hot``), softmaxed together by segment max and
sums without concatenating them, as in the reference: B9 runs four times a
layer there (the denominator and the aggregation of each stream), twice on
a plain batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..common import trunc_normal
from ._params import from_reference
from .common import (GraphBatch, gather_src, segment_max, segment_softmax,
                     segment_sum)

__all__ = ["GATConfig", "init_params", "apply", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: Any = torch.float32


def init_params(cfg: GATConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (the reference's init;
    other draws)."""
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        hd = (cfg.n_heads, d_out)
        layers.append({
            "w": trunc_normal(generator, (d_in,) + hd, dtype=cfg.dtype),
            "a_src": trunc_normal(generator, hd, dtype=cfg.dtype),
            "a_dst": trunc_normal(generator, hd, dtype=cfg.dtype),
            "b": torch.zeros(hd, dtype=cfg.dtype, device=generator.device),
        })
        d_in = cfg.d_hidden * cfg.n_heads if not last else d_out
    return {"layers": layers}


def params_from_reference(cfg: GATConfig, tree) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as CPU tensors."""
    return from_reference(tree, init_params(cfg, torch.Generator()))


def _gat_layer(p, x, batch: GraphBatch, cfg: GATConfig, *, last: bool):
    n = x.shape[0]
    h = torch.einsum("nf,fhd->nhd", x, p["w"])  # [N, H, D]
    s_src = (h * p["a_src"]).sum(-1)  # [N, H]
    s_dst = (h * p["a_dst"]).sum(-1)
    if "edge_src_cold" in batch:
        agg = _hub_split_attention(h, s_src, s_dst, batch, cfg, n)
    else:
        src, dst = batch["edge_src"], batch["edge_dst"]
        mask = batch["edge_mask"]
        e = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)
        w = segment_softmax(e, dst, n, mask=mask[:, None])  # [E, H]
        msg = gather_src(h, src) * w[..., None]  # [E, H, D]
        msg = torch.where(mask[:, None, None], msg, 0.0)
        agg = segment_sum(msg, dst, n)
    agg = agg + p["b"]  # [N, H, D]
    if last:
        return agg.mean(dim=1)  # average heads -> logits
    return F.elu(agg.reshape(n, -1))  # concat heads


def _hub_split_attention(h, s_src, s_dst, batch, cfg: GATConfig, n: int):
    """Two-stream edge attention: the hot stream reads the hub table
    ``h[hub_ids]``, the cold stream the node table; one softmax over both
    by explicit (max, exp-sum, weighted-sum) segment reductions."""
    hub = batch["hub_ids"]
    h_hub, s_hub = h[hub], s_src[hub]  # [C, H, D], [C, H]
    cold, hot = batch["edge_src_cold"], batch["edge_src_hub_pos"]
    dst_c, dst_h = batch["edge_dst_cold"], batch["edge_dst_hot"]
    msk_c = batch["edge_mask_cold"][:, None]
    msk_h = batch["edge_mask_hot"][:, None]
    slope = cfg.negative_slope
    e_c = torch.where(msk_c, F.leaky_relu(s_src[cold] + s_dst[dst_c], slope),
                      float("-inf"))
    e_h = torch.where(msk_h, F.leaky_relu(s_hub[hot] + s_dst[dst_h], slope),
                      float("-inf"))
    m = torch.maximum(segment_max(e_c, dst_c, n), segment_max(e_h, dst_h, n))
    m = torch.where(torch.isfinite(m), m, 0.0)
    x_c = torch.where(msk_c, torch.exp(e_c - m[dst_c]), 0.0)
    x_h = torch.where(msk_h, torch.exp(e_h - m[dst_h]), 0.0)
    denom = segment_sum(x_c, dst_c, n) + segment_sum(x_h, dst_h, n)  # [N, H]
    num = (segment_sum(gather_src(h, cold) * x_c[..., None], dst_c, n)
           + segment_sum(h_hub[hot] * x_h[..., None], dst_h, n))
    return num / torch.clamp(denom, min=1e-9)[..., None]


def apply(params, batch: GraphBatch, cfg: GATConfig) -> torch.Tensor:
    """Returns node logits [N, n_classes]."""
    x = batch["node_feat"].to(cfg.dtype)
    for i, p in enumerate(params["layers"]):
        x = _gat_layer(p, x, batch, cfg, last=i == cfg.n_layers - 1)
    return x
