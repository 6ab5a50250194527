"""GAT (Velickovic et al., arXiv:1710.10903), the counterpart of
``repro.models.gnn.gat`` — gat-cora assigned config: 2 layers,
d_hidden=8, 8 heads, attention aggregator.

Layer: per-edge score e_ij = LeakyReLU(a_src . Wh_i + a_dst . Wh_j), then
segment-softmax over each destination's incoming edges and a weighted
segment-sum (the softmax denominator and the aggregation are B9). First
layer concatenates heads, final layer averages them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..common import trunc_normal
from ._params import from_reference
from .common import GraphBatch, gather_src, segment_softmax, segment_sum

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
    if "edge_src_cold" in batch:
        raise NotImplementedError(
            "not ported yet: GAT's hub-split attention (edge_src_cold), "
            "which comes with distributed/hub_gather.py and sharding.py")
    n = x.shape[0]
    h = torch.einsum("nf,fhd->nhd", x, p["w"])  # [N, H, D]
    s_src = (h * p["a_src"]).sum(-1)  # [N, H]
    s_dst = (h * p["a_dst"]).sum(-1)
    src, dst, mask = batch["edge_src"], batch["edge_dst"], batch["edge_mask"]
    e = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)  # [E, H]
    w = segment_softmax(e, dst, n, mask=mask[:, None])  # [E, H]
    msg = gather_src(h, src) * w[..., None]  # [E, H, D]
    msg = torch.where(mask[:, None, None], msg, 0.0)
    agg = segment_sum(msg, dst, n) + p["b"]  # [N, H, D]
    if last:
        return agg.mean(dim=1)  # average heads -> logits
    return F.elu(agg.reshape(n, -1))  # concat heads


def apply(params, batch: GraphBatch, cfg: GATConfig) -> torch.Tensor:
    """Returns node logits [N, n_classes]."""
    x = batch["node_feat"].to(cfg.dtype)
    for i, p in enumerate(params["layers"]):
        x = _gat_layer(p, x, batch, cfg, last=i == cfg.n_layers - 1)
    return x
