"""GIN (Xu et al., arXiv:1810.00826), the counterpart of
``repro.models.gnn.gin`` — gin-tu assigned config: 5 layers, d_hidden=64,
sum aggregator, learnable eps.

h_i' = MLP((1 + eps) h_i + sum_{j in N(i)} h_j); graph-level readout sums
node embeddings of every layer (jumping knowledge, as in the paper) and
classifies with a linear head per layer, summed. Both sums are B9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ._params import from_reference
from .common import GraphBatch, gather_src, mlp_apply, mlp_init, segment_sum

__all__ = ["GINConfig", "init_params", "apply", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_in: int = 7  # TU molecule node labels (one-hot)
    d_hidden: int = 64
    n_classes: int = 2
    dtype: Any = torch.float32


def init_params(cfg: GINConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (the reference's init;
    other draws)."""
    layers = []
    d = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "mlp": mlp_init(generator, (d, cfg.d_hidden, cfg.d_hidden),
                            cfg.dtype),
            "eps": torch.zeros((), dtype=cfg.dtype, device=generator.device),
            "head": mlp_init(generator, (cfg.d_hidden, cfg.n_classes),
                             cfg.dtype),
        })
        d = cfg.d_hidden
    return {"layers": layers}


def params_from_reference(cfg: GINConfig, tree) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as CPU tensors."""
    return from_reference(tree, init_params(cfg, torch.Generator()))


def apply(params, batch: GraphBatch, cfg: GINConfig) -> torch.Tensor:
    """Graph logits [n_graphs, C] when ``graph_ids`` present (sum readout
    per layer, jumping knowledge); node logits [N, C] otherwise."""
    x = batch["node_feat"].to(cfg.dtype)
    src, dst, mask = batch["edge_src"], batch["edge_dst"], batch["edge_mask"]
    n = x.shape[0]
    graph_level = "graph_ids" in batch
    node_mask = batch["node_mask"][:, None]
    if graph_level:
        gid = batch["graph_ids"]
        n_graphs = batch["labels"].shape[0]  # one label per graph
        out = torch.zeros((n_graphs, cfg.n_classes), dtype=cfg.dtype,
                          device=x.device)
    else:
        out = torch.zeros((n, cfg.n_classes), dtype=cfg.dtype,
                          device=x.device)
    drop = ~mask[:, None]
    for p in params["layers"]:
        # Masked in place: the gather's backward keeps only the indices, so
        # autograd holds no reference to the gathered [E, D] tensor, and
        # torch.where would hold two of them at once.
        msg = gather_src(x, src).masked_fill_(drop, 0.0)
        agg = segment_sum(msg, dst, n)
        del msg
        x = mlp_apply(p["mlp"], (1.0 + p["eps"]) * x + agg,
                      act=torch.relu, final_act=True)
        x = torch.where(node_mask, x, 0.0)
        pooled = segment_sum(x, gid, n_graphs) if graph_level else x
        out = out + mlp_apply(p["head"], pooled)
    return out
