"""PNA (Corso et al., arXiv:2004.05718), the counterpart of
``repro.models.gnn.pna`` — pna assigned config: 4 layers, d_hidden=75,
aggregators {mean, max, min, std}, scalers {identity, amplification,
attenuation}.

Each layer: message = MLP([h_i || h_j]); aggregate with the 4 aggregators
(the sums behind mean and std are B9); apply the 3 degree scalers
(log(d+1)/delta amplification and its inverse); concat (4 agg x 3 scalers)
and project back with an MLP + skip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ._params import from_reference
from .common import (
    GraphBatch,
    degree_counts,
    gather_src,
    mlp_apply,
    mlp_init,
    segment_max,
    segment_mean,
)

__all__ = ["PNAConfig", "init_params", "apply", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_in: int = 16
    d_hidden: int = 75
    n_classes: int = 1  # regression head (ZINC-style)
    delta: float = 2.5  # avg log-degree normalizer of the train set
    dtype: Any = torch.float32


def init_params(cfg: PNAConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (the reference's init;
    other draws)."""
    d = cfg.d_hidden
    encode = mlp_init(generator, (cfg.d_in, d), cfg.dtype)
    layers = [{"msg": mlp_init(generator, (2 * d, d), cfg.dtype),
               "upd": mlp_init(generator, (12 * d + d, d), cfg.dtype)}
              for _ in range(cfg.n_layers)]
    decode = mlp_init(generator, (d, d, cfg.n_classes), cfg.dtype)
    return {"encode": encode, "layers": layers, "decode": decode}


def params_from_reference(cfg: PNAConfig, tree) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as CPU tensors."""
    return from_reference(tree, init_params(cfg, torch.Generator()))


def _aggregate(msg, dst, mask, n, deg, cfg: PNAConfig):
    msg = torch.where(mask[:, None], msg, 0.0)
    mean = segment_mean(msg, dst, n)
    mx = segment_max(torch.where(mask[:, None], msg, float("-inf")), dst, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mn = -segment_max(torch.where(mask[:, None], -msg, float("-inf")), dst, n)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    sq = segment_mean(msg * msg, dst, n)
    # torch.maximum, not clamp: at a tie (a node whose messages are all
    # equal) it splits the gradient in halves, as jnp.maximum does
    var = torch.maximum(sq - mean * mean, sq.new_zeros(()))
    std = torch.sqrt(var + 1e-8)
    agg = torch.cat([mean, mx, mn, std], dim=-1)  # [N, 4D]
    # scalers
    logd = torch.log(deg + 1.0)[:, None] / cfg.delta
    amp = agg * logd
    att = agg / torch.clamp(logd, min=1e-2)
    return torch.cat([agg, amp, att], dim=-1)  # [N, 12D]


def apply(params, batch: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """Returns graph-level prediction [n_graphs, n_classes] if graph_ids
    are present, else node-level [N, n_classes]."""
    src, dst, mask = batch["edge_src"], batch["edge_dst"], batch["edge_mask"]
    x = mlp_apply(params["encode"], batch["node_feat"].to(cfg.dtype))
    n = x.shape[0]
    deg = degree_counts(dst, mask, n)
    for p in params["layers"]:
        m_in = torch.cat([gather_src(x, src), x[dst]], dim=-1)
        msg = mlp_apply(p["msg"], m_in, act=torch.relu, final_act=True)
        agg = _aggregate(msg, dst, mask, n, deg, cfg)
        x = x + mlp_apply(p["upd"], torch.cat([x, agg], -1))
    x = torch.where(batch["node_mask"][:, None], x, 0.0)
    if "graph_ids" in batch:
        n_graphs = batch["labels"].shape[0]  # one target per graph
        pooled = segment_mean(x, batch["graph_ids"], n_graphs)
        return mlp_apply(params["decode"], pooled)
    return mlp_apply(params["decode"], x)
