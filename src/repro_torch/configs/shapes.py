"""Canonical assigned input shapes per architecture family (the 40 cells).

LM shapes are (seq_len x global_batch); decode_*/long_* lower serve_step
(one token + KV cache), not train_step. long_500k requires sub-quadratic
attention: only gemma2-27b (alternating local/global) runs it — the pure
full-attention archs record a documented skip (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["LMShape", "GNNShape", "RecsysShape", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: Optional[int]
    kind: str  # 'full' | 'sampled' | 'batched'
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0
    nodes_per_graph: int = 0
    edges_per_graph: int = 0


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", 2708, 10556, 1433, "full"),
    "minibatch_lg": GNNShape(
        "minibatch_lg", 232_965, 114_615_892, None, "sampled",
        batch_nodes=1024, fanout=(15, 10),
    ),
    "ogb_products": GNNShape("ogb_products", 2_449_029, 61_859_140, 100, "full"),
    "molecule": GNNShape(
        "molecule", 30, 64, None, "batched",
        batch_graphs=128, nodes_per_graph=30, edges_per_graph=64,
    ),
}


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    kind: str  # 'train' | 'serve' | 'retrieval'
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", 65_536, "train"),
    "serve_p99": RecsysShape("serve_p99", 512, "serve"),
    "serve_bulk": RecsysShape("serve_bulk", 262_144, "serve"),
    "retrieval_cand": RecsysShape("retrieval_cand", 1, "retrieval",
                                  n_candidates=1_000_000),
}
