"""Input construction for every (arch x shape) cell, the counterpart of
``repro.configs.inputs``.

Two modes sharing one shape computation:
- ``input_specs(arch_id, shape_id)``: tensors on the ``meta`` device for
  the FULL assigned shapes (shapes and dtypes, no storage), in place of the
  reference's ``jax.ShapeDtypeStruct``.
- ``make_smoke_batch(arch_id, kind, rng)``: small concrete numpy batches
  with identical structure, the reference's draws from the same ``rng``.

GNN features and labels are synthetic with the assigned dims. MACE is not
ported yet (``get_arch`` raises for it), so its branches are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .registry import ArchEntry, get_arch
from .shapes import GNNShape, LMShape, RecsysShape

__all__ = ["cell_shapes", "input_specs", "make_smoke_batch", "step_kind",
           "gnn_feat_dim"]

F32, I32, BOOL = torch.float32, torch.int32, torch.bool


# --------------------------------------------------------------------------
# shape computation (dict of name -> (shape, dtype)), shared by both modes
# --------------------------------------------------------------------------
def _sampled_sizes(batch_nodes: int, fanout: Tuple[int, ...]) -> Tuple[int, int]:
    n_max, e_max, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        e_max += frontier * f
        frontier *= f
        n_max += frontier
    return n_max, e_max


def _gnn_class_count(shape_id: str) -> int:
    return {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
            "molecule": 2}[shape_id]


def gnn_feat_dim(arch_cfg, shape: GNNShape) -> int:
    if shape.d_feat is not None:
        return int(shape.d_feat)
    if shape.kind == "sampled":
        return 602  # Reddit features
    return getattr(arch_cfg, "d_in", 16)


def cell_shapes(arch: ArchEntry, cfg, shape) -> Dict[str, Tuple[tuple, Any]]:
    """name -> (shape tuple, torch dtype) for the step's batch inputs."""
    if arch.family == "lm":
        s: LMShape = shape
        if s.kind == "train":
            return {
                "tokens": ((s.global_batch, s.seq_len), I32),
                "labels": ((s.global_batch, s.seq_len), I32),
            }
        if s.kind == "prefill":
            return {"tokens": ((s.global_batch, s.seq_len), I32)}
        # decode: one new token; the KV cache is built separately
        return {"token": ((s.global_batch,), I32)}
    if arch.family == "gnn":
        g: GNNShape = shape
        if g.kind == "sampled":
            n, e = _sampled_sizes(g.batch_nodes, g.fanout)
            n_out = g.batch_nodes
        elif g.kind == "batched":
            n = g.batch_graphs * g.nodes_per_graph
            e = g.batch_graphs * g.edges_per_graph
            n_out = g.batch_graphs
        else:
            n, e = g.n_nodes, g.n_edges
            n_out = n
        d = gnn_feat_dim(cfg, g)
        out: Dict[str, Tuple[tuple, Any]] = {
            "edge_src": ((e,), I32),
            "edge_dst": ((e,), I32),
            "edge_mask": ((e,), BOOL),
            "node_mask": ((n,), BOOL),
            "node_feat": ((n, d), F32),
        }
        if g.kind == "batched":
            out["graph_ids"] = ((n,), I32)
            out["labels"] = ((n_out,), I32)
        else:  # sampled and full graphs: node-level labels with a mask
            out["labels"] = ((n,), I32)
            out["label_mask"] = ((n,), BOOL)
        return out
    if arch.family == "recsys":
        r: RecsysShape = shape
        if r.kind == "retrieval":
            return {
                "hist_items": ((1, cfg.seq_len), I32),
                "hist_cats": ((1, cfg.seq_len), I32),
                "hist_mask": ((1, cfg.seq_len), BOOL),
                "user_profile": ((1, cfg.d_profile), F32),
                "cand_items": ((r.n_candidates,), I32),
                "cand_cats": ((r.n_candidates,), I32),
            }
        b = r.batch
        out = {
            "hist_items": ((b, cfg.seq_len), I32),
            "hist_cats": ((b, cfg.seq_len), I32),
            "hist_mask": ((b, cfg.seq_len), BOOL),
            "target_item": ((b,), I32),
            "target_cat": ((b,), I32),
            "user_profile": ((b, cfg.d_profile), F32),
        }
        if r.kind == "train":
            out["label"] = ((b,), F32)
        return out
    raise ValueError(arch.family)


def step_kind(arch: ArchEntry, shape) -> str:
    if arch.family == "lm":
        return {"train": "lm_train", "prefill": "lm_prefill",
                "decode": "lm_decode"}[shape.kind]
    if arch.family == "gnn":
        return "gnn_train"
    if arch.family == "recsys":
        return {"train": "recsys_train", "serve": "recsys_serve",
                "retrieval": "retrieval"}[shape.kind]
    raise ValueError(arch.family)


def input_specs(arch_id: str, shape_id: str):
    """(cfg adapted to the shape, shape, batch of ``meta`` tensors) for the
    FULL cell."""
    arch = get_arch(arch_id)
    cfg = arch.config()
    shape = arch.shapes[shape_id]
    shapes = cell_shapes(arch, cfg, shape)
    cfg = _adapt_cfg(arch, cfg, shape_id, shape)
    return (
        cfg,
        shape,
        {k: torch.empty(s, dtype=dt, device="meta")
         for k, (s, dt) in shapes.items()},
    )


def _adapt_cfg(arch: ArchEntry, cfg, shape_id: str, shape):
    """A GNN config with the shape's feature width and class count."""
    if arch.family != "gnn":
        return cfg
    kw = {"d_in": gnn_feat_dim(cfg, shape)}
    if hasattr(cfg, "n_classes") and cfg.__class__.__name__ != "PNAConfig":
        kw["n_classes"] = _gnn_class_count(shape_id)
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------------------
# concrete smoke batches (reduced sizes, same structure)
# --------------------------------------------------------------------------
SMOKE_LM = dict(seq_len=32, global_batch=4)
SMOKE_GNN = dict(n=48, e=192, n_graphs=4, nodes_per_graph=6, edges_per_graph=10)
SMOKE_RECSYS = dict(batch=8, n_candidates=64)


def make_smoke_batch(arch_id: str, kind: str, rng: np.random.Generator):
    """(cfg, batch dict of numpy arrays) for a reduced cell of ``kind``."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_config()
    if arch.family == "lm":
        b, s = SMOKE_LM["global_batch"], SMOKE_LM["seq_len"]
        toks = rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
        if kind == "lm_train":
            return cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if kind == "lm_prefill":
            return cfg, {"tokens": toks[:, :-1]}
        return cfg, {"token": toks[:, 0]}
    if arch.family == "gnn":
        n, e = SMOKE_GNN["n"], SMOKE_GNN["e"]
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n, size=e).astype(np.int32)
        batch: Dict[str, Any] = {
            "edge_src": src,
            "edge_dst": dst,
            "edge_mask": (rng.random(e) < 0.9),
            "node_mask": np.ones(n, bool),
        }
        batch["node_feat"] = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
        graph_ids = (np.arange(n) * SMOKE_GNN["n_graphs"] // n).astype(np.int32)
        if cfg.__class__.__name__ == "GINConfig":
            batch["graph_ids"] = graph_ids
            batch["labels"] = rng.integers(
                0, cfg.n_classes, SMOKE_GNN["n_graphs"]
            ).astype(np.int32)
        elif cfg.__class__.__name__ == "PNAConfig":
            batch["graph_ids"] = graph_ids
            batch["labels"] = rng.normal(size=SMOKE_GNN["n_graphs"]).astype(
                np.float32
            )
        else:  # GAT: node classification
            batch["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
            batch["label_mask"] = np.ones(n, bool)
        return cfg, batch
    if arch.family == "recsys":
        from ..data.recsys import CTRStream

        b = SMOKE_RECSYS["batch"]
        stream = CTRStream(cfg.n_items, cfg.n_cats, b, seq_len=cfg.seq_len,
                           d_profile=cfg.d_profile, seed=0)
        batch = stream.batch_at(0)
        if kind == "retrieval":
            nc = SMOKE_RECSYS["n_candidates"]
            batch = {
                "hist_items": batch["hist_items"][:1],
                "hist_cats": batch["hist_cats"][:1],
                "hist_mask": batch["hist_mask"][:1],
                "user_profile": batch["user_profile"][:1],
                "cand_items": rng.integers(0, cfg.n_items, nc).astype(np.int32),
                "cand_cats": rng.integers(0, cfg.n_cats, nc).astype(np.int32),
            }
        return cfg, batch
    raise ValueError(arch.family)
