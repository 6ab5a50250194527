"""GNN message-passing primitives, the counterparts of
``repro.models.gnn.common``.

Message passing is edge-index gather/scatter: gather source-node features
by ``edge_src``, transform, ``segment_sum``/``segment_max`` into the
destination nodes. Edge arrays carry ``edge_mask`` for padded edges.

``segment_sum`` is kernel B9 (``kernels/segment_sum_sorted.py``) behind a
``torch.autograd.Function``: B9 computes exactly the reference's
``jax.ops.segment_sum`` (ids outside ``[0, N)`` dropped, any order), and
``sort_edges_by_dst`` gives it the layout its name promises, once per
batch. The backward is the gather ``grad_values[e] = grad_out[ids[e]]``
(0 for ids out of range), as JAX differentiates ``segment_sum``.
``segment_max`` stays stock torch: the reference uses
``jax.ops.segment_max`` there, not a Pallas kernel. The reference's GSPMD
node sharding (``set_node_spec``) has no one-card counterpart and is
dropped.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ...kernels import ops
from ..common import trunc_normal

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "gather_src",
    "degree_counts",
    "mlp_init",
    "mlp_apply",
    "sort_edges_by_dst",
    "GraphBatch",
]

# A graph batch is a plain dict with keys:
#   node_feat [N, F], edge_src [E], edge_dst [E], edge_mask [E],
#   node_mask [N], (optional) graph_ids [N], labels, label_mask
GraphBatch = Dict[str, torch.Tensor]

EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask")


def gather_src(node_feat: torch.Tensor, edge_src: torch.Tensor):
    return node_feat[edge_src]


def sort_edges_by_dst(batch: GraphBatch) -> GraphBatch:
    """The batch with its edges in ascending ``edge_dst`` order: one stable
    sort on the batch's device, every per-edge array carried through the
    same permutation. Nodes keep their order, so outputs stay in node
    order; sums over a node's edges change only their fp32 order."""
    perm = torch.sort(batch["edge_dst"], stable=True).indices
    out = dict(batch)
    for k in EDGE_KEYS:
        out[k] = batch[k][perm]
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return ops.segment_sum_sorted(values, segment_ids,
                                      num_segments=num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        n = ctx.num_segments
        # ids out of range read an appended zero row
        g = grad_out.reshape(n, math.prod(grad_out.shape[1:]))
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        ids = torch.where((ids >= 0) & (ids < n), ids, n)
        grad = g.index_select(0, ids.long())
        return grad.reshape(ids.shape + grad_out.shape[1:]), None, None


def segment_sum(values, segment_ids, num_segments: int):
    return _SegmentSum.apply(values, segment_ids, int(num_segments))


def segment_max(values, segment_ids, num_segments: int):
    """``jax.ops.segment_max``: -inf for an empty segment, ids outside
    ``[0, N)`` dropped (sent to a spare row that is cut off); the gradient
    is split evenly over ties, as in JAX."""
    n = int(num_segments)
    ids = torch.where((segment_ids >= 0) & (segment_ids < n), segment_ids,
                      n).long()
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), float("-inf"))
    idx = ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=False)[:n]


def segment_mean(values, segment_ids, num_segments: int):
    s = segment_sum(values, segment_ids, num_segments)
    ones = torch.ones(values.shape[:1] + (1,) * (values.dim() - 1),
                      dtype=values.dtype, device=values.device)
    cnt = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0)


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Numerically stable softmax over edges grouped by destination node."""
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    mx = segment_max(scores, segment_ids, num_segments)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(scores - mx[segment_ids])
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(denom[segment_ids], min=1e-9)


def degree_counts(edge_dst, edge_mask, num_nodes: int):
    ones = edge_mask.to(torch.float32)
    return segment_sum(ones, edge_dst, num_nodes)


def mlp_init(generator: torch.Generator, sizes, dtype=torch.float32):
    """Layers ``{"w": [a, b], "b": [b]}`` on ``generator``'s device: the
    reference's init (fan-in truncated normal, zero bias; other draws)."""
    return [{"w": trunc_normal(generator, (a, b), dtype=dtype),
             "b": torch.zeros((b,), dtype=dtype, device=generator.device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x, act=torch.relu, *, final_act: bool = False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x
