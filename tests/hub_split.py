"""The hub-split batch of the reference's dryrun (``launch/dryrun.py``:
GAT's edges in a cold and a hot stream), built from a plain GNN batch with
the port's planner. Numpy only, no JAX: the CPU parity tests and the card's
tests share it."""
import numpy as np

from repro_torch.distributed.hub_gather import split_hot_cold


def hub_split_batch(batch, capacity):
    """A plain GNN batch (numpy) split into the reference's two edge
    streams: the ``capacity`` sources of highest out-degree
    (``split_hot_cold``, scores = out-degree) form the hub table; an edge
    whose source is a hub goes to the hot stream, the rest stay cold, each
    stream in the batch's edge order."""
    src = batch["edge_src"]
    deg = np.bincount(src, minlength=batch["node_feat"].shape[0])
    plan = split_hot_cold(src, deg, capacity)
    hot = plan.is_hot
    out = {k: v for k, v in batch.items()
           if k not in ("edge_src", "edge_dst", "edge_mask")}
    out.update(
        hub_ids=plan.hot_ids.astype(np.int32),
        edge_src_cold=src[~hot], edge_src_hub_pos=plan.hot_pos[hot],
        edge_dst_cold=batch["edge_dst"][~hot],
        edge_dst_hot=batch["edge_dst"][hot],
        edge_mask_cold=batch["edge_mask"][~hot],
        edge_mask_hot=batch["edge_mask"][hot])
    return out
