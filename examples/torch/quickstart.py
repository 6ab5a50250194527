"""Quickstart of the PyTorch port: triangle counting + LCC with RMA caching
in 60 seconds, the counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The R-MAT graph's triangle total comes from the epoch engine on
``--device`` (default ``cuda``, through kernel B7; a missing card raises,
``--device cpu`` runs the plain torch versions); the toy graph, the LCC
and the RMA access simulation are host numpy, as in the reference.
"""
import argparse

import numpy as np

from repro_torch.core.csr import from_edges
from repro_torch.core.lcc import lcc_distributed, lcc_simulated, lcc_single
from repro_torch.core.lcc import triangle_count
from repro_torch.device import resolve_device
from repro_torch.graphs.rmat import rmat_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a toy graph (Fig. 1 of the paper)
    edges = np.array([
        [0, 1], [0, 2], [1, 2], [1, 4], [2, 4], [3, 4], [3, 5], [4, 5],
    ])
    g = from_edges(edges, 6, undirected=True)
    print("toy graph:", g.n, "vertices,", g.m // 2, "undirected edges")
    print("triangles:", triangle_count(g))
    print("LCC:", np.round(lcc_single(g), 3))

    # the paper's workload: power-law graph, distributed with RMA caching
    g = rmat_graph(12, 16, seed=0)
    print(f"\nR-MAT S12 EF16: n={g.n} m={g.m}")
    t, _ = lcc_distributed(g, 8, cache_rows=256, device=dev)
    total = int(t.astype(np.int64).sum()) // 3
    if total != triangle_count(g):
        raise SystemExit(f"engine on {dev}: {total} triangles, host "
                         f"{triangle_count(g)}")
    print("total triangles:", total)

    # simulate the distributed RMA access stream on 8 nodes,
    # with and without the CLaMPI-style cache (degree scores)
    st0 = lcc_simulated(g, 8)
    st1 = lcc_simulated(
        g, 8,
        offsets_cache_bytes=g.n,  # ~1 offset-pair per 8 vertices
        adj_cache_bytes=g.csr_nbytes() // 4,
        use_degree_score=True,
    )
    print("\n8-node RMA simulation:")
    print(f"  remote reads:        {st0.remote_gets.sum():,}")
    print(f"  comm time (no cache): {st0.makespan * 1e3:.1f} ms (modeled)")
    print(f"  comm time (cached):   {st1.makespan * 1e3:.1f} ms (modeled)")
    hits = sum(s.hits for s in st1.adj_stats)
    gets = sum(s.gets for s in st1.adj_stats)
    print(f"  C_adj hit rate:       {hits / gets:.1%}")
    print(f"  saved:                "
          f"{1 - st1.makespan / st0.makespan:.1%} of communication time")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
