"""End-to-end run of the PyTorch port (the paper's kind): distributed
asynchronous LCC over p logical ranks on one device with RMA-style pull
gathers + degree-score caching, verified exact against the single-node
reference and timed against the TriC-style BSP baseline; the counterpart
of ``examples/lcc_distributed.py``.

    PYTHONPATH=src python examples/torch/lcc_distributed.py [--scale 12] [--p 8] [--device cpu]

The ranks are the leading dimension of the problem's tensors (the port's
stand-in for the reference's 8 host devices), and ``lcc_pipelined`` runs
the epoch on ``--device``: kernel B7 (``epoch_land``, ``epoch_count``) on
the card (default ``cuda``; a missing card raises), the plain torch
versions on the CPU. The exactness lines and the communication volumes are
the reference's.
"""
import argparse
import time

import numpy as np

from repro_torch.core.async_engine import lcc_pipelined
from repro_torch.core.cache import build_static_degree_cache
from repro_torch.core.partition import partition_1d
from repro_torch.core.rma import build_sharded_problem
from repro_torch.core.triangles import lcc_scores, triangles_per_vertex
from repro_torch.core.tric_baseline import tric_problem
from repro_torch.device import resolve_device
from repro_torch.graphs.rmat import rmat_graph


def bench(prob, label, dev, n_iters=3):
    dprob = prob.to_device(dev)
    t, lcc = lcc_pipelined(dprob, dev)  # warm
    t0 = time.perf_counter()
    for _ in range(n_iters):
        t, lcc = lcc_pipelined(dprob, dev)  # ends with the copy to numpy
    dt = (time.perf_counter() - t0) / n_iters
    print(f"  {label:28s} {dt * 1e3:8.1f} ms/iter")
    return t, lcc, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = rmat_graph(args.scale, args.edge_factor, seed=0)
    print(f"graph: R-MAT S{args.scale} EF{args.edge_factor} "
          f"(n={g.n}, m={g.m}), p={args.p}")

    want_t = triangles_per_vertex(g)
    want_lcc = lcc_scores(g)
    part = partition_1d(g.n, args.p)

    def check(t, lcc, label):
        tg = np.concatenate(
            [t[k, : part.hi(k) - part.lo(k)] for k in range(args.p)]
        )
        lg = np.concatenate(
            [lcc[k, : part.hi(k) - part.lo(k)] for k in range(args.p)]
        )
        ok = np.array_equal(tg, want_t) and np.allclose(lg, want_lcc,
                                                        rtol=1e-5)
        print(f"  {label:28s} exact: {'YES' if ok else 'NO'}")
        if not ok:
            raise SystemExit(f"{label}: not exact")

    print(f"\nengines (the epoch engine, p={args.p} logical ranks on "
          f"{dev.type}):")
    p_async = build_sharded_problem(g, args.p, n_rounds=4)
    t, lcc, dt_async = bench(p_async, "async (pipelined)", dev)
    check(t, lcc, "async (pipelined)")

    cache = build_static_degree_cache(g.degrees, args.cache_rows)
    p_cached = build_sharded_problem(g, args.p, n_rounds=4, cache=cache)
    t, lcc, dt_cached = bench(p_cached, "async + degree cache", dev)
    check(t, lcc, "async + degree cache")

    p_tric = tric_problem(g, args.p)
    t, lcc, dt_tric = bench(p_tric, "TriC-style BSP baseline", dev)
    check(t, lcc, "TriC-style BSP baseline")

    b_async = p_async.comm_bytes_per_round().sum()
    b_cached = p_cached.comm_bytes_per_round().sum()
    b_tric = p_tric.comm_bytes_per_round().sum()
    print("\ncommunication volume (bytes, all devices):")
    print(f"  async:        {b_async:,}")
    print(f"  async+cache:  {b_cached:,} "
          f"({1 - b_cached / b_async:.1%} saved by caching)")
    print(f"  TriC BSP:     {b_tric:,} "
          f"({b_tric / b_async:.2f}x the async volume — no dedup)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
