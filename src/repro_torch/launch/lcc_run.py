"""Paper-workload launcher: distributed LCC/TC with RMA-style caching.

    python -m repro_torch.launch.lcc_run --scale 11 --p 8 --cache-rows 256
    python -m repro_torch.launch.lcc_run --graph livejournal --max-n 8192

Runs the async engine with ``--p`` logical ranks on one device (``--device``,
default ``cuda``; a missing card raises — pass ``--device cpu`` to run the
plain torch versions), verifies exactness against the single-node reference
for small graphs, and reports communication statistics + the
CLaMPI-simulator view.

``comm_bytes=`` (printed) and ``rma_bytes_modeled`` (``--metrics``) are
padded-width models: every pulled row at the schedule's width W. The engine
lands only each row's valid prefix: ``rma_ids_landed`` / ``rma_bytes_landed``
count what the timed epoch landed. ``--trace`` records the engine's and the
schedule's spans (``lcc.*``, ``schedule.*``; ``repro_torch.obs.trace``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--graph", default=None,
                    help="named Table-II stand-in instead of R-MAT")
    ap.add_argument("--max-n", type=int, default=1 << 13)
    ap.add_argument("--p", type=int, default=8,
                    help="logical ranks (all on one device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; there is no automatic CPU switch")
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--n-rounds", type=int, default=4)
    ap.add_argument("--method", default="hybrid",
                    choices=["bsearch", "pairwise", "hybrid"])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome-trace span timeline of the run "
                         "(open at ui.perfetto.dev or chrome://tracing)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the labeled metrics snapshot (per-rank "
                         "cache stats + modeled comm + per-phase time)")
    ap.add_argument("--cache-trace", default=None, metavar="PATH",
                    help="record the CLaMPI-sim access streams and write "
                         "the cachescope analysis sidecar (Mattson "
                         "hit-rate curve, eviction audit, policy replay)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..obs import trace as obs_trace

    if args.p < 1:
        ap.error("--p must be >= 1")
    device = resolve_device(args.device)

    tracer = obs_trace.enable_tracing() if args.trace else None
    recorder = None
    if args.cache_trace:
        from ..obs import cachescope as obs_cachescope

        recorder = obs_cachescope.enable_recording()

    from ..core.async_engine import lcc_pipelined
    from ..core.cache import build_static_degree_cache
    from ..core.rma import ID_BYTES, build_sharded_problem, simulate_rma_lcc
    from ..graphs.datasets import get as get_graph
    from ..graphs.rmat import rmat_graph

    if args.graph:
        csr = get_graph(args.graph, max_n=args.max_n)
        name = args.graph
    else:
        csr = rmat_graph(args.scale, args.edge_factor, seed=0)
        name = f"R-MAT S{args.scale} EF{args.edge_factor}"
    p = args.p
    print(f"graph {name}: n={csr.n} m={csr.m}; p={p} devices")

    cache = (build_static_degree_cache(csr.degrees, args.cache_rows)
             if args.cache_rows else None)
    prob = build_sharded_problem(csr, p, n_rounds=args.n_rounds, cache=cache)
    dev_prob = prob.to_device(device)
    t, lcc = lcc_pipelined(dev_prob, device, method=args.method)  # warm-up
    t0 = time.perf_counter()
    # the results come back as numpy, so the clock stops after the device
    # has finished
    t, lcc = lcc_pipelined(dev_prob, device, method=args.method)
    dt = time.perf_counter() - t0
    total_t = int(t.sum()) // 3
    print(f"triangles={total_t}  wall={dt * 1e3:.1f} ms  "
          f"comm_bytes={prob.comm_bytes_per_round().sum():,}")

    if args.verify:
        from ..core.triangles import triangles_per_vertex

        want = triangles_per_vertex(csr)
        from ..core.partition import partition_1d

        part = partition_1d(csr.n, p)
        got = np.concatenate(
            [t[k, : part.hi(k) - part.lo(k)] for k in range(p)])
        assert np.array_equal(got, want), "MISMATCH vs reference"
        print("verified exact vs single-node reference")

    with obs_trace.span("clampi_sim", cat="epoch"):
        st = simulate_rma_lcc(
            csr, p,
            adj_cache_bytes=csr.csr_nbytes() // 4,
            offsets_cache_bytes=csr.n * 2,
            use_degree_score=True,
        )
    hits = sum(s.hits for s in st.adj_stats)
    gets = sum(s.gets for s in st.adj_stats)
    print(f"CLaMPI-sim: adj hit rate {hits / max(gets, 1):.1%}, "
          f"modeled comm {st.makespan * 1e3:.2f} ms")
    cache_report = None
    if recorder is not None:
        from ..obs import cachescope as obs_cachescope

        obs_cachescope.disable_recording()
        cache_report = obs_cachescope.analyze(recorder)
        obs_cachescope.save_report(cache_report, args.cache_trace)
        print(obs_cachescope.summarize(cache_report))
        print(f"cache trace: {recorder.n_events()} events -> "
              f"{args.cache_trace}")
    if args.metrics:
        from ..obs.metrics import (
            MetricRegistry,
            fold_trace,
            imbalance,
            record_cache_stats,
            record_cachescope,
        )

        reg = MetricRegistry()
        for k, s in enumerate(st.adj_stats):
            record_cache_stats(reg, s, rank=k)
        if cache_report is not None:
            record_cachescope(reg, cache_report)
        reg.counter("rma_bytes_modeled",
                    float(prob.comm_bytes_per_round().sum()),
                    tier="wire", phase="fetch_rows")
        reg.counter("rma_ids_landed", float(dev_prob.landed_ids),
                    tier="wire", phase="lcc.epoch")
        reg.counter("rma_bytes_landed",
                    float(ID_BYTES * dev_prob.landed_ids),
                    tier="wire", phase="lcc.epoch")
        reg.counter("modeled_comm_s", float(st.makespan), tier="wire")
        reg.counter("epoch_wall_s", float(dt), phase="lcc.epoch")
        reg.gauge("cache_get_imbalance",
                  imbalance([s.gets for s in st.adj_stats]),
                  tier="host_cache")
        if tracer is not None:
            fold_trace(reg, tracer)
        snap = reg.to_dict()
        reg.save(args.metrics)
        print(f"metrics: {len(snap['counters'])} counters, "
              f"{len(snap['gauges'])} gauges -> {args.metrics}")
    if tracer is not None:
        obs_trace.disable_tracing()
        tracer.export(args.trace)
        print(f"trace: {len(tracer)} events -> {args.trace} "
              "(open at ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
