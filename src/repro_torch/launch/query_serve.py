"""Online query-serving launcher: batched LCC/triangle/neighborhood
queries with cache-backed remote reads over a live R-MAT graph.

    python -m repro_torch.launch.query_serve --smoke --device cpu
    python -m repro_torch.launch.query_serve --scale 12 --queries 4000 \
        --workload zipf --batch-window 64 --write-frac 0.2 --p 8
    python -m repro_torch.launch.query_serve --smoke --ranks 4   # cross-rank
    python -m repro_torch.launch.query_serve --smoke --open-loop poisson \
        --rate 500 --slo --tenants 3                       # traffic plane

Runs on ``--device`` (default ``cuda``; a missing card raises — pass
``--device cpu`` to run the plain host route). On the card the pair
counts go through the hand-written kernels: ``intersect_count`` (B1) for
pairs whose rows were fetched, ``resident_intersect`` (B3) for pairs with
a row resident in the device tier (``--device-tier``), and the stream
engine's update batches through the same two.

Builds the graph, stands up a ``LiveQueryService`` over the shared
``ShardedRuntime`` (streaming engine + degree-scored cache-backed row
providers + microbatching scheduler), and drives a closed-loop
read-write workload: query groups drain through the scheduler in
``--batch-window`` microbatches, update batches mutate the store and
invalidate cached rows through the runtime's targeted coherence fanout.

``--open-loop {poisson,diurnal,burst,trace:PATH}`` switches the driver
from the closed-loop read-write stream to **open-loop** arrivals at
``--rate`` offered q/s: queries enter the scheduler at sampled arrival
times that never wait for completions, so the reported latency includes
real queueing delay (the latency-vs-offered-load regime). Open-loop
runs are queries-only (the write stream is disabled). ``--slo`` turns
on per-class deadlines with EDF window selection and SLO-aware
flush/shed; ``--tenants N`` stands up N symmetric tenants with
token-bucket admission and cache byte shares; ``--ewma-scores``
replaces the static degree cache score with the live
request-frequency×degree blend. One ``--seed`` drives graph, workload,
arrivals, and tenant assignment through independent spawned streams —
the whole run is bit-reproducible.

``--ranks p`` switches on **cross-rank serving**: p provider/engine
instances over one runtime, every query routed to the rank that owns its
target vertex, remote rows shipped owner -> requester through that
rank's cache (the dynamic analogue of the static engine's all-to-all
serve lists). Per-rank cache/read stats and the cross-rank transport
totals are reported alongside the aggregate. ``--p`` without ``--ranks``
keeps the classic single-rank view of a p-way partition. ``--spmd`` runs
the ``--ranks`` views as one SPMD execution unit a microbatch on the same
device (the serve block B5 and the pair counts B6); ``--pipeline``
double-buffers those microbatches.

Reports throughput, p50/p99 latency, provider hit rate, and — with
``--verify`` (on in ``--smoke``) — recomputes every point query against
a from-scratch recount of the current snapshot (bit-exact) and audits
that zero cached rows are stale on any rank.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, checked (``--smoke`` applied)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--workload", choices=("uniform", "zipf"), default="zipf")
    ap.add_argument("--batch-window", type=int, default=64,
                    help="microbatch size (1 = one query at a time)")
    ap.add_argument("--queries-per-event", type=int, default=64)
    ap.add_argument("--write-frac", type=float, default=0.2,
                    help="fraction of events that are update batches")
    ap.add_argument("--updates-per-event", type=int, default=64)
    ap.add_argument("--p", type=int, default=4,
                    help="simulated ranks (owner partition for remote reads)")
    ap.add_argument("--partition", choices=("1d", "hub"), default="1d",
                    help="vertex ownership: '1d' equal blocks (paper "
                         "§III-A) or 'hub' balance-aware cuts + degree-"
                         "threshold hub splitting (hub rows served as "
                         "per-rank fragments; see docs/partitioning.md)")
    ap.add_argument("--hub-threshold", type=int, default=None,
                    help="with --partition hub: degree at/above which a "
                         "row is fragmented (default: 4x mean degree)")
    ap.add_argument("--rebalance", action="store_true",
                    help="with --partition hub: gauge-driven online "
                         "repartition — when the windowed read imbalance "
                         "crosses --rebalance-trigger, migrate bounded "
                         "row ranges toward the degree-balanced cuts "
                         "(closed-loop runs only)")
    ap.add_argument("--rebalance-trigger", type=float, default=1.25,
                    help="windowed max/mean read imbalance that arms a "
                         "migration")
    ap.add_argument("--max-moves", type=int, default=4096,
                    help="rows each cut boundary may move per migration")
    ap.add_argument("--ranks", type=int, default=0,
                    help="cross-rank serving: run this many provider/engine "
                         "instances over the runtime, routing each query to "
                         "its owner rank (0: single-rank view of --p)")
    ap.add_argument("--spmd", action="store_true",
                    help="execute the --ranks rank views as one SPMD "
                         "execution unit a microbatch on --device: remote "
                         "rows ship through the serve block (B5) whose "
                         "measured traffic is reconciled against the "
                         "modeled serve matrix, pairs counted by B6")
    ap.add_argument("--pipeline", action="store_true",
                    help="with --spmd: double-buffer microbatches — the "
                         "host pack + launch of window k+1 overlaps window "
                         "k's in-flight device counts (bit-identical "
                         "results; end_batch is the only device sync)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; there is no automatic CPU switch")
    ap.add_argument("--device-scope", choices=("replicated", "per_rank"),
                    default="replicated",
                    help="with --device-tier: one hot set replicated on "
                         "every device, or a distinct per-rank hot set "
                         "of each rank's own remote-heavy rows")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="deadline-aware batching: flush a partial window "
                         "once its oldest query waited this long")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: bound the pending queue; "
                         "submits past the bound are shed with reason "
                         "'depth' (see the shed-rate counter)")
    ap.add_argument("--shed-wait-ms", type=float, default=None,
                    help="load shedding: poll() drops queries that "
                         "already waited this long instead of serving "
                         "them (reason 'deadline')")
    ap.add_argument("--open-loop", default=None, metavar="PROC",
                    help="open-loop arrivals instead of the closed-loop "
                         "stream: poisson | diurnal | burst | trace:PATH "
                         "(queries-only; latency includes queueing delay)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered load in queries/s for --open-loop")
    ap.add_argument("--arrivals-out", default=None, metavar="PATH",
                    help="with --open-loop: save the sampled arrival "
                         "trace for exact replay (trace:PATH)")
    ap.add_argument("--slo", action="store_true",
                    help="per-class deadlines (EDF window selection, "
                         "SLO-aware flush, shed past deadline with "
                         "reason 'slo', per-class shed rates)")
    ap.add_argument("--slo-scale", type=float, default=1.0,
                    help="multiply every class deadline (tighten <1, "
                         "relax >1)")
    ap.add_argument("--slo-headroom-ms", type=float, default=5.0,
                    help="dispatch a window this far before its most "
                         "urgent deadline (margin for batch service "
                         "time + poll granularity)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="N symmetric tenants: token-bucket admission "
                         "(shed reason 'quota') + even cache byte "
                         "shares with quota-aware eviction")
    ap.add_argument("--tenant-qps", type=float, default=100.0,
                    help="per-tenant sustained admission rate")
    ap.add_argument("--tenant-burst", type=float, default=16.0,
                    help="per-tenant token-bucket burst depth")
    ap.add_argument("--ewma-scores", action="store_true",
                    help="live workload-driven cache scores: blend the "
                         "request-frequency EWMA with degree for both "
                         "the host caches and the device tier")
    ap.add_argument("--ewma-blend", type=float, default=0.7,
                    help="frequency weight in the blended score "
                         "(0 = pure degree; must be < 1 so cold rows "
                         "stay device-tier eligible)")
    ap.add_argument("--ewma-decay", type=float, default=0.98,
                    help="per-access EWMA decay (cachescope-identical)")
    ap.add_argument("--device-tier", action="store_true",
                    help="enable the device-resident hot-row cache tier "
                         "(hub adjacency kept on the card; resident pairs "
                         "intersect via the resident_intersect gather "
                         "kernel, B3)")
    ap.add_argument("--device-slots", type=int, default=256,
                    help="hot-set capacity (rows) of the device tier")
    ap.add_argument("--device-width", type=int, default=None,
                    help="padded row width of the device buffer "
                         "(default: pow2 ceiling of the max degree)")
    ap.add_argument("--cache-kib", type=int, default=1024)
    ap.add_argument("--uncached", action="store_true",
                    help="DirectRowProvider baseline instead of the cache")
    ap.add_argument("--verify", action="store_true",
                    help="check every point query vs a from-scratch recount")
    ap.add_argument("--smoke", action="store_true",
                    help="small graph, verification on")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome-trace span timeline of the run "
                         "(open at ui.perfetto.dev or chrome://tracing)")
    ap.add_argument("--trace-fine", action="store_true",
                    help="with --trace: also emit per-cache-entry "
                         "admit/evict instants (bigger trace)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the labeled metrics snapshot (all ledgers "
                         "+ per-phase time; see docs/observability.md)")
    ap.add_argument("--cache-trace", default=None, metavar="PATH",
                    help="record every cache access on both tiers and "
                         "write the cachescope analysis sidecar (reuse "
                         "distances, Mattson hit-rate curve, eviction "
                         "audit, offline policy replay incl. Belady)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not 0.0 <= args.write_frac <= 0.9:
        ap.error("--write-frac must be in [0, 0.9] (queries must flow)")
    if args.uncached and args.device_tier:
        ap.error("--uncached is the no-cache baseline; a device tier on "
                 "top of it would serve remote reads from residency and "
                 "corrupt the comparison")
    if args.spmd and args.ranks <= 0:
        ap.error("--spmd executes the cross-rank views on devices; "
                 "pass --ranks p")
    if args.pipeline and not args.spmd:
        ap.error("--pipeline double-buffers SPMD microbatches; pass --spmd")
    if args.device_scope != "replicated" and not args.device_tier:
        ap.error("--device-scope shapes the device tier; pass --device-tier")
    if args.trace_fine and not args.trace:
        ap.error("--trace-fine needs --trace")
    if args.open_loop is not None:
        known = ("poisson", "diurnal", "burst")
        if args.open_loop not in known and \
                not args.open_loop.startswith("trace:"):
            ap.error(f"--open-loop must be one of {known} or trace:PATH")
        if args.rate <= 0.0:
            ap.error("--rate must be positive")
        args.write_frac = 0.0  # open-loop runs are queries-only
    if args.arrivals_out and not args.open_loop:
        ap.error("--arrivals-out records the --open-loop arrival trace")
    if args.hub_threshold is not None and args.partition != "hub":
        ap.error("--hub-threshold shapes the hub partition; pass "
                 "--partition hub")
    if args.rebalance and args.partition != "hub":
        ap.error("--rebalance migrates hub-partition cuts; pass "
                 "--partition hub")
    if args.rebalance and args.open_loop:
        ap.error("--rebalance checks the gauge between closed-loop "
                 "events; open-loop runs are queries-only")
    if args.tenants < 0:
        ap.error("--tenants must be >= 0")
    if args.ewma_scores and not 0.0 <= args.ewma_blend < 1.0:
        ap.error("--ewma-blend must be in [0, 1): the device tier only "
                 "admits rows with positive scores, so pure frequency "
                 "(1.0) would exclude every not-yet-requested row")
    if args.smoke:
        args.scale = min(args.scale, 8)
        args.queries = min(args.queries, 256)
        args.verify = True
    return args


def build_service(
    args: argparse.Namespace, device, use_kernel: Optional[bool] = None
) -> argparse.Namespace:
    """The graph, the traffic-plane objects and the ``LiveQueryService``
    the launcher wires from its flags, on ``device`` (``use_kernel`` as
    ``LiveQueryService`` takes it: None keys the route on the device).
    Prints the graph's
    line (and the hub partition's). Returns them as one namespace:
    ``csr, svc, p, cross_rank, slo, quotas, scorer, clock, rebalancer,
    arrival_seed, tenant_seed``."""
    from ..graphs.rmat import rmat_graph
    from ..serving import LiveQueryService

    # One --seed, independent derived streams: the graph and the
    # closed-loop workload keep the raw seed, arrivals and tenant
    # assignment get spawned children so adding --tenants never perturbs
    # the arrival times.
    seed_root = np.random.SeedSequence(args.seed)
    arrival_seed, tenant_seed = (
        int(c.generate_state(1)[0]) for c in seed_root.spawn(2)
    )

    slo = quotas = scorer = clock = None
    if args.slo:
        from ..traffic import SLOPolicy

        slo = SLOPolicy(
            headroom_s=args.slo_headroom_ms * 1e-3
        ).scaled(args.slo_scale)
    if args.tenants:
        from ..traffic import TenantQuotas

        quotas = TenantQuotas.uniform(
            args.tenants, rate_qps=args.tenant_qps, burst=args.tenant_burst
        )
    if args.ewma_scores:
        from ..traffic import WorkloadScorer

        scorer = WorkloadScorer(blend=args.ewma_blend,
                                decay=args.ewma_decay)
    if args.open_loop:
        from ..traffic import HybridClock

        clock = HybridClock()

    n = 1 << args.scale
    csr = rmat_graph(args.scale, args.edge_factor, seed=args.seed)
    cross_rank = args.ranks > 0
    p = args.ranks if cross_rank else args.p
    print(f"R-MAT S{args.scale} EF{args.edge_factor}: n={n}, m={csr.m} "
          f"(directed), max deg {csr.max_degree}"
          + (f"  [cross-rank serving, p={p}"
             f"{', SPMD device mesh' if args.spmd else ''}]"
             if cross_rank else ""))

    partition = None
    if args.partition == "hub":
        from ..core.partition import partition_hub

        partition = partition_hub(
            csr.degrees, p, threshold=args.hub_threshold
        )
        sizes = partition.sizes()
        print(f"hub partition: {partition.hubs.size} hubs (degree >= "
              f"{partition.threshold}) fragmented across {p} ranks, "
              f"blocks {int(sizes.min())}..{int(sizes.max())} rows")

    svc = LiveQueryService(
        csr,
        p=p,
        cross_rank=cross_rank,
        partition=partition,
        cache_bytes=args.cache_kib << 10,
        max_batch=args.batch_window,
        max_wait=(args.max_wait_ms * 1e-3
                  if args.max_wait_ms is not None else None),
        max_queue=args.max_queue,
        shed_wait=(args.shed_wait_ms * 1e-3
                   if args.shed_wait_ms is not None else None),
        device_slots=args.device_slots if args.device_tier else 0,
        device_width=args.device_width,
        uncached=args.uncached,
        execution="spmd" if args.spmd else "loop",
        pipeline=args.pipeline,
        device_scope=args.device_scope,
        slo=slo,
        quotas=quotas,
        scorer=scorer,
        clock=clock,
        use_kernel=use_kernel,
        device=device,
    )

    rebalancer = None
    if args.rebalance:
        from ..core.repartition import Rebalancer

        rebalancer = Rebalancer(
            svc.runtime,
            trigger=args.rebalance_trigger,
            max_moves=args.max_moves,
            hub_threshold=args.hub_threshold,
        )
    return argparse.Namespace(
        csr=csr, svc=svc, p=p, cross_rank=cross_rank, slo=slo,
        quotas=quotas, scorer=scorer, clock=clock, rebalancer=rebalancer,
        arrival_seed=arrival_seed, tenant_seed=tenant_seed,
    )


def closed_loop(
    args: argparse.Namespace,
    svc,
    *,
    rebalancer=None,
    on_results: Optional[Callable[[list], None]] = None,
):
    """The closed-loop read-write stream: update batches through
    ``svc.apply_updates``, query groups through the scheduler until
    ``--queries`` are served. ``on_results`` sees each group's results
    before the next event mutates the graph. Returns ``(served,
    n_updates)``."""
    from ..serving import read_write_stream

    served = 0
    n_updates = 0
    # 2x safety factor: event kinds are drawn i.i.d., so an unlucky
    # write-heavy prefix must not end the stream before --queries served.
    n_query_events = -(-args.queries // args.queries_per_event)
    n_events = int(2 * n_query_events / (1.0 - args.write_frac)) + 1
    for ev in read_write_stream(
        lambda: svc.store.degrees,
        svc.store.n,
        n_events=n_events,
        write_frac=args.write_frac,
        queries_per_event=args.queries_per_event,
        updates_per_event=args.updates_per_event,
        kind=args.workload,
        seed=args.seed,
    ):
        if ev.is_update:
            res = svc.apply_updates(ev.update)
            n_updates += res.n_inserted + res.n_deleted
            if rebalancer is not None:
                # batch boundary: the scheduler is drained (single-
                # writer), so ownership may move here and nowhere else.
                rebalancer.maybe_rebalance(svc.store.degrees)
            continue
        if args.max_wait_ms is None:
            results = svc.scheduler.run(ev.queries)
        else:
            # deadline-aware serving: submit one at a time and poll —
            # full windows dispatch immediately, the trailing partial
            # window sits until its oldest query ages past the deadline
            results = []
            for q in ev.queries:
                svc.scheduler.submit(q)
                results.extend(svc.scheduler.poll())
            while svc.scheduler.pending:
                time.sleep(args.max_wait_ms * 1e-3 / 8)
                results.extend(svc.scheduler.poll())
        served += len(results)
        if on_results is not None:
            on_results(results)
        if served >= args.queries:
            break
    return served, n_updates


def main(argv=None, result: Optional[dict] = None):
    """Serve; returns the exit code. ``result``, when given, is filled
    with the service (``"svc"``), the queries served (``"served"``), the
    driver's wall time (``"wall_s"``) and the scheduler's
    ``LatencySummary`` (``"latency"``)."""
    args = parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.ewma_scores and args.cache_trace:
        print("note: --ewma-scores + --cache-trace — offline replay "
              "gates that assume the deployed degree policy (and any "
              "tenant cache shares) do not hold on this trace")
    tracer = None
    if args.trace:
        from ..obs import trace as obs_trace

        tracer = obs_trace.enable_tracing(fine=args.trace_fine)
    recorder = None
    if args.cache_trace:
        from ..obs import cachescope as obs_cachescope

        recorder = obs_cachescope.enable_recording()

    from ..core.triangles import lcc_scores, triangles_per_vertex
    from ..serving import QueryKind

    w = build_service(args, device)
    svc, p, cross_rank = w.svc, w.p, w.cross_rank
    quotas, scorer, rebalancer = w.quotas, w.scorer, w.rebalancer

    n_verified = 0
    open_report = None

    def _verify_results(results):
        nonlocal n_verified
        snap = svc.store.to_csr()
        t_ref = triangles_per_vertex(snap)
        lcc_ref = lcc_scores(snap, t_ref)
        for r in results:
            q = r.query
            if q.kind == QueryKind.TRIANGLES:
                assert r.value == t_ref[q.u], (q, r.value, t_ref[q.u])
            elif q.kind == QueryKind.LCC:
                assert r.value == lcc_ref[q.u], (q, r.value, lcc_ref[q.u])
            elif q.kind == QueryKind.COMMON_NEIGHBORS:
                want = np.intersect1d(snap.row(q.u), snap.row(q.v))
                assert r.value == want.size and np.array_equal(r.ids, want)
            else:  # TOP_K_LCC: compare ranking vs the recount
                order = np.lexsort((np.arange(snap.n), -lcc_ref))[: q.k]
                assert np.array_equal(r.ids, order), (q, r.ids, order)
            n_verified += 1

    t_start = time.perf_counter()
    n_updates = 0
    if args.open_loop:
        # -------- open-loop: arrivals never wait for completions ------
        from ..serving import make_queries
        from ..traffic import assign_tenants, make_arrivals, run_open_loop

        queries = make_queries(
            svc.store.degrees, args.queries, kind=args.workload,
            seed=args.seed,
        )
        if quotas is not None:
            queries = assign_tenants(
                queries, quotas.tenants,
                rng=np.random.default_rng(w.tenant_seed),
            )
        arrivals = make_arrivals(
            args.open_loop, len(queries), args.rate, seed=w.arrival_seed
        )
        if args.arrivals_out:
            arrivals.save(args.arrivals_out)
            print(f"arrival trace: {len(arrivals)} arrivals "
                  f"({arrivals.measured_qps:,.0f} q/s measured) -> "
                  f"{args.arrivals_out}")
        open_report = run_open_loop(
            svc.scheduler, queries, arrivals, clock=w.clock
        )
        served = open_report.n_served
        if args.verify:
            _verify_results(open_report.results)
    else:
        served, n_updates = closed_loop(
            args, svc, rebalancer=rebalancer,
            on_results=_verify_results if args.verify else None,
        )
    wall = time.perf_counter() - t_start
    if served < args.queries and not args.open_loop:
        print(f"note: stream exhausted at {served}/{args.queries} queries")

    lat = svc.scheduler.latency_summary()
    if open_report is not None:
        print(f"open-loop[{open_report.process}]: offered "
              f"{open_report.offered_qps:,.0f} q/s -> achieved "
              f"{open_report.achieved_qps:,.0f} q/s, "
              f"{open_report.n_arrivals} arrivals / "
              f"{open_report.n_admitted} admitted / "
              f"{open_report.n_served} served over "
              f"{open_report.duration_s:.2f}s virtual")
    if args.slo:
        sch = svc.scheduler
        print(f"slo: hit rate {lat.slo_hit_rate:.1%} "
              f"({lat.slo_violations} violations), "
              f"{sch.n_slo_flushes} slo flushes, "
              f"{sch.n_shed_slo} shed past deadline")
        for cls in sorted(lat.shed_rate_by_class):
            print(f"  {cls}: shed rate "
                  f"{lat.shed_rate_by_class[cls]:.1%} "
                  f"({lat.shed_by_class.get(cls, 0)} shed)")
    if quotas is not None:
        qc = quotas.counters()
        adm, rej = sum(qc["admitted"].values()), sum(qc["rejected"].values())
        print(f"tenants[{args.tenants}]: {adm} admitted / {rej} "
              f"quota-shed ({svc.scheduler.n_shed_quota} at the door)")
        if svc.runtime.caches is not None:
            tb = {}
            for c in svc.runtime.caches:
                for t, b in c.tenant_bytes().items():
                    tb[t] = tb.get(t, 0) + b
            total = sum(c.used_bytes for c in svc.runtime.caches)
            shares = " ".join(
                f"{t or '_'}={b}B" for t, b in sorted(tb.items())
            )
            print(f"  cache shares: {shares} (sum {sum(tb.values())} "
                  f"== used {total})")
            assert sum(tb.values()) == total, \
                "per-tenant cache accounting does not sum to used bytes"
    if scorer is not None:
        print(f"ewma scores: blend {args.ewma_blend} decay "
              f"{args.ewma_decay}, {len(scorer._freq)} vertices tracked")
    rt = svc.runtime
    st = rt.aggregate_stats() if cross_rank else svc.provider.stats
    print(f"served {served} queries in {wall:.2f}s wall "
          f"({served / max(wall, 1e-9):,.0f} q/s end-to-end; "
          f"{lat.throughput_qps:,.0f} q/s in-engine), "
          f"{n_updates} interleaved updates, T={svc.triangle_count}")
    print(f"latency: p50 {lat.p50_ms:.2f} ms  p90 {lat.p90_ms:.2f} ms  "
          f"p99 {lat.p99_ms:.2f} ms  max {lat.max_ms:.2f} ms  "
          f"(window={args.batch_window})"
          + (f"  deadline flushes {svc.scheduler.n_deadline_flushes}, "
             f"priority {svc.scheduler.n_priority_flushes}"
             if args.max_wait_ms is not None else ""))
    scope = f"runtime[p={p}]" if cross_rank else "provider"
    print(f"{scope}: {st.local_reads} local / {st.remote_reads} remote "
          f"reads, hit rate {st.hit_rate:.1%}, "
          f"{st.invalidations} invalidations, "
          f"{st.bytes_fetched} B fetched, "
          f"modeled remote time {st.modeled_comm_s * 1e3:.2f} ms")
    if cross_rank:
        for k, sk in enumerate(rt.stats):
            print(f"  rank {k}: {sk.local_reads} local / "
                  f"{sk.remote_reads} remote, hit rate {sk.hit_rate:.1%}, "
                  f"{sk.cache_misses} misses, {sk.invalidations} inval, "
                  f"{sk.bytes_fetched} B")
        print(f"cross-rank transport: {rt.cross_rank_rows_served()} rows "
              f"shipped owner->requester, invalidation fanout saved "
              f"{rt.invalidation_fanout_saved} msgs vs broadcast")
    if rebalancer is not None:
        print(f"rebalance: {rebalancer.migrations} migrations moved "
              f"{rebalancer.rows_moved} rows "
              f"(trigger {args.rebalance_trigger}x, "
              f"<= {args.max_moves} rows/boundary); runtime saw "
              f"{rt.rows_migrated} ownership changes")
    if args.spmd:
        led = svc.engine.spmd.ledger
        modeled_rows = rt.cross_rank_rows_served()
        modeled_bytes = sum(s.bytes_fetched for s in rt.stats)
        agree = (led.total_rows == modeled_rows
                 and led.bytes_payload == modeled_bytes)
        print(f"spmd[{led.p} devices]: {led.n_collectives} all_to_all "
              f"collectives, {led.total_rows} rows / {led.bytes_payload} B "
              f"payload shipped (modeled {modeled_rows} rows / "
              f"{modeled_bytes} B — {'EXACT match' if agree else 'MISMATCH'}"
              f"), {led.bytes_on_wire} B on the padded wire, "
              f"{led.n_pairs} pairs intersected on-device in "
              f"{led.device_wall_s:.2f}s")
        print(f"  async plane: {led.bytes_uploaded} B uploaded in "
              f"{led.n_patches} resident-buffer patches, "
              f"{led.upload_bytes_saved} B re-upload saved; wire padding "
              f"saved {led.wire_padding_saved} B vs single-width "
              f"({led.bytes_on_wire_single} B)"
              + (f"; overlap wait {led.overlap_wait_s:.2f}s"
                 if args.pipeline else ""))
        assert agree, "measured collective traffic != modeled serve matrix"
    print(f"pair dedup: {svc.engine.n_pairs_raw} raw -> "
          f"{svc.engine.n_pairs_total} intersected")
    if args.max_queue is not None or args.shed_wait_ms is not None:
        sch = svc.scheduler
        print(f"admission: queue bound {args.max_queue}, shed "
              f"{sch.n_shed_depth} depth + {sch.n_shed_deadline} deadline "
              f"(shed rate {lat.shed_rate:.1%})")
    if args.device_tier:
        views = svc.runtime.device_views()
        ds = svc.runtime.merged_device_stats()
        resident = sum(v.resident_rows for v in views)
        slots = sum(v.slots for v in views)
        label = (f"{len(views)} per-rank hot sets"
                 if args.device_scope == "per_rank" else "replicated")
        print(f"device tier[{label}, {resident}/{slots} slots x "
              f"width {views[0].max_width}]: {svc.engine.n_pairs_resident} "
              f"resident pairs, hit rate {ds.hit_rate:.1%}, "
              f"{ds.bytes_saved} B host materialization saved "
              f"({svc.engine.host_pack_bytes} B still packed), "
              f"{ds.patches} patches / {ds.admits} admits / "
              f"{ds.evicts} evicts, {ds.upload_bytes} B uploaded")
    if args.verify:
        svc.verify()
        print(f"verified: {n_verified} point queries bit-exact vs recount, "
              "0 stale cached rows")
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
        reg = svc.metrics_registry(tracer=tracer)
        if cache_report is not None:
            from ..obs.metrics import record_cachescope

            record_cachescope(reg, cache_report)
        snap = reg.to_dict()
        reg.save(args.metrics)
        print(f"metrics: {len(snap['counters'])} counters, "
              f"{len(snap['gauges'])} gauges, "
              f"{len(snap['histograms'])} histograms -> {args.metrics}  "
              f"[load imbalance "
              f"{reg.get_gauge('load_imbalance', tier='host'):.2f}x, "
              f"serve-matrix skew "
              f"{reg.get_gauge('serve_matrix_skew', tier='wire'):.2f}x]")
    if tracer is not None:
        from ..obs import trace as obs_trace

        obs_trace.disable_tracing()
        tracer.export(args.trace)
        print(f"trace: {len(tracer)} events -> {args.trace} "
              "(open at ui.perfetto.dev)")
    if result is not None:
        result.update(svc=svc, served=served, wall_s=wall, latency=lat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
