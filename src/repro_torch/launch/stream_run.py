"""Streaming-workload launcher: incremental triangle counting + LCC over
a replayed R-MAT edge stream with batched insert/delete updates.

    python -m repro_torch.launch.stream_run --scale 10 --batches 8
    python -m repro_torch.launch.stream_run --scale 12 --batches 32 \
        --delete-frac 0.2 --cache-rows 512 --ranks 8 --checkpoint-every 4 \
        --maintain-schedule --device-tier

Runs on ``--device`` (default ``cuda``; a missing card raises — pass
``--device cpu`` to run the plain torch versions of the kernels). Each
batch flows through ``StreamingLCCEngine`` over the shared
``ShardedRuntime``: the delta worklist is partitioned by owner rank and
each shard's row pairs are intersected on the device — the
``intersect_count`` kernel (B1), and with ``--device-tier`` the
``resident_intersect`` kernel (B3) for pairs with a resident row — per-vertex triangle tallies and LCC are patched
in place, the ``DynamicCSR`` absorbs the updates (compacting when the
delta buffer outgrows its threshold), and the coherence layer replays the
delta access stream through the runtime's per-rank CLaMPI caches +
static degree cache, fanning invalidations only to the ranks that cached
the touched rows. At every checkpoint the engine state is verified
**bit-exactly** against a from-scratch ``triangles_per_vertex`` /
``lcc_scores`` recount of the compacted graph.

With ``--maintain-schedule`` the runtime also carries the epoch engine's
compiled pull schedule and keeps it fresh per batch via the incremental
``ShardedLCCProblem.apply_delta`` (falling back to a from-scratch build
on padded-width overflow); every checkpoint additionally verifies the
maintained schedule bit-exact against ``build_sharded_problem`` on the
current snapshot.

Reports per batch: effective ops, updates/sec, triangle count; at the
end: total throughput, per-rank worklist balance, cache hit rate on the
delta stream, invalidation fanout savings, static-cache rebuilds,
schedule maintenance counts, and compactions.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags; ``ranks`` is resolved from ``--ranks``/``--p``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--batches", type=int, default=8,
                    help="number of update batches the stream is split into")
    ap.add_argument("--delete-frac", type=float, default=0.15,
                    help="fraction of each batch that deletes prior edges")
    ap.add_argument("--p", type=int, default=4,
                    help="runtime ranks (1D partition for sharded worklists "
                         "and the coherence replay)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="alias for --p (overrides it when given)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; there is no automatic CPU switch")
    ap.add_argument("--spmd", action="store_true",
                    help="execute the per-rank delta shards as one SPMD "
                         "execution unit a batch phase on --device: remote "
                         "rows ship owner->rank through the serve block "
                         "(B5) and the old-intersect-old counts run in the "
                         "pair-count program (B6), cross-checked against "
                         "the host membership masks")
    ap.add_argument("--pipeline", action="store_true",
                    help="with --spmd: double-buffer the two batch phases "
                         "— the insert phase's host pack + launch overlaps "
                         "the delete phase's in-flight device counts "
                         "(bit-identical results)")
    ap.add_argument("--device-scope", choices=("replicated", "per_rank"),
                    default="replicated",
                    help="with --device-tier: one hot set replicated on "
                         "every device, or a distinct per-rank hot set "
                         "of each rank's own remote-heavy rows")
    ap.add_argument("--adversarial", action="store_true",
                    help="hub-targeted deletes (stresses degree-score drift)")
    ap.add_argument("--partition", choices=("1d", "hub"), default="1d",
                    help="vertex ownership: '1d' equal blocks or 'hub' "
                         "balance-aware cuts + hub splitting. The stream "
                         "starts empty, so hub cuts degenerate to 1D at "
                         "batch 0 — pair with --rebalance to chase the "
                         "emerging heavy tail (docs/partitioning.md)")
    ap.add_argument("--hub-threshold", type=int, default=None,
                    help="with --partition hub: degree at/above which a "
                         "row is fragmented (default: recomputed from the "
                         "live degrees at each rebalance)")
    ap.add_argument("--rebalance", action="store_true",
                    help="with --partition hub: between batches, when the "
                         "windowed read imbalance crosses "
                         "--rebalance-trigger, refresh the hub set and "
                         "migrate bounded row ranges toward the degree-"
                         "balanced cuts (invalidation fanout + residency "
                         "handoff + schedule rebuild; checkpoints stay "
                         "bit-exact)")
    ap.add_argument("--rebalance-trigger", type=float, default=1.25,
                    help="windowed max/mean read imbalance that arms a "
                         "migration")
    ap.add_argument("--max-moves", type=int, default=4096,
                    help="rows each cut boundary may move per migration")
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--clampi-kib", type=int, default=1024)
    ap.add_argument("--maintain-schedule", action="store_true",
                    help="keep a compiled pull schedule fresh incrementally "
                         "(verified vs a from-scratch build per checkpoint); "
                         "carries the coherence layer's static residency, "
                         "refreshed in place when it drifts")
    ap.add_argument("--device-tier", action="store_true",
                    help="device-resident hot-row tier: oo delta "
                         "intersections run against persistently resident "
                         "hub rows (resident_intersect gather kernel, B3)")
    ap.add_argument("--device-slots", type=int, default=256,
                    help="hot-set capacity (rows) of the device tier")
    ap.add_argument("--device-width", type=int, default=None,
                    help="padded row width of the device buffer")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="verify vs from-scratch recount every k batches "
                         "(<= 0: only the final verification)")
    ap.add_argument("--compact-threshold", type=float, default=0.25)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--no-kernel", action="store_true",
                    help="skip the kernels (pure-numpy masks only)")
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
                         "audit, offline policy replay incl. Belady; "
                         "validated by repro_torch.obs.validate "
                         "--cachescope)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.trace_fine and not args.trace:
        ap.error("--trace-fine needs --trace")
    if args.pipeline and not args.spmd:
        ap.error("--pipeline double-buffers SPMD phases; pass --spmd")
    if args.device_scope != "replicated" and not args.device_tier:
        ap.error("--device-scope shapes the device tier; pass --device-tier")
    if args.hub_threshold is not None and args.partition != "hub":
        ap.error("--hub-threshold shapes the hub partition; pass "
                 "--partition hub")
    if args.rebalance and args.partition != "hub":
        ap.error("--rebalance migrates hub-partition cuts; pass "
                 "--partition hub")
    args.ranks = args.ranks if args.ranks is not None else args.p
    return args


def build_engine(args: argparse.Namespace, device):
    """The coherence layer, engine and rebalancer (``None`` without
    ``--rebalance``) the launcher wires from its flags, on ``device``."""
    from ..core.rma import build_sharded_problem
    from ..streaming import StreamingCacheCoherence, StreamingLCCEngine

    n = 1 << args.scale
    ranks = args.ranks
    partition = None
    if args.partition == "hub":
        from ..core.partition import partition_hub

        # built against the empty store: no hubs yet, equal cuts — the
        # rebalancer refreshes both as the heavy tail emerges.
        partition = partition_hub(
            np.zeros(n, np.int64), ranks, threshold=args.hub_threshold
        )
        print(f"hub partition: starting empty (threshold "
              f"{partition.threshold}), "
              + ("rebalancer will chase the live degrees"
                 if args.rebalance else "static cuts (no --rebalance)"))
    coh = StreamingCacheCoherence(
        n,
        np.zeros(n, np.int64),
        p=ranks,
        cache_rows=args.cache_rows,
        clampi_bytes=args.clampi_kib << 10,
        partition=partition,
        device=device,
    )
    eng = StreamingLCCEngine.empty(
        n,
        use_kernel=not args.no_kernel,
        compact_threshold=args.compact_threshold,
        coherence=coh,
        execution="spmd" if args.spmd else "loop",
        pipeline=args.pipeline,
        device=device,
    )
    runtime = eng.runtime
    if args.device_tier:
        # the stream starts from an empty graph, so the width cannot be
        # inferred from current degrees; 256 covers R-MAT hubs at the
        # launcher's scales (wider rows simply stay host-side).
        runtime.enable_device_tier(
            args.device_slots,
            args.device_width if args.device_width is not None else 256,
            scope=args.device_scope,
        )
    if args.maintain_schedule:
        # compile the schedule WITH the coherence layer's static
        # residency: when churn drifts the top-C, maintain_schedule
        # refreshes cache_ids in place instead of rebuilding.
        runtime.attach_problem(
            build_sharded_problem(
                eng.store.to_csr(), ranks, width=64, cache=coh.static,
                part=runtime.part,
            )
        )
    rebalancer = None
    if args.rebalance:
        from ..core.repartition import Rebalancer

        # load signal: the sharded delta worklist (what shard_imbalance
        # summarizes) — the coherence replay bypasses fetch_rows, so the
        # runtime's provider read stats would never move here.
        rebalancer = Rebalancer(
            runtime,
            trigger=args.rebalance_trigger,
            max_moves=args.max_moves,
            hub_threshold=args.hub_threshold,
            reads=lambda: eng.shard_pairs,
        )
    return coh, eng, rebalancer


def batches(args: argparse.Namespace):
    """The launcher's update stream: ``--batches`` batches of R-MAT
    inserts plus ``--delete-frac`` deletes (hub-targeted with
    ``--adversarial``)."""
    from ..graphs.rmat import rmat_adversarial_stream, rmat_stream

    batch_size = -(-(args.edge_factor << args.scale) // args.batches)
    gen = rmat_adversarial_stream if args.adversarial else rmat_stream
    return gen(args.scale, args.edge_factor, batch_size=batch_size,
               delete_frac=args.delete_frac, seed=args.seed)


def main(argv=None, result: Optional[dict] = None):
    """Run the stream; returns the exit code. ``result``, when given, is
    filled with the engine (``"engine"``), the summed batch wall time
    (``"wall_s"``) and every ``BatchResult`` (``"batches"``) for callers
    that drive the launcher programmatically."""
    args = parse_args(argv)
    tracer = None
    if args.trace:
        from ..obs import trace as obs_trace

        tracer = obs_trace.enable_tracing(fine=args.trace_fine)
    recorder = None
    if args.cache_trace:
        from ..obs import cachescope as obs_cachescope

        recorder = obs_cachescope.enable_recording()
    ranks = args.ranks
    from ..device import resolve_device

    device = resolve_device(args.device)

    from ..core.rma import assert_problems_equal, build_sharded_problem

    n = 1 << args.scale
    total_ops = args.edge_factor << args.scale
    batch_size = -(-total_ops // args.batches)
    print(f"R-MAT S{args.scale} EF{args.edge_factor} stream: n={n}, "
          f"{total_ops} inserts (+{args.delete_frac:.0%} deletes"
          f"{', hub-targeted' if args.adversarial else ''}) in "
          f"{args.batches} batches of {batch_size}, ranks={ranks}, "
          f"device={device}"
          + ("  [SPMD device mesh]" if args.spmd else ""))
    coh, eng, rebalancer = build_engine(args, device)
    runtime = eng.runtime

    def check_schedule():
        from ..core.cache import StaticDegreeCache

        snap = eng.store.to_csr()
        prob = runtime.problem
        cache = (
            StaticDegreeCache(vertex_ids=prob.cache_ids.copy())
            if prob.cache_ids.size
            else None
        )
        fresh = build_sharded_problem(
            snap,
            ranks,
            n_rounds=prob.n_rounds_requested,
            cache=cache,
            width=prob.width,
            dedup_rounds=prob.dedup_rounds,
            part=runtime.part,
        )
        assert_problems_equal(prob, fresh)

    wall = 0.0
    verified_last = False
    batch_results = []
    for i, batch in enumerate(batches(args)):
        t0 = time.perf_counter()
        res = eng.apply_batch(batch)
        batch_results.append(res)
        plan = (rebalancer.maybe_rebalance(eng.store.degrees)
                if rebalancer is not None else None)
        dt = time.perf_counter() - t0
        wall += dt
        verified_last = False
        ops = res.n_inserted + res.n_deleted
        line = (f"batch {i:3d}: +{res.n_inserted} -{res.n_deleted} "
                f"(noop {res.n_noop})  T={eng.triangle_count}  "
                f"{ops / max(dt, 1e-9):,.0f} upd/s"
                + ("  [compacted]" if res.compacted else "")
                + ("  [schedule rebuilt]"
                   if res.schedule_incremental is False else "")
                + (f"  [migrated {plan.n_moved} rows]"
                   if plan is not None else ""))
        if (not args.no_verify and args.checkpoint_every > 0
                and (i + 1) % args.checkpoint_every == 0):
            eng.verify()
            if args.maintain_schedule:
                check_schedule()
            verified_last = True
            line += "  checkpoint: exact vs recount"
            if args.maintain_schedule:
                line += " + schedule"
        print(line, flush=True)

    rep = coh.report
    shares = eng.shard_pairs / max(int(eng.shard_pairs.sum()), 1)
    print(f"\n{eng.n_updates} effective updates in {wall:.2f}s "
          f"({eng.n_updates / max(wall, 1e-9):,.0f} upd/s), "
          f"{eng.delta_pairs_total} delta row pairs, "
          f"{eng.store.n_compactions} compactions")
    print(f"shards[p={ranks}]: worklist shares "
          f"[{', '.join(f'{s:.0%}' for s in shares)}]")
    if rebalancer is not None:
        part = runtime.part
        sizes = part.sizes()
        print(f"rebalance: {rebalancer.migrations} migrations moved "
              f"{rebalancer.rows_moved} rows; final cuts "
              f"{int(sizes.min())}..{int(sizes.max())} rows/rank, "
              f"{part.hubs.size} hubs (degree >= {part.threshold})")
    print(f"coherence[p={ranks}]: delta-stream hit rate {rep.hit_rate:.1%} "
          f"(static {rep.static_hits}, clampi {rep.clampi_hits} hits / "
          f"{rep.remote_reads} remote reads), "
          f"{rep.invalidations} invalidations "
          f"(fanout saved {runtime.invalidation_fanout_saved} msgs vs "
          f"broadcast), "
          f"{rep.static_rebuilds} static rebuilds, "
          f"{coh.clampi.stats.evictions} evictions, "
          f"modeled comm {coh.total_comm_time * 1e3:.2f} ms")
    if args.maintain_schedule:
        print(f"schedule: {runtime.schedule_deltas} incremental deltas, "
              f"{runtime.schedule_rebuilds} width-overflow rebuilds, "
              f"{runtime.schedule_residency_refreshes} in-place residency "
              f"refreshes (width {runtime.problem.width}, e_max "
              f"{runtime.problem.e_max}, s_max {runtime.problem.s_max})")
    if args.device_tier:
        views = runtime.device_views()
        ds = runtime.merged_device_stats()
        resident = sum(v.resident_rows for v in views)
        slots = sum(v.slots for v in views)
        label = (f"{len(views)} per-rank hot sets"
                 if args.device_scope == "per_rank" else "replicated")
        print(f"device tier[{label}, {resident}/{slots} slots x "
              f"width {views[0].max_width}]: {eng.oo_resident_pairs} oo pairs "
              f"on-device, hit rate {ds.hit_rate:.1%}, "
              f"{ds.bytes_saved} B host materialization saved "
              f"({eng.oo_host_bytes} B still built), "
              f"{ds.patches} patches / {ds.admits} admits / "
              f"{ds.evicts} evicts, {ds.upload_bytes} B uploaded")
    if args.spmd:
        led = eng.spmd.ledger
        print(f"spmd[{led.p} devices]: {led.n_collectives} all_to_all "
              f"collectives, {led.total_rows} remote rows / "
              f"{led.bytes_payload} B payload shipped owner->rank, "
              f"{led.bytes_on_wire} B on the padded wire, "
              f"{led.n_pairs} oo pairs intersected on-device in "
              f"{led.device_wall_s:.2f}s (counts cross-checked vs host "
              f"masks every batch)")
        print(f"  async plane: {led.bytes_uploaded} B uploaded in "
              f"{led.n_patches} resident-buffer patches, "
              f"{led.upload_bytes_saved} B re-upload saved; wire padding "
              f"saved {led.wire_padding_saved} B vs single-width "
              f"({led.bytes_on_wire_single} B)"
              + (f"; overlap wait {led.overlap_wait_s:.2f}s"
                 if args.pipeline else ""))
    if not args.no_verify:
        if not verified_last:  # last batch's checkpoint already recounted
            eng.verify()
            if args.maintain_schedule:
                check_schedule()
        print("final state verified bit-exact vs from-scratch recount"
              + (" (incl. maintained schedule)"
                 if args.maintain_schedule else ""))
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
            record_cachescope,
            record_collective_ledger,
            record_coherence_report,
            record_runtime,
        )

        reg = MetricRegistry()
        record_runtime(reg, runtime)
        record_coherence_report(reg, rep)
        if cache_report is not None:
            record_cachescope(reg, cache_report)
        # streaming's load dimension is the sharded delta worklist
        for k in range(ranks):
            reg.counter("shard_pairs", int(eng.shard_pairs[k]), rank=k,
                        tier="host", phase="intersect_kernel")
        reg.gauge("shard_imbalance", imbalance(eng.shard_pairs),
                  tier="host")
        if args.spmd:
            # measured wire traffic only — no reconciliation claim: the
            # loop-path counterpart of these reads goes straight to the
            # store, so the serve matrix models none of this traffic
            record_collective_ledger(reg, eng.spmd.ledger)
        if tracer is not None:
            fold_trace(reg, tracer)
        snap = reg.to_dict()
        reg.save(args.metrics)
        print(f"metrics: {len(snap['counters'])} counters, "
              f"{len(snap['gauges'])} gauges -> {args.metrics}  "
              f"[shard imbalance "
              f"{reg.get_gauge('shard_imbalance', tier='host'):.2f}x]")
    if tracer is not None:
        from ..obs import trace as obs_trace

        obs_trace.disable_tracing()
        tracer.export(args.trace)
        print(f"trace: {len(tracer)} events -> {args.trace} "
              "(open at ui.perfetto.dev)")
    if result is not None:
        result.update(engine=eng, wall_s=wall, batches=batch_results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
