"""Where one epoch of the engine spends its device time.

    python -m repro_torch.launch.epoch_profile --scale 16 --edge-factor 16 \\
        --p 8 --cache-rows 256 --n-rounds 32 --method hybrid [--plain]

Builds the R-MAT problem, warms the engine up, then traces one epoch with
``torch.profiler`` and prints one JSON line: the card, the epoch's wall
time, the summed device time of every kernel, the kernels by device time,
and the epoch's peak device memory beyond the problem's own tensors (from
the untraced warm-up). The device's idle share is the benchmark's
``device_idle_share`` (``gpubench/``): the union of the device's activity
over a window of epochs, not a sum over one. ``--plain`` profiles the
padded plain route instead of the kernels. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--n-rounds", type=int, default=32)
    ap.add_argument("--method", default="hybrid",
                    choices=["bsearch", "pairwise", "hybrid"])
    ap.add_argument("--plain", action="store_true",
                    help="the padded plain route, not the kernels; at full "
                         "size only with --method bsearch (its pairwise "
                         "count compares all W x W slots of a pair)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.async_engine import lcc_pipelined
    from ..core.cache import build_static_degree_cache
    from ..core.rma import build_sharded_problem
    from ..device import resolve_device
    from ..graphs.rmat import rmat_graph

    dev = resolve_device("cuda")
    csr = rmat_graph(args.scale, args.edge_factor, seed=0)
    cache = (build_static_degree_cache(csr.degrees, args.cache_rows)
             if args.cache_rows else None)
    prob = build_sharded_problem(csr, args.p, n_rounds=args.n_rounds,
                                 cache=cache).to_device(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # warm-up (and build)
    lcc_pipelined(prob, dev, method=args.method, plain=args.plain)
    extra_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lcc_pipelined(prob, dev, method=args.method, plain=args.plain)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    on_device = torch.autograd.DeviceType.CUDA
    for ev in prof.key_averages():
        # kernel rows only: the operator rows repeat their kernels' time
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us > 0 and ev.device_type == on_device:
            rows.append({"name": ev.key[:80], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "scale": args.scale, "edge_factor": args.edge_factor,
        "p": args.p, "cache_rows": args.cache_rows,
        "n_rounds": prob.n_rounds, "method": args.method,
        "route": "plain" if args.plain else "kernels",
        "directed_edges": csr.m, "width": csr.max_degree,
        "epoch_wall_ms_traced": wall_ms, "device_busy_ms": busy_ms,
        "epoch_extra_peak_bytes": extra_peak,
        "kernels": rows[: args.top],
    }))
    if not rows:
        print("no device time in the trace: time with CUDA events instead")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
