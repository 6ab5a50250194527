#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and nothing else; it imports ``torch`` and
``numpy`` and the port, never ``jax`` and never the reference package. It
builds every hand-written kernel from the sources in this checkout, holds
each against its plain torch version on the card (integers: bit for bit,
tolerance 0), drives the port's main path — the paper's LCC pipeline —
through its public entry points, and fails (non-zero exit) if any phase
fails. Each phase prints one JSON object on a line of its own:

  env      versions, device name, ``nvidia-smi`` name and power limit
  build    seconds to build each library, ``-Xptxas -v`` registers / smem
  checks   kernel vs plain version at the listed shapes
  entry    ``repro_torch.launch.lcc_run.main`` at R-MAT scale 12, --verify
  full     the epoch engine at R-MAT scale 16 / edge factor 16, p = 8:
           kernel route (``pairwise``) vs plain route (``bsearch``), and
           the host oracle at scale 14
  pairs    100,000 sampled edges through ``batched_pair_counts``
  timing   the kernel at the full-size engine's per-round shapes (CUDA
           events), beside its plain version and ``count_bsearch_torch``

then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``. The launch counts in the summary are read
from the wrappers' counters, set to 0 just before ``entry`` and read just
after ``pairs``; launches made by ``checks`` and ``timing`` are not in them.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

FULL_SCALE = 16
ORACLE_SCALE = 14
EDGE_FACTOR = 16
RANKS = 8
CACHE_ROWS = 256
FULL_ROUNDS = 32
N_PAIRS = 100_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# fp32 CUDA-core peak of the data sheet; taken as the rate of the int32
# compares too (an upper bound of it, so the bound stays a lower bound)
OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def pad_sorted(rng, e, w, sentinel, np):
    out = np.full((e, w), sentinel, np.int32)
    for i in range(e):
        k = int(rng.integers(0, w + 1))
        vals = np.unique(rng.integers(0, sentinel, size=k))
        out[i, : len(vals)] = vals
    return out


def global_rows(prob, ids, np):
    """(owner rank, local row index) of global vertex ids in the compiled
    problem's ``rows_ext`` slabs; id ``n`` maps to the phantom row."""
    ids = np.asarray(ids, np.int64)
    part = prob.part
    real = ids < prob.n
    safe = np.where(real, ids, 0)
    own = part.owner(safe).astype(np.int64)
    lo = np.array([part.lo(k) for k in range(prob.p)], np.int64)
    loc = np.where(real, safe - lo[own], prob.n_loc)
    return own, loc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import async_engine, triangles
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.intersect import count_bsearch_torch
    from repro_torch.core.rma import build_sharded_problem
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import _build, intersect_count as ic, ops
    from repro_torch.kernels.point_query import batched_pair_counts
    from repro_torch.launch import lcc_run

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- env
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "nvidia_smi": smi})

    # -------------------------------------------------------------- build
    info = _build.build_info("intersect_count")
    regs = re.findall(r"Used (\d+) registers", info.ptxas)
    smem = re.findall(r"(\d+) bytes smem", info.ptxas)
    spills = re.findall(r"(\d+) bytes spill stores", info.ptxas)
    emit({"phase": "build", "library": os.path.relpath(info.library, root),
          "seconds": info.seconds,
          "registers": [int(x) for x in regs],
          "smem_bytes": [int(x) for x in smem] or [0],  # 0 is not printed
          "spill_store_bytes": [int(x) for x in spills]})
    if not regs:
        raise RuntimeError(f"no ptxas report in build output:\n{info.ptxas}")

    # ---------------------------------------------- the full-size problem
    t0 = time.perf_counter()
    csr = rmat_graph(FULL_SCALE, EDGE_FACTOR, seed=0)
    cache = build_static_degree_cache(csr.degrees, CACHE_ROWS)
    prob = build_sharded_problem(csr, RANKS, n_rounds=FULL_ROUNDS, cache=cache)
    schedule_s = time.perf_counter() - t0
    sent, w = prob.sentinel, prob.width
    dprob = prob.to_device(dev)

    def operands(u_glob, v_glob):
        """Device rows of the (u, v) pairs at the engine's width W."""
        ou, lu = global_rows(prob, u_glob, np)
        ov, lv = global_rows(prob, v_glob, np)
        flat = dprob.rows_ext.view(-1, w)
        stride = prob.n_loc + 1
        ia = torch.from_numpy(ou * stride + lu).to(dev)
        ib = torch.from_numpy(ov * stride + lv).to(dev)
        return flat.index_select(0, ia), flat.index_select(0, ib)

    # ------------------------------------------------------------- checks
    rng = np.random.default_rng(0)
    max_abs_err = 0
    checked = []

    def check(tag, a, b, sentinel):
        nonlocal max_abs_err
        got = ops.intersect_count(a, b, sentinel=sentinel)
        torch.cuda.synchronize()
        want = ic.intersect_count_ref(a, b, sentinel=sentinel)
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"{tag}: bad output {got.dtype} {got.shape}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_abs_err = max(max_abs_err, err)
        checked.append({"case": tag, "shape": [a.shape[0], a.shape[1],
                                               b.shape[1]], "err": err})
        if err != 0:
            raise RuntimeError(f"{tag}: kernel != plain version (err {err})")

    ic.reset_launches()
    small_sent = 4096
    for e, wa, wb in [(128, 16, 32), (256, 64, 128), (128, 8, 200),
                      (1, 16, 32), (3, 16, 32), (1000, 16, 32),
                      (64, 16, 0), (64, 16, 1), (64, 0, 16)]:
        a = torch.from_numpy(pad_sorted(rng, e, wa, small_sent, np)).to(dev)
        b = torch.from_numpy(pad_sorted(rng, e, wb, small_sent, np)).to(dev)
        check("random", a, b, small_sent)
    full_a = torch.full((96, 40), small_sent, dtype=torch.int32, device=dev)
    some_b = torch.from_numpy(pad_sorted(rng, 96, 24, small_sent, np)).to(dev)
    check("all_sentinel_a", full_a, some_b, small_sent)
    check("all_sentinel_b", some_b, full_a, small_sent)
    check("all_sentinel_both", full_a, full_a, small_sent)
    check("self", some_b, some_b, small_sent)
    # wide: 512 directed edges of the full-size graph whose endpoints have
    # the highest degree sums, at the engine's width
    src, dst = csr.edge_list()
    deg = csr.degrees
    heavy = np.argsort(-(deg[src] + deg[dst]), kind="stable")[:512]
    wa_rows, wb_rows = operands(src[heavy], dst[heavy])
    check("wide_full_graph", wa_rows, wb_rows, sent)
    del wa_rows, wb_rows, full_a, some_b
    check_launches = ic.launches()
    emit({"phase": "checks", "kernels": [{
        "name": "intersect_count",
        "source": "src/repro_torch/kernels/csrc/intersect_count.cu",
        "ok": True, "cases": checked, "launches": check_launches,
        "max_abs_err": max_abs_err, "tolerance": 0}]})

    # ------------------------------------------ main path: counters to 0
    ic.reset_launches()

    # -------------------------------------------------------------- entry
    t0 = time.perf_counter()
    rc = lcc_run.main(["--scale", "12", "--p", "8", "--cache-rows", "256",
                       "--verify"])
    if rc != 0:
        raise RuntimeError(f"lcc_run.main returned {rc}")
    entry_launches = ic.launches()
    emit({"phase": "entry", "argv": "--scale 12 --p 8 --cache-rows 256 "
          "--verify", "rc": rc, "seconds": time.perf_counter() - t0,
          "kernel_launches": entry_launches})

    # --------------------------------------------------------------- full
    torch.cuda.reset_peak_memory_stats()
    epoch = {}
    result = {}
    launches_per_epoch = None
    for method in ("pairwise", "bsearch"):
        before = ic.launches()
        result[method] = async_engine.lcc_pipelined(dprob, dev, method=method)
        if method == "pairwise":
            launches_per_epoch = ic.launches() - before
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            async_engine.lcc_pipelined(dprob, dev, method=method)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        epoch[method] = {"median_s": statistics.median(walls), "runs_s": walls}
    peak_bytes = torch.cuda.max_memory_allocated()
    t_k, lcc_k = result["pairwise"]
    t_p, lcc_p = result["bsearch"]
    if t_k.dtype != np.int32 or lcc_k.dtype != np.float32:
        raise RuntimeError(f"engine dtypes {t_k.dtype} {lcc_k.dtype}")
    if not np.array_equal(t_k, t_p) or not np.array_equal(lcc_k, lcc_p):
        raise RuntimeError("full: kernel route != plain route")
    if not np.isfinite(lcc_k).all() or lcc_k.min() < 0 or lcc_k.max() > 1:
        raise RuntimeError("full: lcc outside [0, 1]")
    total = int(t_k.astype(np.int64).sum())
    if total % 3 != 0:
        raise RuntimeError(f"full: sum(t) = {total} is not a multiple of 3")

    # host oracle at the smaller scale, against the kernel route
    csr_o = rmat_graph(ORACLE_SCALE, EDGE_FACTOR, seed=0)
    t0 = time.perf_counter()
    t_o, lcc_o = async_engine.run_distributed_lcc(
        csr_o, RANKS, n_rounds=8, cache_rows=CACHE_ROWS, method="pairwise",
        device=dev)
    oracle_engine_s = time.perf_counter() - t0
    want_t = triangles.triangles_per_vertex(csr_o)
    if not np.array_equal(t_o, want_t):
        raise RuntimeError("oracle: engine t != triangles_per_vertex")
    if not np.allclose(lcc_o, triangles.lcc_scores(csr_o, want_t), rtol=1e-5):
        raise RuntimeError("oracle: engine lcc != lcc_scores (rtol 1e-5)")
    full_launches = ic.launches() - entry_launches
    emit({"phase": "full", "scale": FULL_SCALE, "edge_factor": EDGE_FACTOR,
          "n": csr.n, "directed_edges": csr.m, "width": w, "p": RANKS,
          "cache_rows": CACHE_ROWS, "n_rounds": prob.n_rounds,
          "e_chunk": prob.e_max // prob.n_rounds, "s_max": prob.s_max,
          "rows_ext_bytes": int(prob.rows_ext.nbytes),
          "schedule_build_s": schedule_s,
          "triangles": total // 3, "kernel_route_equals_plain_route": True,
          "epoch_wall_s": epoch,
          "directed_edges_per_s": {m: csr.m / epoch[m]["median_s"]
                                   for m in epoch},
          "kernel_launches_per_epoch": launches_per_epoch,
          "kernel_launches": full_launches,
          "comm_bytes": int(prob.comm_bytes_per_round().sum()),
          "max_memory_allocated": peak_bytes,
          "oracle": {"scale": ORACLE_SCALE, "n": csr_o.n,
                     "directed_edges": csr_o.m, "width": csr_o.max_degree,
                     "exact": True, "engine_s": oracle_engine_s}})

    # -------------------------------------------------------------- pairs
    before = ic.launches()
    pick = np.sort(np.random.default_rng(1).choice(csr.m, N_PAIRS,
                                                   replace=False))
    pu, pv = src[pick], dst[pick]
    ra = [csr.row(int(u)) for u in pu]
    rb = [csr.row(int(v)) for v in pv]
    t0 = time.perf_counter()
    got_kernel = batched_pair_counts(ra, rb, sentinel=sent, use_kernel=True,
                                     device=dev)
    pairs_kernel_s = time.perf_counter() - t0
    pairs_launches = ic.launches() - before
    main_path_launches = ic.launches()  # entry + full + pairs, read here
    got_host = batched_pair_counts(ra, rb, sentinel=sent, use_kernel=False)
    # the engine's per-edge count: the same kernel on the engine's operands
    # (rows at width W, read from the compiled problem)
    eng = []
    step = max(1, (1 << 30) // (4 * w))
    for lo in range(0, N_PAIRS, step):
        a, b = operands(pu[lo:lo + step], pv[lo:lo + step])
        eng.append(ops.intersect_count(a, b, sentinel=sent).cpu().numpy())
    eng = np.concatenate(eng).astype(np.int64)
    if got_kernel.dtype != np.int64 or got_host.dtype != np.int64:
        raise RuntimeError("pairs: counts must be int64")
    if not (np.array_equal(got_kernel, got_host)
            and np.array_equal(got_kernel, eng)):
        raise RuntimeError("pairs: kernel, host masks and engine disagree")
    emit({"phase": "pairs", "n_pairs": N_PAIRS, "equal": True,
          "sum_counts": int(got_kernel.sum()),
          "use_kernel_seconds": pairs_kernel_s,
          "kernel_launches": pairs_launches})
    for tag, n in (("entry", entry_launches), ("full", full_launches),
                   ("pairs", pairs_launches)):
        if n <= 0:
            raise RuntimeError(f"{tag}: the kernel was never launched")

    # ------------------------------------------------------------- timing
    # round 0 of the full-size schedule, all ranks, in the engine's slabs
    e_chunk = prob.e_max // prob.n_rounds
    lo_of = np.array([prob.part.lo(k) for k in range(RANKS)], np.int64)
    u_glob = np.full((RANKS, e_chunk), prob.n, np.int64)
    v_glob = np.full((RANKS, e_chunk), prob.n, np.int64)
    for k in range(RANKS):
        u_l, v_g = prob.works[k]
        m = min(e_chunk, u_l.size)
        u_glob[k, :m] = u_l[:m].astype(np.int64) + lo_of[k]
        v_glob[k, :m] = v_g[:m]
    u_glob, v_glob = u_glob.ravel(), v_glob.ravel()
    slab = max(1, async_engine._PAIR_SLAB_BYTES // (4 * w))
    rows_a, rows_b = operands(u_glob[:slab], v_glob[:slab])
    e_t = rows_a.shape[0]
    na = (rows_a < sent).sum(1).to(torch.float64)
    nb = (rows_b < sent).sum(1).to(torch.float64)
    prefix_bytes = float((na.sum() + nb.sum()) * 4 + e_t * 4)
    ns, nl = torch.minimum(na, nb), torch.maximum(na, nb)
    compares = float((ns * torch.ceil(torch.log2(nl + 1))).sum()
                     + 2 * e_t * math.ceil(math.log2(w + 1)))
    bytes_ms = prefix_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = compares / OPS_PER_S * 1e3
    kernel_ms = cuda_ms(
        lambda: ops.intersect_count(rows_a, rows_b, sentinel=sent), reps=20,
        warmup=3)
    bsearch_ms = cuda_ms(
        lambda: count_bsearch_torch(rows_a, rows_b, sent), reps=3)
    plain_ms = cuda_ms(
        lambda: ic.intersect_count_ref(rows_a, rows_b, sentinel=sent), reps=1,
        warmup=0)
    kernel_ms_again = cuda_ms(
        lambda: ops.intersect_count(rows_a, rows_b, sentinel=sent), reps=20,
        warmup=3)
    same = torch.equal(ops.intersect_count(rows_a, rows_b, sentinel=sent),
                       count_bsearch_torch(rows_a, rows_b, sent))
    if not same:
        raise RuntimeError("timing: kernel != count_bsearch_torch")
    emit({"phase": "timing", "shape": [e_t, w, w],
          "slabs_per_round": -(-u_glob.size // slab),
          "valid_prefix_bytes": prefix_bytes, "padded_bytes": 2.0 * e_t * w * 4,
          "compares": compares, "kernel_ms": [kernel_ms, kernel_ms_again],
          "count_bsearch_torch_ms": bsearch_ms, "plain_ms": plain_ms,
          "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms})

    # ------------------------------------------------------------ summary
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [{
        "name": "intersect_count", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/intersect_count.cu",
        "replaces": "src/repro/kernels/intersect_count.py:49",
        "launches": main_path_launches,
        "launches_entry": entry_launches, "launches_full": full_launches,
        "launches_pairs": pairs_launches,
        "launches_per_epoch": launches_per_epoch,
        "max_abs_err": max_abs_err, "tolerance": 0,
        "shape": [e_t, w, w],
        "ms": min(kernel_ms, kernel_ms_again), "plain_ms": plain_ms,
        "count_bsearch_torch_ms": bsearch_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}],
        "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
