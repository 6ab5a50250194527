"""Time B10 (``embedding_bag``) alone on the card, at the served batch's
shape and at serve_bulk.

    python -m repro_torch.launch.bag_timing
    PYTHONPATH=<other tree>/src python src/repro_torch/launch/bag_timing.py

The second form times another checkout's wrapper on the same data: this
file imports ``repro_torch`` by its absolute name only, and uses nothing of
it beyond ``kernels.ops.embedding_bag``, ``kernels.embedding_bag``'s plain
version and ``data.recsys.CTRStream``.

The table is DIN's item table at its full config, ``N_ITEMS`` x ``DIM``
fp32 (``configs/din.py``), drawn on the card from a generator seeded with
0. The batches are the CTR stream's (``CTRStream``: Zipf ids, a = 1.3,
lengths uniform over 5-100):

  served      [512, 100]: the first batch the DIN launcher times (seed 0,
              step 1; ``launch/serve.py``)
  serve_bulk  [262,144, 100]: seed 1, step 0 (B10's row since it was ported)
  rotating    serve_bulk's shape, seeds 1-4 in turn: each batch touches
              ~50 MB of distinct rows and the four share only their hot
              ones, so together they hold more than the 50 MB L2, and a
              call does not find the previous call's cold rows there
  hot_ids     serve_bulk's mask with ids drawn uniformly from [0, 256):
              every row lies in L1, so the time is what the instructions
              of a row cost
  cold_ids    the same with ids uniform over the whole table: nearly every
              row comes from HBM

For each: the kernel (sum; at ``served`` mean too), its plain version (not
for ``rotating`` and the two id brackets), and
``F.embedding_bag(mode="sum", per_sample_weights=mask.float())`` on int64
ids (one PyTorch call of the same function, timed as a yardstick only).
Times are the lower of two means of 20 calls after 3 warm-up calls
(``obs.timing.min_ms``: calls issued back to back from Python, so at the
served batch's size they measure the host's launch path) and, as
``device_ms``, the same 20 calls captured in a CUDA graph and replayed (the
device's time alone; the lower of two replays). Every output of the kernel
is checked against the plain version at ``BAG_TOL``. The bound is bytes:
each distinct row a call touches read once, the ids (4 B a position), the
mask (1 B a position) and the fp32 output written once, over 3.35 TB/s (a
mean over the batches for ``rotating``). Prints one JSON line with the
card's name and power limit. ``chip_smoke.py``'s ``timing`` phase times B10
with ``time_shapes`` on the served DIN's own table and batch.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import torch

N_ITEMS, DIM = 100_000_000, 18  # configs/din.py: n_items, embed_dim
SERVED_BAGS = 512  # launch/serve.py --arch din --batch 512
BULK_BAGS = 262_144  # serve_bulk
SEQ_LEN = 100
ROTATING_SEEDS = (1, 2, 3, 4)
BAG_TOL = 2e-3  # the reference's embedding-bag test tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def stream_batch(n_rows, bags, seed, step=0):
    """(ids int32, mask bool) of ``CTRStream(...).batch_at(step)`` on the
    card: the history ids and mask do not depend on the stream's other
    sizes."""
    from repro_torch.data.recsys import CTRStream

    b = CTRStream(n_rows, 1, bags, seq_len=SEQ_LEN, seed=seed).batch_at(step)
    return (torch.from_numpy(b["hist_items"]).cuda(),
            torch.from_numpy(b["hist_mask"]).cuda())


def bound_bytes(table, ids, mask) -> float:
    """Bytes the function must move: each distinct row once, the ids, the
    mask at 1 B a position, the fp32 output."""
    d = table.shape[1]
    unique = int(torch.unique(ids).numel())
    return (unique * d * table.element_size()
            + ids.numel() * ids.element_size()
            + mask.numel() * mask.element_size() + ids.shape[0] * d * 4.0)


def check(table, ids, mask, mode="sum") -> float:
    """Max |kernel - plain| on one batch; raises beyond ``BAG_TOL``."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops

    got = ops.embedding_bag(table, ids, mask, mode=mode)
    want = eb.embedding_bag_ref(table, ids, mask, mode=mode)
    err = float((got - want).abs().max())
    if not err <= BAG_TOL * (1 + float(want.abs().max())):
        raise RuntimeError(f"B10 != plain ({mode}, ids {tuple(ids.shape)}): "
                           f"{err}")
    return err


def graph_ms(fn, reps) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls captured in one CUDA graph:
    the lower of two replays, after warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return min(times)


def time_batches(table, batches, reps, plain=True):
    """One shape: the kernel over ``batches`` in turn, the plain version
    (on the first), ``F.embedding_bag``, the bound and the check."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.obs.timing import cuda_ms, min_ms

    def turns(fn, inputs):
        it = itertools.cycle(inputs)
        return lambda: fn(*next(it))

    lib_in = [(ids.long(), mask.float()) for ids, mask in batches]
    nbytes = [bound_bytes(table, ids, mask) for ids, mask in batches]

    def kernel(ids, mask):
        return ops.embedding_bag(table, ids, mask)

    def library(ids, w):
        return F.embedding_bag(ids, table, mode="sum", per_sample_weights=w)

    rec = {
        "ids": list(batches[0][0].shape), "batches": len(batches),
        "err": max(check(table, ids, mask) for ids, mask in batches),
        "ms": min_ms(turns(kernel, batches), reps=reps),
        "device_ms": graph_ms(turns(kernel, batches), reps),
        "library_ms": min_ms(turns(library, lib_in), reps=reps),
        "library_device_ms": graph_ms(turns(library, lib_in), reps),
        "bytes": sum(nbytes) / len(nbytes),
    }
    if plain:
        ids, mask = batches[0]
        rec["plain_ms"] = cuda_ms(
            lambda: eb.embedding_bag_ref(table, ids, mask), reps=1)
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    rec["bound_by"] = "bytes"
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def time_shapes(table, served, reps=20):
    """``served`` (the served batch's ids and mask), ``serve_bulk``,
    ``rotating`` and the two id brackets on ``table``: one record each, and
    the served batch's mean mode."""
    from repro_torch.kernels import ops
    from repro_torch.obs.timing import min_ms

    n = table.shape[0]
    bulk = [stream_batch(n, BULK_BAGS, s) for s in ROTATING_SEEDS]
    gen = torch.Generator("cuda").manual_seed(1)
    mask = bulk[0][1]
    hot, cold = (torch.randint(0, hi, mask.shape, generator=gen,
                               device="cuda", dtype=torch.int32)
                 for hi in (256, n))
    out = {"served": time_batches(table, [served], reps),
           "serve_bulk": time_batches(table, bulk[:1], reps),
           "rotating": time_batches(table, bulk, reps, plain=False),
           "hot_ids": time_batches(table, [(hot, mask)], reps, plain=False),
           "cold_ids": time_batches(table, [(cold, mask)], reps,
                                    plain=False)}
    ids, mask = served
    out["served"]["mean_err"] = check(table, ids, mask, mode="mean")
    out["served"]["mean_ms"] = min_ms(
        lambda: ops.embedding_bag(table, ids, mask, mode="mean"), reps=reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON record to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bag_timing needs a CUDA device")
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    table = torch.randn((N_ITEMS, DIM), generator=gen, device="cuda")
    rec = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
        "table": [N_ITEMS, DIM],
        **time_shapes(table, stream_batch(N_ITEMS, SERVED_BAGS, 0, step=1)),
    }
    rec["seconds"] = time.perf_counter() - t0
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
