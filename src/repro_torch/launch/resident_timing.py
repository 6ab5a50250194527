"""Time B3 (``resident_intersect``) alone on the card, at the device tier's
hub shapes.

    python -m repro_torch.launch.resident_timing [--scale 16]
    python -m repro_torch.launch.resident_timing --scale 14 \
        --tier-rows 1024 --max-width 512   # the stream's tier

The residency holds the ``--tier-rows`` highest-degree rows of the R-MAT
graph ``rmat_graph(scale, 16, seed=0)`` (of those no wider than
``--max-width``), each padded to the widest of them, with their valid
lengths beside them (the tier's ``lens``). Three batches of pairs go
through the kernel:

  vs_slots           the first ``VS_SLOTS_PAIRS`` directed edges with both
                     ends resident, in CSR order (runs of pairs share
                     ``slot_a``)
  vs_slots_shuffled  the same pairs in a seeded random order (no runs)
  vs_rows            the first ``VS_ROWS_PAIRS`` edges with one end
                     resident, the other end's row uploaded, padded

each twice: with the graph's own sentinel (``ids_fit``: at scale <= 17 the
ids fit the kernel's bitmap) and with the padding raised to
``WIDE_SENTINEL`` (``wide_ids``: the same ids and counts, but an id space
too wide for the bitmap, as on a graph of more than 2^17 vertices, so
every pair is searched). Every batch is checked in full, with and without
the lengths, against ``count_bsearch_torch`` on the gathered rows, then
timed with CUDA events: the lower of two rounds over all batches (the
second in reverse order), each the mean of 20 calls after 3 warm-up calls
(``obs.timing.min_ms``'s statistic). ``shape_stats`` counts the work and
the share of it the kernel counts by bitmap. Prints one JSON line with the
card's name and power limit. ``chip_smoke.py``'s ``timing`` phase builds
its B3 shapes and times them with this module. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..obs.timing import cuda_ms

TIER_ROWS = 4096
VS_SLOTS_PAIRS = 262_144
VS_ROWS_PAIRS = 65_536
SHUFFLE_SEED = 1
WIDE_SENTINEL = 1 << 20
BATCHES = ("vs_slots", "vs_slots_shuffled", "vs_rows")
CHECK_CHUNK = 8192  # pairs a chunk of the count_bsearch_torch check gathers
# csrc/resident_intersect.cu's choice of bitmap runs, restated for
# shape_stats: kTile, kWarps, kBlocksPerSm, kBitmapIds, kBitmapQ,
# kBitmapMinRun
K_TILE, K_WARPS, K_BLOCKS_PER_SM = 32, 8, 8
K_BITMAP_IDS, K_BITMAP_Q, K_BITMAP_MIN_RUN = 1 << 17, 2, 2


@dataclasses.dataclass
class TierShapes:
    """The device tensors of the three batches, and what the bound needs."""

    residency: torch.Tensor  # [TIER_ROWS, w_res] int32
    lens: torch.Tensor  # [TIER_ROWS] int32 valid length per slot
    sa: torch.Tensor  # [E] int32, vs_slots in CSR order
    sb: torch.Tensor
    perm: torch.Tensor  # [E] int64, the shuffled order
    sr: torch.Tensor  # [E'] int32, the resident end of vs_rows
    rows_o: torch.Tensor  # [E', w_other] int32, the uploaded end
    n_other: torch.Tensor  # [E'] int64 valid length of each rows_o row
    sentinel: int
    res_bytes_slots: float  # each resident row vs_slots touches, read once
    res_bytes_rows: float  # the same for vs_rows


def padded(csr, vertices, width, sentinel):
    out = np.full((len(vertices), width), sentinel, np.int32)
    for i, v in enumerate(vertices):
        r = csr.row(int(v))
        out[i, : r.size] = r
    return out


def tier_shapes(csr, dev, *, tier_rows=TIER_ROWS, slots_pairs=VS_SLOTS_PAIRS,
                rows_pairs=VS_ROWS_PAIRS, max_width=None) -> TierShapes:
    """The ``tier_rows`` highest-degree rows of ``csr`` (of those no wider
    than ``max_width``, as the tier admits them) resident on ``dev``, and
    the three batches of pairs over them (module docstring)."""
    sent = int(csr.n)
    deg = csr.degrees.astype(np.int64)
    score = deg if max_width is None else np.where(deg <= max_width, deg, -1)
    top = np.sort(np.argsort(-score, kind="stable")[:tier_rows])
    w_res = int(deg[top].max())
    slot_of = np.full(csr.n, -1, np.int64)
    slot_of[top] = np.arange(top.size)
    src, dst = csr.edge_list()
    s_src, s_dst = slot_of[src], slot_of[dst]
    both = np.flatnonzero((s_src >= 0) & (s_dst >= 0))[:slots_pairs]
    one = np.flatnonzero((s_src >= 0) != (s_dst >= 0))[:rows_pairs]
    res_end = np.where(s_src[one] >= 0, src[one], dst[one])
    other = np.where(s_src[one] >= 0, dst[one], src[one])
    perm = np.random.default_rng(SHUFFLE_SEED).permutation(both.size)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return TierShapes(
        residency=up(padded(csr, top, w_res, sent)),
        lens=up(deg[top].astype(np.int32)),
        sa=up(s_src[both].astype(np.int32)),
        sb=up(s_dst[both].astype(np.int32)),
        perm=up(perm),
        sr=up(slot_of[res_end].astype(np.int32)),
        rows_o=up(padded(csr, other, max(int(deg[other].max(initial=0)), 1),
                         sent)),
        n_other=up(deg[other]),
        sentinel=sent,
        res_bytes_slots=float(deg[top][np.unique(np.concatenate(
            [s_src[both], s_dst[both]]))].sum()) * 4,
        res_bytes_rows=float(deg[np.unique(res_end)].sum()) * 4)


def widened(sh: TierShapes, sentinel: int = WIDE_SENTINEL) -> TierShapes:
    """``sh`` with its padding raised to ``sentinel``: the same ids, pairs
    and counts in an id space too wide for the kernel's bitmap."""
    def pad(x):
        return torch.where(x >= sh.sentinel, torch.full_like(x, sentinel), x)

    return dataclasses.replace(sh, residency=pad(sh.residency),
                               rows_o=pad(sh.rows_o), sentinel=sentinel)


def pairs_of(sh: TierShapes):
    """``{batch: (slot_a, the valid lengths of A and of B)}``, numpy."""
    lens = sh.lens.cpu().numpy().astype(np.int64)
    sa, sb = sh.sa.cpu().numpy(), sh.sb.cpu().numpy()
    perm, sr = sh.perm.cpu().numpy(), sh.sr.cpu().numpy()
    return {"vs_slots": (sa, lens[sa], lens[sb]),
            "vs_slots_shuffled": (sa[perm], lens[sa[perm]], lens[sb[perm]]),
            "vs_rows": (sr, lens[sr], sh.n_other.cpu().numpy())}


def bitmap_runs(sa, na, nb, sentinel, n_sm):
    """Which pairs the kernel counts against a bitmap of their run's
    ``slot_a`` row, decided as ``resident_intersect.cu`` decides it: runs of
    live pairs with one ``slot_a`` within a block's tile, at least
    ``K_BITMAP_MIN_RUN`` long, whose rows cost less to stream than to
    search (``4 * (na + sum nb) <= K_BITMAP_Q * sum work``), and only while
    ``sentinel <= K_BITMAP_IDS``. Returns a bool mask over the pairs."""
    e = sa.size
    if e == 0 or sentinel > K_BITMAP_IDS:
        return np.zeros(e, bool)
    fill = n_sm * K_BLOCKS_PER_SM
    tile = min(K_TILE, max(K_WARPS, -(-e // fill)))
    pos = np.arange(e)
    live = (na > 0) & (nb > 0)
    key = np.where(live, sa.astype(np.int64), -1 - pos)
    start = (pos % tile == 0) | np.r_[True, key[1:] != key[:-1]]
    run = np.cumsum(start) - 1
    heads = np.flatnonzero(start)
    length = np.diff(np.r_[heads, e])
    nb_sum = np.bincount(run, weights=np.where(live, nb, 0))
    work_sum = np.bincount(run, weights=np.where(live, search_work(na, nb), 0))
    by = (live[heads] & (length >= K_BITMAP_MIN_RUN)
          & (4 * (na[heads] + nb_sum) <= K_BITMAP_Q * work_sum))
    return by[run]


def search_work(na, nb):
    """Compares a search needs, pair by pair: ``ns * ceil(log2(nl + 1))``
    (``pair_intersect.cuh::work``)."""
    ns, nl = np.minimum(na, nb), np.maximum(na, nb)
    return ns * np.frexp(nl.astype(np.float64))[1].astype(np.int64)


def shape_stats(sh: TierShapes, n_sm: int) -> Dict[str, Dict[str, float]]:
    """Counts of the data, per batch: pairs, runs of consecutive pairs with
    one ``slot_a``, the compares a search needs and a merge (``na + nb``),
    the ids a bitmap count streams (every ``B`` row once) and builds (each
    run's ``A`` row), and the share of the pairs and of the search compares
    that the kernel counts by bitmap at the graph's sentinel (0 beyond
    ``K_BITMAP_IDS``) on a card of ``n_sm`` SMs."""
    out = {}
    for batch, (sa, na, nb) in pairs_of(sh).items():
        head = np.r_[True, sa[1:] != sa[:-1]] if sa.size else sa.astype(bool)
        work = search_work(na, nb)
        by = bitmap_runs(sa, na, nb, sh.sentinel, n_sm)
        out[batch] = {"pairs": int(sa.size), "runs": int(head.sum()),
                      "search_compares": int(work.sum()),
                      "merge_compares": int((na + nb).sum()),
                      "streamed_ids": int(nb.sum()),
                      "built_ids": int(na[head].sum()),
                      "bitmap_pair_share": float(by.mean()) if sa.size else 0.0,
                      "bitmap_compare_share": float(work[by].sum()
                                                    / max(work.sum(), 1))}
    return out


def runs(sh: TierShapes,
         lengths: bool = True) -> Dict[str, Callable[[], torch.Tensor]]:
    """One B3 launch per batch, with the tier's lengths or without."""
    from ..kernels import resident_intersect as ri

    sa_s = sh.sa[sh.perm].contiguous()
    sb_s = sh.sb[sh.perm].contiguous()
    kw = {"lengths": sh.lens if lengths else None, "sentinel": sh.sentinel}
    return {
        "vs_slots": lambda: ri.resident_intersect(
            sh.residency, sh.sa, slots_b=sh.sb, **kw),
        "vs_slots_shuffled": lambda: ri.resident_intersect(
            sh.residency, sa_s, slots_b=sb_s, **kw),
        "vs_rows": lambda: ri.resident_intersect(
            sh.residency, sh.sr, sh.rows_o, **kw),
    }


def time_batches(shapes: Dict[str, TierShapes], *, rounds: int = 2,
                 reps: int = 20,
                 warmup: int = 3) -> Dict[str, Dict[str, float]]:
    """``{shape: {batch: ms}}``: every batch of every shape, the lowest of
    ``rounds`` interleaved rounds (the order reversed every other round),
    each the mean of ``reps`` calls after ``warmup`` calls."""
    fns = {k: runs(sh) for k, sh in shapes.items()}
    order = [(k, b) for k in shapes for b in BATCHES]
    best: Dict[str, Dict[str, float]] = {k: {} for k in shapes}
    for r in range(rounds):
        for k, b in (order if r % 2 == 0 else order[::-1]):
            ms = cuda_ms(fns[k][b], reps=reps, warmup=warmup)
            best[k][b] = min(best[k].get(b, float("inf")), ms)
    return best


def bsearch_counts(sh: TierShapes) -> Dict[str, torch.Tensor]:
    """``count_bsearch_torch`` on the gathered rows of each pair of
    ``vs_slots`` and ``vs_rows``, in chunks of ``CHECK_CHUNK`` pairs: an
    independent plain count of both batches."""
    from ..core.intersect import count_bsearch_torch

    def chunked(sa, other):
        out = []
        for lo in range(0, sa.shape[0], CHECK_CHUNK):
            a = sh.residency.index_select(0, sa[lo:lo + CHECK_CHUNK].long())
            out.append(count_bsearch_torch(a, other(lo), sh.sentinel))
        return torch.cat(out) if out else sa.new_zeros((0,))

    return {
        "vs_slots": chunked(sh.sa, lambda lo: sh.residency.index_select(
            0, sh.sb[lo:lo + CHECK_CHUNK].long())),
        "vs_rows": chunked(sh.sr, lambda lo: sh.rows_o[lo:lo + CHECK_CHUNK]),
    }


def check(shapes: Dict[str, TierShapes],
          want: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Max abs error of every batch of every shape, with and without
    lengths, against ``want`` (``bsearch_counts`` of one of them: every
    shape holds the same pairs and ids). Raises on any difference."""
    errs = {}
    for k, sh in shapes.items():
        want_k = {**want, "vs_slots_shuffled": want["vs_slots"][sh.perm]}
        for lengths in (True, False):
            for b, fn in runs(sh, lengths).items():
                err = int((fn().long() - want_k[b].long()).abs().max())
                errs[f"{k}/{b}/{'lens' if lengths else 'no_lens'}"] = err
                if err:
                    raise RuntimeError(f"B3 {k} {b} lengths={lengths}: "
                                       f"kernel != count_bsearch_torch")
    return errs


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--tier-rows", type=int, default=TIER_ROWS)
    ap.add_argument("--max-width", type=int, default=None,
                    help="admit only rows no wider (the tier's max_width)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON record to this file")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..graphs.rmat import rmat_graph

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    csr = rmat_graph(args.scale, 16, seed=0)
    sh = tier_shapes(csr, dev, tier_rows=args.tier_rows,
                     max_width=args.max_width)
    shapes = {"ids_fit": sh, "wide_ids": widened(sh)}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
        "scale": args.scale,
        "residency": list(sh.residency.shape),
        "sentinels": {k: s.sentinel for k, s in shapes.items()},
        "pairs": shape_stats(sh, n_sm),
        "check": check(shapes, bsearch_counts(sh)),
        "ms": time_batches(shapes),
    }
    rec["seconds"] = time.perf_counter() - t0
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
