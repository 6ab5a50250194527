"""One round of the LCC epoch by index: the packed landing of the pulled rows
and the fused count (the reference's compiled epoch body, B7, with B1 inside
it). The hand-written CUDA kernels (``csrc/epoch_count.cu`` on
``csrc/pair_intersect.cuh``), their wrappers and their plain torch versions.

Per epoch, ``epoch_index`` makes on the problem's device, with one gather
and one ``cumsum``, the length ``land_len[r, dst, src, slot]`` of every row a
serve slot pulls (its degree; 0 for a phantom slot) and its offset
``land_off`` in the round's packed landing (an exclusive cumsum), plus the
valid length of every cache row. Per round ``r``:

  ``epoch_land``   the all-to-all ``got[dst, src] = to_send[src, dst]``: the
                   valid prefix of every real pulled row, packed into
                   ``landing[land_off[r]]``; exactly the ids an RMA get moves.
  ``epoch_count``  for every edge slot of the round, ``|row(u) ∩ row(v)|``
                   added into ``acc[rank, u]``: u's row from the problem's
                   ragged store (``row_ids`` from ``row_off``), v's by its
                   combined index from the store (``[0, n_loc]``), the
                   cache rows (``[n_loc+1, n_loc+1+C)``) or the landing
                   (the rest), each with its valid length; phantom slots add
                   nothing and ``acc[rank, n_loc]`` is never touched.
                   ``method`` picks the strategy per pair: ``bsearch``
                   searches, ``pairwise`` merges, ``hybrid`` merges iff
                   ``na + nb <= ns * ceil(log2(nl + 1))`` (``hybrid_merges``).
                   A hub's run of slots (one ``u``) that ``count_runs``
                   keeps is counted instead against a bitmap of u's row:
                   the same integers, whatever the method.

The run table (``count_runs``, built once a problem on its device, before
the first epoch's index) lists the pieces of those runs and the tiles of the
slots no piece covers. A run is a stretch of consecutive real slots of one
``(rank, round)`` chunk that share ``u``; it is kept iff the bitmap of the
ids fits the shared memory that costs no block of occupancy
(``bitmap_fits``), it holds at least ``_MIN_RUN`` slots, and ``4 * (bitmap
build + ids streamed) <= _BITMAP_Q * compares``: its pieces clear and set a
bitmap each (``words + deg(u)``), its slots stream their v rows (``sum
nb``), against the compares ``hybrid`` would make. A kept run is
cut into pieces of at most ``_PIECE_SLOTS`` slots, so one hub's run spreads
over many blocks. The constants were chosen on the card (``csrc/
epoch_count.cu``'s header). ``bitmap_slot_share`` is the share of the real
slots the pieces cover, ``heavy_slot_share`` the share a tile block counts as
a heavy pair (more than ``_HEAVY_WORK`` compares: the whole block's).

The plain versions count padded rows, built from the store a slab at a time
(``DeviceLCCProblem.padded_rows``); no padded copy of the whole store is
made on either route.

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; the choice follows the tensors' device and nothing else. A
build or launch failure raises. Neither kernel reads anything back to the
host, so a round enqueues without a synchronisation.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..core.intersect import count_bsearch_torch, count_pairwise_torch
from . import _build

__all__ = [
    "CountRuns",
    "EpochIndex",
    "bitmap_slot_share",
    "count_runs",
    "epoch_index",
    "epoch_land",
    "epoch_land_ref",
    "epoch_count",
    "epoch_count_ref",
    "heavy_slot_share",
    "hybrid_merges",
    "launches",
    "reset_launches",
]

_LIB = "epoch_count"
METHOD_CODES = {"bsearch": 0, "pairwise": 1, "hybrid": 2}
# most bytes one padded operand of the plain count may take per slab
_SLAB_BYTES = 2 << 30
# the run table's rule (see csrc/epoch_count.cu's header for the choice):
# the fewest slots of a kept run, the most slots of a piece, and the weight
# of the compares saved: keep iff 4 * (ids set, cleared, streamed) <= Q * them
_MIN_RUN = 32
_PIECE_SLOTS = 256
_BITMAP_Q = 64
# shared memory a piece block may take without costing a tile block any
# occupancy: the stage a launch takes anyway (kStageCap ids of csrc/
# epoch_count.cu, 4 B each) or 24 KB, with which 8 blocks of 256 threads, the
# thread limit, still fit an SM; a piece block takes the bitmap and 16 B a
# thread for its slots
_STAGE_IDS = 10240
_FREE_SMEM = 24 << 10
_PIECE_SCRATCH = 256 * 16  # kThreads x sizeof(PieceSlot)
# slots of a tile block (kTile of csrc/epoch_count.cu)
_TILE_SLOTS = 16
# compares above which a tile block counts a pair with all its threads
# (kHeavyWork of csrc/epoch_count.cu)
_HEAVY_WORK = 2048
_launches = {"epoch_land": 0, "epoch_count": 0}


def launches() -> dict:
    """Kernel launches per entry point since the last reset."""
    return dict(_launches)


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


def bit_length(n: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(n + 1))`` of non-negative integers, exactly (int32)."""
    return torch.frexp(n.to(torch.float64)).exponent


def hybrid_merges(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """The hybrid rule per pair: merge iff ``na + nb <= ns * ceil(log2(nl +
    1))``, with ns / nl the shorter / longer valid length — the cost of each
    strategy in compares (paper §III-C's rule with the card's costs)."""
    na, nb = na.to(torch.int64), nb.to(torch.int64)
    ns, nl = torch.minimum(na, nb), torch.maximum(na, nb)
    return na + nb <= ns * bit_length(nl).to(torch.int64)


@dataclasses.dataclass
class CountRuns:
    """The run table of one ``DeviceLCCProblem``, on its device. Slots are
    named by their flat index ``e = rank * e_max + round * e_chunk + j``;
    both lists are grouped by round, round ``r``'s entries at
    ``[start[r], start[r + 1])`` (host offsets)."""

    piece_e: torch.Tensor  # [pieces] int64 first slot of each piece
    piece_n: torch.Tensor  # [pieces] int32 slots of each piece
    piece_start: Tuple[int, ...]  # [NR + 1]
    # [tiles] int64 ``e * 32 + slots`` of up to _TILE_SLOTS consecutive real
    # slots no piece covers; None where the problem has no piece: the tile
    # blocks then take every _TILE_SLOTS slots of the round in order
    tiles: Optional[torch.Tensor]
    tile_start: Optional[Tuple[int, ...]]  # [NR + 1]
    covered: int  # real slots the pieces cover
    real: int  # real slots of the problem
    # real slots no piece covers whose pair a tile block counts as heavy
    # under ``hybrid`` (both rows nonempty, over _HEAVY_WORK compares)
    heavy: int = 0

    @property
    def share(self) -> float:
        return self.covered / self.real if self.real else 0.0

    @property
    def heavy_share(self) -> float:
        return self.heavy / self.real if self.real else 0.0


def _slot_lengths(prob, k: int, pos: torch.Tensor, deg_ext: torch.Tensor,
                  cache_len: torch.Tensor) -> torch.Tensor:
    """Valid length (int64) of v's row for rank ``k``'s real slots ``pos``:
    local rows and pulled rows by their owner's degree (a pulled slot's
    row through ``serve_idx``), cache rows by their valid prefix."""
    n_loc, s_max = prob.n_loc, prob.s_max
    c = cache_len.numel()
    e_chunk = prob.e_max // prob.n_rounds
    vc = prob.edge_vc[k][pos].to(torch.int64)
    nb = deg_ext[k * (n_loc + 1) + vc.clamp(max=n_loc)]
    fetched = vc >= n_loc + 1 + c
    item = (vc - (n_loc + 1 + c)).clamp(min=0)
    src = item // s_max
    loc = prob.serve_idx[src, pos // e_chunk, k, item % s_max].to(torch.int64)
    nb = torch.where(fetched, deg_ext[src * (n_loc + 1) + loc], nb)
    if c:
        cached = (vc > n_loc) & ~fetched
        nb = torch.where(cached, cache_len[(vc - (n_loc + 1)).clamp(0, c - 1)],
                         nb)
    return nb


def _hybrid_work(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """Compares ``hybrid`` makes on pairs of valid lengths ``na``, ``nb``
    (int64): what a tile block classes its pairs by."""
    ns, nl = torch.minimum(na, nb), torch.maximum(na, nb)
    return torch.where(hybrid_merges(na, nb), na + nb,
                       ns * bit_length(nl).to(torch.int64))


def _real(prob, k: int) -> torch.Tensor:
    """[e_max] bool: rank ``k``'s real slots (an edge, u not the phantom)."""
    return prob.edge_mask[k] & (prob.edge_u[k] < prob.n_loc)


def _stretches(pos: torch.Tensor, key: torch.Tensor, e_chunk: int):
    """Run ids of sorted slot positions: a run breaks where positions skip,
    ``key`` changes or a round chunk ends. Returns (run of each position,
    first position of each run, slots of each run)."""
    new = torch.ones_like(pos, dtype=torch.bool)
    new[1:] = ((pos[1:] != pos[:-1] + 1) | (key[1:] != key[:-1])
               | (pos[1:] // e_chunk != pos[:-1] // e_chunk))
    run = torch.cumsum(new, 0) - 1
    return run, pos[new], torch.bincount(run, minlength=int(new.sum()))


def _pieces_of_rank(prob, k: int, deg_ext: torch.Tensor,
                    cache_len: torch.Tensor):
    """(first slot, slots) of rank ``k``'s pieces, positions within the
    rank: the kept runs, each cut into near-equal pieces of at most
    ``_PIECE_SLOTS`` slots."""
    n_loc, e_chunk = prob.n_loc, prob.e_max // prob.n_rounds
    eu = prob.edge_u[k].to(torch.int64)
    na_all = deg_ext[k * (n_loc + 1) + eu.clamp(max=n_loc)]
    # a run holds at most deg(u) slots: only hubs' slots are candidates
    pos = (_real(prob, k) & (na_all >= _MIN_RUN)).nonzero().reshape(-1)
    empty = pos.new_zeros(0)
    if pos.numel() == 0:
        return empty, empty
    run, first, slots = _stretches(pos, eu[pos], e_chunk)
    na, nb = na_all[pos], _slot_lengths(prob, k, pos, deg_ext, cache_len)
    work = _hybrid_work(na, nb)
    n_runs = first.numel()
    compares = torch.zeros(n_runs, dtype=torch.int64,
                           device=pos.device).index_add_(0, run, work)
    streamed = torch.zeros_like(compares).index_add_(0, run, nb)
    pieces = (slots + _PIECE_SLOTS - 1) // _PIECE_SLOTS
    words = bitmap_bytes(prob.sentinel) // 4
    cost = pieces * (words + na_all[first]) + streamed
    keep = (slots >= _MIN_RUN) & (4 * cost <= _BITMAP_Q * compares)
    first, slots, pieces = first[keep], slots[keep], pieces[keep]
    if first.numel() == 0:
        return empty, empty
    of = torch.repeat_interleave(torch.arange(first.numel(),
                                              device=pos.device), pieces)
    i = torch.arange(of.numel(), device=pos.device) - (
        torch.cumsum(pieces, 0) - pieces)[of]
    lo = i * slots[of] // pieces[of]
    hi = (i + 1) * slots[of] // pieces[of]
    return first[of] + lo, hi - lo


def _covered(prob, first: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[e_max] bool: a rank's slots that its pieces (rank-local first slot,
    slots) cover."""
    edge = torch.zeros(prob.e_max + 1, dtype=torch.int32, device=first.device)
    edge.index_add_(0, first, torch.ones_like(first, dtype=torch.int32))
    edge.index_add_(0, first + slots,
                    -torch.ones_like(first, dtype=torch.int32))
    return torch.cumsum(edge[: prob.e_max], 0) > 0


def _heavy_of_rank(prob, k: int, covered: torch.Tensor,
                   deg_ext: torch.Tensor, cache_len: torch.Tensor) -> int:
    """Rank ``k``'s real slots outside ``covered`` whose pair a tile block
    counts as heavy under ``hybrid`` (``tile_add`` of csrc/
    pair_intersect.cuh: both rows nonempty, over ``_HEAVY_WORK``
    compares)."""
    pos = (_real(prob, k) & ~covered).nonzero().reshape(-1)
    eu = prob.edge_u[k][pos].to(torch.int64)
    na = deg_ext[k * (prob.n_loc + 1) + eu]
    nb = _slot_lengths(prob, k, pos, deg_ext, cache_len)
    return int(((na > 0) & (nb > 0)
                & (_hybrid_work(na, nb) > _HEAVY_WORK)).sum())


def _tiles_of_rank(prob, k: int, covered: torch.Tensor) -> torch.Tensor:
    """Rank-local ``pos * 32 + slots`` of the tiles over the real slots no
    piece covers: each stretch of them within a round chunk cut into
    ``_TILE_SLOTS``-slot tiles from its start."""
    e_chunk = prob.e_max // prob.n_rounds
    pos = (_real(prob, k) & ~covered).nonzero().reshape(-1)
    if pos.numel() == 0:
        return pos
    run, start, length = _stretches(pos, torch.zeros_like(pos), e_chunk)
    at = pos - start[run]
    head = at % _TILE_SLOTS == 0
    n = torch.clamp(length[run] - at, max=_TILE_SLOTS)
    return pos[head] * 32 + n[head]


def _by_round(prob, e: torch.Tensor):
    """Stable order of flat slot indices by round, and the host offsets of
    each round's entries."""
    e_chunk = prob.e_max // prob.n_rounds
    rnd = (e % prob.e_max) // e_chunk
    order = torch.sort(rnd, stable=True).indices
    counts = torch.bincount(rnd, minlength=prob.n_rounds).tolist()
    start = [0]
    for c in counts:
        start.append(start[-1] + c)
    return order, tuple(start)


def bitmap_bytes(sentinel: int) -> int:
    """Bytes of the bitmap of ``[0, sentinel)``, in whole 16-byte groups."""
    return 16 * -(-sentinel // 128)


def bitmap_fits(prob) -> bool:
    """A piece block's shared memory (bitmap and slots) within what the
    launch takes anyway for a staged row, or within ``_FREE_SMEM``."""
    stage = 4 * min(prob.width, _STAGE_IDS)
    return (bitmap_bytes(prob.sentinel) + _PIECE_SCRATCH
            <= max(stage, _FREE_SMEM))


def count_runs(prob) -> CountRuns:
    """The run table of ``prob`` (``DeviceLCCProblem``), built on its device
    the first time it is asked for and kept on it (``_count_runs``); no
    piece where the bitmap would not fit (``bitmap_fits``). The build reads
    the problem's schedule arrays and synchronises; ``epoch_index`` asks for
    it before the epoch's own buffers exist, so its temporaries (rank by
    rank) stay within the epoch's. It also counts the slots left to tiles
    that are heavy pairs (``heavy_slot_share``)."""
    runs = getattr(prob, "_count_runs", None)
    if runs is not None:
        return runs
    p, n_loc, e_max = prob.p, prob.n_loc, prob.e_max
    dev = prob.device
    n_real = sum(int(_real(prob, k).sum()) for k in range(p))
    deg_ext = torch.cat([prob.degrees, prob.degrees.new_zeros((p, 1))],
                        dim=1).reshape(-1).to(torch.int64)
    cache_len = (prob.cache_rows < prob.sentinel).sum(-1)
    firsts = []
    if (bitmap_fits(prob) and prob.degrees.numel()
            and int(prob.degrees.max()) >= _MIN_RUN):
        for k in range(p):
            first, slots = _pieces_of_rank(prob, k, deg_ext, cache_len)
            firsts.append((first + k * e_max, slots))
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    piece_e = torch.cat([f for f, _ in firsts] or [empty])
    piece_n = torch.cat([n for _, n in firsts] or [empty])
    order, piece_start = _by_round(prob, piece_e)
    piece_e, piece_n = piece_e[order], piece_n[order]
    tiles = tile_start = None
    per_rank, heavy = [], 0
    for k in range(p):
        mine = (piece_e // e_max) == k
        covered = _covered(prob, piece_e[mine] % e_max, piece_n[mine])
        heavy += _heavy_of_rank(prob, k, covered, deg_ext, cache_len)
        if piece_e.numel():
            per_rank.append(_tiles_of_rank(prob, k, covered) + k * e_max * 32)
    if piece_e.numel():
        tiles = torch.cat(per_rank)
        order, tile_start = _by_round(prob, tiles // 32)
        tiles = tiles[order]
    runs = CountRuns(piece_e=piece_e, piece_n=piece_n.to(torch.int32),
                     piece_start=piece_start, tiles=tiles,
                     tile_start=tile_start, covered=int(piece_n.sum()),
                     real=n_real, heavy=heavy)
    prob._count_runs = runs
    return runs


def bitmap_slot_share(prob) -> float:
    """Share of the real edge slots of ``prob`` that the run table's pieces
    cover: the slots counted against a bitmap of their hub's row."""
    return count_runs(prob).share


def heavy_slot_share(prob) -> float:
    """Share of the real edge slots of ``prob`` that the epoch's tile
    blocks count as heavy pairs under ``hybrid``: no piece covers them and
    their two rows need more than ``_HEAVY_WORK`` compares, so a whole
    block counts each (``tile_count`` of csrc/pair_intersect.cuh)."""
    return count_runs(prob).heavy_share


@dataclasses.dataclass
class EpochIndex:
    """The per-epoch index maps of one ``DeviceLCCProblem``, and its run
    table (built once a problem)."""

    deg_ext: torch.Tensor  # [p * (n_loc + 1)] int32; 0 for the phantom rows
    cache_len: torch.Tensor  # [C] int32 valid length of each cache row
    land_len: torch.Tensor  # [NR, p * p * S_max] int32, items [dst, src, slot]
    land_off: torch.Tensor  # [NR, p * p * S_max] int64, exclusive cumsum
    runs: CountRuns


def epoch_index(prob) -> EpochIndex:
    """The index maps of ``prob`` on its device: one gather of the pulled
    degrees through ``serve_idx`` and one ``cumsum``; no host sync once the
    problem's run table is built (``count_runs``, first, so its temporaries
    come before the maps')."""
    p, n_loc, nr, s_max = prob.p, prob.n_loc, prob.n_rounds, prob.s_max
    dev = prob.device
    runs = count_runs(prob)
    deg_ext = torch.cat(
        [prob.degrees, prob.degrees.new_zeros((p, 1))], dim=1).reshape(-1)
    cache_len = (prob.cache_rows < prob.sentinel).sum(-1, dtype=torch.int32)
    src_base = torch.arange(p, device=dev, dtype=torch.int64) * (n_loc + 1)
    # serve_idx [src, NR, dst, S] -> [NR, dst, src, S], as global rows
    glob = prob.serve_idx.permute(1, 2, 0, 3).to(torch.int64)
    glob = glob + src_base[None, None, :, None]
    land_len = deg_ext[glob.reshape(nr, p * p * s_max)]
    ends = torch.cumsum(land_len, dim=1)  # int64
    return EpochIndex(deg_ext=deg_ext, cache_len=cache_len,
                      land_len=land_len, land_off=ends - land_len, runs=runs)


def _check(prob, index: EpochIndex, r: int, landing: torch.Tensor) -> None:
    if not 0 <= r < prob.n_rounds:
        raise ValueError(f"round {r} outside [0, {prob.n_rounds})")
    if landing.dtype != torch.int32 or landing.dim() != 1:
        raise ValueError(f"landing must be 1-D int32, got {landing.dtype} "
                         f"{tuple(landing.shape)}")
    if landing.numel() < prob.land_ids:
        raise ValueError(f"landing holds {landing.numel()} ids, a round "
                         f"lands up to {prob.land_ids}")
    dev = prob.device
    for name, t in (("landing", landing), ("land_len", index.land_len),
                    ("land_off", index.land_off)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, problem on {dev}")


def _function(name: str, argtypes):
    fn = getattr(_build.load(_LIB), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _contiguous(prob, index: EpochIndex, *extra) -> None:
    for name, t in (("row_ids", prob.row_ids), ("row_off", prob.row_off),
                    ("serve_idx", prob.serve_idx),
                    ("edge_u", prob.edge_u), ("edge_vc", prob.edge_vc),
                    ("edge_mask", prob.edge_mask),
                    ("cache_rows", prob.cache_rows),
                    ("deg_ext", index.deg_ext), ("cache_len", index.cache_len),
                    ("land_len", index.land_len),
                    ("land_off", index.land_off), *extra):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def epoch_land_ref(prob, index: EpochIndex, r: int,
                   landing: torch.Tensor) -> torch.Tensor:
    """Plain version of ``epoch_land``: one gather of every landed id."""
    p, n_loc, s_max = prob.p, prob.n_loc, prob.s_max
    dev = prob.device
    loc = prob.serve_idx[:, r].permute(1, 0, 2).reshape(-1).to(torch.int64)
    src = torch.arange(p, device=dev, dtype=torch.int64)
    src = src.view(1, p, 1).expand(p, p, s_max).reshape(-1)
    lens = index.land_len[r].to(torch.int64)
    off = index.land_off[r]
    row = torch.repeat_interleave(src * (n_loc + 1) + loc, lens)
    start = torch.repeat_interleave(off, lens)
    col = torch.arange(row.numel(), device=dev, dtype=torch.int64) - start
    # offsets are the exclusive cumsum in item order: the ids fill [0, total)
    landing[: row.numel()] = prob.row_ids[prob.row_off[row] + col]
    return landing


def epoch_land(prob, index: EpochIndex, r: int,
               landing: torch.Tensor) -> torch.Tensor:
    """Land round ``r``'s pulled rows, packed, into ``landing`` (int32, at
    least ``prob.land_ids`` ids, on the problem's device); returns it.
    Launches on the current stream and does not synchronise."""
    _check(prob, index, r, landing)
    dev = prob.device
    if dev.type == "cpu":
        return epoch_land_ref(prob, index, r, landing)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(prob, index, ("landing", landing))
    fn = _function("epoch_land_launch",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        err = fn(prob.row_ids.data_ptr(), prob.row_off.data_ptr(),
                 prob.serve_idx.data_ptr(),
                 index.land_off[r].data_ptr(), index.land_len[r].data_ptr(),
                 landing.data_ptr(), prob.p, prob.n_loc, prob.s_max,
                 prob.n_rounds, r, torch.cuda.current_stream().cuda_stream)
    _launches["epoch_land"] += 1
    if err != 0:
        raise RuntimeError(f"epoch_land kernel launch failed: cudaError {err} "
                           f"(p={prob.p}, S_max={prob.s_max}, round {r})")
    return landing


def _round_slots(prob, r: int):
    """This round's slots of every rank, flattened: (u's global row, v's
    combined index, real) with real = edge_mask and u < n_loc."""
    e_chunk = prob.e_max // prob.n_rounds
    sl = slice(r * e_chunk, (r + 1) * e_chunk)
    dev = prob.device
    base = torch.arange(prob.p, device=dev, dtype=torch.int64)[:, None]
    eu = prob.edge_u[:, sl].to(torch.int64)
    real = prob.edge_mask[:, sl] & (eu < prob.n_loc)
    rank = base.expand(-1, e_chunk)
    return ((eu + base * (prob.n_loc + 1)).reshape(-1),
            prob.edge_vc[:, sl].to(torch.int64).reshape(-1),
            rank.reshape(-1), real.reshape(-1))


def _rows_b(prob, index: EpochIndex, r: int, landing, vc, rank):
    """Padded rows of v (sentinel beyond each valid prefix) and their valid
    lengths, read from the three regions of the combined index."""
    n_loc, c, w = prob.n_loc, prob.cache_rows.shape[0], prob.width
    sent = prob.sentinel
    out = torch.full((vc.numel(), w), sent, dtype=torch.int32,
                     device=vc.device)
    nb = torch.zeros(vc.numel(), dtype=torch.int32, device=vc.device)
    local = vc <= n_loc
    cache = (vc > n_loc) & (vc < n_loc + 1 + c)
    fetched = vc >= n_loc + 1 + c
    g = rank[local] * (n_loc + 1) + vc[local]
    out[local] = prob.padded_rows(g)
    nb[local] = index.deg_ext[g]
    ci = vc[cache] - (n_loc + 1)
    out[cache] = prob.cache_rows[ci]
    nb[cache] = index.cache_len[ci]
    item = rank[fetched] * prob.p * prob.s_max + vc[fetched] - (n_loc + 1 + c)
    off, ln = index.land_off[r][item], index.land_len[r][item]
    col = torch.arange(w, device=vc.device, dtype=torch.int64)
    land = landing if landing.numel() else landing.new_full((1,), sent)
    pos = (off[:, None] + col).clamp(max=land.numel() - 1)
    out[fetched] = torch.where(col < ln[:, None], land[pos], sent)
    nb[fetched] = ln
    return out, nb


def epoch_count_ref(prob, index: EpochIndex, r: int, landing: torch.Tensor,
                    acc: torch.Tensor, *, method: str) -> torch.Tensor:
    """Plain version of ``epoch_count``: the round's real slots in slabs of
    padded rows (at most ``_SLAB_BYTES`` an operand, padded from the store
    slab by slab), counted by
    ``count_bsearch_torch`` (bsearch), ``count_pairwise_torch`` (pairwise)
    or both picked by ``hybrid_merges`` (hybrid), then ``index_add_``."""
    a_row, vc, rank, real = _round_slots(prob, r)
    keep = real.nonzero().reshape(-1)
    a_row, vc, rank = a_row[keep], vc[keep], rank[keep]
    sent = prob.sentinel
    slab = max(1, _SLAB_BYTES // (4 * prob.width))
    for lo in range(0, a_row.numel(), slab):
        a_s = a_row[lo: lo + slab]
        rows_a = prob.padded_rows(a_s)
        rows_b, nb = _rows_b(prob, index, r, landing, vc[lo: lo + slab],
                             rank[lo: lo + slab])
        if method == "bsearch":
            cnt = count_bsearch_torch(rows_a, rows_b, sent)
        elif method == "pairwise":
            cnt = count_pairwise_torch(rows_a, rows_b, sent)
        else:
            cnt = torch.where(hybrid_merges(index.deg_ext[a_s], nb),
                              count_pairwise_torch(rows_a, rows_b, sent),
                              count_bsearch_torch(rows_a, rows_b, sent))
        acc.index_add_(0, a_s, cnt)
    return acc


def epoch_count(prob, index: EpochIndex, r: int, landing: torch.Tensor,
                acc: torch.Tensor, *, method: str) -> torch.Tensor:
    """Add round ``r``'s per-edge counts into ``acc`` (int32 ``[p * (n_loc +
    1)]``, on the problem's device) and return it. ``landing`` holds round
    ``r``'s packed rows (``epoch_land``). Launches on the current stream
    and does not synchronise."""
    if method not in METHOD_CODES:
        raise ValueError(f"method {method!r} not in {tuple(METHOD_CODES)}")
    _check(prob, index, r, landing)
    if acc.dtype != torch.int32 or acc.shape != (prob.p * (prob.n_loc + 1),):
        raise ValueError(f"acc must be int32 [{prob.p * (prob.n_loc + 1)}], "
                         f"got {acc.dtype} {tuple(acc.shape)}")
    dev = prob.device
    if acc.device != dev:
        raise ValueError(f"acc on {acc.device}, problem on {dev}")
    if dev.type == "cpu":
        return epoch_count_ref(prob, index, r, landing, acc, method=method)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(prob, index, ("landing", landing), ("acc", acc))
    lib = _build.load(_LIB)
    fn = _function("epoch_count_launch",
                   [_P, _P, _P, _P, _LL, _P, _I, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _LL, _LL, _I, _I, _I, _P, _P, _I, _P, _LL,
                    _I, _P, _P])
    if lib.epoch_count_tile_slots() != _TILE_SLOTS:
        raise RuntimeError("csrc/epoch_count.cu's tile is not _TILE_SLOTS")
    stage_cap = min(prob.width, _STAGE_IDS, lib.epoch_count_stage_cap())
    runs = index.runs
    p0, p1 = runs.piece_start[r], runs.piece_start[r + 1]
    tiles, n_tiles = None, -1  # -1: every _TILE_SLOTS slots of the round
    if runs.tiles is not None:
        t0 = runs.tile_start[r]
        tiles = runs.tiles.data_ptr() + 8 * t0
        n_tiles = runs.tile_start[r + 1] - t0
    words = bitmap_bytes(prob.sentinel) // 4 if p1 > p0 else 0
    with torch.cuda.device(dev):
        err = fn(prob.row_ids.data_ptr(), prob.row_off.data_ptr(),
                 index.deg_ext.data_ptr(),
                 prob.cache_rows.data_ptr(), prob.cache_rows.shape[-1],
                 index.cache_len.data_ptr(), prob.cache_rows.shape[0],
                 landing.data_ptr(), index.land_off[r].data_ptr(),
                 index.land_len[r].data_ptr(), prob.edge_u.data_ptr(),
                 prob.edge_vc.data_ptr(), prob.edge_mask.data_ptr(), prob.p,
                 prob.n_loc, prob.s_max, prob.e_max,
                 prob.e_max // prob.n_rounds, r, METHOD_CODES[method],
                 stage_cap, runs.piece_e.data_ptr() + 8 * p0,
                 runs.piece_n.data_ptr() + 4 * p0, p1 - p0, tiles, n_tiles,
                 words, acc.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _launches["epoch_count"] += 1
    if err != 0:
        raise RuntimeError(f"epoch_count kernel launch failed: cudaError "
                           f"{err} (p={prob.p}, round {r}, method {method})")
    return acc
