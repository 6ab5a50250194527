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
                   added into ``acc[rank, u]``: u's row from ``rows_ext``, v's
                   by its combined index from ``rows_ext`` (``[0, n_loc]``),
                   the cache rows (``[n_loc+1, n_loc+1+C)``) or the landing
                   (the rest), each with its valid length; phantom slots add
                   nothing and ``acc[rank, n_loc]`` is never touched.
                   ``method`` picks the strategy per pair: ``bsearch``
                   searches, ``pairwise`` merges, ``hybrid`` merges iff
                   ``na + nb <= ns * ceil(log2(nl + 1))`` (``hybrid_merges``).

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; the choice follows the tensors' device and nothing else. A
build or launch failure raises. Neither kernel reads anything back to the
host, so a round enqueues without a synchronisation.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.intersect import count_bsearch_torch, count_pairwise_torch
from . import _build

__all__ = [
    "EpochIndex",
    "epoch_index",
    "epoch_land",
    "epoch_land_ref",
    "epoch_count",
    "epoch_count_ref",
    "hybrid_merges",
    "launches",
    "reset_launches",
]

_LIB = "epoch_count"
METHOD_CODES = {"bsearch": 0, "pairwise": 1, "hybrid": 2}
# most bytes one padded operand of the plain count may take per slab
_SLAB_BYTES = 2 << 30
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
class EpochIndex:
    """The per-epoch index maps of one ``DeviceLCCProblem``."""

    deg_ext: torch.Tensor  # [p * (n_loc + 1)] int32; 0 for the phantom rows
    cache_len: torch.Tensor  # [C] int32 valid length of each cache row
    land_len: torch.Tensor  # [NR, p * p * S_max] int32, items [dst, src, slot]
    land_off: torch.Tensor  # [NR, p * p * S_max] int64, exclusive cumsum


def epoch_index(prob) -> EpochIndex:
    """The index maps of ``prob`` on its device: one gather of the pulled
    degrees through ``serve_idx`` and one ``cumsum``; no host sync."""
    p, n_loc, nr, s_max = prob.p, prob.n_loc, prob.n_rounds, prob.s_max
    dev = prob.rows_ext.device
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
                      land_len=land_len, land_off=ends - land_len)


def _rows_flat(prob) -> torch.Tensor:
    return prob.rows_ext.view(prob.p * (prob.n_loc + 1), -1)


def _check(prob, index: EpochIndex, r: int, landing: torch.Tensor) -> None:
    if not 0 <= r < prob.n_rounds:
        raise ValueError(f"round {r} outside [0, {prob.n_rounds})")
    if landing.dtype != torch.int32 or landing.dim() != 1:
        raise ValueError(f"landing must be 1-D int32, got {landing.dtype} "
                         f"{tuple(landing.shape)}")
    if landing.numel() < prob.land_ids:
        raise ValueError(f"landing holds {landing.numel()} ids, a round "
                         f"lands up to {prob.land_ids}")
    dev = prob.rows_ext.device
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
    for name, t in (("rows_ext", prob.rows_ext), ("serve_idx", prob.serve_idx),
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
    dev = prob.rows_ext.device
    loc = prob.serve_idx[:, r].permute(1, 0, 2).reshape(-1).to(torch.int64)
    src = torch.arange(p, device=dev, dtype=torch.int64)
    src = src.view(1, p, 1).expand(p, p, s_max).reshape(-1)
    lens = index.land_len[r].to(torch.int64)
    off = index.land_off[r]
    row = torch.repeat_interleave(src * (n_loc + 1) + loc, lens)
    start = torch.repeat_interleave(off, lens)
    col = torch.arange(row.numel(), device=dev, dtype=torch.int64) - start
    # offsets are the exclusive cumsum in item order: the ids fill [0, total)
    landing[: row.numel()] = _rows_flat(prob)[row, col]
    return landing


def epoch_land(prob, index: EpochIndex, r: int,
               landing: torch.Tensor) -> torch.Tensor:
    """Land round ``r``'s pulled rows, packed, into ``landing`` (int32, at
    least ``prob.land_ids`` ids, on the problem's device); returns it.
    Launches on the current stream and does not synchronise."""
    _check(prob, index, r, landing)
    dev = prob.rows_ext.device
    if dev.type == "cpu":
        return epoch_land_ref(prob, index, r, landing)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(prob, index, ("landing", landing))
    fn = _function("epoch_land_launch",
                   [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    w = prob.rows_ext.shape[-1]
    with torch.cuda.device(dev):
        err = fn(prob.rows_ext.data_ptr(), w, prob.serve_idx.data_ptr(),
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
    dev = prob.rows_ext.device
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
    n_loc, c, w = prob.n_loc, prob.cache_rows.shape[0], prob.rows_ext.shape[-1]
    sent = prob.sentinel
    out = torch.full((vc.numel(), w), sent, dtype=torch.int32,
                     device=vc.device)
    nb = torch.zeros(vc.numel(), dtype=torch.int32, device=vc.device)
    local = vc <= n_loc
    cache = (vc > n_loc) & (vc < n_loc + 1 + c)
    fetched = vc >= n_loc + 1 + c
    g = rank[local] * (n_loc + 1) + vc[local]
    out[local] = _rows_flat(prob)[g]
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
    padded rows (at most ``_SLAB_BYTES`` an operand), counted by
    ``count_bsearch_torch`` (bsearch), ``count_pairwise_torch`` (pairwise)
    or both picked by ``hybrid_merges`` (hybrid), then ``index_add_``."""
    a_row, vc, rank, real = _round_slots(prob, r)
    keep = real.nonzero().reshape(-1)
    a_row, vc, rank = a_row[keep], vc[keep], rank[keep]
    rows_flat, sent = _rows_flat(prob), prob.sentinel
    slab = max(1, _SLAB_BYTES // (4 * rows_flat.shape[-1]))
    for lo in range(0, a_row.numel(), slab):
        a_s = a_row[lo: lo + slab]
        rows_a = rows_flat[a_s]
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
    dev = prob.rows_ext.device
    if acc.device != dev:
        raise ValueError(f"acc on {acc.device}, problem on {dev}")
    if dev.type == "cpu":
        return epoch_count_ref(prob, index, r, landing, acc, method=method)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(prob, index, ("landing", landing), ("acc", acc))
    lib = _build.load(_LIB)
    fn = _function("epoch_count_launch",
                   [_P, _LL, _P, _P, _LL, _P, _I, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _LL, _LL, _I, _I, _I, _P, _P])
    w = prob.rows_ext.shape[-1]
    stage_cap = min(w, lib.epoch_count_stage_cap())
    with torch.cuda.device(dev):
        err = fn(prob.rows_ext.data_ptr(), w, index.deg_ext.data_ptr(),
                 prob.cache_rows.data_ptr(), prob.cache_rows.shape[-1],
                 index.cache_len.data_ptr(), prob.cache_rows.shape[0],
                 landing.data_ptr(), index.land_off[r].data_ptr(),
                 index.land_len[r].data_ptr(), prob.edge_u.data_ptr(),
                 prob.edge_vc.data_ptr(), prob.edge_mask.data_ptr(), prob.p,
                 prob.n_loc, prob.s_max, prob.e_max,
                 prob.e_max // prob.n_rounds, r, METHOD_CODES[method],
                 stage_cap, acc.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _launches["epoch_count"] += 1
    if err != 0:
        raise RuntimeError(f"epoch_count kernel launch failed: cudaError "
                           f"{err} (p={prob.p}, round {r}, method {method})")
    return acc
