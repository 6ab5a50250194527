"""The SPMD data plane's device programs: the serve (B5) and the pair counts
(B6). The hand-written CUDA kernels (``csrc/spmd_plane.cu`` on
``csrc/pair_intersect.cuh``), their wrappers and their plain torch versions.

One execution unit of ``distributed/spmd_runtime.py`` runs both on the
executor's device; the p ranks are the leading axis of every tensor. The
fetched row ``f = base(b) + k * s_b + pos`` of requester j (width rung ``b
= (s_b, w_b)``, source rank k, position ``pos``; ``base(b)`` p times the
earlier capacities) is ``rows[k, serve_idx[k, j, off(b) + pos]]``:

  ``serve_landing``       B5 on the executor's path: the valid prefix of
                          every fetched row (its length from ``serve_len``,
                          0 at rung padding) packed into one int32 landing at
                          ``land_off[j, f]``, the exclusive cumsum of the
                          lengths in ``(j, f)`` order, ``[p, f_exact + 1]``.
                          The ids an all_to_all of the valid rows moves. Its
                          kernel launches over ``landing_items``: the rows of
                          nonzero length, in chunks of ``LAND_CHUNK`` ids.
  ``serve_block``         B5 as the reference lays it out, ``_body_serve``:
                          per rung the rows truncated to ``w_b``, moved by
                          the block transpose ``got[dst, src] = to_send[src,
                          dst]``, re-padded to W with the sentinel and
                          stacked into the fixed ``[p, f_pad, W]`` block
                          (rows past the rungs all sentinel). Kept beside
                          the landing as the reference's layout.
  ``pair_counts_landed``  B6 on the executor's path, the reference's
                          ``_body_pairs``: ``|A ∩ B|`` of every worklist
                          position of the unit's ``[p, E_tot]`` list, each
                          side read by its combined index (``< H``: the
                          resident buffer; else the landing at ``land_off[j,
                          index - H]``), phantom positions (``mask`` False)
                          0. int32 ``[p, E_tot]``.
  ``pair_counts``         the same kernel on the ``[p, f_pad, W]`` block.

``unpack_landing`` lays a landing out as the block. The kernel of the pair
counts reads each side's valid prefix by the lengths ``a_len`` / ``b_len``
and launches over the real positions only (``real``: their flat positions
``j * E_tot + e``, ascending, the caller's); the plain version follows the reference's math (per pair bucket
``(e_b, w_p)``: gather from ``[rows | fetched]``, truncate to ``w_p``,
``count_bsearch_torch``, mask) and reads neither. The two agree because
``w_p`` is at least both widths of every sub-pair of its bucket (see the
note in the ``.cu`` file).

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; the choice follows the tensors' device and nothing else. A
build or launch failure raises. No kernel reads anything back to the host.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.intersect import count_bsearch_torch
from . import _build

__all__ = [
    "LAND_CHUNK",
    "flat_spans",
    "landing_items",
    "launches",
    "reset_launches",
    "serve_landing",
    "serve_landing_ref",
    "unpack_landing",
    "serve_block",
    "serve_block_ref",
    "pair_counts_landed",
    "pair_counts_landed_ref",
    "pair_counts",
    "pair_counts_ref",
]

_LIB = "spmd_plane"
_MAX_RUNGS = 8
# ids one warp of the landing kernel copies: a longer row is split in chunks
LAND_CHUNK = 1024
# ids one gathered side of the plain pair count may hold per slab (256 MB)
_SLAB_IDS = 1 << 26
_launches = {"serve_landing": 0, "serve_block": 0, "pair_counts_landed": 0,
             "pair_counts": 0}


def launches() -> dict:
    """Kernel launches per entry point since the last reset."""
    return dict(_launches)


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


def _int32(name: str, t: torch.Tensor, dim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got "
                         f"{tuple(t.shape)}")


def _same_device(ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, rows on {ref.device}")


def _function(name: str, argtypes):
    fn = getattr(_build.load(_LIB), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


def flat_spans(starts: torch.Tensor, lens: torch.Tensor,
               n: int) -> torch.Tensor:
    """The flat positions ``start + c``, ``c < len``, of every span in
    order (``n`` = the sum of ``lens``): one ``repeat_interleave``."""
    lens = lens.reshape(-1).long()
    shift = starts.reshape(-1).long() - (torch.cumsum(lens, 0) - lens)
    return torch.arange(n, device=lens.device) + torch.repeat_interleave(
        shift, lens, output_size=n)


# --------------------------------------------------------- B5: serve_landing
def _landed_rows(serve_idx, serve_len, serve_cfg):
    """Source rank, slot and length of every landed row, ``[p (dst),
    f_exact]`` each, in landing order (``f = base(b) + k * s_b + pos``)."""
    p = serve_idx.shape[0]
    src = torch.arange(p, dtype=torch.int64, device=serve_idx.device)
    ks, slots, lens = [], [], []
    off = 0
    for s_b, _ in serve_cfg:
        cut = slice(off, off + s_b)
        ks.append(src[None, :, None].expand(p, p, s_b).reshape(p, p * s_b))
        slots.append(serve_idx[:, :, cut].transpose(0, 1).reshape(p, p * s_b))
        lens.append(serve_len[:, :, cut].transpose(0, 1).reshape(p, p * s_b))
        off += s_b
    if not ks:
        empty = serve_idx.new_zeros((p, 0))
        return empty.long(), empty, empty
    return torch.cat(ks, 1), torch.cat(slots, 1), torch.cat(lens, 1)


def landing_items(lens: np.ndarray) -> np.ndarray:
    """The landing kernel's work list from the landed lengths ``[p (dst),
    f_exact]`` (host numpy): one ``(j * f_exact + f, chunk)`` int32 pair a
    ``LAND_CHUNK`` ids of every row of nonzero length, ``[n_items, 2]``."""
    lens = np.asarray(lens, np.int64).reshape(-1)
    chunks = -(-lens // LAND_CHUNK)
    rows = np.repeat(np.arange(lens.size, dtype=np.int64), chunks)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    return np.stack([rows, np.arange(rows.size) - first],
                    axis=1).astype(np.int32)


def _check_landing(rows, serve_idx, serve_len, land_off, serve_cfg, n_ids):
    _int32("rows", rows, 3)
    _int32("serve_idx", serve_idx, 3)
    _int32("serve_len", serve_len, 3)
    if land_off.dtype != torch.int64 or land_off.dim() != 2:
        raise TypeError(f"land_off: expected 2-D int64, got {land_off.dtype} "
                        f"{tuple(land_off.shape)}")
    _same_device(rows, serve_idx=serve_idx, serve_len=serve_len,
                 land_off=land_off)
    p, _, w = rows.shape
    if serve_idx.shape[:2] != (p, p) or serve_len.shape != serve_idx.shape:
        raise ValueError(f"serve_idx and serve_len must be [p, p, S_tot] "
                         f"with p = {p}, got {tuple(serve_idx.shape)} and "
                         f"{tuple(serve_len.shape)}")
    if sum(s for s, _ in serve_cfg) != serve_idx.shape[2]:
        raise ValueError(f"rung capacities {serve_cfg} do not sum to "
                         f"S_tot = {serve_idx.shape[2]}")
    if any(s <= 0 or not 0 <= wb <= w for s, wb in serve_cfg):
        raise ValueError(f"bad rung (s_b, w_b) in {serve_cfg} at W = {w}")
    f_exact = p * sum(s for s, _ in serve_cfg)
    if land_off.shape != (p, f_exact + 1):
        raise ValueError(f"land_off must be [p, f_exact + 1] = [{p}, "
                         f"{f_exact + 1}], got {tuple(land_off.shape)}")
    if n_ids < 0:
        raise ValueError(f"n_ids = {n_ids} < 0")


def serve_landing_ref(
    rows: torch.Tensor,
    serve_idx: torch.Tensor,
    serve_len: torch.Tensor,
    land_off: torch.Tensor,
    serve_cfg: Sequence[Tuple[int, int]],
    n_ids: int,
) -> torch.Tensor:
    """Plain version of ``serve_landing``: the flat indices of every valid
    prefix in landing order, then one gather from the flattened buffer
    (``land_off`` is their exclusive cumsum, so it is not read)."""
    _, h, w = rows.shape
    k, slot, lens = _landed_rows(serve_idx, serve_len, serve_cfg)
    src = flat_spans((k * h + slot.long()) * w, lens, int(n_ids))
    return rows.reshape(-1)[src]


def serve_landing(
    rows: torch.Tensor,
    serve_idx: torch.Tensor,
    serve_len: torch.Tensor,
    land_off: torch.Tensor,
    serve_cfg: Sequence[Tuple[int, int]],
    n_ids: int,
    *,
    items: torch.Tensor,
) -> torch.Tensor:
    """The packed landing of one unit: int32 ``[n_ids]`` on the rows'
    device. ``rows`` is the resident buffer ``[p, H, W]``, ``serve_idx`` /
    ``serve_len`` ``[p (src), p (dst), S_tot]`` the slots each rank serves
    each requester and their valid lengths (0 at rung padding; rungs
    concatenated in ladder order), ``land_off`` int64 ``[p (dst), f_exact +
    1]`` the exclusive cumsum of the landed lengths in ``(j, f)`` order
    (``f_exact = p * S_tot``; its last entry is ``n_ids``), ``serve_cfg``
    the rungs' ``(s_b, w_b)``, ``items`` the kernel's work list
    (``landing_items`` of the landed lengths, int32 ``[n_items, 2]``, on
    the rows' device). Launches on the current stream and does not
    synchronise."""
    serve_cfg = [(int(s), int(wb)) for s, wb in serve_cfg]
    n_ids = int(n_ids)
    _check_landing(rows, serve_idx, serve_len, land_off, serve_cfg, n_ids)
    _int32("items", items, 2)
    _same_device(rows, items=items)
    if rows.device.type == "cpu":
        return serve_landing_ref(rows, serve_idx, serve_len, land_off,
                                 serve_cfg, n_ids)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    for name, t in (("rows", rows), ("serve_idx", serve_idx),
                    ("serve_len", serve_len), ("land_off", land_off)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(serve_cfg) > _MAX_RUNGS:
        raise ValueError(f"at most {_MAX_RUNGS} rungs, got {len(serve_cfg)}")
    if items.shape[1] != 2 or not items.is_contiguous():
        raise ValueError(f"items must be contiguous [n_items, 2], got "
                         f"{tuple(items.shape)}")
    p, h, w = rows.shape
    out = torch.empty(n_ids, dtype=torch.int32, device=rows.device)
    if n_ids == 0 or items.shape[0] == 0:
        return out
    n = len(serve_cfg)
    s_b = (ctypes.c_int * max(n, 1))(*[s for s, _ in serve_cfg])
    fn = _function("spmd_serve_landing_launch",
                   [_P, _P, _P, _P, _P, _LL, _I, _P, _I, _I, _I, _I, _I, _I,
                    _IP, _P])
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), serve_idx.data_ptr(), serve_len.data_ptr(),
                 land_off.data_ptr(), items.data_ptr(), items.shape[0],
                 LAND_CHUNK, out.data_ptr(), p, h, w, serve_idx.shape[2],
                 land_off.shape[1] - 1, n, s_b,
                 torch.cuda.current_stream().cuda_stream)
    _launches["serve_landing"] += 1
    if err != 0:
        raise RuntimeError(f"serve_landing kernel launch failed: cudaError "
                           f"{err} (p={p}, H={h}, W={w}, rungs {serve_cfg}, "
                           f"n_ids={n_ids})")
    return out


def unpack_landing(
    landing: torch.Tensor,
    land_off: torch.Tensor,
    w: int,
    sentinel: int,
    f_pad: Optional[int] = None,
) -> torch.Tensor:
    """The landing laid out as the fetched block ``[p, f_pad, W]``: row
    ``(j, f)`` holds its landed ids, then the sentinel (rows past
    ``f_exact`` all sentinel; ``f_pad`` defaults to ``f_exact``)."""
    p, f1 = land_off.shape
    f_exact = f1 - 1
    f_pad = f_exact if f_pad is None else int(f_pad)
    if f_pad < f_exact:
        raise ValueError(f"f_pad = {f_pad} < f_exact = {f_exact}")
    lens = land_off[:, 1:] - land_off[:, :-1]
    if f_exact and int(lens.max()) > w:
        raise ValueError(f"a landed row is longer than W = {w}")
    n = int(lens.sum())
    dev = landing.device
    rows_of = (torch.arange(p, device=dev)[:, None] * f_pad
               + torch.arange(f_exact, device=dev)[None, :])
    block = landing.new_full((p, f_pad, w), sentinel)
    block.view(-1)[flat_spans(rows_of * w, lens, n)] = \
        landing[flat_spans(land_off[:, :-1], lens, n)]
    return block


# ----------------------------------------------------------- B5: serve_block
def _check_serve(rows, serve_idx, serve_cfg, f_pad):
    _int32("rows", rows, 3)
    _int32("serve_idx", serve_idx, 3)
    _same_device(rows, serve_idx=serve_idx)
    p, _, w = rows.shape
    if serve_idx.shape[:2] != (p, p):
        raise ValueError(f"serve_idx must be [p, p, S_tot] with p = {p}, "
                         f"got {tuple(serve_idx.shape)}")
    if sum(s for s, _ in serve_cfg) != serve_idx.shape[2]:
        raise ValueError(f"rung capacities {serve_cfg} do not sum to "
                         f"S_tot = {serve_idx.shape[2]}")
    if any(s <= 0 or not 0 <= wb <= w for s, wb in serve_cfg):
        raise ValueError(f"bad rung (s_b, w_b) in {serve_cfg} at W = {w}")
    if p * sum(s for s, _ in serve_cfg) > f_pad:
        raise ValueError(f"the rungs' {p * sum(s for s, _ in serve_cfg)} "
                         f"rows exceed f_pad = {f_pad}")


def serve_block_ref(
    rows: torch.Tensor,
    serve_idx: torch.Tensor,
    serve_cfg: Sequence[Tuple[int, int]],
    f_pad: int,
    *,
    sentinel: int,
) -> torch.Tensor:
    """Plain version of ``serve_block``: the reference's loop over rungs
    (gather, truncate, transpose, pad to W, concatenate, sentinel tail)."""
    p, _, w = rows.shape
    src = torch.arange(p, device=rows.device)[:, None, None]
    parts = []
    off = 0
    for s_b, w_b in serve_cfg:
        idx = serve_idx[:, :, off: off + s_b].long()  # [src, dst, s_b]
        to_send = rows[..., :w_b][src, idx]  # [src, dst, s_b, w_b]
        got = to_send.transpose(0, 1).reshape(p, p * s_b, w_b)
        if w_b < w:
            got = F.pad(got, (0, w - w_b), value=sentinel)
        parts.append(got)
        off += s_b
    n_rows = sum(part.shape[1] for part in parts)
    parts.append(rows.new_full((p, f_pad - n_rows, w), sentinel))
    return torch.cat(parts, 1)


def serve_block(
    rows: torch.Tensor,
    serve_idx: torch.Tensor,
    serve_cfg: Sequence[Tuple[int, int]],
    f_pad: int,
    *,
    sentinel: int,
) -> torch.Tensor:
    """The ``[p, f_pad, W]`` int32 fetched block of one unit, on the rows'
    device. ``rows`` is the resident buffer ``[p, H, W]``, ``serve_idx``
    ``[p (src), p (dst), S_tot]`` the slots each rank serves each requester
    (rungs concatenated in ladder order), ``serve_cfg`` the rungs' ``(s_b,
    w_b)``. Launches on the current stream and does not synchronise."""
    serve_cfg = [(int(s), int(wb)) for s, wb in serve_cfg]
    _check_serve(rows, serve_idx, serve_cfg, int(f_pad))
    if rows.device.type == "cpu":
        return serve_block_ref(rows, serve_idx, serve_cfg, f_pad,
                               sentinel=sentinel)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if not (rows.is_contiguous() and serve_idx.is_contiguous()):
        raise ValueError("rows and serve_idx must be contiguous")
    if len(serve_cfg) > _MAX_RUNGS:
        raise ValueError(f"at most {_MAX_RUNGS} rungs, got {len(serve_cfg)}")
    p, h, w = rows.shape
    out = torch.empty((p, int(f_pad), w), dtype=torch.int32,
                      device=rows.device)
    if out.numel() == 0:
        return out
    n = len(serve_cfg)
    s_b = (ctypes.c_int * max(n, 1))(*[s for s, _ in serve_cfg])
    w_b = (ctypes.c_int * max(n, 1))(*[wb for _, wb in serve_cfg])
    fn = _function("spmd_serve_block_launch",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _IP, _IP, _I, _P])
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), serve_idx.data_ptr(), out.data_ptr(), p, h,
                 w, serve_idx.shape[2], int(f_pad), n, s_b, w_b,
                 int(sentinel), torch.cuda.current_stream().cuda_stream)
    _launches["serve_block"] += 1
    if err != 0:
        raise RuntimeError(f"serve_block kernel launch failed: cudaError "
                           f"{err} (p={p}, H={h}, W={w}, rungs {serve_cfg}, "
                           f"f_pad={f_pad})")
    return out


# ----------------------------------------------------------- B6: pair_counts
def _check_lists(rows, a_idx, b_idx, a_len, b_len, mask, real):
    _int32("rows", rows, 3)
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("a_len", a_len),
                    ("b_len", b_len)):
        _int32(name, t, 2)
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise TypeError(f"mask: expected 2-D bool, got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    _int32("real", real, 1)
    _same_device(rows, a_idx=a_idx, b_idx=b_idx, a_len=a_len, b_len=b_len,
                 mask=mask, real=real)
    shape = a_idx.shape
    if shape[0] != rows.shape[0]:
        raise ValueError(f"worklist must be [p, E_tot] with p = "
                         f"{rows.shape[0]}, got {tuple(shape)}")
    for name, t in (("b_idx", b_idx), ("a_len", a_len), ("b_len", b_len),
                    ("mask", mask)):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, a_idx "
                             f"{tuple(shape)}")


def _check_pairs(rows, fetched, a_idx, b_idx, a_len, b_len, mask, real):
    _check_lists(rows, a_idx, b_idx, a_len, b_len, mask, real)
    _int32("fetched", fetched, 3)
    _same_device(rows, fetched=fetched)
    p, _, w = rows.shape
    if fetched.shape[0] != p or fetched.shape[2] != w:
        raise ValueError(f"fetched must be [p, f_pad, W] = [{p}, *, {w}], "
                         f"got {tuple(fetched.shape)}")


def _check_buckets(pair_cfg, a_idx):
    if sum(e for e, _ in pair_cfg) != a_idx.shape[1]:
        raise ValueError(f"pair buckets {pair_cfg} do not sum to E_tot = "
                         f"{a_idx.shape[1]}")


def pair_counts_ref(
    rows: torch.Tensor,
    fetched: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    mask: torch.Tensor,
    *,
    pair_cfg: Sequence[Tuple[int, int]],
    sentinel: int,
) -> torch.Tensor:
    """Plain version of ``pair_counts``: the reference's math. Per rank
    and pair bucket ``(e_b, w_p)``: gather both sides from ``[rows |
    fetched]``, truncate to ``w_p``, ``count_bsearch_torch``, zero where
    ``mask`` is False (in slabs of at most ``_SLAB_IDS`` gathered ids a
    side). The lengths are not read."""
    p = rows.shape[0]
    if sum(e for e, _ in pair_cfg) != a_idx.shape[1]:
        raise ValueError(f"pair buckets {list(pair_cfg)} do not sum to "
                         f"E_tot = {a_idx.shape[1]}")
    out = torch.zeros(a_idx.shape, dtype=torch.int32, device=rows.device)
    for j in range(p):
        combined = torch.cat([rows[j], fetched[j]], 0)
        off = 0
        for e_b, w_p in pair_cfg:
            cut = combined[:, :w_p]
            step = max(1, _SLAB_IDS // max(w_p, 1))
            for lo in range(off, off + e_b, step):
                hi = min(off + e_b, lo + step)
                ra = cut[a_idx[j, lo:hi].long()]
                rb = cut[b_idx[j, lo:hi].long()]
                cnt = count_bsearch_torch(ra, rb, sentinel)
                out[j, lo:hi] = torch.where(mask[j, lo:hi], cnt, 0)
            off += e_b
    return out


def _launch_pairs(name, rows, fetched, fetched_off, a_idx, b_idx, a_len,
                  b_len, mask, real):
    """B6's kernel over ``fetched`` (flat ids) at ``fetched_off [p,
    f_cols]``, launched over ``real``."""
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    for t_name, t in (("rows", rows), ("fetched", fetched),
                      ("fetched_off", fetched_off), ("a_idx", a_idx),
                      ("b_idx", b_idx), ("a_len", a_len), ("b_len", b_len),
                      ("real", real)):
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    p, h, w = rows.shape
    e_tot = a_idx.shape[1]
    if p * e_tot >= 1 << 31:
        raise ValueError(f"p * E_tot = {p * e_tot} positions exceed int32")
    out = torch.empty((p, e_tot), dtype=torch.int32, device=rows.device)
    if out.numel() == 0:
        return out
    fn = _function("spmd_pair_counts_launch",
                   [_P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _I,
                    _LL, _I, _P])
    cap = _function("spmd_pair_counts_stage_cap", [])()
    n_real = real.numel()
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), fetched.data_ptr(), fetched_off.data_ptr(),
                 fetched_off.shape[1], a_idx.data_ptr(), b_idx.data_ptr(),
                 a_len.data_ptr(), b_len.data_ptr(), real.data_ptr(), n_real,
                 out.data_ptr(), p, h, w, e_tot, min(w, cap),
                 torch.cuda.current_stream().cuda_stream)
    if n_real:  # no real position: out is zeroed and no kernel launched
        _launches[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"(p={p}, H={h}, W={w}, E_tot={e_tot}, "
                           f"{n_real} real)")
    return out


def pair_counts(
    rows: torch.Tensor,
    fetched: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    mask: torch.Tensor,
    *,
    pair_cfg: Sequence[Tuple[int, int]],
    sentinel: int,
    real: torch.Tensor,
) -> torch.Tensor:
    """``|A ∩ B|`` of every worklist position, int32 ``[p, E_tot]`` on the
    rows' device. ``a_idx`` / ``b_idx`` are combined indices (``< H``: the
    resident buffer ``rows [p, H, W]``; else ``fetched [p, f_pad, W]`` at
    ``index - H``), ``a_len`` / ``b_len`` the valid lengths, ``mask`` the
    real positions and ``real`` their flat positions (int32, ascending:
    ``torch.nonzero`` of the flattened ``mask``); ``pair_cfg`` the buckets
    ``(e_b, w_p)`` the plain version counts by. Launches on the current
    stream and does not synchronise."""
    pair_cfg = [(int(e), int(wp)) for e, wp in pair_cfg]
    _check_pairs(rows, fetched, a_idx, b_idx, a_len, b_len, mask, real)
    _check_buckets(pair_cfg, a_idx)
    if rows.device.type == "cpu":
        return pair_counts_ref(rows, fetched, a_idx, b_idx, a_len, b_len,
                               mask, pair_cfg=pair_cfg, sentinel=sentinel)
    p, f_pad, w = fetched.shape
    offsets = torch.arange(p * f_pad, dtype=torch.int64,
                           device=rows.device).mul_(w).view(p, f_pad)
    return _launch_pairs("pair_counts", rows, fetched, offsets, a_idx, b_idx,
                         a_len, b_len, mask, real)


def _check_landed(rows, landing, land_off):
    _int32("landing", landing, 1)
    if land_off.dtype != torch.int64 or land_off.dim() != 2:
        raise TypeError(f"land_off: expected 2-D int64, got {land_off.dtype} "
                        f"{tuple(land_off.shape)}")
    _same_device(rows, landing=landing, land_off=land_off)
    if land_off.shape[0] != rows.shape[0] or land_off.shape[1] < 1:
        raise ValueError(f"land_off must be [p, f_exact + 1] with p = "
                         f"{rows.shape[0]}, got {tuple(land_off.shape)}")


def pair_counts_landed_ref(
    rows: torch.Tensor,
    landing: torch.Tensor,
    land_off: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    mask: torch.Tensor,
    *,
    pair_cfg: Sequence[Tuple[int, int]],
    sentinel: int,
) -> torch.Tensor:
    """Plain version of ``pair_counts_landed``: the landing unpacked to the
    block (``unpack_landing``), then ``pair_counts_ref``."""
    block = unpack_landing(landing, land_off, rows.shape[2], sentinel)
    return pair_counts_ref(rows, block, a_idx, b_idx, a_len, b_len, mask,
                           pair_cfg=pair_cfg, sentinel=sentinel)


def pair_counts_landed(
    rows: torch.Tensor,
    landing: torch.Tensor,
    land_off: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    a_len: torch.Tensor,
    b_len: torch.Tensor,
    mask: torch.Tensor,
    *,
    pair_cfg: Sequence[Tuple[int, int]],
    sentinel: int,
    real: torch.Tensor,
) -> torch.Tensor:
    """``pair_counts`` with the fetched rows read from the packed landing
    of ``serve_landing``: a combined index ``>= H`` reads ``landing[
    land_off[j, index - H]:]`` over its valid length. int32 ``[p, E_tot]``
    on the rows' device; launches on the current stream and does not
    synchronise."""
    pair_cfg = [(int(e), int(wp)) for e, wp in pair_cfg]
    _check_lists(rows, a_idx, b_idx, a_len, b_len, mask, real)
    _check_landed(rows, landing, land_off)
    _check_buckets(pair_cfg, a_idx)
    if rows.device.type == "cpu":
        return pair_counts_landed_ref(rows, landing, land_off, a_idx, b_idx,
                                      a_len, b_len, mask, pair_cfg=pair_cfg,
                                      sentinel=sentinel)
    return _launch_pairs("pair_counts_landed", rows, landing, land_off, a_idx,
                         b_idx, a_len, b_len, mask, real)
