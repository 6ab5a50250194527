"""The SPMD data plane's two device programs: the serve block (B5) and the
pair counts (B6). The hand-written CUDA kernels (``csrc/spmd_plane.cu`` on
``csrc/pair_intersect.cuh``), their wrappers and their plain torch versions.

One execution unit of ``distributed/spmd_runtime.py`` runs both on the
executor's device; the p ranks are the leading axis of every tensor:

  ``serve_block``  B5, the reference's ``_body_serve``: per width rung
                   ``(s_b, w_b)``, the rows each source rank serves each
                   requester, truncated to ``w_b``, moved by the block
                   transpose ``got[dst, src] = to_send[src, dst]`` (the
                   all_to_all on one card), re-padded to W with the sentinel
                   and stacked into the fixed ``[p, f_pad, W]`` fetched block
                   (rows past the rungs all sentinel).
  ``pair_counts``  B6, the reference's ``_body_pairs``: ``|A ∩ B|`` of every
                   worklist position of the unit's ``[p, E_tot]`` list, each
                   side read by its combined index (``< H``: the resident
                   buffer; else the fetched block at ``index - H``), phantom
                   positions (``mask`` False) 0. int32 ``[p, E_tot]``.

The kernel of ``pair_counts`` reads each side's valid prefix by the lengths
``a_len`` / ``b_len``; the plain version follows the reference's math (per
pair bucket ``(e_b, w_p)``: gather from ``[rows | fetched]``, truncate to
``w_p``, ``count_bsearch_torch``, mask) and does not read the lengths. The
two agree because ``w_p`` is at least both widths of every sub-pair of its
bucket (see the note in the ``.cu`` file).

A wrapper launches its kernel for CUDA tensors and takes the plain version
for CPU tensors; the choice follows the tensors' device and nothing else. A
build or launch failure raises. Neither kernel reads anything back to the
host.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.intersect import count_bsearch_torch
from . import _build

__all__ = [
    "launches",
    "reset_launches",
    "serve_block",
    "serve_block_ref",
    "pair_counts",
    "pair_counts_ref",
]

_LIB = "spmd_plane"
_MAX_RUNGS = 8
# ids one gathered side of the plain pair count may hold per slab (256 MB)
_SLAB_IDS = 1 << 26
_launches = {"serve_block": 0, "pair_counts": 0}


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
def _check_pairs(rows, fetched, a_idx, b_idx, a_len, b_len, mask):
    _int32("rows", rows, 3)
    _int32("fetched", fetched, 3)
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("a_len", a_len),
                    ("b_len", b_len)):
        _int32(name, t, 2)
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise TypeError(f"mask: expected 2-D bool, got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    _same_device(rows, fetched=fetched, a_idx=a_idx, b_idx=b_idx,
                 a_len=a_len, b_len=b_len, mask=mask)
    p, _, w = rows.shape
    if fetched.shape[0] != p or fetched.shape[2] != w:
        raise ValueError(f"fetched must be [p, f_pad, W] = [{p}, *, {w}], "
                         f"got {tuple(fetched.shape)}")
    shape = a_idx.shape
    if shape[0] != p:
        raise ValueError(f"worklist must be [p, E_tot] with p = {p}, got "
                         f"{tuple(shape)}")
    for name, t in (("b_idx", b_idx), ("a_len", a_len), ("b_len", b_len),
                    ("mask", mask)):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, a_idx "
                             f"{tuple(shape)}")


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
) -> torch.Tensor:
    """``|A ∩ B|`` of every worklist position, int32 ``[p, E_tot]`` on the
    rows' device. ``a_idx`` / ``b_idx`` are combined indices (``< H``: the
    resident buffer ``rows [p, H, W]``; else ``fetched [p, f_pad, W]`` at
    ``index - H``), ``a_len`` / ``b_len`` the valid lengths, ``mask`` the
    real positions; ``pair_cfg`` the buckets ``(e_b, w_p)`` the plain
    version counts by. Launches on the current stream and does not
    synchronise."""
    pair_cfg = [(int(e), int(wp)) for e, wp in pair_cfg]
    _check_pairs(rows, fetched, a_idx, b_idx, a_len, b_len, mask)
    if sum(e for e, _ in pair_cfg) != a_idx.shape[1]:
        raise ValueError(f"pair buckets {pair_cfg} do not sum to E_tot = "
                         f"{a_idx.shape[1]}")
    if rows.device.type == "cpu":
        return pair_counts_ref(rows, fetched, a_idx, b_idx, a_len, b_len,
                               mask, pair_cfg=pair_cfg, sentinel=sentinel)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    for name, t in (("rows", rows), ("fetched", fetched), ("a_idx", a_idx),
                    ("b_idx", b_idx), ("a_len", a_len), ("b_len", b_len),
                    ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p, h, w = rows.shape
    e_tot = a_idx.shape[1]
    out = torch.empty((p, e_tot), dtype=torch.int32, device=rows.device)
    if out.numel() == 0:
        return out
    fn = _function("spmd_pair_counts_launch",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P])
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), fetched.data_ptr(), a_idx.data_ptr(),
                 b_idx.data_ptr(), a_len.data_ptr(), b_len.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), p, h, fetched.shape[1], w,
                 e_tot, torch.cuda.current_stream().cuda_stream)
    _launches["pair_counts"] += 1
    if err != 0:
        raise RuntimeError(f"pair_counts kernel launch failed: cudaError "
                           f"{err} (p={p}, H={h}, W={w}, E_tot={e_tot})")
    return out
