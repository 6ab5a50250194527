"""Intersect query rows against device-resident slots: the hand-written CUDA
kernel (``csrc/resident_intersect.cu`` on ``csrc/pair_intersect.cuh``, B3),
its wrappers and its plain torch version.

The device tier (``repro_torch.device.ResidencyManager``) keeps the
degree-scored hot adjacency rows persistently resident in a padded
``[slots, max_width]`` int32 tensor, and the valid length of each slot in
an int32 ``[slots]`` tensor beside it (``lens``). The host intersection
path would gather those rows back to host, re-pack and re-upload them per
call; this kernel reads them where they are:

  in:   residency [S, W] i32 (sorted rows, sentinel-padded), slots_a [E] i32,
        and rows_b [E, WB] i32 (one uploaded side) XOR slots_b [E] i32
        (both sides resident); optionally lengths [S] i32, the valid length
        of each slot (positions at or past it count as invalid)
  out:  counts [E] i32, counts[e] = |residency[slots_a[e]] ∩ B[e]|

Without ``lengths`` the kernel finds each row's valid prefix itself; the
valid prefix of an uploaded ``rows_b`` row is always found in the kernel (a
search of the sentinel over WB), so no lengths are computed or uploaded
for it. Each pair searches the shorter row in the longer. Where the ids fit
the kernel's bitmap (``sentinel <= 2**17``: graphs of fewer than 131,072
vertices), a run of consecutive pairs that share ``slot_a`` may instead be
counted against a bitmap of that row in shared memory, when streaming the
run's rows costs less than searching them. Both give the same integers.

``resident_intersect`` takes tensors and follows their device: the kernel
for CUDA tensors, the plain version (``resident_intersect_ref``: an
``index_select`` of the resident rows, positions past ``lengths`` masked,
then ``intersect_count_ref``) for CPU tensors. ``resident_intersect_counts``
is the ragged-batch entry the streaming engine calls: numpy slots
(range-checked on the host) and query rows, any ``E >= 0``, int64 counts.
The kernel masks the ragged edge, so no pair padding. Each variant keeps
its own launch counter.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .intersect_count import intersect_count_ref

__all__ = [
    "resident_intersect",
    "resident_intersect_counts",
    "resident_intersect_ref",
    "launches",
    "reset_launches",
]

_LIB = "resident_intersect"
VARIANTS = ("vs_rows", "vs_slots")
_launches: Dict[str, int] = dict.fromkeys(VARIANTS, 0)


def launches(variant: Optional[str] = None):
    """Kernel launches of one variant (``"vs_rows"``: one resident side,
    ``"vs_slots"``: both), or a dict of both when ``variant`` is None."""
    if variant is None:
        return dict(_launches)
    return _launches[variant]


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


def _cut(rows: torch.Tensor, lens: torch.Tensor, sentinel: int):
    """``rows`` with every position at or past its row's length set to
    ``sentinel``."""
    cols = torch.arange(rows.shape[1], device=rows.device)
    return torch.where(cols[None, :] < lens[:, None].long(), rows,
                       torch.full_like(rows, sentinel))


def resident_intersect_ref(
    residency: torch.Tensor,
    slots_a: torch.Tensor,
    rows_b: Optional[torch.Tensor] = None,
    *,
    slots_b: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    sentinel: int,
) -> torch.Tensor:
    """Plain torch version: gather the resident rows (each cut to its
    ``lengths`` entry when given), then the plain pairwise intersect.
    ``rows_b`` XOR ``slots_b``."""
    def gather(slots):
        rows = residency.index_select(0, slots.long())
        if lengths is None:
            return rows
        return _cut(rows, lengths.index_select(0, slots.long()), sentinel)

    a = gather(slots_a)
    b = rows_b if slots_b is None else gather(slots_b)
    return intersect_count_ref(a, b, sentinel=sentinel)


def _check(residency, slots_a, rows_b, slots_b, lengths) -> None:
    if (rows_b is None) == (slots_b is None):
        raise ValueError("pass rows_b XOR slots_b")
    named = [("residency", residency, 2), ("slots_a", slots_a, 1)]
    if rows_b is not None:
        named.append(("rows_b", rows_b, 2))
    else:
        named.append(("slots_b", slots_b, 1))
    if lengths is not None:
        named.append(("lengths", lengths, 1))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(
                f"{name}: expected {dim} dims, got {tuple(t.shape)}")
        if t.device != residency.device:
            raise ValueError(
                f"{name} on {t.device}, residency on {residency.device}")
    other = rows_b if rows_b is not None else slots_b
    if other.shape[0] != slots_a.shape[0]:
        raise ValueError(
            f"pair counts differ: {slots_a.shape[0]} vs {other.shape[0]}")
    if lengths is not None and lengths.shape[0] != residency.shape[0]:
        raise ValueError(f"lengths: expected [S={residency.shape[0]}], got "
                         f"{tuple(lengths.shape)}")


def _function():
    fn = _build.load(_LIB).resident_intersect_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def resident_intersect(
    residency: torch.Tensor,
    slots_a: torch.Tensor,
    rows_b: Optional[torch.Tensor] = None,
    *,
    slots_b: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    sentinel: int,
) -> torch.Tensor:
    """``|residency[slots_a[e]] ∩ B[e]|`` per pair, int32 ``[E]`` on the
    residency's device; ``B`` is ``rows_b[e]`` or ``residency[slots_b[e]]``.
    ``lengths`` (int32 ``[S]``, beside the residency) is each slot's valid
    length. Slots must lie in ``[0, S)`` (``resident_intersect_counts``
    checks; the kernel reads an out-of-range slot as an empty row).
    Launches on the current stream and does not synchronise."""
    _check(residency, slots_a, rows_b, slots_b, lengths)
    if residency.device.type == "cpu":
        return resident_intersect_ref(residency, slots_a, rows_b,
                                      slots_b=slots_b, lengths=lengths,
                                      sentinel=sentinel)
    if residency.device.type != "cuda":
        raise ValueError(f"unsupported device {residency.device}")
    operands = [residency, slots_a, rows_b if rows_b is not None else slots_b]
    if lengths is not None:
        operands.append(lengths)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(
            "residency, slots, rows_b and lengths must be contiguous")
    s, w = residency.shape
    e = slots_a.shape[0]
    counts = torch.empty((e,), dtype=torch.int32, device=residency.device)
    if e == 0:
        return counts
    variant = "vs_rows" if slots_b is None else "vs_slots"
    wb = rows_b.shape[1] if rows_b is not None else w
    fn = _function()
    with torch.cuda.device(residency.device):
        err = fn(
            residency.data_ptr(), s, w,
            None if lengths is None else lengths.data_ptr(),
            slots_a.data_ptr(),
            None if slots_b is None else slots_b.data_ptr(),
            None if rows_b is None else rows_b.data_ptr(), wb,
            counts.data_ptr(), e, int(sentinel),
            torch.cuda.current_stream().cuda_stream,
        )
    _launches[variant] += 1
    if err != 0:
        raise RuntimeError(
            f"resident_intersect kernel launch failed: cudaError {err} "
            f"({variant}, S={s}, W={w}, E={e}, WB={wb})"
        )
    return counts


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev`` (``cuda`` without an index means the
    current CUDA device)."""
    if t.device.type != dev.type:
        return False
    if dev.type == "cuda" and dev.index is None:
        return t.device.index == torch.cuda.current_device()
    return dev.index is None or t.device.index == dev.index


def _resident(name, x, dev):
    """A tensor that must already lie on ``dev`` (never copied: the tier's
    tensors stay resident), or numpy, uploaded."""
    if isinstance(x, torch.Tensor):
        if not _on(x, dev):
            raise ValueError(f"{name} lives on {x.device}, not on {dev}")
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)


def resident_intersect_counts(
    residency,  # [S, W] int32: torch tensor (stays put) or numpy (uploaded)
    slots_a: np.ndarray,  # [E] slot indices in [0, S)
    rows_b: Optional[np.ndarray] = None,  # [E, WB] int32 sorted, padded
    *,
    slots_b: Optional[np.ndarray] = None,
    lengths=None,  # [S] int32 valid length per slot, beside the residency
    sentinel: int,
    device="cuda",
) -> np.ndarray:
    """Ragged-friendly wrapper: any E >= 0, returns int64 [E].

    A tensor ``residency`` (or ``lengths``) must already lie on ``device``
    (it is never copied here: the tier's tensors stay resident); a numpy
    one is uploaded. Every slot is checked to lie in ``[0, S)`` and a
    ValueError names the first that does not."""
    if (rows_b is None) == (slots_b is None):
        raise ValueError("pass rows_b XOR slots_b")
    dev = resolve_device(device)
    res = _resident("residency", residency, dev)
    lens = None if lengths is None else _resident("lengths", lengths, dev)
    n_slots = res.shape[0]
    slots = [np.ascontiguousarray(slots_a, np.int64)]
    if slots_b is not None:
        slots.append(np.ascontiguousarray(slots_b, np.int64))
    e = slots[0].shape[0]
    for sl in slots:
        if sl.shape != (e,):
            raise ValueError(f"slot arrays must be [E={e}], got {sl.shape}")
        bad = np.flatnonzero((sl < 0) | (sl >= n_slots))
        if bad.size:
            raise ValueError(
                f"slot {int(sl[bad[0]])} at pair {int(bad[0])} outside "
                f"[0, {n_slots})")
    if e == 0:
        return np.zeros((0,), np.int64)
    t_slots = [torch.from_numpy(sl.astype(np.int32)).to(dev) for sl in slots]
    if slots_b is not None:
        cnt = resident_intersect(res, t_slots[0], slots_b=t_slots[1],
                                 lengths=lens, sentinel=sentinel)
    else:
        rb = np.ascontiguousarray(rows_b, np.int32)
        if rb.ndim != 2 or rb.shape[0] != e:
            raise ValueError(f"rows_b must be [E={e}, WB], got {rb.shape}")
        cnt = resident_intersect(res, t_slots[0], torch.from_numpy(rb).to(dev),
                                 lengths=lens, sentinel=sentinel)
    return cnt.cpu().numpy().astype(np.int64)
