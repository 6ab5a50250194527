"""Segment sum over sorted segment ids: the hand-written CUDA kernel
(``csrc/segment_sum_sorted.cu``, B9), its wrapper and its plain torch
version.

The GNN message-passing reduction (``models/gnn/common.py::segment_sum``
computes its function; the edges are sorted by destination once per batch):

  in:   values [E, ...] fp32; seg_ids [E] int32 or int64, ascending,
        padding id N
  out:  [N, ...] fp32, out[n] = sum of values[e] over e with seg_ids[e] == n

Ids outside ``[0, N)`` are dropped, as ``jax.ops.segment_sum`` drops them.
The kernel is exact for any order of ids (one atomic per maximal run of
equal adjacent ids in a warp's run); sorted ids make it cheap.
``segment_sum_sorted`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — the choice follows the tensors' device and
nothing else. The kernel reads int32 ids (int64 ids are narrowed first,
those outside ``[0, N)`` to -1) and takes fp32 values only (every GNN
config is fp32); on the CPU the plain version also
takes float64, so that the gradient can be checked with ``gradcheck``.
``geometry`` lays the launch out from E, D, N and the SM count. Any E is
accepted (the reference needs a multiple of ``block_e``, dropped here with
``rows`` and ``interpret``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build

__all__ = [
    "segment_sum_sorted",
    "segment_sum_sorted_ref",
    "launches",
    "reset_launches",
]

_LIB = "segment_sum_sorted"
KWARPS = 8  # warps a block (kWarps in the source)
FILL_WARPS_PER_SM = 32  # warps an SM that the runs are cut short to give
RUN_SEGMENTS = 4  # a run spans at least this many average segments (E / N)
MAX_STEPS = 256  # edges a lane group walks at the most
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def _check(values, seg_ids, num_segments) -> None:
    for name, t in (("values", values), ("seg_ids", seg_ids)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if values.dim() < 1 or not values.dtype.is_floating_point:
        raise TypeError(f"values: expected a float [E, ...] tensor, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if (seg_ids.dtype not in (torch.int32, torch.int64)
            or seg_ids.shape != values.shape[:1]):
        raise TypeError(f"seg_ids: expected int32 {tuple(values.shape[:1])}, "
                        f"got {seg_ids.dtype} {tuple(seg_ids.shape)}")
    if values.device != seg_ids.device:
        raise ValueError(f"devices differ: {values.device}, {seg_ids.device}")
    if int(num_segments) < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


def segment_sum_sorted_ref(values, seg_ids, *, num_segments: int):
    """Plain torch version: ``index_add_`` of the rows whose id lies in
    ``[0, N)`` into zeros, in the values' dtype (fp32 on the path)."""
    _check(values, seg_ids, num_segments)
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids[ok].long(), values[ok])


def _function():
    fn = _build.load(_LIB).segment_sum_sorted_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel lays one call out (``csrc/segment_sum_sorted.cu``)."""

    vec: int  # floats a load (a chunk)
    chunks: int  # chunks of a row
    pieces: int  # pieces of a row, a warp each
    lpr: int  # lanes on one piece, a chunk each (a lane group)
    groups: int  # lane groups a warp, each on its own edges
    steps: int  # consecutive edges a group walks
    warps: int  # runs x pieces
    blocks: int

    @property
    def run(self) -> int:
        """Edges of a warp's run: ``groups`` x ``steps``."""
        return self.groups * self.steps

    def edges(self, run: int, group: int, e: int) -> range:
        """The edges of an ``e``-edge call that ``group`` of ``run`` walks,
        in the kernel's order."""
        b = (run * self.groups + group) * self.steps
        return range(min(b, e), min(b + self.steps, e))

    def lane(self, lane: int, piece: int):
        """(group, chunk) that ``lane`` of a warp on ``piece`` takes, as the
        kernel computes them; None for a lane that loads no chunk."""
        k, sub = divmod(lane, self.lpr)
        c = piece * self.lpr + sub
        return (k, c) if k < self.groups and c < self.chunks else None


def load_floats(d: int, ptr: int) -> int:
    """Floats a load: the widest of 4, 2, 1 that divides a row and the
    values' alignment."""
    for vec in (4, 2):
        if d % vec == 0 and ptr % (4 * vec) == 0:
            return vec
    return 1


def geometry(e: int, d: int, n: int, n_sm: int, ptr: int = 0) -> Geometry:
    """The launch of a call on ``e`` rows of ``d`` floats (at address
    ``ptr``) into ``n`` segments on a card of ``n_sm`` SMs.

    A row of ``chunks`` chunks takes ``lpr`` lanes: all of it up to 32
    chunks, else ``pieces`` equal pieces of at most 32; a warp holds
    ``groups = 32 // lpr`` groups. Each group walks ``steps`` edges: as
    many as give the card about ``FILL_WARPS_PER_SM`` warps an SM, but a
    run spans at least ``RUN_SEGMENTS`` average segments (so the runs' ends
    add at most one flush per ``RUN_SEGMENTS`` segments) and a group walks
    at most ``MAX_STEPS`` edges. MACE's ``[8,192 x 640]`` into 3,840 segments:
    5 pieces, steps 10, 4,100 warps (31 an SM at 132 SMs); ogb_products'
    ``[61,859,140 x 64]``: 2 groups of 16 lanes, steps 256. Cached by
    shape and alignment: the paths call it with the same shapes every
    step."""
    return _geometry(e, d, n, n_sm, ptr % 16)


@functools.lru_cache(maxsize=256)
def _geometry(e: int, d: int, n: int, n_sm: int, align: int) -> Geometry:
    vec = load_floats(d, align)
    chunks = d // vec
    pieces = -(-chunks // 32)
    lpr = -(-chunks // pieces)
    groups = 32 // lpr
    fill = -(-e * pieces // (n_sm * FILL_WARPS_PER_SM * groups))
    keep = -(-RUN_SEGMENTS * e // (max(n, 1) * groups))
    steps = max(1, min(MAX_STEPS, max(fill, keep)))
    warps = -(-e // (groups * steps)) * pieces
    return Geometry(vec, chunks, pieces, lpr, groups, steps, warps,
                    -(-warps // KWARPS))


@functools.lru_cache(maxsize=1024)
def _launch_args(e: int, d: int, n: int, index: int, align: int):
    """(vec, lpr, pieces, steps) of a call on card ``index``: the kernel's
    geometry arguments, one cached lookup a call."""
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    geo = _geometry(e, d, n, n_sm, align)
    return geo.vec, geo.lpr, geo.pieces, geo.steps


def segment_sum_sorted(values, seg_ids, *, num_segments: int):
    """Segment sums ``[N, ...]`` on the tensors' device. Launches on the
    current stream and does not synchronise."""
    _check(values, seg_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_sorted_ref(values, seg_ids,
                                      num_segments=num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"values: the kernel takes float32, got "
                        f"{values.dtype}")
    n = int(num_segments)
    e = values.shape[0]
    rest = tuple(values.shape[1:])
    d = math.prod(rest)
    flat = values.reshape(e, d)
    if flat.stride() != (d, 1):
        flat = flat.contiguous()
    if seg_ids.dtype == torch.int64:  # ids outside [0, N) stay outside
        seg_ids = torch.where((seg_ids >= 0) & (seg_ids < n), seg_ids,
                              -1).to(torch.int32)
    seg_ids = seg_ids.contiguous()
    out = torch.zeros((n, d), dtype=torch.float32, device=values.device)
    if e == 0 or d == 0 or n == 0:
        return out.reshape((n,) + rest)
    ptr = flat.data_ptr()
    vec, lpr, pieces, steps = _launch_args(e, d, n, values.device.index,
                                           ptr % 16)
    fn = _function()
    with torch.cuda.device(values.device):
        err = fn(ptr, seg_ids.data_ptr(), out.data_ptr(), e, d, n, vec, lpr,
                 pieces, steps, torch.cuda.current_stream().cuda_stream)
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"segment_sum_sorted kernel launch failed: cudaError {err} "
            f"(values {tuple(values.shape)}, N {n}, vec {vec}, lpr {lpr}, "
            f"pieces {pieces}, steps {steps})"
        )
    return out.reshape((n,) + rest)
