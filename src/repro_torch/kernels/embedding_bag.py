"""EmbeddingBag (gather + masked reduce): the hand-written CUDA kernel
(``csrc/embedding_bag.cu``, B10), its wrapper and its plain torch version.

The recsys pooling primitive (``models/recsys/embedding.py::bag_fixed``
computes its function):

  in:   table [N, D] fp32, bf16 or fp16; ids [B, L] int32 or int64; mask
        [B, L] bool
  out:  pooled [B, D] f32, pooled[b] = sum_l w[b, l] * table[ids[b, l]],
        w = mask (``sum``) or mask / max(sum(mask), 1) (``mean``)

As ``jnp.take`` does in the reference's oracle, a negative id counts from
the end of the table and an id outside ``[-N, N)`` contributes NaN, masked
or not. ``embedding_bag`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — the choice follows the tensors' device and
nothing else. The kernel reads the ids and the mask as given (one launch a
call, no ``[B, L]`` tensor made); ``geometry`` lays the launch out from the
shapes and the SM count. Any B is accepted (the reference needs a multiple
of ``block_b``, dropped here with ``interpret``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

__all__ = [
    "embedding_bag",
    "embedding_bag_ref",
    "launches",
    "reset_launches",
]

_LIB = "embedding_bag"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KWARPS = 8  # warps a block (kWarps in the source)
FILL_WARPS_PER_SM = 32  # a batch that gives fewer warps an SM is spread
MIN_STEPS = 4  # positions a group walks at the least when a bag is spread
MAX_TILE = 256  # positions of a bag staged at a time
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def _bag_weights(mask: torch.Tensor, mode: str) -> torch.Tensor:
    """The per-position weights of the reference wrapper, fp32 ``[B, L]``."""
    w = mask.to(torch.float32)
    if mode == "mean":
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    elif mode != "sum":
        raise ValueError(mode)
    return w


def _check(table, ids, mask) -> None:
    for name, t in (("table", table), ("ids", ids), ("mask", mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise TypeError(f"table: expected [N, D] float32/bfloat16/float16, "
                        f"got {table.dtype} {tuple(table.shape)}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 2:
        raise TypeError(f"ids: expected int32 [B, L], got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if mask.dtype != torch.bool or mask.shape != ids.shape:
        raise TypeError(f"mask: expected bool {tuple(ids.shape)}, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if not table.device == ids.device == mask.device:
        raise ValueError(f"devices differ: {table.device}, {ids.device}, "
                         f"{mask.device}")


def embedding_bag_ref(table, ids, mask, *, mode="sum"):
    """Plain torch version: gather ``[B, L, D]`` in fp32, weight, sum."""
    _check(table, ids, mask)
    w = _bag_weights(mask, mode)
    n = table.shape[0]
    ids = torch.where(ids < 0, ids.long() + n, ids.long())
    ok = (ids >= 0) & (ids < n)
    emb = table[torch.where(ok, ids, 0)].to(torch.float32)
    emb = torch.where(ok[..., None], emb, float("nan"))
    return (emb * w[..., None]).sum(dim=1)


def _function():
    fn = _build.load(_LIB).embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel lays one call out (``csrc/embedding_bag.cu``)."""

    vb: int  # bytes a lane loads at once (a chunk)
    ve: int  # elements of a chunk
    chunks: int  # chunks of a row
    lpr: int  # lanes on one row, a chunk each (a piece of the row)
    gpw: int  # groups of ``lpr`` lanes a warp: rows in flight a step
    wpb: int  # warps on one bag: 1, or the whole block (KWARPS)
    tile: int  # positions of a bag staged in shared memory at a time
    units: int  # bags a block (KWARPS // wpb)
    blocks: int
    smem: int  # dynamic shared memory a block, bytes

    @property
    def groups(self) -> int:
        """Position groups of a bag: group k takes positions k, k + groups,
        ..."""
        return self.wpb * self.gpw

    def lane(self, lane: int, piece: int):
        """(group within the bag's warp, chunk) that ``lane`` loads in the
        row's ``piece``-th pass, as the kernel computes them; None for a
        lane that loads nothing there."""
        grp, sub = divmod(lane, self.lpr)
        c = piece * self.lpr + sub
        return (grp, c) if grp < self.gpw and c < self.chunks else None

    @property
    def pieces(self) -> int:
        """Passes over a row: ``lpr`` chunks each."""
        return -(-self.chunks // self.lpr)

    @property
    def unroll(self) -> int:
        """Rows a lane loads before their FMAs (``unroll`` in the source)."""
        return 2 if self.ve >= 8 else 4 if self.ve >= 4 else 8

    def positions(self, k: int, l: int):
        """The staged positions of an ``l``-long bag that group ``k`` adds,
        in the kernel's order: ``k``, ``k + groups``, ... of each tile
        (positions whose id is out of range are dropped when they are
        staged; the rest keep this order)."""
        for l0 in range(0, l, self.tile):
            yield from range(l0 + k, l0 + min(self.tile, l - l0),
                             self.groups)


def load_bytes(row_bytes: int, elem: int, ptr: int) -> int:
    """Widest load (bytes) that divides a row and the table's alignment."""
    for vb in (16, 8, 4, 2):
        if vb >= elem and row_bytes % vb == 0 and ptr % vb == 0:
            return vb
    raise AssertionError("unreachable: a row is a whole number of elements")


def unit_bytes(tile: int, groups: int, piece: int) -> int:
    """Shared memory of one bag (``unit_bytes`` in the source): its staged
    rows, 8 bytes each, its groups' partial sums and two ints, to 16
    bytes."""
    b = tile * 8 + groups * piece * 4 + 8
    return -(-b // 16) * 16


def geometry(b: int, l: int, d: int, elem: int, n_sm: int,
             ptr: int = 0) -> Geometry:
    """The launch of a call on ``b`` bags of ``l`` positions over rows of
    ``d`` elements of ``elem`` bytes (table at address ``ptr``) on a card
    of ``n_sm`` SMs.

    One row takes ``lpr = min(chunks, 32)`` lanes and a warp holds
    ``32 // lpr`` such groups (3 of 9 lanes at D = 18 fp32). A bag takes a
    whole block of ``KWARPS`` warps when one warp a bag would give the card
    fewer than ``FILL_WARPS_PER_SM`` warps an SM even spread, and each group
    still walks ``MIN_STEPS`` positions or more: the served batch (512 x
    100, D = 18) gets 8 warps a bag, serve_bulk (262,144 bags) one."""
    vb = load_bytes(d * elem, elem, ptr)
    ve = vb // elem
    chunks = d // ve
    lpr = min(chunks, 32)
    gpw = 32 // lpr
    spread = (b * KWARPS <= n_sm * FILL_WARPS_PER_SM
              and KWARPS * gpw * MIN_STEPS <= l)
    wpb = KWARPS if spread else 1
    tile = min(-(-max(l, 1) // 32) * 32, MAX_TILE)
    units = KWARPS // wpb
    smem = units * unit_bytes(tile, wpb * gpw, lpr * ve)
    return Geometry(vb, ve, chunks, lpr, gpw, wpb, tile, units,
                    -(-b // units), smem)


def embedding_bag(table, ids, mask, *, mode="sum"):
    """Pooled bags, fp32 ``[B, D]`` on the tensors' device. Launches on the
    current stream and does not synchronise."""
    _check(table, ids, mask)
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mask, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n, d = table.shape
    b, l = ids.shape
    if table.stride() != (d, 1):
        raise ValueError("table must be contiguous")
    ids, mask = ids.contiguous(), mask.contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    n_sm = torch.cuda.get_device_properties(table.device).multi_processor_count
    geo = geometry(b, l, d, table.element_size(), n_sm, table.data_ptr())
    fn = _function()
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            DTYPES[table.dtype], ids.element_size(), geo.vb, n, b, l, d,
            int(mode == "mean"), geo.lpr, geo.gpw, geo.wpb, geo.tile,
            geo.blocks, geo.smem, torch.cuda.current_stream().cuda_stream,
        )
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: cudaError {err} "
            f"(table {tuple(table.shape)} {table.dtype}, ids {(b, l)} "
            f"{ids.dtype}, {geo})"
        )
    return out
