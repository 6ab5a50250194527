"""EmbeddingBag (gather + masked reduce): the hand-written CUDA kernel
(``csrc/embedding_bag.cu``, B10), its wrapper and its plain torch version.

The recsys pooling primitive (``models/recsys/embedding.py::bag_fixed``
computes its function):

  in:   table [N, D] fp32, bf16 or fp16; ids [B, L] int32 (int64 is
        narrowed); mask [B, L] bool
  out:  pooled [B, D] f32, pooled[b] = sum_l w[b, l] * table[ids[b, l]],
        w = mask (``sum``) or mask / max(sum(mask), 1) (``mean``)

As ``jnp.take`` does in the reference's oracle, a negative id counts from
the end of the table and an id outside ``[-N, N)`` contributes NaN. ``embedding_bag`` launches the kernel for CUDA
tensors and takes the plain version for CPU tensors — the choice follows
the tensors' device and nothing else. Any B is accepted (the reference
needs a multiple of ``block_b``, dropped here with ``interpret``).
"""
from __future__ import annotations

import ctypes

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
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _load_bytes(table: torch.Tensor) -> int:
    """Widest load (bytes) that divides a row and the table's alignment."""
    row = table.shape[1] * table.element_size()
    for vb in (16, 8, 4, 2):
        if (vb >= table.element_size() and row % vb == 0
                and table.data_ptr() % vb == 0):
            return vb
    raise AssertionError("unreachable: a row is a whole number of elements")


def embedding_bag(table, ids, mask, *, mode="sum"):
    """Pooled bags, fp32 ``[B, D]`` on the tensors' device. Launches on the
    current stream and does not synchronise."""
    _check(table, ids, mask)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mask, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    w = _bag_weights(mask, mode).contiguous()
    n, d = table.shape
    b, l = ids.shape
    if ids.dtype == torch.int64:  # ids outside [-N, N) stay outside
        ids = torch.where((ids >= -n) & (ids < n), ids,
                          torch.iinfo(torch.int32).min).to(torch.int32)
    if table.stride() != (d, 1):
        raise ValueError("table must be contiguous")
    ids = ids.contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    fn = _function()
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
            DTYPES[table.dtype], _load_bytes(table), n, b, l, d,
            torch.cuda.current_stream().cuda_stream,
        )
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: cudaError {err} "
            f"(table {tuple(table.shape)} {table.dtype}, ids {(b, l)})"
        )
    return out
