"""Operation census of one step on one card, the counterpart of
``repro.launch.hlo_census``.

The reference parses partitioned HLO text for three things: matmul FLOPs
(``_dot_flops``), loop bodies multiplied by their trip counts, and the
bytes of the collectives. The port runs its steps eagerly, so a census
watches the step run instead, on fake tensors (``FakeTensorMode``: shapes,
dtypes and strides, no storage, nothing allocated):

- **FLOPs.** ``torch.utils.flop_counter.FlopCounterMode`` counts every
  matmul, convolution and attention op as it runs, the backward's too;
  ``dot_flops`` is their sum, broken down by op. A loop is counted as it
  runs, so there is no trip count to recover.
- **Memory.** ``OpCensus`` (a dispatch mode) sees every tensor each op
  makes and holds a weak reference to its storage: live bytes rise when a
  storage is made and fall when Python frees it, as the caching
  allocator's ``memory_allocated`` does on the card (each block rounded up
  to 512 bytes). Some CUDA implementations take scratch memory below the
  dispatcher that their meta kernels do not: ``WORKSPACE`` charges it to
  the peak while the op runs.
- **Bytes.** ``bytes_accessed`` sums the inputs and outputs of every op
  that moves data (not views, not ``empty``): the traffic of the unfused
  eager step, each op reading its inputs and writing its outputs once. It
  is not XLA's ``bytes accessed`` of fused HLO. The floor a roofline uses
  is ``bytes_min``, reckoned by the caller from the step's arguments.
- **Collectives.** On one card the only collectives are the SPMD plane's
  block transposes, which ``distributed.spmd_runtime.CollectiveLedger``
  counts already; no HLO parser is ported.

A step that reaches a hand-written kernel would take its plain version on
fake CPU tensors, which is another program (B9's plain version copies the
masked edge values; B8's keeps fp32 score tiles). ``StandIns`` swaps each
for a stand-in of the kernel's signature at the point where the models
look it up (``kernels.ops.flash_attention_gqa``: B8 at ``s >=
cfg.flash_cutoff``; ``kernels.ops.segment_sum_sorted`` under
``models/gnn/common.py::segment_sum``'s autograd Function: B9). A stand-in
returns an empty tensor of the kernel's output shape and dtype and charges
the kernel's own operations and bytes by the formulas of the bound column
of ``PERF.md`` §6. The random fill of ``trunc_normal`` (data-dependent on
fake tensors) becomes a no-op; its buffers are made as on the card. The
swaps hold inside ``StandIns`` only: the main path has no switch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import ops, segment_sum_sorted

__all__ = ["BLOCK", "WORKSPACE", "CachingAllocator", "CardAudit", "OpCensus", "StandIns", "StepCensus",
           "trace", "attention_pairs", "segment_sum_work", "tensor_bytes"]

BLOCK = 512  # the CUDA caching allocator's smallest block and rounding
aten = torch.ops.aten
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.lift_fresh.default}


def _block(nbytes: int) -> int:
    return -(-int(nbytes) // BLOCK) * BLOCK


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _input_bytes(args, out):
    return tensor_bytes(args[0])


def _index_scratch(args, out):
    # int32 indices are widened to int64 first
    return sum(8 * t.numel() for t in args[1]
               if t is not None and t.dtype == torch.int32)


def _index_put_scratch(args, out):
    # accumulate=True sorts the linear indices (int64 keys and positions,
    # cub's double buffers: 48 bytes an index); strided values are copied
    if len(args) < 4 or not args[3]:
        return 0
    n = max((t.numel() for t in args[1] if t is not None), default=0)
    values = args[2]
    return 48 * n + (0 if values.is_contiguous() else tensor_bytes(values))


def _sort_scratch(args, out):
    # cub's radix sort of (key, int64 position) pairs, double-buffered
    return args[0].numel() * (16 + args[0].element_size())


# op -> bytes of scratch its CUDA implementation holds while it runs, from
# (args, out), charged to the peak and to the allocator model, as measured
# op by op on an NVIDIA H100 80GB HBM3 with torch 2.11 (``dryrun.py
# --audit``, which runs a configuration on the card under ``CardAudit``):
# logsumexp exp(x - max) of x's size; softmax's backward one temporary of
# its gradient's size; index with int32 indices and index_put_ with
# accumulate as above; the stable sort of the edges by destination
WORKSPACE: Dict[Any, Callable] = {
    aten.logsumexp.default: _input_bytes,
    aten._softmax_backward_data.default: _input_bytes,
    aten.index.Tensor: _index_scratch,
    aten.index_put.default: _index_put_scratch,
    aten.index_put_.default: _index_put_scratch,
    aten.sort.stable: _sort_scratch,
}


class _Block:
    __slots__ = ("size", "seg", "offset", "prev", "next", "free", "small")

    def __init__(self, size, seg, offset, small):
        self.size, self.seg, self.offset, self.small = size, seg, offset, small
        self.prev = self.next = None
        self.free = True

    def key(self):
        return (self.size, self.seg, self.offset)


class CachingAllocator:
    """A model of PyTorch's CUDA caching allocator at its default settings
    (``c10/cuda/CUDACachingAllocator.cpp``), replayed over a run's
    allocations and frees: requests rounded to 512 bytes; blocks of 1 MB
    or less from 2 MB segments, others from 20 MB segments under 10 MB and
    from segments of their own size rounded to 2 MB above; the smallest
    cached free block that holds a request (its lowest address among
    equals), split when what remains is at least 512 bytes (small) or over
    1 MB (large); freed blocks merged with free neighbours of their
    segment. A segment is taken while the reserved bytes stay within
    ``capacity``; past it the wholly free segments are released and the
    segment asked again, and a request that still does not fit is the
    out-of-memory error the card raises (``oom``, the first such request).
    ``reserved`` and its peak are what ``memory_reserved`` reports."""

    SMALL = 1 << 20
    SMALL_BUFFER = 2 << 20
    LARGE_BUFFER = 20 << 20
    MIN_LARGE_ALLOC = 10 << 20
    ROUND_LARGE = 2 << 20

    def __init__(self, capacity: Optional[int] = None):
        import bisect

        self._bisect = bisect
        self.capacity = capacity
        self.reserved = self.allocated = 0
        self.peak_reserved = self.peak_allocated = 0
        self.oom = None
        self._free = {True: [], False: []}  # small? -> sorted block keys
        self._by_key = {}
        self._live = {}
        self._segments = 0

    def _insert(self, b):
        k = b.key()
        self._bisect.insort(self._free[b.small], k)
        self._by_key[k] = b

    def _remove(self, b):
        lst = self._free[b.small]
        k = b.key()
        del lst[self._bisect.bisect_left(lst, k)]
        del self._by_key[k]

    def _release_cached(self):
        for small in (True, False):
            for k in list(self._free[small]):
                b = self._by_key[k]
                if b.prev is None and b.next is None:
                    self._remove(b)
                    self.reserved -= b.size

    def malloc(self, key, nbytes: int) -> None:
        size = max(_block(nbytes), BLOCK)
        small = size <= self.SMALL
        lst = self._free[small]
        i = self._bisect.bisect_left(lst, (size, -1, -1))
        if i < len(lst):
            b = self._by_key[lst[i]]
            self._remove(b)
        else:
            seg = (self.SMALL_BUFFER if small else self.LARGE_BUFFER
                   if size < self.MIN_LARGE_ALLOC else
                   -(-size // self.ROUND_LARGE) * self.ROUND_LARGE)
            if self.capacity is not None and \
                    self.reserved + seg > self.capacity:
                self._release_cached()
                if self.reserved + seg > self.capacity and self.oom is None:
                    self.oom = {"request": size, "segment": seg,
                                "allocated": self.allocated,
                                "reserved": self.reserved}
            self._segments += 1
            b = _Block(seg, self._segments, 0, small)
            self.reserved += seg
        rest = b.size - size
        if rest >= BLOCK if small else rest > self.SMALL:
            r = _Block(rest, b.seg, b.offset + size, small)
            r.prev, r.next = b, b.next
            if b.next is not None:
                b.next.prev = r
            b.next = r
            b.size = size
            self._insert(r)
        b.free = False
        self.allocated += b.size
        self._live[key] = b
        self.peak_allocated = max(self.peak_allocated, self.allocated)
        self.peak_reserved = max(self.peak_reserved, self.reserved)

    def free(self, key) -> None:
        b = self._live.pop(key)
        self.allocated -= b.size
        b.free = True
        for nb in (b.prev, b.next):
            if nb is not None and nb.free:
                self._remove(nb)
                if nb is b.prev:  # nb absorbs b
                    nb.size += b.size
                    nb.next = b.next
                    if b.next is not None:
                        b.next.prev = nb
                    b = nb
                else:  # b absorbs nb
                    b.size += nb.size
                    b.next = nb.next
                    if nb.next is not None:
                        nb.next.prev = b
        self._insert(b)


class OpCensus(TorchDispatchMode):
    """Live bytes and their peak of every storage the ops make; between
    ``start`` and ``stop`` also the bytes each op reads and writes and the
    storages that were alive at ``start`` (the step's arguments)."""

    def __init__(self, capacity: Optional[int] = None):
        super().__init__()
        self._sizes = WeakIdKeyDictionary()  # storage -> (bytes, key)
        self.allocator = CachingAllocator(capacity)
        self._keys = 0
        self.live = 0
        self.peak = 0
        self.window_peak = 0
        self.counting = False
        self.bytes_accessed = 0.0
        self.ops = 0
        self._at_start = None
        self.segment_peaks: Dict[str, int] = {}

    def _malloc(self, nbytes: int) -> int:
        self._keys += 1
        self.allocator.malloc(self._keys, nbytes)
        return self._keys

    def _free(self, cell) -> None:
        nbytes, key = cell
        self.live -= nbytes
        self.allocator.free(key)

    def _charge(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        nbytes = _block(st.nbytes())
        cell = self._sizes.get(st)
        if cell is not None and cell[0] == nbytes:
            return
        if cell is None:
            cell = [nbytes, self._malloc(nbytes)]
            # the finalizer holds the cell, not the storage
            weakref.finalize(st, self._free, cell)
            self._sizes[st] = cell
            self.live += nbytes
        else:  # resized in place
            self.allocator.free(cell[1])
            self.live += nbytes - cell[0]
            cell[0], cell[1] = nbytes, self._malloc(nbytes)
        self._high(self.live)

    def _high(self, level: int) -> None:
        self.peak = max(self.peak, level)
        self.window_peak = max(self.window_peak, level)
        seg = self._segment()
        self.segment_peaks[seg] = max(self.segment_peaks.get(seg, 0), level)

    def _segment(self) -> str:
        """Which part of the run an op belongs to: the set-up, or the
        step's forward (grad enabled), the backward of one kind of autograd
        node, or work without grad (an optimizer update, serving). Within a
        part the place of the peak does not move with depth, so each
        part's peak is linear in it."""
        if not self.counting:
            return "build"
        node = torch._C._current_autograd_node()
        if node is not None:
            return "backward " + node.name()
        return "forward" if torch.is_grad_enabled() else "no_grad"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._charge(t)
        extra = WORKSPACE.get(func)
        if extra is not None:
            nbytes = _block(extra(args, out))
            self._high(self.live + nbytes)
            self.allocator.free(self._malloc(nbytes))
        # ops that make no tensor (metadata queries) move nothing
        if self.counting and outs and not func.is_view and \
                func not in _NO_TRAFFIC:
            self.ops += 1
            self.bytes_accessed += sum(
                tensor_bytes(t) for t in _tensors((args, kwargs)) + outs)
        return out

    def start(self) -> None:
        """Open the step's window: bytes and ops count from here, the
        window's peak starts at the live bytes, and the live storages are
        the arguments."""
        self.counting = True
        self.window_peak = self.live
        self.segment_peaks["build"] = self.peak
        self._at_start = set(map(id, self._sizes.keys()))
        self.argument_bytes = self.live

    def stop(self, outputs) -> None:
        self.counting = False
        seen = set()
        self.output_bytes = 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) in self._at_start or id(st) in seen:
                continue
            seen.add(id(st))
            self.output_bytes += self._sizes.get(st, (0,))[0]


class CardAudit(OpCensus):
    """``OpCensus`` over real CUDA tensors, op by op beside the caching
    allocator's own counters: the bytes an op held beyond its inputs and
    outputs while it ran (``max_memory_allocated`` within the op, less the
    larger of the allocated bytes before and after it), by op, and the
    largest gap between the allocated bytes and the census's live bytes.
    What ``WORKSPACE`` charges was read with it."""

    def __init__(self, capacity: Optional[int] = None):
        super().__init__(capacity)
        self.base = torch.cuda.memory_allocated()
        self.base_reserved = torch.cuda.memory_reserved()
        self.scratch: Dict[str, dict] = {}
        self.card_peak = self.card_reserved_peak = 0
        self.max_gap = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        self.card_peak = max(self.card_peak, peak - self.base)
        self.card_reserved_peak = max(
            self.card_reserved_peak,
            torch.cuda.memory_reserved() - self.base_reserved)
        held = peak - max(before, after)
        if held > (8 << 20):
            row = self.scratch.setdefault(str(func), {
                "calls": 0, "max_bytes": 0, "input_bytes": 0,
                "input_shapes": None})
            row["calls"] += 1
            if held > row["max_bytes"]:
                ins = _tensors(args)
                row.update(max_bytes=held,
                           input_bytes=sum(map(tensor_bytes, ins)),
                           input_shapes=[list(t.shape) for t in ins[:3]])
        gap = after - self.base - self.live
        if abs(gap) > abs(self.max_gap):
            self.max_gap = gap
        return out


def attention_pairs(s, t, causal, window):
    """Live (query, key) pairs of one head of kernel B8: the causal limit
    and the window counted exactly (``chip_smoke.py``'s ``attention_work``
    in closed form)."""
    if not causal:
        return s * t if window <= 0 else sum(
            max(t - max(i - window + 1, 0), 0) for i in range(s))
    full = min(s, t)
    pairs = full * (full + 1) // 2 + max(s - t, 0) * t
    if window > 0:  # keys older than the window drop out
        k = max(min(s, t) - window, 0)
        pairs -= k * (k + 1) // 2
    return pairs


def segment_sum_work(values, num_segments):
    """(operations, bytes) of kernel B9: one add a value element; the
    values and the int32 ids read once and the output written once."""
    e = values.shape[0]
    row = math.prod(values.shape[1:])
    return (float(e) * row,
            4.0 * e * row + 4.0 * e + 4.0 * num_segments * row)


@dataclasses.dataclass
class KernelCharge:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class StandIns:
    """Within this context, B8 (``ops.flash_attention_gqa``) and B9
    (``ops.segment_sum_sorted``) are shape-only stand-ins that count their
    calls and charge the kernels' own work (``charges``), and
    ``torch.nn.init.trunc_normal_`` fills nothing."""

    def __init__(self):
        self.charges = {"flash_attention": KernelCharge(),
                        "segment_sum_sorted": KernelCharge()}
        self.counting = True

    def _flash(self, q, k, v, *, scale, causal=True, window=0, softcap=0.0):
        b, s, kh, g, dh = q.shape
        t = k.shape[1]
        pairs = attention_pairs(s, t, causal, window) * b * kh * g
        c = self.charges["flash_attention"]
        c.calls += 1
        c.flops += 4.0 * dh * pairs
        c.bytes += (2.0 * s * kh * g * dh + 2.0 * t * kh * dh) * \
            q.element_size() * b
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def _segsum(self, values, seg_ids, *, num_segments):
        ops_, nbytes = segment_sum_work(values, num_segments)
        c = self.charges["segment_sum_sorted"]
        c.calls += 1
        c.flops += ops_
        c.bytes += nbytes
        n = int(num_segments)
        # the wrapper's operands (a contiguous copy of strided values,
        # narrowed ids, the zeroed output), then no launch
        _, _, out = segment_sum_sorted.kernel_operands(values, seg_ids, n)
        return out.reshape((n,) + tuple(values.shape[1:]))

    def __enter__(self):
        self._saved = (ops.flash_attention_gqa, ops.segment_sum_sorted,
                       torch.nn.init.trunc_normal_)
        ops.flash_attention_gqa = self._flash
        ops.segment_sum_sorted = self._segsum
        torch.nn.init.trunc_normal_ = lambda t, *a, **k: t
        return self

    def __exit__(self, *exc):
        (ops.flash_attention_gqa, ops.segment_sum_sorted,
         torch.nn.init.trunc_normal_) = self._saved
        return False

    def reset(self) -> None:
        for c in self.charges.values():
            c.calls, c.flops, c.bytes = 0, 0.0, 0.0


@dataclasses.dataclass
class StepCensus:
    """What one traced step counted. Bytes of memory are the allocator's
    (blocks of 512); ``peak_bytes`` spans the set-up (``build``) and the
    step, ``step_peak_bytes`` the step alone (its arguments included), and
    ``segment_peaks`` splits the peak by ``OpCensus._segment``."""

    argument_bytes: int
    output_bytes: int
    step_peak_bytes: int
    peak_bytes: int
    dot_flops: float
    dot_flops_by_op: Dict[str, float]
    bytes_accessed: float
    ops: int
    kernels: Dict[str, Dict[str, float]]
    segment_peaks: Dict[str, int] = dataclasses.field(default_factory=dict)
    reserved_peak_bytes: int = 0
    oom: Optional[dict] = None
    result: Any = None

    @property
    def temp_bytes(self) -> int:
        return max(self.step_peak_bytes - self.argument_bytes
                   - self.output_bytes, 0)

    @property
    def flops(self) -> float:
        """Matmul FLOPs plus the stand-in kernels' operations (B8's are
        matmul FLOPs too; B9's adds)."""
        return self.dot_flops + sum(k["flops"] for k in self.kernels.values())


def trace(build: Callable[[], tuple], step: Callable, *,
          keep: Optional[Callable] = None,
          capacity: Optional[int] = None) -> StepCensus:
    """``build()`` makes the step's arguments and ``step(*args)`` runs it,
    both on fake tensors under ``StandIns``; returns the step's census,
    its allocations replayed through ``CachingAllocator(capacity)``.
    ``keep(args, out)``, if given, is stored as ``result`` (plain values
    read from the fake tensors' shapes)."""
    with contextlib.ExitStack() as stack:
        stand = stack.enter_context(StandIns())
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        census = stack.enter_context(OpCensus(capacity))
        args = build()
        stand.reset()
        census.start()
        counter = FlopCounterMode(display=False)
        with counter:
            out = step(*args)
        census.stop(out)
        by_op = {str(op): float(n) for op, n in
                 counter.get_flop_counts().get("Global", {}).items()}
        result = keep(args, out) if keep is not None else None
        del out, args
    kernels = {name: dataclasses.asdict(c)
               for name, c in stand.charges.items()}
    return StepCensus(
        argument_bytes=census.argument_bytes,
        output_bytes=census.output_bytes,
        step_peak_bytes=census.window_peak, peak_bytes=census.peak,
        dot_flops=float(sum(by_op.values())),
        dot_flops_by_op=by_op, bytes_accessed=census.bytes_accessed,
        ops=census.ops, kernels=kernels,
        segment_peaks=dict(census.segment_peaks),
        reserved_peak_bytes=census.allocator.peak_reserved,
        oom=census.allocator.oom, result=result)
