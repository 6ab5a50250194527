"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics and the breakdown read.

The window is the CPU range of the harness's ``gpubench.window`` annotation.
Inside it:

- ``busy_s``: the union of the device's activity (kernels, copies, sets),
  in seconds; idle is the rest of the window;
- ``device_seconds(kernel)``: the summed device time of the kernels whose
  function is named ``kernel`` (namespaces, template and parameter lists
  aside: ``(anonymous namespace)::epoch_count_kernel(CountArgs)`` is
  ``epoch_count_kernel``);
- ``device_ops``: device time summed by name, largest first;
- ``idle_gaps``: the idle time summed by what the host was doing during each
  gap (the innermost host operation, on the harness's thread, that covers the
  gap's midpoint), largest first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["DeviceTrace", "function_name", "reduce", "WINDOW", "STEP"]

WINDOW = "gpubench.window"
STEP = "gpubench.step"
_NAME_CHARS = 96


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_by_name: Dict[str, float]
    idle_by_host: Dict[str, float]

    def device_seconds(self, kernel: str) -> float:
        return sum(s for n, s in self.device_by_name.items()
                   if function_name(n) == kernel)

    @staticmethod
    def top(d: Dict[str, float], k: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:k]]


def function_name(name: str) -> str:
    """The bare function name of a demangled kernel name."""
    head = name.split("(", 1)[0] if not name.startswith("(") else \
        name.split(")::", 1)[-1].split("(", 1)[0]
    return head.split("<", 1)[0].rsplit("::", 1)[-1].strip().rsplit(" ", 1)[-1]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(host: List[Tuple[float, float, str]], points: List[float],
               fallback: str) -> List[str]:
    """For each point (sorted), the name of the innermost host range that
    covers it; ranges of one thread nest, so a stack sweep finds it."""
    names: List[str] = []
    stack: List[Tuple[float, float, str]] = []
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    i = 0
    for x in points:
        while i < len(host) and host[i][0] <= x:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        names.append(stack[-1][2] if stack else fallback)
    return names


def reduce(events) -> DeviceTrace:
    """``events``: the profiler's ``prof.events()`` (times in microseconds)."""
    from torch.autograd import DeviceType

    windows = [e for e in events
               if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"no {WINDOW!r} range in the trace")
    win = windows[0]
    w0, w1 = win.time_range.start, win.time_range.end
    device: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    host: List[Tuple[float, float, str]] = []
    for e in events:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        if e.device_type == DeviceType.CPU:
            if e.thread == win.thread and e.name != WINDOW:
                host.append((a, b, e.name[:_NAME_CHARS]))
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("gpubench.")):
            device.append((a, b))
            name = e.name[:_NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(device)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    idle: Dict[str, float] = {}
    for name, (_, length) in zip(
            _innermost(host, [m for m, _ in mids], WINDOW), mids):
        idle[name] = idle.get(name, 0.0) + length * 1e-6
    return DeviceTrace(window_s=(w1 - w0) * 1e-6,
                       busy_s=sum(b - a for a, b in busy) * 1e-6,
                       device_by_name=by_name, idle_by_host=idle)

