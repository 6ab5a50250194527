"""Device time of a callable by CUDA events: the statistic every kernel time
of ``chip_smoke.py`` and ``launch/resident_timing.py`` is read with."""
from __future__ import annotations

import torch


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def min_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The lower of two ``cuda_ms`` timings of ``fn`` (``reps`` calls each)."""
    return min(cuda_ms(fn, reps=reps, warmup=warmup),
               cuda_ms(fn, reps=reps, warmup=warmup))
