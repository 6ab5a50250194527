"""Fault-tolerance substrate, the counterpart of
``repro.distributed.fault_tolerance``: restartable training, straggler
detection, restore onto a device.

- ``TrainRunner``: step loop with periodic async checkpoints, bounded
  retry on step exceptions, deterministic data resume (the next step in
  the manifest). A step's time ends when its loss is on the host
  (``float(loss)`` waits for the device, as the reference's
  ``jax.block_until_ready`` does).
- ``StragglerMonitor``: per-step timing stats; flags steps (or devices)
  slower than ``threshold x`` the running median.
- ``elastic_restore``: checkpoint -> tensors on a (possibly different)
  device; the reference re-shards onto a new mesh there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..train.checkpoint import CheckpointManager

__all__ = ["StragglerMonitor", "TrainRunner", "elastic_restore"]


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: deque[float] = deque(maxlen=window)
        self.flagged: list[dict] = []

    def record(self, step: int, dt: float,
               per_device: Optional[Dict[str, float]] = None):
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) >= 8 and dt > self.threshold * med:
            self.flagged.append({"step": step, "dt": dt, "median": med})
        if per_device:
            slow = {
                d: t
                for d, t in per_device.items()
                if t > self.threshold * float(np.median(list(per_device.values())))
            }
            if slow:
                self.flagged.append({"step": step, "devices": slow})

    @property
    def straggler_suspected(self) -> bool:
        return len(self.flagged) > 0


def elastic_restore(ckpt: CheckpointManager, template, device, *, step=None):
    """Restore onto ``device`` (which may differ from the one the
    checkpoint was written from)."""
    return ckpt.restore(template, step=step, device=device)


@dataclasses.dataclass
class TrainRunner:
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    data_fn: Callable[[int], Any]  # step -> batch
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 100
    max_retries: int = 2
    monitor: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)

    def run(self, params, opt_state, *, start_step: int, n_steps: int,
            meta: Optional[dict] = None, async_ckpt: bool = True):
        metrics_log = []
        pending = None
        for step in range(start_step, start_step + n_steps):
            batch = self.data_fn(step)
            t0 = time.perf_counter()
            for attempt in range(self.max_retries + 1):
                try:
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch
                    )
                    break
                except Exception:
                    if attempt == self.max_retries:
                        raise
            loss = float(metrics["loss"])  # waits for the device
            dt = time.perf_counter() - t0
            self.monitor.record(step, dt)
            metrics_log.append({"step": step, "dt": dt, "loss": loss})
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                m = dict(meta or {})
                m["next_step"] = step + 1
                state = {"params": params, "opt_state": opt_state}
                if async_ckpt:
                    if pending is not None:
                        pending.result()  # backpressure: one in flight
                    pending = self.ckpt.save_async(step + 1, state, meta=m)
                else:
                    self.ckpt.save(step + 1, state, meta=m)
        if pending is not None:
            pending.result()
        return params, opt_state, metrics_log
