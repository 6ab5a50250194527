"""Synthetic CTR stream for DIN: Zipf-distributed item ids (the power-law
id popularity that makes the paper's hot-row cache effective), correlated
labels so training is learnable, deterministic per (seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CTRStream"]


@dataclasses.dataclass
class CTRStream:
    n_items: int
    n_cats: int
    batch: int
    seq_len: int = 100
    d_profile: int = 8
    seed: int = 0
    zipf_a: float = 1.3

    def _zipf_ids(self, rng, shape, hi):
        return ((rng.zipf(self.zipf_a, size=shape) - 1) % hi).astype(np.int32)

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed << 32) ^ (step * 2 + 1))
        hist_items = self._zipf_ids(rng, (self.batch, self.seq_len), self.n_items)
        hist_cats = (hist_items % self.n_cats).astype(np.int32)
        lengths = rng.integers(5, self.seq_len + 1, size=self.batch)
        hist_mask = np.arange(self.seq_len)[None, :] < lengths[:, None]
        target_item = self._zipf_ids(rng, (self.batch,), self.n_items)
        target_cat = (target_item % self.n_cats).astype(np.int32)
        profile = rng.normal(size=(self.batch, self.d_profile)).astype(np.float32)
        # label correlates with whether target's category appears in history
        seen = (hist_cats == target_cat[:, None]) & hist_mask
        p = np.where(seen.any(axis=1), 0.75, 0.2)
        label = (rng.random(self.batch) < p).astype(np.float32)
        return {
            "hist_items": hist_items,
            "hist_cats": hist_cats,
            "hist_mask": hist_mask,
            "target_item": target_item,
            "target_cat": target_cat,
            "user_profile": profile,
            "label": label,
        }
