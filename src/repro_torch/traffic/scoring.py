"""Live workload-driven cache scores: request-frequency EWMA × degree.

The paper's CLaMPI extension argues application-defined scores steering
eviction beat generic LRU — but a *static* degree prior only predicts
reuse when popularity tracks degree. Real request streams drift: a
low-degree vertex a hot query keeps touching deserves cache residency
over a high-degree vertex nobody asks about. The cachescope replay
(``obs/cachescope.py``) already showed a frequency-EWMA score winning
offline on recorded traces; this module deploys that exact estimator
live.

``WorkloadScorer`` maintains, per vertex, the same recency-weighted
access frequency the cachescope ``"ewma"`` replay policy computes —
bit-identical update rule, so the live score path is validated by
replaying the very trace it produced:

    t   — global access counter (one tick per requested vertex)
    f   = 1 + f_prev * decay ** (t - t_prev)      # on access
    f(t)=     f_prev * decay ** (t - t_prev)      # read without access

The deployed score blends frequency with the degree prior::

    score = (1 - blend) * deg / deg_scale + blend * f / f_cap

with ``f_cap = 1 / (1 - decay)`` (the fixed point of the update under
constant access — an always-hot key saturates toward 1). ``blend=0``
degenerates to the pure-degree prior; ``blend=1`` is pure frequency.
The default 0.7 lets frequency dominate while degree still breaks ties
among never-accessed vertices — which matters for ``ResidencyManager``,
whose rebuild only admits rows with score > 0: with ``blend < 1``
every nonzero-degree row keeps a nonzero score before its first access.

The same scorer feeds both tiers: ``cache_score`` per-key for
``ClampiCache`` admission/eviction, ``score_array`` vectorized over all
vertices for ``ResidencyManager`` hot-set selection.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["WorkloadScorer"]


class WorkloadScorer:
    def __init__(self, *, blend: float = 0.7, decay: float = 0.98,
                 deg_scale: Optional[float] = None):
        assert 0.0 <= blend <= 1.0
        assert 0.0 < decay < 1.0
        self.blend = float(blend)
        self.decay = float(decay)
        # f_cap: sum of decay^k — the saturation frequency of a key
        # accessed on every tick
        self.f_cap = 1.0 / (1.0 - self.decay)
        self.deg_scale = float(deg_scale) if deg_scale else 1.0
        self._freq: Dict[int, Tuple[float, int]] = {}  # key -> (f, t)
        self._t = 0
        self.n_observed = 0

    def set_degree_scale(self, max_degree: float) -> None:
        """Normalize the degree term by the graph's max degree so both
        blend terms live in [0, 1]."""
        self.deg_scale = max(1.0, float(max_degree))

    # ---------------- live update path ----------------
    def observe(self, key: int) -> float:
        """One requested vertex: advance the global access clock and
        bump the key's EWMA (cachescope's exact update rule). Returns
        the new frequency."""
        self._t += 1
        self.n_observed += 1
        f_prev, t_prev = self._freq.get(int(key), (0.0, self._t))
        f = 1.0 + f_prev * (self.decay ** (self._t - t_prev))
        self._freq[int(key)] = (f, self._t)
        return f

    def freq(self, key: int) -> float:
        """Current decayed frequency — a read, not an access."""
        f_prev, t_prev = self._freq.get(int(key), (0.0, self._t))
        return f_prev * (self.decay ** (self._t - t_prev))

    # ---------------- score surfaces ----------------
    def cache_score(self, key: int, degree: float) -> float:
        """Blended score for one key (host-cache admission/eviction).
        Call after ``observe(key)`` so the access that triggered the
        fetch is already counted."""
        f_prev, t_prev = self._freq.get(int(key), (0.0, self._t))
        f = f_prev * (self.decay ** (self._t - t_prev))
        return ((1.0 - self.blend) * float(degree) / self.deg_scale
                + self.blend * min(1.0, f / self.f_cap))

    def score_array(self, degrees: np.ndarray) -> np.ndarray:
        """Blended scores for ALL vertices (device-residency rebuild).
        Vectorized: decay every tracked frequency to the current tick,
        scatter into a dense array, blend with the degree prior."""
        deg = np.asarray(degrees, np.float64)
        f = np.zeros(deg.shape[0], np.float64)
        if self._freq:
            keys = np.fromiter(self._freq.keys(), np.int64,
                               count=len(self._freq))
            fs = np.fromiter((v[0] for v in self._freq.values()),
                             np.float64, count=len(self._freq))
            ts = np.fromiter((v[1] for v in self._freq.values()),
                             np.int64, count=len(self._freq))
            live = keys < deg.shape[0]
            f[keys[live]] = fs[live] * (
                self.decay ** (self._t - ts[live]).astype(np.float64)
            )
        return ((1.0 - self.blend) * deg / self.deg_scale
                + self.blend * np.minimum(1.0, f / self.f_cap))

    def reset(self) -> None:
        self._freq.clear()
        self._t = 0
