"""Cache-science observability: access traces + analytics for both tiers.

The paper's caching claims (§III-B, Observations 3.1/3.2: degree
predicts reuse; Fig. 7/8: hit rate vs capacity and score policy) are
*why* questions, but ``CacheStats``/``ResidencyStats`` only answer
*what*. This module records the per-access event stream of every cache
instance — host ``ClampiCache`` and device ``ResidencyManager`` — and
turns one recorded run into the full cache-science picture:

1. **Recorder** (``enable_recording``/``disable_recording``): the same
   near-zero-overhead pattern as ``obs.trace`` — each hook in the cache
   hot paths is one module-global load + ``None`` check when disabled.
   Streams are keyed per cache instance and labeled ``(tier, rank,
   label)``; host streams log ``get``/``evict``/``invalidate``/
   ``flush``/``close_epoch`` events (key, size, score at access, hit),
   device streams log lookups and membership changes
   (``reset``/``admit``/``evict``/``patch``).

2. **Reuse-distance analytics** (``reuse_distances``): a one-pass
   Mattson stack-distance computation (Fenwick tree over access
   positions, one counting entries and one counting bytes) yielding,
   from a single run, the LRU hit-rate-vs-capacity curve at *every*
   capacity — what previously took one full run per cache size
   (``bench_cache_size``). Invalidations remove the key from the stack
   (its next access is a compulsory re-miss); flushes clear it. The
   byte-distance curve is exact for ideal LRU at capacities >= the
   largest entry on invalidation-free traces (entry sizes are constant
   between invalidations — the runtime invalidates before any row
   mutation becomes visible); ``spot_checks`` verify it against a
   direct LRU simulation.

3. **Eviction-quality audit** (``eviction_audit``): fraction of evicted
   victims re-referenced within k accesses ("premature evictions"),
   overall and per policy-score decile, plus the byte-denominated
   counterpart that ``CacheStats.bytes_evicted_live`` tracks live.

4. **Offline policy replay** (``replay_host``/``replay_belady``): the
   same trace re-run under the deployed policy, pure LRU, degree
   (size-proportional) score, frequency-EWMA score, and a clairvoyant
   Belady upper bound. The hard invariant — checked by ``analyze`` and
   re-checked by ``repro.obs.validate`` on the exported sidecar — is
   that the *deployed*-policy replay reproduces the live ``CacheStats``
   deltas (gets/hits/misses/evictions/...) bit-exactly: the recorded
   stream provably contains everything the cache decided on.

Results flow into the ``MetricRegistry`` via
``metrics.record_cachescope`` and export as a ``.cachescope.json``
sidecar (``save_report``/``load_report``), surfaced by ``--cache-trace``
on ``query_serve``, ``stream_run`` and ``lcc_run``.

The core/device modules import *this module object only* (to read
``_recorder``); all imports of ``repro_torch.core`` here are lazy, inside
functions, so there is no import cycle.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "SCHEMA",
    "CacheTraceRecorder",
    "enable_recording",
    "disable_recording",
    "get_recorder",
    "recording_enabled",
    "reuse_distances",
    "hit_curve",
    "eviction_audit",
    "replay_host",
    "replay_belady",
    "replay_device",
    "simulate_lru_bytes",
    "analyze",
    "save_report",
    "load_report",
]

SCHEMA = "repro.obs.cachescope/v1"

# host-stream CacheStats fields the deployed replay must reproduce
# bit-exactly (all integers; comm_time is float and excluded because a
# warm-start baseline shifts the accumulation order).
HOST_COMPARE = (
    "gets", "hits", "misses", "evictions", "invalidations", "flushes",
    "bytes_hit", "bytes_missed",
)
# device-stream ResidencyStats fields the membership replay reproduces.
DEVICE_COMPARE = ("lookups", "hits", "misses", "admits", "evicts", "patches")


# --------------------------------------------------------------------------
# Recorder
# --------------------------------------------------------------------------

class _HostStream:
    """Event log of one ``ClampiCache`` instance.

    Columnar parallel arrays; ``kinds[i]`` is one of ``"g"`` (get),
    ``"e"`` (evict victim), ``"i"`` (invalidate), ``"f"`` (flush),
    ``"c"`` (close_epoch). Non-get events carry ``key=-1``/``size=0``
    where not meaningful; ``scores`` holds None for unscored events.
    """

    __slots__ = ("tier", "rank", "label", "config", "preload", "baseline",
                 "kinds", "keys", "sizes", "scores", "hits", "cache")

    def __init__(self, cache):
        self.tier = "host_cache"
        self.rank = int(getattr(cache, "rank", -1))
        self.label = str(getattr(cache, "scope_label", "clampi"))
        net = cache.net
        self.config = {
            "capacity": int(cache.capacity),
            "table_slots": int(cache.table_slots),
            "mode": cache.mode,
            "positional_weight": float(cache.positional_weight),
            "adaptive": bool(cache.adaptive),
            "alpha": float(net.alpha),
            "beta": float(net.beta),
            "hit_cost": float(net.hit_cost),
            "insert_cost": float(net.insert_cost),
        }
        # warm-start snapshot: a cache registered mid-life replays from
        # its state at registration, not from empty.
        self.preload = None
        if cache.entries or cache.clock:
            self.preload = {
                "clock": int(cache.clock),
                "free": [[int(a), int(s)] for a, s in cache.free],
                "entries": [
                    [int(e.key), int(e.addr), int(e.size), int(e.last_use),
                     (None if e.score is None else float(e.score))]
                    for e in cache.entries.values()
                ],
            }
        self.baseline = _stats_dict(cache.stats)
        self.kinds: List[str] = []
        self.keys: List[int] = []
        self.sizes: List[int] = []
        self.scores: List[Optional[float]] = []
        self.hits: List[int] = []
        self.cache = cache

    def push(self, kind: str, key: int, size: int,
             score: Optional[float], hit: bool) -> None:
        self.kinds.append(kind)
        self.keys.append(int(key))
        self.sizes.append(int(size))
        self.scores.append(None if score is None else float(score))
        self.hits.append(1 if hit else 0)

    def live_delta(self) -> Dict[str, float]:
        now = _stats_dict(self.cache.stats)
        return {k: now[k] - self.baseline.get(k, 0) for k in now}

    def to_doc(self) -> dict:
        # rank/scope_label tags may be attached after the first recorded
        # event (e.g. right after construction) — re-read at export
        return {
            "tier": self.tier,
            "rank": int(getattr(self.cache, "rank", self.rank)),
            "label": str(getattr(self.cache, "scope_label", self.label)),
            "config": self.config,
            "preload": self.preload,
            "events": {
                "kinds": "".join(self.kinds),
                "keys": self.keys,
                "sizes": self.sizes,
                "scores": self.scores,
                "hits": self.hits,
            },
            "live": self.live_delta(),
        }


class _DeviceStream:
    """Event log of one ``ResidencyManager``.

    ``events`` is a list of ``[kind, payload]``: ``["r", [ids...]]``
    (reset: membership becomes exactly ids), ``["l", [ids...]]``
    (lookup batch), ``["a", v]`` (admit), ``["e", v]`` (evict),
    ``["p", v]`` (in-place patch; membership unchanged).
    """

    __slots__ = ("tier", "rank", "label", "config", "preload", "baseline",
                 "events", "mgr")

    def __init__(self, mgr):
        self.tier = "device"
        self.rank = int(getattr(mgr, "rank", -1))
        self.label = str(getattr(mgr, "scope_label", "residency"))
        self.config = {"slots": int(mgr.slots),
                       "max_width": int(mgr.max_width)}
        ids = np.asarray(mgr.slot_ids)
        self.preload = [int(v) for v in ids[ids >= 0]]
        self.baseline = _stats_dict(mgr.stats)
        self.events: List[list] = []
        self.mgr = mgr

    def live_delta(self) -> Dict[str, float]:
        now = _stats_dict(self.mgr.stats)
        return {k: now[k] - self.baseline.get(k, 0) for k in now}

    def to_doc(self) -> dict:
        return {
            "tier": self.tier,
            "rank": int(getattr(self.mgr, "rank", self.rank)),
            "label": str(getattr(self.mgr, "scope_label", self.label)),
            "config": self.config,
            "preload": self.preload,
            "events": self.events,
            "live": self.live_delta(),
        }


def _stats_dict(stats) -> Dict[str, float]:
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (int, np.integer)):
            out[f.name] = int(v)
        elif isinstance(v, (float, np.floating)):
            out[f.name] = float(v)
    return out


class CacheTraceRecorder:
    """Per-cache-instance event streams. Hooks in the cache hot paths
    call ``on_*``; each is a dict lookup + appends — cheap enough for
    recorded runs, and *free* when no recorder is installed (the hooks
    check the module global first)."""

    def __init__(self):
        self._host: Dict[int, _HostStream] = {}
        self._dev: Dict[int, _DeviceStream] = {}

    # ---------------- host tier ----------------
    def _h(self, cache) -> Optional[_HostStream]:
        if getattr(cache, "_scope_exempt", False):
            return None  # replay caches must not re-record themselves
        s = self._host.get(id(cache))
        if s is None:
            s = self._host[id(cache)] = _HostStream(cache)
        return s

    def touch(self, cache) -> None:
        """Register ``cache``'s stream now (before the caller mutates any
        stats), so the baseline snapshot is clean."""
        self._h(cache)

    def on_get(self, cache, key: int, size: int,
               score: Optional[float], hit: bool) -> None:
        s = self._h(cache)
        if s is not None:
            s.push("g", key, size, score, hit)

    def on_evict(self, cache, key: int, size: int,
                 score: Optional[float]) -> None:
        s = self._h(cache)
        if s is not None:
            s.push("e", key, size, score, False)

    def on_invalidate(self, cache, key: int) -> None:
        s = self._h(cache)
        if s is not None:
            s.push("i", key, 0, None, False)

    def on_flush(self, cache) -> None:
        s = self._h(cache)
        if s is not None:
            s.push("f", -1, 0, None, False)

    def on_close_epoch(self, cache) -> None:
        s = self._h(cache)
        if s is not None:
            s.push("c", -1, 0, None, False)

    # ---------------- device tier ----------------
    def _d(self, mgr) -> _DeviceStream:
        s = self._dev.get(id(mgr))
        if s is None:
            s = self._dev[id(mgr)] = _DeviceStream(mgr)
        return s

    def on_dev_reset(self, mgr, ids) -> None:
        self._d(mgr).events.append(
            ["r", [int(v) for v in np.asarray(ids).ravel()]])

    def on_dev_lookup(self, mgr, ids) -> None:
        self._d(mgr).events.append(
            ["l", [int(v) for v in np.asarray(ids).ravel()]])

    def on_dev_admit(self, mgr, v: int) -> None:
        self._d(mgr).events.append(["a", int(v)])

    def on_dev_evict(self, mgr, v: int) -> None:
        self._d(mgr).events.append(["e", int(v)])

    def on_dev_patch(self, mgr, v: int) -> None:
        self._d(mgr).events.append(["p", int(v)])

    # ---------------- access ----------------
    def host_streams(self) -> List[_HostStream]:
        return list(self._host.values())

    def device_streams(self) -> List[_DeviceStream]:
        return list(self._dev.values())

    def n_events(self) -> int:
        return (sum(len(s.kinds) for s in self._host.values())
                + sum(len(s.events) for s in self._dev.values()))


# module-level switchboard (same contract as obs.trace._tracer): the
# cache hot paths read `_recorder` directly — one global load + None
# check when recording is off.
_recorder: Optional[CacheTraceRecorder] = None


def enable_recording() -> CacheTraceRecorder:
    """Install (and return) a fresh global cache-trace recorder."""
    global _recorder
    _recorder = CacheTraceRecorder()
    return _recorder


def disable_recording() -> Optional[CacheTraceRecorder]:
    """Remove the global recorder; returns it (streams intact) if any."""
    global _recorder
    r, _recorder = _recorder, None
    return r


def get_recorder() -> Optional[CacheTraceRecorder]:
    return _recorder


def recording_enabled() -> bool:
    return _recorder is not None


# --------------------------------------------------------------------------
# Reuse distances (one-pass Mattson) + hit-rate-vs-capacity curve
# --------------------------------------------------------------------------

class _Fenwick:
    """Prefix-sum tree over access positions (1-indexed)."""

    __slots__ = ("n", "t")

    def __init__(self, n: int):
        self.n = n
        self.t = [0] * (n + 1)

    def add(self, i: int, x: int) -> None:
        i += 1
        while i <= self.n:
            self.t[i] += x
            i += i & (-i)

    def prefix(self, i: int) -> int:  # sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += self.t[i]
            i -= i & (-i)
        return s

    def range(self, lo: int, hi: int) -> int:  # sum of [lo, hi]
        if hi < lo:
            return 0
        return self.prefix(hi) - (self.prefix(lo - 1) if lo > 0 else 0)


def _host_events(doc_or_stream):
    """Normalize a _HostStream or its exported doc to parallel arrays."""
    if isinstance(doc_or_stream, _HostStream):
        return (doc_or_stream.kinds, doc_or_stream.keys,
                doc_or_stream.sizes, doc_or_stream.scores,
                doc_or_stream.hits)
    ev = doc_or_stream["events"] if "events" in doc_or_stream else doc_or_stream
    return (list(ev["kinds"]), ev["keys"], ev["sizes"], ev["scores"],
            ev["hits"])


def reuse_distances(stream, *, mode: str = "always") -> Dict[str, Any]:
    """One-pass Mattson stack distances over a host event stream.

    For each get: ``dist_entries`` = number of *distinct* keys accessed
    since this key's previous access (inclusive of itself) and
    ``dist_bytes`` = their byte footprint — the LRU stack depth the
    access lands at. ``-1`` encodes infinity (first access, or access
    after an invalidation/flush of the key). Under ideal LRU the access
    hits a cache of ``C`` slots iff ``dist_entries <= C`` and a cache of
    ``B`` bytes iff ``dist_bytes <= B`` (exact for ``B`` >= the largest
    entry; entry sizes are constant between invalidations).
    """
    kinds, keys, sizes, _scores, _hits = _host_events(stream)
    n_gets = sum(1 for k in kinds if k == "g")
    bit_cnt = _Fenwick(n_gets)
    bit_bytes = _Fenwick(n_gets)
    last: Dict[int, Tuple[int, int]] = {}  # key -> (pos, size)
    dist_e = np.full(n_gets, -1, np.int64)
    dist_b = np.full(n_gets, -1, np.int64)
    out_sizes = np.zeros(n_gets, np.int64)
    pos = 0
    had_inval = False
    transparent = mode == "transparent"
    for i, kind in enumerate(kinds):
        if kind == "g":
            key, size = keys[i], sizes[i]
            prev = last.get(key)
            if prev is not None:
                p0, s0 = prev
                dist_e[pos] = 1 + bit_cnt.range(p0 + 1, pos - 1)
                dist_b[pos] = size + bit_bytes.range(p0 + 1, pos - 1)
                bit_cnt.add(p0, -1)
                bit_bytes.add(p0, -s0)
            bit_cnt.add(pos, 1)
            bit_bytes.add(pos, size)
            last[key] = (pos, size)
            out_sizes[pos] = size
            pos += 1
        elif kind == "i":
            prev = last.pop(keys[i], None)
            if prev is not None:
                bit_cnt.add(prev[0], -1)
                bit_bytes.add(prev[0], -prev[1])
            had_inval = True
        elif kind == "f" or (kind == "c" and transparent):
            for p0, s0 in last.values():
                bit_cnt.add(p0, -1)
                bit_bytes.add(p0, -s0)
            last.clear()
    return {
        "dist_entries": dist_e,
        "dist_bytes": dist_b,
        "sizes": out_sizes,
        "n_gets": n_gets,
        "had_invalidations": had_inval,
        "max_entry_bytes": int(out_sizes.max()) if n_gets else 0,
    }


def hit_curve(dist: np.ndarray, capacities) -> np.ndarray:
    """Hits at each capacity from a distance array (-1 = never hits)."""
    finite = np.sort(dist[dist >= 0])
    caps = np.asarray(list(capacities), np.int64)
    return np.searchsorted(finite, caps, side="right")


def _log2_hist(dist: np.ndarray) -> Dict[str, Any]:
    """Log2-bucketed histogram of reuse distances; bucket b counts
    distances in [2^b, 2^(b+1))."""
    finite = dist[dist >= 0]
    inf = int((dist < 0).sum())
    if finite.size == 0:
        return {"log2_counts": [], "inf": inf, "n": int(dist.size)}
    b = np.floor(np.log2(np.maximum(finite, 1))).astype(np.int64)
    counts = np.bincount(b).tolist()
    return {"log2_counts": [int(c) for c in counts], "inf": inf,
            "n": int(dist.size)}


def simulate_lru_bytes(stream, capacity: int, *,
                       mode: str = "always") -> Tuple[int, int]:
    """Direct ideal-LRU byte-capacity simulation (no fragmentation, no
    table-slot limit) — the ground truth the Mattson curve is
    spot-checked against. Returns (hits, misses)."""
    from collections import OrderedDict

    kinds, keys, sizes, _scores, _hits = _host_events(stream)
    res: "OrderedDict[int, int]" = OrderedDict()
    used = 0
    hits = misses = 0
    transparent = mode == "transparent"
    for i, kind in enumerate(kinds):
        if kind == "g":
            key, size = keys[i], sizes[i]
            old = res.get(key)
            if old is not None:
                res.move_to_end(key)
                if old != size:  # defensive; sizes are stable in practice
                    used += size - old
                    res[key] = size
                hits += 1
                continue
            misses += 1
            if size > capacity:
                continue
            while used + size > capacity:
                _k, s0 = res.popitem(last=False)
                used -= s0
            res[key] = size
            used += size
        elif kind == "i":
            s0 = res.pop(keys[i], None)
            if s0 is not None:
                used -= s0
        elif kind == "f" or (kind == "c" and transparent):
            res.clear()
            used = 0
    return hits, misses


# --------------------------------------------------------------------------
# Eviction-quality audit
# --------------------------------------------------------------------------

def eviction_audit(stream, *, ks: Tuple[int, ...] = (64, 1024)) -> dict:
    """Were evictions premature? For every recorded victim, find its
    next re-reference (in get-stream positions); report the fraction
    re-referenced ever and within each window ``k``, overall and per
    policy-score decile, plus the byte-denominated totals (the offline
    counterpart of ``CacheStats.bytes_evicted_live``)."""
    kinds, keys, sizes, scores, _hits = _host_events(stream)
    access_pos: Dict[int, List[int]] = {}
    pos = 0
    evs: List[Tuple[int, int, int, Optional[float]]] = []  # (pos, key, size, score)
    for i, kind in enumerate(kinds):
        if kind == "g":
            access_pos.setdefault(keys[i], []).append(pos)
            pos += 1
        elif kind == "e":
            evs.append((pos, keys[i], sizes[i], scores[i]))
    gaps: List[float] = []  # accesses until re-reference (inf if never)
    bytes_evicted = 0
    bytes_live = 0
    for at, key, size, _sc in evs:
        bytes_evicted += size
        nxt = access_pos.get(key)
        j = bisect.bisect_left(nxt, at) if nxt else 0
        if nxt and j < len(nxt):
            gaps.append(float(nxt[j] - at + 1))
            bytes_live += size
        else:
            gaps.append(math.inf)
    g = np.asarray(gaps, np.float64)
    n = len(evs)
    out = {
        "n_evictions": n,
        "reref_frac": float((g < math.inf).mean()) if n else 0.0,
        "premature_within_k": {
            str(k): (float((g <= k).mean()) if n else 0.0) for k in ks
        },
        "bytes_evicted": int(bytes_evicted),
        "bytes_evicted_live": int(bytes_live),
    }
    # per score decile: does a low policy score actually predict no
    # re-reference? (paper Obs. 3.1/3.2 quality check for the score fn)
    sc = np.asarray(
        [s if s is not None else np.nan for (_p, _k, _s, s) in
         ((e[0], e[1], e[2], e[3]) for e in evs)], np.float64)
    scored = ~np.isnan(sc)
    deciles = []
    if scored.sum() >= 10:
        edges = np.quantile(sc[scored], np.linspace(0, 1, 11))
        which = np.clip(
            np.searchsorted(edges, sc[scored], side="right") - 1, 0, 9)
        gg = g[scored]
        kmax = max(ks)
        for d in range(10):
            m = which == d
            deciles.append({
                "decile": d,
                "score_lo": float(edges[d]),
                "score_hi": float(edges[d + 1]),
                "n": int(m.sum()),
                "premature_frac": (
                    float((gg[m] <= kmax).mean()) if m.any() else 0.0),
            })
    out["by_score_decile"] = deciles
    return out


# --------------------------------------------------------------------------
# Offline policy replay
# --------------------------------------------------------------------------

def _build_replay_cache(cfg: dict, *, capacity=None, table_slots=None,
                        positional_weight=None, adaptive=None):
    from ..core.cache import ClampiCache, NetworkModel

    net = NetworkModel(alpha=cfg["alpha"], beta=cfg["beta"],
                       hit_cost=cfg["hit_cost"],
                       insert_cost=cfg["insert_cost"])
    c = ClampiCache(
        int(capacity if capacity is not None else cfg["capacity"]),
        int(table_slots if table_slots is not None else cfg["table_slots"]),
        mode=cfg["mode"],
        positional_weight=(cfg["positional_weight"]
                           if positional_weight is None
                           else positional_weight),
        adaptive=(cfg["adaptive"] if adaptive is None else adaptive),
        network=net,
    )
    c._scope_exempt = True  # never re-record a replay
    return c


def _restore_preload(cache, preload: Optional[dict]) -> None:
    if not preload:
        return
    from ..core.cache import _Entry

    cache.clock = int(preload["clock"])
    cache.free = [(int(a), int(s)) for a, s in preload["free"]]
    for key, addr, size, last_use, score in preload["entries"]:
        cache.entries[int(key)] = _Entry(
            int(key), int(addr), int(size), int(last_use),
            None if score is None else float(score))
        cache._seen.add(int(key))


def replay_host(stream, *, policy: str = "deployed",
                capacity: Optional[int] = None,
                table_slots: Optional[int] = None,
                positional_weight: Optional[float] = None,
                ewma_decay: float = 0.98) -> Dict[str, float]:
    """Re-run a recorded host stream through a fresh ``ClampiCache``.

    Policies rewrite only the score each get carries:

    - ``"deployed"`` — the recorded score, recorded positional weight:
      by cache determinism this MUST reproduce the live stats deltas
      bit-exactly (the reconciliation invariant).
    - ``"lru"`` — no score, positional weight 0 (pure LRU).
    - ``"lru_positional"`` — no score, recorded positional weight
      (CLaMPI's default victim selection).
    - ``"degree"`` — score = entry byte size (proportional to degree
      for adjacency rows; the paper's application score reconstructed
      from the trace alone).
    - ``"ewma"`` — frequency-EWMA score: on each access of ``key``,
      ``f = 1 + f_prev * decay**(gap)`` (gap in accesses) — the live-
      workload score ROADMAP item 4 wants to blend with degree.
    """
    kinds, keys, sizes, scores, _hits = _host_events(stream)
    cfg = stream.config if isinstance(stream, _HostStream) else stream["config"]
    preload = (stream.preload if isinstance(stream, _HostStream)
               else stream.get("preload"))
    if policy == "lru":
        positional_weight = 0.0 if positional_weight is None else positional_weight
    cache = _build_replay_cache(cfg, capacity=capacity,
                                table_slots=table_slots,
                                positional_weight=positional_weight)
    _restore_preload(cache, preload)
    freq: Dict[int, Tuple[float, int]] = {}  # key -> (f, last access idx)
    t = 0
    for i, kind in enumerate(kinds):
        if kind == "g":
            key, size = keys[i], sizes[i]
            t += 1
            if policy == "deployed":
                score = scores[i]
            elif policy in ("lru", "lru_positional"):
                score = None
            elif policy == "degree":
                score = float(size)
            elif policy == "ewma":
                f_prev, t_prev = freq.get(key, (0.0, t))
                f = 1.0 + f_prev * (ewma_decay ** (t - t_prev))
                freq[key] = (f, t)
                score = f
            else:
                raise ValueError(f"unknown replay policy {policy!r}")
            cache.get(key, size, score=score)
        elif kind == "i":
            cache.invalidate(keys[i])
        elif kind == "f":
            cache.flush()
        elif kind == "c":
            cache.close_epoch()
        # "e" events are the deployed cache's own decisions — a replay
        # makes its own.
    out = _stats_dict(cache.stats)
    out["policy"] = policy
    out["hit_rate"] = out["hits"] / out["gets"] if out["gets"] else 0.0
    return out


def replay_belady(stream, *, capacity: Optional[int] = None) -> Dict[str, float]:
    """Clairvoyant upper bound: byte-capacity cache with perfect
    knowledge of the future — never admits a never-again-referenced
    entry, evicts the resident with the farthest next use. No
    fragmentation or table-slot limits, so it upper-bounds what any
    practical policy in this memory system can reach."""
    kinds, keys, sizes, _scores, _hits = _host_events(stream)
    cfg = stream.config if isinstance(stream, _HostStream) else stream["config"]
    cap = int(capacity if capacity is not None else cfg["capacity"])
    transparent = cfg["mode"] == "transparent"
    # next-use chain over get positions
    n_gets = sum(1 for k in kinds if k == "g")
    nxt = np.full(n_gets, np.iinfo(np.int64).max, np.int64)
    last_seen: Dict[int, int] = {}
    pos = n_gets
    for i in range(len(kinds) - 1, -1, -1):
        if kinds[i] == "g":
            pos -= 1
            key = keys[i]
            if key in last_seen:
                nxt[pos] = last_seen[key]
            last_seen[key] = pos
    res: Dict[int, Tuple[int, int]] = {}  # key -> (size, next_use)
    used = 0
    hits = misses = evictions = 0
    pos = 0
    inf = np.iinfo(np.int64).max
    for i, kind in enumerate(kinds):
        if kind == "g":
            key, size = keys[i], sizes[i]
            nu = int(nxt[pos])
            pos += 1
            if key in res:
                hits += 1
                res[key] = (size, nu)
                continue
            misses += 1
            if size > cap or nu == inf:
                continue  # clairvoyant bypass: no future benefit
            admitted = True
            while used + size > cap:
                victim = max(res, key=lambda k: res[k][1])
                if res[victim][1] <= nu:
                    admitted = False  # everything resident is more useful
                    break
                used -= res.pop(victim)[0]
                evictions += 1
            if not admitted:
                continue
            res[key] = (size, nu)
            used += size
        elif kind == "i":
            s0 = res.pop(keys[i], None)
            if s0 is not None:
                used -= s0[0]
        elif kind == "f" or (kind == "c" and transparent):
            res.clear()
            used = 0
    gets = hits + misses
    return {"policy": "belady", "gets": gets, "hits": hits,
            "misses": misses, "evictions": evictions,
            "hit_rate": hits / gets if gets else 0.0}


def replay_device(stream) -> Dict[str, int]:
    """Membership-set replay of a device stream: derive lookup
    hits/misses and membership-change counts from the event log alone;
    reconciles against the live ``ResidencyStats`` deltas."""
    preload = (stream.preload if isinstance(stream, _DeviceStream)
               else stream["preload"])
    events = (stream.events if isinstance(stream, _DeviceStream)
              else stream["events"])
    member = set(int(v) for v in preload)
    lookups = hits = misses = admits = evicts = patches = 0
    for kind, payload in events:
        if kind == "l":
            lookups += len(payload)
            h = sum(1 for v in payload if v in member)
            hits += h
            misses += len(payload) - h
        elif kind == "a":
            member.add(int(payload))
            admits += 1
        elif kind == "e":
            member.discard(int(payload))
            evicts += 1
        elif kind == "p":
            patches += 1
        elif kind == "r":
            member = set(int(v) for v in payload)
    return {"lookups": lookups, "hits": hits, "misses": misses,
            "admits": admits, "evicts": evicts, "patches": patches}


# --------------------------------------------------------------------------
# Analysis report + sidecar
# --------------------------------------------------------------------------

def _spot_capacities(max_entry: int, capacity: int) -> List[int]:
    """>=3 distinct byte capacities at which the Mattson curve is
    provably exact for ideal LRU (all >= the largest entry)."""
    base = max(int(max_entry), 1)
    caps = {base, 2 * base, 4 * base, max(int(capacity), base)}
    return sorted(caps)


def _analyze_host_doc(doc: dict, *, policies, curve_points: int,
                      audit_ks) -> dict:
    mode = doc["config"]["mode"]
    dist = reuse_distances(doc, mode=mode)
    n_gets = dist["n_gets"]
    analysis: Dict[str, Any] = {
        "n_gets": n_gets,
        "reuse_hist_entries": _log2_hist(dist["dist_entries"]),
        "reuse_hist_bytes": _log2_hist(dist["dist_bytes"]),
        "had_invalidations": dist["had_invalidations"],
        "max_entry_bytes": dist["max_entry_bytes"],
    }
    if n_gets:
        cap = int(doc["config"]["capacity"])
        lo = max(dist["max_entry_bytes"], 1)
        hi = max(cap, 2 * lo)
        caps = np.unique(np.geomspace(lo, hi, curve_points).astype(np.int64))
        hits = hit_curve(dist["dist_bytes"], caps)
        analysis["mattson"] = {
            "capacities_bytes": [int(c) for c in caps],
            "hit_rate": [float(h / n_gets) for h in hits],
            "exact_model": not dist["had_invalidations"],
        }
        # exactness vs ideal LRU holds only on invalidation-free traces
        # (an entry can be evicted under pressure from bytes that are
        # later invalidated — the retroactive BIT removal can't see
        # that); with invalidations the curve is a model, not gated.
        if not dist["had_invalidations"]:
            spot = []
            for c in _spot_capacities(dist["max_entry_bytes"], cap):
                m_hits = int(hit_curve(dist["dist_bytes"], [c])[0])
                d_hits, _ = simulate_lru_bytes(doc, c, mode=mode)
                spot.append({"capacity_bytes": int(c),
                             "mattson_hits": m_hits,
                             "direct_hits": int(d_hits),
                             "match": m_hits == d_hits})
            analysis["spot_checks"] = spot
            analysis["spot_match_all"] = all(s["match"] for s in spot)
        else:
            analysis["spot_checks"] = []
            analysis["spot_match_all"] = None
    analysis["eviction_audit"] = eviction_audit(doc, ks=audit_ks)

    replay: Dict[str, dict] = {}
    for pol in policies:
        replay[pol] = replay_host(doc, policy=pol)
    replay["belady"] = replay_belady(doc)
    live = doc["live"]
    reconciled = all(
        int(live.get(k, 0)) == int(replay["deployed"].get(k, 0))
        for k in HOST_COMPARE
    )
    return {**doc, "replay": replay, "reconciled": reconciled,
            "analysis": analysis}


def _analyze_device_doc(doc: dict) -> dict:
    rep = replay_device(doc)
    live = doc["live"]
    reconciled = all(
        int(live.get(k, 0)) == int(rep.get(k, 0)) for k in DEVICE_COMPARE
    )
    # reuse distances over the lookup stream (unit-size keys): the
    # LRU-slots curve that sizes `device_slots` (docs worked example)
    lk: List[int] = []
    for kind, payload in doc["events"]:
        if kind == "l":
            lk.extend(payload)
    synth = {
        "events": {
            "kinds": "g" * len(lk),
            "keys": lk,
            "sizes": [1] * len(lk),
            "scores": [None] * len(lk),
            "hits": [0] * len(lk),
        }
    }
    dist = reuse_distances(synth)
    analysis: Dict[str, Any] = {
        "n_lookups": len(lk),
        "reuse_hist_entries": _log2_hist(dist["dist_entries"]),
    }
    if lk:
        slots_axis = np.unique(np.geomspace(
            1, max(2 * doc["config"]["slots"], 2), 12).astype(np.int64))
        hits = hit_curve(dist["dist_entries"], slots_axis)
        analysis["lru_slots_curve"] = {
            "slots": [int(s) for s in slots_axis],
            "hit_rate": [float(h / len(lk)) for h in hits],
        }
    return {**doc, "replay": {"deployed": rep}, "reconciled": reconciled,
            "analysis": analysis}


def analyze(recorder: CacheTraceRecorder, *,
            policies: Tuple[str, ...] = ("deployed", "lru", "degree", "ewma"),
            curve_points: int = 12,
            audit_ks: Tuple[int, ...] = (64, 1024)) -> dict:
    """Full cache-science report over every recorded stream: replay
    reconciliation, Mattson curves + spot checks, reuse histograms,
    eviction audits, and the policy/Belady comparison. The returned
    dict is the ``.cachescope.json`` sidecar (``save_report``)."""
    streams = []
    for hs in recorder.host_streams():
        streams.append(_analyze_host_doc(
            hs.to_doc(), policies=policies, curve_points=curve_points,
            audit_ks=audit_ks))
    for ds in recorder.device_streams():
        streams.append(_analyze_device_doc(ds.to_doc()))
    host = [s for s in streams if s["tier"] == "host_cache"]
    belady_ok = all(
        s["replay"]["belady"]["hits"] >= max(
            r["hits"] for p, r in s["replay"].items() if p != "belady")
        for s in host if s["analysis"]["n_gets"]
    )
    report = {
        "schema": SCHEMA,
        "streams": streams,
        "summary": {
            "n_streams": len(streams),
            "n_host_streams": len(host),
            "n_device_streams": len(streams) - len(host),
            "all_reconciled": all(s["reconciled"] for s in streams),
            "belady_dominates": belady_ok,
        },
    }
    return report


def save_report(report: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, separators=(",", ":"))


def load_report(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} sidecar")
    return doc


def summarize(report: dict) -> str:
    """One-paragraph human summary for the launchers."""
    s = report["summary"]
    lines = [
        f"cachescope: {s['n_host_streams']} host + "
        f"{s['n_device_streams']} device stream(s), "
        f"replay reconciled: {'EXACT' if s['all_reconciled'] else 'MISMATCH'}"
        f", belady dominates: {s['belady_dominates']}"
    ]
    for st in report["streams"]:
        if st["tier"] != "host_cache" or not st["analysis"]["n_gets"]:
            continue
        rep = st["replay"]
        lines.append(
            f"  [{st['label']} r{st['rank']}] {st['analysis']['n_gets']} gets"
            f" | hit rate deployed {rep['deployed']['hit_rate']:.1%}"
            f" lru {rep['lru']['hit_rate']:.1%}"
            f" ewma {rep['ewma']['hit_rate']:.1%}"
            f" belady {rep['belady']['hit_rate']:.1%}"
            f" | premature evictions "
            f"{st['analysis']['eviction_audit']['reref_frac']:.1%}"
        )
    return "\n".join(lines)
