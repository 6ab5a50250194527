// Count of the common ids of two sorted, deduplicated int32 rows whose valid
// lengths are given — the device core of epoch_count.cu (B7),
// intersect_count.cu (B1) and resident_intersect.cu (B3; B3 alone calls the
// search with K lookups in flight, search_part_ilp / group_count_ilp). B3
// and B7 also count a row against a bitmap of another in shared memory
// (bitmap_part).
//
// Valid ids are < sentinel <= INT_MAX, so kPad (INT_MAX) pads a ragged tile
// and never equals a valid id. Two strategies give the same integer:
//
//   search  every lane takes elements of the shorter prefix and binary-
//           searches the longer one, in device memory or in a copy staged in
//           shared memory (heavy pairs, see block_count). A lane's elements
//           increase, so its next search starts where its last one ended.
//           Work ns * ceil(log2(nl + 1)) compares.
//   merge   both prefixes are walked in G-wide tiles (G = the group's
//           lanes): every lane finds its element of the A tile in the B tile
//           by a log2(G)-step search over shuffles, then the tile with the
//           smaller maximum advances (both on a tie). The next tile of each
//           row is loaded before the current one is compared, so one load
//           latency is in flight behind every step. Work na + nb.
//
// The hybrid rule (paper §III-C with this card's costs, the cost that
// chip_smoke.py's pair_ops counts): merge iff na + nb <= ns * ceil(log2(nl+1)).
//
// A group is G consecutive lanes of one warp (G = 8 or 32) named by `mask`;
// every lane of the group calls a group function, gets its partial count,
// and group_sum folds the partials. block_count is called by every thread of
// a block and returns the pair's count on thread 0.
//
// A tile (Tile, tile_add, tile_count) is the work classing of B7
// (epoch_count.cu) and B6 (spmd_plane.cu): a block resolves up to kTile
// pairs (pointers, lengths, strategy) into shared memory and files each
// under a class by its work; then heavy pairs are split by the whole block
// one after another (the longer row staged in shared memory for a search, a
// row shared by consecutive heavy pairs staged once), medium pairs take one
// warp each and light pairs G lanes each, both taken from their lists by a
// shared counter.
#pragma once

#include <cuda_runtime.h>

namespace pair_intersect {

constexpr int kPad = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

enum Method { kSearch = 0, kMerge = 1, kHybrid = 2 };

// ceil(log2(n + 1)) for n >= 0: the bit length of n
__device__ __forceinline__ int bit_length(int n) { return 32 - __clz(n); }

__device__ __forceinline__ bool merges(int na, int nb) {
  const int ns = min(na, nb), nl = max(na, nb);
  return (long long)na + nb <= (long long)ns * bit_length(nl);
}

__device__ __forceinline__ bool use_merge(int method, int na, int nb) {
  return method == kMerge || (method == kHybrid && merges(na, nb));
}

// compares the chosen strategy needs: what the cost classes are cut by
__device__ __forceinline__ long long work(bool merge, int na, int nb) {
  const int ns = min(na, nb), nl = max(na, nb);
  return merge ? (long long)na + nb : (long long)ns * bit_length(nl);
}

template <bool kShared>
__device__ __forceinline__ int load(const int* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// first index in row[0, n) whose value is >= key
template <bool kShared>
__device__ __forceinline__ int lower_bound(const int* row, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (load<kShared>(row + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// first index in row[0, n) whose value is >= key, by the 32 lanes of a warp
// (all of them call it): 31 probes a round narrow the range 32-fold, so a
// row of n ids takes ceil(log32(n)) + 1 dependent loads instead of log2(n)
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ row,
                                                int n, int key, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + (lane + 1) * step - 1;
    const unsigned below =
        __ballot_sync(kFull, at < hi && __ldg(row + at) < key);
    const int k = __popc(below);
    hi = min(hi, lo + (k + 1) * step);
    lo += k * step;
  }
  const int at = lo + lane;
  return lo + __popc(__ballot_sync(kFull, at < hi && __ldg(row + at) < key));
}

// search: elements first, first + stride, ... of s[0, ns) looked up in
// l[0, nl); s is in device memory, l where kSharedL says
template <bool kSharedL>
__device__ __forceinline__ int search_part(const int* __restrict__ s, int ns,
                                           const int* l, int nl, int first,
                                           int stride) {
  int hits = 0, from = 0;
  for (int i = first; i < ns; i += stride) {
    const int x = __ldg(s + i);
    const int pos = from + lower_bound<kSharedL>(l + from, nl - from, x);
    hits += (pos < nl && load<kSharedL>(l + pos) == x) ? 1 : 0;
    from = pos;
  }
  return hits;
}

__device__ __forceinline__ int tile_load(const int* __restrict__ row, int n,
                                         int i) {
  return i < n ? __ldg(row + i) : kPad;
}

// merge of a[0, na) and b[0, nb) by the G lanes of a group
template <int G>
__device__ __forceinline__ int merge_part(const int* __restrict__ a, int na,
                                          const int* __restrict__ b, int nb,
                                          int g_lane, unsigned mask) {
  if (na == 0 || nb == 0) return 0;
  int hits = 0, i0 = 0, j0 = 0;
  int x = tile_load(a, na, g_lane), y = tile_load(b, nb, g_lane);
  int xn = tile_load(a, na, G + g_lane), yn = tile_load(b, nb, G + g_lane);
  while (true) {
    int lo = 0;  // elements of the B tile < x, capped at G - 1
#pragma unroll
    for (int step = G / 2; step >= 1; step >>= 1) {
      if (__shfl_sync(mask, y, lo + step - 1, G) < x) lo += step;
    }
    // every lane of the group takes part in every shuffle: no && before it
    const int z = __shfl_sync(mask, y, lo, G);
    hits += (x != kPad && z == x) ? 1 : 0;
    const int amax = __shfl_sync(mask, x, min(na - i0, G) - 1, G);
    const int bmax = __shfl_sync(mask, y, min(nb - j0, G) - 1, G);
    if (amax <= bmax) {
      i0 += G;
      if (i0 >= na) break;
      x = xn;
      xn = tile_load(a, na, i0 + G + g_lane);
    }
    if (bmax <= amax) {
      j0 += G;
      if (j0 >= nb) break;
      y = yn;
      yn = tile_load(b, nb, j0 + G + g_lane);
    }
  }
  return hits;
}

template <int G>
__device__ __forceinline__ int group_sum(int v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
  return v;
}

// |a ∩ b| by one group; every lane of the group returns the count
template <int G>
__device__ __forceinline__ int group_count(const int* __restrict__ a, int na,
                                           const int* __restrict__ b, int nb,
                                           bool merge, int g_lane,
                                           unsigned mask) {
  int part;
  if (merge) {
    part = merge_part<G>(a, na, b, nb, g_lane, mask);
  } else if (na <= nb) {
    part = search_part<false>(a, na, b, nb, g_lane, G);
  } else {
    part = search_part<false>(b, nb, a, na, g_lane, G);
  }
  return group_sum<G>(part, mask);
}

// search with K lookups in flight: a lane takes K elements of s at a time
// (first, first + stride, ..., first + (K - 1) * stride, then K * stride on)
// and looks them up in l[from, nl) together, by a branch-free search of one
// length for all K, so K independent loads stand behind every step; `from`
// then moves to the last one's position. Each lookup finds the last index
// whose id is <= x and checks it: ceil(log2(nl - from)) + 1 loads. Gives
// search_part's integer (s and l in device memory).
template <int K>
__device__ __forceinline__ int search_part_ilp(const int* __restrict__ s,
                                               int ns,
                                               const int* __restrict__ l,
                                               int nl, int first, int stride) {
  int hits = 0, from = 0;
  for (int i = first; i < ns && from < nl; i += K * stride) {
    int x[K], at[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = i + k * stride;
      x[k] = j < ns ? __ldg(s + j) : kPad;
      at[k] = from;
    }
    for (int n = nl - from; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        at[k] = __ldg(l + at[k] + half) <= x[k] ? at[k] + half : at[k];
      }
      n -= half;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) hits += __ldg(l + at[k]) == x[k] ? 1 : 0;
    from = at[K - 1];
  }
  return hits;
}

// |a ∩ b| by the G lanes of a group, the shorter prefix searched in the
// longer by search_part_ilp<K>
template <int G, int K>
__device__ __forceinline__ int group_count_ilp(const int* __restrict__ a,
                                               int na,
                                               const int* __restrict__ b,
                                               int nb, int g_lane,
                                               unsigned mask) {
  const int part = na <= nb ? search_part_ilp<K>(a, na, b, nb, g_lane, G)
                            : search_part_ilp<K>(b, nb, a, na, g_lane, G);
  return group_sum<G>(part, mask);
}

// count of b[0, nb)'s ids whose bit is set in `bitmap` (shared memory), by
// the 32 lanes of a warp: coalesced loads, K of them in flight a lane
template <int K>
__device__ __forceinline__ int bitmap_part(const int* __restrict__ b, int nb,
                                           const unsigned* bitmap, int lane) {
  int hits = 0;
  for (int i = lane; i < nb; i += 32 * K) {
    int id[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = i + 32 * k;
      id[k] = j < nb ? __ldg(b + j) : -1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (id[k] >= 0) hits += (bitmap[id[k] >> 5] >> (id[k] & 31)) & 1u;
    }
  }
  return hits;
}

// |a ∩ b| by every thread of a block of T threads. merge: the longer prefix
// is cut into one chunk a warp, and each warp merges its chunk with the
// slice of the shorter prefix that can hold the chunk's matches (found by
// warp_lower_bound). search: the
// longer prefix is staged in shared memory (`stage`, stage_cap ids) when it
// fits, then every thread searches its elements of the shorter one; `staged`
// (the same on every thread) names the row `stage` holds, so a row that
// several heavy pairs share (a hub's) is staged once. `red` holds T / 32
// ints. Returns the count on thread 0; ends in __syncthreads so `stage` and
// `red` may be reused at once.
template <int T>
__device__ __forceinline__ int block_count(const int* __restrict__ a, int na,
                                           const int* __restrict__ b, int nb,
                                           bool merge, int* stage,
                                           int stage_cap, const int*& staged,
                                           int* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* s = na <= nb ? a : b;
  const int* l = na <= nb ? b : a;
  const int ns = min(na, nb), nl = max(na, nb);
  int part = 0;
  if (merge) {
    constexpr int kWarps = T / 32;
    const int chunk = (nl + kWarps - 1) / kWarps;
    const int c0 = min(nl, warp * chunk), c1 = min(nl, c0 + chunk);
    if (c0 < c1) {  // the same for every lane of the warp
      const int s0 = warp_lower_bound(s, ns, __ldg(l + c0), lane);
      const int s1 = s0 + warp_lower_bound(s + s0, ns - s0,
                                           __ldg(l + c1 - 1) + 1, lane);
      part = merge_part<32>(l + c0, c1 - c0, s + s0, s1 - s0, lane, kFull);
    }
  } else if (nl <= stage_cap) {
    if (l != staged) {
      for (int i = tid; i < nl; i += T) stage[i] = __ldg(l + i);
      staged = l;
      __syncthreads();
    }
    part = search_part<true>(s, ns, stage, nl, tid, T);
  } else {
    part = search_part<false>(s, ns, l, nl, tid, T);
  }
  part = __reduce_add_sync(kFull, part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  int total = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < T / 32; ++w) total += red[w];
  }
  __syncthreads();
  return total;
}

// One resolved pair of a tile: its two rows and valid lengths, where its
// count goes (`dst`, read by the caller's emit) and the strategy.
struct Pair {
  const int* a;
  const int* b;
  int na, nb, dst, merge;
};

// The pairs a block resolved and their three class lists: 0 heavy (the
// whole block), 1 medium (a warp), 2 light (G lanes).
template <int kTile>
struct Tile {
  Pair pairs[kTile];
  unsigned char lists[3][kTile];
  int n_in[3], next_in[3];
};

// every thread calls it; a __syncthreads must follow before tile_add
template <int kTile>
__device__ __forceinline__ void tile_init(Tile<kTile>& t) {
  if (threadIdx.x < 3) {
    t.n_in[threadIdx.x] = 0;
    t.next_in[threadIdx.x] = 0;
  }
}

// files `pr` at `slot` (< kTile, one slot a thread) under its class:
// heavy above kHeavy compares, light at or below kLight
template <int kTile, long long kLight, long long kHeavy>
__device__ __forceinline__ void tile_add(Tile<kTile>& t, int slot,
                                         const Pair& pr) {
  const long long w = work(pr.merge != 0, pr.na, pr.nb);
  const int cls = w > kHeavy ? 0 : (w > kLight ? 1 : 2);
  t.pairs[slot] = pr;
  t.lists[cls][atomicAdd(&t.n_in[cls], 1)] = (unsigned char)slot;
}

// counts every filed pair of the tile (after a __syncthreads) by every
// thread of a block of T threads; emit(pair, count) is called once a pair,
// by one thread. `stage` holds stage_cap ids, `red` T / 32 ints.
template <int T, int G, int kTile, class Emit>
__device__ __forceinline__ void tile_count(Tile<kTile>& t, int* stage,
                                           int stage_cap, int* red,
                                           const Emit& emit) {
  static_assert(G == 8 || G == 16, "a light pair takes 8 or 16 lanes");
  const int tid = threadIdx.x, lane = tid & 31;

  // heavy pairs: the whole block, one after another
  const int* staged = nullptr;
  for (int h = 0; h < t.n_in[0]; ++h) {
    const Pair pr = t.pairs[t.lists[0][h]];
    const int c = block_count<T>(pr.a, pr.na, pr.b, pr.nb, pr.merge != 0,
                                 stage, stage_cap, staged, red);
    if (tid == 0) emit(pr, c);
  }

  // medium pairs: one warp each
  while (true) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&t.next_in[1], 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= t.n_in[1]) break;
    const Pair pr = t.pairs[t.lists[1][k]];
    const int c = group_count<32>(pr.a, pr.na, pr.b, pr.nb, pr.merge != 0,
                                  lane, kFull);
    if (lane == 0) emit(pr, c);
  }

  // light pairs: G lanes each
  const int g_lane = lane & (G - 1);
  const unsigned g_mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  while (true) {
    int k = 0;
    if (g_lane == 0) k = atomicAdd(&t.next_in[2], 1);
    k = __shfl_sync(g_mask, k, 0, G);
    if (k >= t.n_in[2]) break;
    const Pair pr = t.pairs[t.lists[2][k]];
    const int c = group_count<G>(pr.a, pr.na, pr.b, pr.nb, pr.merge != 0,
                                 g_lane, g_mask);
    if (g_lane == 0) emit(pr, c);
  }
}

}  // namespace pair_intersect
