// Intersection count against device-resident rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/resident_intersect.py::
// resident_intersect (_kernel, called by _vs_rows and _vs_slots): for E pairs
//   counts[e] = |residency[slots_a[e]] ∩ B[e]|,
// where B[e] is rows_b[e] (one uploaded side, [E, WB]) or
// residency[slots_b[e]] (both sides resident). residency is the device tier's
// persistent [S, W] int32 tensor of sorted, deduplicated, sentinel-padded
// rows; lens (optional, [S]) is the valid length of each slot, which the tier
// keeps on the device beside its rows. Validity is checked on the A side only,
// as in the reference: B's padding is >= sentinel and matches no valid id.
//
// On the TPU, scalar prefetch of the slot ids drives one DMA of the resident
// row per program into VMEM, followed by the all-pairs compare. Here a pair's
// rows are read where they lie, by slot, and only their valid prefixes.
//
// Bound: latency and L1/L2 traffic, not bytes. The resident rows the pairs
// touch are a few MB (L2 holds them); the compares (pair by pair a search of
// the shorter row in the longer) take microseconds at the card's rate. A
// search costs a chain of dependent loads, L1 hits near its top and L2 round
// trips near its end. The design:
//   1. lengths, not sentinel searches: with lens, a row's valid length is
//      one load and one check that its last id is valid; without lens, and
//      for an uploaded rows_b row, a binary search of the sentinel;
//   2. a block of kThreads threads takes kTile consecutive pairs (fewer, down
//      to one a warp, when the batch is too small to give every SM
//      kBlocksPerSm blocks: the stream's calls are a few hundred pairs); its
//      first warp resolves them (row pointers, lengths, the compares a search
//      needs: pair_intersect.cuh::work) into shared memory and finds the runs
//      of pairs that share slot_a (pairs in CSR order come in runs: a hub's
//      row against each of its neighbours');
//   3. hub rows staged in shared memory, as a bitmap of the id space: where
//      the ids fit the bitmap (sentinel <= kBitmapIds, graphs of fewer than
//      2^17 vertices), a run of at least kBitmapMinRun pairs whose rows cost
//      less to stream than to search (kBitmapQ) sets its slot_a row's ids in
//      a bitmap of [0, sentinel), then every other row of the run is
//      streamed against it, one warp a pair, with coalesced loads and one
//      shared-memory test an id: no search at all. Above that id space every
//      pair is searched (steps 4-5);
//   4. the other pairs are classed by work, as in epoch_count.cu: light
//      pairs (<= kLightWork) to kGroup lanes each, medium pairs to one warp
//      each, both taken from their lists by a shared counter, heavy pairs
//      (> kHeavyWork) split over the whole block (pair_intersect.cuh::
//      block_count) so that no giant pair holds one warp for long;
//   5. every lane keeps kIlp lookups in flight (search_part_ilp), and its
//      next lookups start where its last ones ended.
// The constants, and search over merge, were chosen on the card at the hub
// shape of the S16 graph and at the stream's tier shape (PERF.md, B3).
// Staging the longer row of a heavy pair sorted in shared memory lost there:
// the stage reserves shared memory, and so L1 capacity, in every block, and
// the searches live on L1 hits; so block_count gets no stage, and the heavy
// threshold lies above every pair of the S16 hub shape (64,176 compares at
// most).
//
// No power-of-two padding of E: the last block's tile is ragged. A slot out
// of range is read as an empty row (count 0), never out of bounds; the
// wrapper refuses such slots before a launch. An evicted slot (all sentinel,
// length 0) counts 0. A length is clamped to [0, W], and a length that runs
// into the padding is cut back to the valid prefix, so the count never
// matches sentinel with sentinel.
//
// Plain C interface (no PyTorch headers): slots_b == nullptr selects the
// one-resident-side variant (rows_b given), otherwise rows_b is ignored; the
// Python wrapper (kernels/resident_intersect.py) passes raw device pointers
// and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_intersect.cuh"

namespace {

namespace pi = pair_intersect;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // pairs a block resolves, by its first warp
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident at full occupancy
constexpr int kGroup = 8;  // lanes of a light pair
constexpr int kIlp = 2;    // lookups a lane keeps in flight
constexpr long long kLightWork = 256;
constexpr long long kHeavyWork = 65536;
// the id spaces a bitmap covers: sentinel <= kBitmapIds; its 16 KB and the
// static arrays (~1.8 KB) stay under the 48 KB a block gets without opt-in
constexpr int kBitmapIds = 1 << 17;
// a run goes by bitmap iff 4 * (its slot_a row + its other rows) <=
// kBitmapQ * the compares its pairs' searches need
constexpr long long kBitmapQ = 2;
constexpr int kBitmapMinRun = 2;  // pairs a bitmap run needs
static_assert(kTile >= 1 && kTile <= 32, "one warp resolves the tile");
static_assert(kThreads % 32 == 0, "whole warps");

struct Args {
  const int* residency;  // [n_slots, w]
  long long w;
  int n_slots;
  const int* lens;     // [n_slots] valid length per slot, or null
  const int* slots_a;  // [n_pairs]
  const int* slots_b;  // [n_pairs], or null: rows_b
  const int* rows_b;   // [n_pairs, wb]
  long long wb;
  int* counts;  // [n_pairs]
  long long n_pairs;
  int sentinel;
  int bitmap_words;  // words of the bitmap of ids [0, sentinel); 0: none
  int tile;          // pairs a block takes, <= kTile
};

struct Pair {
  const int* a;
  const int* b;
  int na, nb;
};

// valid length of a sorted row whose valid ids lie in row[0, cap): all of it
// when its last id is valid (one load), else the sentinel's position
__device__ __forceinline__ int valid_len(const int* __restrict__ row, int cap,
                                         int sentinel) {
  if (cap <= 0) return 0;
  if (__ldg(row + cap - 1) < sentinel) return cap;
  return pi::lower_bound<false>(row, cap - 1, sentinel);
}

__device__ __forceinline__ const int* slot_row(const Args& args, int s,
                                               int& n) {
  if (s < 0 || s >= args.n_slots) {
    n = 0;
    return args.residency;
  }
  const int w = (int)args.w;
  const int* row = args.residency + (long long)s * args.w;
  const int cap =
      args.lens != nullptr ? min(max(__ldg(args.lens + s), 0), w) : w;
  n = valid_len(row, cap, args.sentinel);
  return row;
}

__global__ void __launch_bounds__(kThreads)
resident_intersect_kernel(const Args args) {
  __shared__ Pair pairs[kTile];
  __shared__ unsigned char lists[3][kTile];  // heavy, medium, light
  __shared__ int n_in[3], next_in[3];
  __shared__ int red[kWarps];
  // runs of pairs that share slot_a: their sums, and those counted by bitmap
  __shared__ unsigned long long run_nb[32], run_work[32];
  __shared__ unsigned char bm_first[kTile], bm_len[kTile];
  __shared__ int n_bm;
  extern __shared__ unsigned bitmap[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long first = (long long)blockIdx.x * args.tile;
  if (tid < 32) {
    const long long e = first + lane;
    int key = -1 - lane;  // no run: an empty pair, or past the tile
    long long work = 0;
    int na = 0, nb = 0;
    if (lane < args.tile && e < args.n_pairs) {
      const int sa = __ldg(args.slots_a + e);
      const int* a = slot_row(args, sa, na);
      const int* b;
      if (args.slots_b != nullptr) {
        b = slot_row(args, __ldg(args.slots_b + e), nb);
      } else {
        b = args.rows_b + e * args.wb;
        nb = valid_len(b, (int)args.wb, args.sentinel);
      }
      if (na > 0 && nb > 0) {
        work = pi::work(false, na, nb);
        key = sa;
        pairs[lane] = Pair{a, b, na, nb};
      } else {
        args.counts[e] = 0;
      }
    }
    // runs: maximal stretches of consecutive pairs with one slot_a
    const int prev = __shfl_up_sync(pi::kFull, key, 1);
    const unsigned starts = __ballot_sync(pi::kFull, lane == 0 || key != prev);
    const int run = __popc(starts & ((2u << lane) - 1u)) - 1;
    run_nb[lane] = 0;
    run_work[lane] = 0;
    __syncwarp();
    if (key >= 0) {
      atomicAdd(&run_nb[run], (unsigned long long)nb);
      atomicAdd(&run_work[run], (unsigned long long)work);
    }
    __syncwarp();
    // a run is counted against a bitmap of its slot_a row when building the
    // bitmap and streaming the other rows costs less than searching
    const bool head = key >= 0 && ((starts >> lane) & 1u);
    const unsigned later = starts & ~((2u << lane) - 1u);
    const int run_len = (later != 0u ? __ffs(later) - 1 : 32) - lane;
    bool by_bitmap = false;
    if (head && args.bitmap_words > 0 && run_len >= kBitmapMinRun) {
      by_bitmap = 4ull * ((unsigned long long)na + run_nb[run]) <=
                  (unsigned long long)kBitmapQ * run_work[run];
    }
    const unsigned heads = __ballot_sync(pi::kFull, by_bitmap);
    if (by_bitmap) {
      const int at = __popc(heads & ((1u << lane) - 1u));
      bm_first[at] = (unsigned char)lane;
      bm_len[at] = (unsigned char)run_len;
    }
    if (lane == 0) n_bm = __popc(heads);
    // a pair of a bitmap run is in no list: its run's head is the last
    // start at or before it
    const int head_lane = 31 - __clz(starts & ((2u << lane) - 1u));
    const bool in_run = ((heads >> head_lane) & 1u) != 0u;
    int cls = 3;
    if (key >= 0 && !in_run) {
      cls = work > kHeavyWork ? 0 : (work > kLightWork ? 1 : 2);
    }
    // the lists keep pair order, so pairs that share a row stay adjacent
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const unsigned in_c = __ballot_sync(pi::kFull, cls == c);
      if (cls == c) {
        lists[c][__popc(in_c & ((1u << lane) - 1u))] = (unsigned char)lane;
      }
      if (lane == 0) {
        n_in[c] = __popc(in_c);
        next_in[c] = 0;
      }
    }
  }
  __syncthreads();

  // bitmap runs: the slot_a row's ids set in a bitmap of the id space, then
  // every other row of the run streamed against it, one warp a pair
  for (int g = 0; g < n_bm; ++g) {
    const int p0 = bm_first[g], len = bm_len[g];
    const int* a = pairs[p0].a;
    const int na = pairs[p0].na;
    for (int i = tid; i < args.bitmap_words; i += kThreads) bitmap[i] = 0u;
    __syncthreads();
    for (int i = tid; i < na; i += kThreads) {
      const int id = __ldg(a + i);
      atomicOr(bitmap + (id >> 5), 1u << (id & 31));
    }
    __syncthreads();
    for (int q = warp; q < len; q += kWarps) {
      const Pair pr = pairs[p0 + q];
      const int c = __reduce_add_sync(
          pi::kFull, pi::bitmap_part<kIlp>(pr.b, pr.nb, bitmap, lane));
      if (lane == 0) args.counts[first + p0 + q] = c;
    }
    __syncthreads();
  }

  // heavy pairs: the whole block, one after another
  const int* staged = nullptr;
  for (int h = 0; h < n_in[0]; ++h) {
    const int k = lists[0][h];
    const Pair pr = pairs[k];
    const int c = pi::block_count<kThreads>(pr.a, pr.na, pr.b, pr.nb, false,
                                            nullptr, 0, staged, red);
    if (tid == 0) args.counts[first + k] = c;
  }

  // medium pairs: one warp each
  while (true) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&next_in[1], 1);
    k = __shfl_sync(pi::kFull, k, 0);
    if (k >= n_in[1]) break;
    const int p = lists[1][k];
    const Pair pr = pairs[p];
    const int c = pi::group_count_ilp<32, kIlp>(pr.a, pr.na, pr.b, pr.nb,
                                                lane, pi::kFull);
    if (lane == 0) args.counts[first + p] = c;
  }

  // light pairs: kGroup lanes each
  const int g_lane = lane & (kGroup - 1);
  const unsigned g_mask = ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
  while (true) {
    int k = 0;
    if (g_lane == 0) k = atomicAdd(&next_in[2], 1);
    k = __shfl_sync(g_mask, k, 0, kGroup);
    if (k >= n_in[2]) break;
    const int p = lists[2][k];
    const Pair pr = pairs[p];
    const int c = pi::group_count_ilp<kGroup, kIlp>(pr.a, pr.na, pr.b, pr.nb,
                                                    g_lane, g_mask);
    if (g_lane == 0) args.counts[first + p] = c;
  }
}

}  // namespace

extern "C" int resident_intersect_launch(const void* residency, int n_slots,
                                         int w, const void* lens,
                                         const void* slots_a,
                                         const void* slots_b,
                                         const void* rows_b, int wb,
                                         void* counts, long long n_pairs,
                                         int sentinel, void* stream) {
  if (n_pairs <= 0) return 0;
  // the card's SMs (the first device asked; every card here is one kind)
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
  }
  const long long fill = (long long)n_sm * kBlocksPerSm;
  const int tile = (int)min((long long)kTile,
                             max((long long)kWarps, (n_pairs + fill - 1) / fill));
  const long long blocks = (n_pairs + tile - 1) / tile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int words =
      sentinel > 0 && sentinel <= kBitmapIds ? (sentinel + 31) / 32 : 0;
  const size_t smem = (size_t)words * sizeof(unsigned);
  const Args args{(const int*)residency, w, n_slots, (const int*)lens,
                  (const int*)slots_a, (const int*)slots_b,
                  (const int*)rows_b, wb, (int*)counts, n_pairs, sentinel,
                  words, tile};
  resident_intersect_kernel<<<(unsigned)blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
