// The device programs of the SPMD data plane for Hopper (sm_90a): the serve
// (B5, as a packed landing and as the reference's block) and the pair counts
// (B6), entry points of one library.
//
// Replaces src/repro/distributed/spmd_runtime.py::_body_serve (B5) and
// ::_body_pairs (B6), the two shard_map programs of one execution unit. On
// one card the p ranks are the leading axis of every tensor, and the
// all_to_all is the block transpose got[dst, src] = to_send[src, dst]. For
// requester j, width rung b = (s_b, w_b) (windowed capacities, rungs in
// ladder order, base(b) = p * the sum of the earlier s_b), source rank k and
// position pos < s_b, the fetched row f = base(b) + k * s_b + pos of j is
// rows[k, serve_idx[k, j, off(b) + pos]].
//
//   serve_landing  (B5, the executor's) copies the valid prefix of every
//                fetched row, its length serve_len[k, j, off(b) + pos] from
//                the host's table (0 at rung padding), to landing[land_off[j,
//                f] ...], the rows packed back to back (land_off the
//                exclusive cumsum of the lengths in (j, f) order, [p,
//                f_exact + 1]). One warp a landed row, lane-strided copies,
//                one launch a unit over every rung (as epoch_land_kernel in
//                epoch_count.cu), over the host's list of (row j * f_exact +
//                f, chunk) items: only rows of nonzero length, and a row of
//                more than `chunk` ids split into chunks of one warp each,
//                so rung padding launches nothing and no warp copies a hub
//                row alone (at the S16 unit 98,368 landed row slots hold
//                48,549 ids). Bound: bytes, the valid prefixes read and
//                written once and the tables; the landing is at most ~1 MB
//                a unit at S16, where the block is 8.6 GB.
//   serve_block  (B5 as the reference lays it out; off the executor's path)
//                out[j, f, :w_b] = that row, columns [w_b, W) the sentinel,
//                rows [n_rows, f_pad) all sentinel: the [p, f_pad, W]
//                fetched block of the reference's per-rung gather,
//                all_to_all, re-pad and concatenate. One warp an output row,
//                16-byte copies. Bound: bytes, the block written whole.
//   pair_counts  (B6) for every real worklist position i = j * e_tot + e of
//                the unit's [p, e_tot] list (the compact list `real`; the
//                phantom positions are not launched: `out` is zeroed first
//                by cudaMemsetAsync), |A ∩ B| of two rows read by index
//                where they lie: an index < H reads rows[j, idx], otherwise
//                the fetched row at fetched + fetched_off[j, idx - H] (the
//                landing and its offsets, or the block with offsets (j *
//                f_pad + f) * W), each over its valid length a_len / b_len
//                (the widths the host holds for every ref). A block takes
//                kTile consecutive real positions and counts them by work
//                classes: pair_intersect.cuh's Tile, as B7 (a heavy pair by
//                the whole block, the longer row staged in shared memory
//                for a search; a medium one by a warp, a light one by 8
//                lanes; merge or search by the hybrid rule, as B1). Each
//                position is written once: int32, no atomics.
//
// Why pair_counts may drop the reference's padding: _body_pairs gathers both
// sides from [rows | fetched] and truncates them to the bucket's width w_p,
// and the host picks w_p >= max(wa, wb) for every sub-pair (the ladder rung at
// or above it, clipped to W, which is >= every row the buffer holds). A row's
// slot holds its ids and then the sentinel to W, so the truncation drops
// sentinels only, and count_bsearch / intersect_count on the truncated rows
// equal the count over the two valid prefixes. No [rows | fetched]
// concatenation and no truncated copy is made here: the rows are read where
// they lie. Bound of pair_counts: latency of the dependent loads of a search
// or merge (the bytes, valid prefixes read once, are small), hence the
// classing: a hub's long rows split over a block instead of holding one
// warp, short pairs not holding 32 lanes each. A query's worklist is
// heavier than an epoch's (at the S16 unit 11,414 of 33,212 real sub-pairs
// are heavy by B7's bound, hub rows of up to 9,754 ids against rows of
// hundreds), so B6's tile is smaller than B7's and its stage holds fewer
// ids, which keeps 8 blocks on an SM; the constants were chosen among
// variants (tiles of 4-16, 128-512 threads, heavy above 2,048-8,192 and
// light up to 64-256 compares, stages of 0-10,240 ids) timed on the units
// of chip_smoke.py's phase spmd. The heavy merge's split of the shorter
// row (warp_lower_bound in pair_intersect.cuh) came from the same timing.
//
// Plain C interface (no PyTorch headers): the Python wrapper
// (kernels/spmd_plane.py) passes raw device pointers and the current stream,
// and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_intersect.cuh"

namespace {

namespace pi = pair_intersect;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRungs = 8;
// B6's tile (see the note above): against B7's 16 slots and 256 / 2,048
// compares, a smaller tile and a higher heavy bound keep a query's many
// heavy pairs from queueing behind each other in one block, and a lower
// light bound gives pairs of a few dozen ids a warp
constexpr int kPairThreads = 256;
constexpr int kTile = 8;     // real positions a block resolves
constexpr int kGroup = 8;    // lanes of a light pair
constexpr long long kLightWork = 64;
constexpr long long kHeavyWork = 4096;
constexpr int kStageCap = 2048;  // ids of a staged row: 8 KB of shared memory

struct ServeArgs {
  const int* rows;       // [p, h, w]
  const int* serve_idx;  // [p (src), p (dst), s_tot]
  int* out;              // [p (dst), f_pad, w]
  int p, h, w, s_tot, f_pad, n_rungs, sentinel;
  int s_b[kMaxRungs];
  int w_b[kMaxRungs];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
serve_block_kernel(const ServeArgs a) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)a.p * a.f_pad) return;
  const int lane = threadIdx.x & 31;
  const int j = (int)(item / a.f_pad);
  const int r = (int)(item % a.f_pad);
  const int* src = nullptr;
  int width = 0;  // ids copied from src; the rest of the row is the sentinel
  int base = 0, off = 0;
  for (int b = 0; b < a.n_rungs; ++b) {
    const int s = a.s_b[b];
    const int n_b = a.p * s;
    if (r < base + n_b) {
      const int k = (r - base) / s, pos = (r - base) % s;
      const int slot =
          __ldg(a.serve_idx + ((long long)k * a.p + j) * a.s_tot + off + pos);
      src = a.rows + ((long long)k * a.h + slot) * a.w;
      width = a.w_b[b];
      break;
    }
    base += n_b;
    off += s;
  }
  int* out = a.out + item * (long long)a.w;
  if constexpr (kVec) {
    // w and every w_b are multiples of 4 (the wrapper checks): int4 copies
    const int4 pad = make_int4(a.sentinel, a.sentinel, a.sentinel, a.sentinel);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int c = lane; c < a.w / 4; c += 32) {
      int4 v = pad;
      if (4 * c < width) v = __ldg(s4 + c);
      o4[c] = v;
    }
  } else {
    for (int c = lane; c < a.w; c += 32) {
      int v = a.sentinel;
      if (c < width) v = __ldg(src + c);
      out[c] = v;
    }
  }
}

struct LandArgs {
  const int* rows;            // [p, h, w]
  const int* serve_idx;       // [p (src), p (dst), s_tot]
  const int* serve_len;       // [p (src), p (dst), s_tot], 0 at padding
  const long long* land_off;  // [p (dst), f_exact + 1]
  const int* items;           // [n_items, 2]: landed row j * f_exact + f,
                              // chunk
  int* landing;
  long long n_items;
  int p, h, w, s_tot, f_exact, n_rungs, chunk;
  int s_b[kMaxRungs];
};

__global__ void __launch_bounds__(kThreads)
serve_landing_kernel(const LandArgs a) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= a.n_items) return;
  const int lane = threadIdx.x & 31;
  const int row = __ldg(a.items + 2 * item);
  const int first = __ldg(a.items + 2 * item + 1) * a.chunk;
  const int j = row / a.f_exact;
  const int f = row % a.f_exact;
  int base = 0, off = 0;
  for (int b = 0; b < a.n_rungs; ++b) {
    const int s = a.s_b[b];
    const int n_b = a.p * s;
    if (f < base + n_b) {
      const int k = (f - base) / s, pos = (f - base) % s;
      const long long at = ((long long)k * a.p + j) * a.s_tot + off + pos;
      const int last = min(__ldg(a.serve_len + at), first + a.chunk);
      const int* src =
          a.rows + ((long long)k * a.h + __ldg(a.serve_idx + at)) * a.w;
      int* dst = a.landing +
                 __ldg(a.land_off + (long long)j * (a.f_exact + 1) + f);
#pragma unroll 4
      for (int c = first + lane; c < last; c += 32) dst[c] = __ldg(src + c);
      return;
    }
    base += n_b;
    off += s;
  }
}

struct PairArgs {
  const int* rows;               // [p, h, w]
  const int* fetched;            // the landing, or the [p, f_pad, w] block
  const long long* fetched_off;  // [p, f_cols]: where fetched row f starts
  const int* a_idx;  // [p, e_tot] combined index: < h resident, else fetched
  const int* b_idx;
  const int* a_len;  // [p, e_tot] valid length of each side
  const int* b_len;
  const int* real;   // [n_real] flat positions of the real sub-pairs
  int* out;          // [p, e_tot], zeroed before the launch
  int h, w, f_cols, stage_cap;
  long long e_tot, n_real;
};

__device__ __forceinline__ const int* row_at(const PairArgs& a, int j,
                                             int idx) {
  return idx < a.h ? a.rows + ((long long)j * a.h + idx) * a.w
                   : a.fetched + __ldg(a.fetched_off +
                                       (long long)j * a.f_cols + (idx - a.h));
}

// out[i] = the pair's count; each position is written by one thread once
struct StoreCount {
  int* out;
  __device__ __forceinline__ void operator()(const pi::Pair& pr,
                                             int c) const {
    out[pr.dst] = c;
  }
};

__global__ void __launch_bounds__(kPairThreads)
pair_counts_kernel(const PairArgs a) {
  __shared__ pi::Tile<kTile> tile;
  __shared__ int red[kPairThreads / 32];
  extern __shared__ int stage[];

  const int tid = threadIdx.x;
  pi::tile_init(tile);
  __syncthreads();

  const long long r = (long long)blockIdx.x * kTile + tid;
  if (tid < kTile && r < a.n_real) {
    const int i = __ldg(a.real + r);
    const int j = (int)(i / a.e_tot);
    const int na = __ldg(a.a_len + i), nb = __ldg(a.b_len + i);
    if (na > 0 && nb > 0) {  // an empty side counts 0: out is zeroed
      pi::tile_add<kTile, kLightWork, kHeavyWork>(
          tile, tid,
          pi::Pair{row_at(a, j, __ldg(a.a_idx + i)),
                   row_at(a, j, __ldg(a.b_idx + i)), na, nb, i,
                   pi::merges(na, nb) ? 1 : 0});
    }
  }
  __syncthreads();
  pi::tile_count<kPairThreads, kGroup>(tile, stage, a.stage_cap, red,
                                       StoreCount{a.out});
}

}  // namespace

extern "C" int spmd_serve_block_launch(const void* rows,
                                       const void* serve_idx, void* out, int p,
                                       int h, int w, int s_tot, int f_pad,
                                       int n_rungs, const int* s_b,
                                       const int* w_b, int sentinel,
                                       void* stream) {
  if (n_rungs < 0 || n_rungs > kMaxRungs) return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)p * f_pad;
  if (n_items <= 0 || w <= 0) return 0;
  ServeArgs a{(const int*)rows, (const int*)serve_idx, (int*)out, p, h, w,
              s_tot, f_pad, n_rungs, sentinel, {}, {}};
  bool vec = w % 4 == 0;
  long long n_rows = 0;
  for (int b = 0; b < n_rungs; ++b) {
    if (s_b[b] <= 0 || w_b[b] < 0 || w_b[b] > w) {
      return (int)cudaErrorInvalidValue;
    }
    a.s_b[b] = s_b[b];
    a.w_b[b] = w_b[b];
    vec = vec && w_b[b] % 4 == 0;
    n_rows += (long long)p * s_b[b];
  }
  if (n_rows > f_pad) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (vec) {
    serve_block_kernel<true>
        <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    serve_block_kernel<false>
        <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int spmd_serve_landing_launch(
    const void* rows, const void* serve_idx, const void* serve_len,
    const void* land_off, const void* items, long long n_items, int chunk,
    void* landing, int p, int h, int w, int s_tot, int f_exact, int n_rungs,
    const int* s_b, void* stream) {
  if (n_rungs < 0 || n_rungs > kMaxRungs || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items <= 0 || w <= 0) return 0;
  LandArgs a{(const int*)rows, (const int*)serve_idx, (const int*)serve_len,
             (const long long*)land_off, (const int*)items, (int*)landing,
             n_items, p, h, w, s_tot, f_exact, n_rungs, chunk, {}};
  long long n_rows = 0;
  for (int b = 0; b < n_rungs; ++b) {
    if (s_b[b] <= 0) return (int)cudaErrorInvalidValue;
    a.s_b[b] = s_b[b];
    n_rows += (long long)p * s_b[b];
  }
  if (n_rows != f_exact) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  serve_landing_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out (p * e_tot ints) is zeroed, then the n_real real positions counted
extern "C" int spmd_pair_counts_launch(
    const void* rows, const void* fetched, const void* fetched_off,
    int f_cols, const void* a_idx, const void* b_idx, const void* a_len,
    const void* b_len, const void* real, long long n_real, void* out, int p,
    int h, int w, long long e_tot, int stage_cap, void* stream) {
  const long long n = (long long)p * e_tot;
  if (n <= 0) return 0;
  if (n > 2147483647LL || n_real < 0 || n_real > n) {
    return (int)cudaErrorInvalidValue;
  }
  if (stage_cap < 0 || stage_cap > kStageCap) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n * sizeof(int),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess || n_real == 0) return (int)err;
  const long long blocks = (n_real + kTile - 1) / kTile;
  const PairArgs a{(const int*)rows,  (const int*)fetched,
                   (const long long*)fetched_off,
                   (const int*)a_idx, (const int*)b_idx,
                   (const int*)a_len, (const int*)b_len,
                   (const int*)real,  (int*)out,
                   h, w, f_cols, stage_cap, e_tot, n_real};
  pair_counts_kernel<<<(unsigned)blocks, kPairThreads,
                       (size_t)stage_cap * sizeof(int),
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int spmd_pair_counts_stage_cap() { return kStageCap; }
