// One round of the LCC epoch for Hopper (sm_90a): the landing of the pulled
// rows and the fused count, two entry points of one library.
//
// Replaces the body of the reference's compiled epoch,
// src/repro/core/async_engine.py::_shard_body (the `body` closure: fetch,
// combined[evc] and rows_ext[eu] gathers, the count, acc.at[eu].add), with
// B1's count (src/repro/kernels/intersect_count.py) inside it. The TPU
// program moves whole padded rows: a [p*S_max, W] fetch block a round and two
// [E, W] operands. Here nothing padded is moved:
//
//   epoch_land   the all-to-all as the block transpose got[dst, src] =
//                to_send[src, dst]: for every real serve slot
//                (serve_idx < n_loc) the valid prefix of the pulled row is
//                copied, packed, to the landing buffer at its offset (an
//                exclusive cumsum of the pulled degrees, made once an epoch).
//                One warp an item, lane-strided copies.
//   epoch_count  every edge slot of the round reads its two rows where they
//                lie, by index, with their valid lengths: u from rows_flat
//                (length from deg_ext), v by edge_vc's combined index from
//                rows_flat [0, n_loc], the cache rows [n_loc+1, n_loc+1+C) or
//                the packed landing (the rest); a phantom slot (edge_mask
//                false) exits at once. The count goes to acc[u] by an int32
//                atomicAdd: exact and order-free; the phantom row n_loc is
//                never touched.
//
// Bound: latency, not bytes. The round's ids read once are a few MB (all
// valid rows of the S16 graph, cache-line padded, fit the 50 MB L2), and the
// compares are ~1e9 an epoch (0.02 ms at 67 TOP/s); what costs is the chain
// of dependent loads of a search or a merge. Design: a block of 256 threads
// takes kTile slots. Its threads resolve the slots (pointers, lengths,
// strategy by `method`) into shared memory and sort them by work into three
// lists, then: a heavy pair (work > kHeavyWork) is split by the whole block
// (the longer row staged in shared memory for a search, see
// pair_intersect.cuh::block_count); medium pairs go to one warp each and
// light pairs (work <= kLightWork) to 8 lanes each, both taken from their
// lists by a shared counter; a heavy row shared by consecutive pairs (a
// hub's) is staged once. The thresholds and kTile were chosen among
// variants timed on the S16 epoch: 16 slots a block keep a hub's run of
// heavy pairs spread over many blocks (32 and 64 were slower), 256 threads
// beat 128, light <= 256 and heavy > 2,048 compares beat 512 / 16,384 and
// 128 / 1,024, and a second tile of prefetch in the merge gained nothing.
// The tile's classing and counting are pair_intersect.cuh's (Tile,
// tile_add, tile_count), shared with B6 (spmd_plane.cu).
//
// Plain C interface (no PyTorch headers): the Python wrapper
// (kernels/epoch_count.py) passes raw device pointers and the current
// stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_intersect.cuh"

namespace {

namespace pi = pair_intersect;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;    // edge slots a block resolves
constexpr int kGroup = 8;    // lanes of a light pair
constexpr long long kLightWork = 256;
constexpr long long kHeavyWork = 2048;
constexpr int kStageCap = 10240;  // ids of a staged row: 40 KB of shared memory

struct CountArgs {
  const int* rows_flat;   // [p * (n_loc + 1), row_stride]
  long long row_stride;
  const int* deg_ext;     // [p * (n_loc + 1)], 0 for the phantom rows
  const int* cache_rows;  // [n_cache, cache_stride]
  long long cache_stride;
  const int* cache_len;   // [n_cache]
  int n_cache;
  const int* landing;     // this round's packed landing
  const long long* land_off;  // [p, p, s_max] of this round
  const int* land_len;        // [p, p, s_max] of this round
  const int* edge_u;          // [p, e_max]
  const int* edge_vc;         // [p, e_max]
  const unsigned char* edge_mask;  // [p, e_max] bool
  int p, n_loc, s_max;
  long long e_max, e_chunk;
  int round, method, stage_cap;
  int* acc;  // [p * (n_loc + 1)]
};

// acc[rank, u] += the pair's count: exact and order-free
struct AddCount {
  int* acc;
  __device__ __forceinline__ void operator()(const pi::Pair& pr,
                                             int c) const {
    if (c != 0) atomicAdd(acc + pr.dst, c);
  }
};

__global__ void __launch_bounds__(kThreads)
epoch_count_kernel(const CountArgs args) {
  __shared__ pi::Tile<kTile> tile;
  __shared__ int red[kWarps];
  extern __shared__ int stage[];

  const int tid = threadIdx.x;
  pi::tile_init(tile);
  __syncthreads();

  const long long n_slots = (long long)args.p * args.e_chunk;
  const long long slot = (long long)blockIdx.x * kTile + tid;
  if (tid < kTile && slot < n_slots) {
    const int rank = (int)(slot / args.e_chunk);
    const long long e = (long long)rank * args.e_max +
                        (long long)args.round * args.e_chunk +
                        slot % args.e_chunk;
    if (args.edge_mask[e]) {
      const int u = args.edge_u[e], vc = args.edge_vc[e];
      const long long base = (long long)rank * (args.n_loc + 1);
      const int na = args.deg_ext[base + u];
      const int* b;
      int nb;
      if (vc <= args.n_loc) {
        b = args.rows_flat + (base + vc) * args.row_stride;
        nb = args.deg_ext[base + vc];
      } else if (vc < args.n_loc + 1 + args.n_cache) {
        const int c = vc - args.n_loc - 1;
        b = args.cache_rows + (long long)c * args.cache_stride;
        nb = args.cache_len[c];
      } else {
        const long long item = (long long)rank * args.p * args.s_max +
                               (vc - args.n_loc - 1 - args.n_cache);
        b = args.landing + args.land_off[item];
        nb = args.land_len[item];
      }
      if (u < args.n_loc && na > 0 && nb > 0) {
        const bool merge = pi::use_merge(args.method, na, nb);
        pi::tile_add<kTile, kLightWork, kHeavyWork>(
            tile, tid,
            pi::Pair{args.rows_flat + (base + u) * args.row_stride, b, na,
                     nb, (int)(base + u), merge ? 1 : 0});
      }
    }
  }
  __syncthreads();
  pi::tile_count<kThreads, kGroup>(tile, stage, args.stage_cap, red,
                                   AddCount{args.acc});
}

__global__ void __launch_bounds__(kThreads)
epoch_land_kernel(const int* __restrict__ rows_flat, long long row_stride,
                  const int* __restrict__ serve_idx,
                  const long long* __restrict__ land_off,
                  const int* __restrict__ land_len, int* __restrict__ landing,
                  int p, int n_loc, int s_max, int n_rounds, int round) {
  const long long n_items = (long long)p * p * s_max;
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int lane = threadIdx.x & 31;
  // item = (dst * p + src) * s_max + slot; serve_idx is [src, NR, dst, S_max]
  const int slot = (int)(item % s_max);
  const int src = (int)((item / s_max) % p);
  const int dst = (int)(item / ((long long)p * s_max));
  const int loc = __ldg(serve_idx +
                        (((long long)src * n_rounds + round) * p + dst) *
                            s_max + slot);
  if (loc >= n_loc) return;  // a phantom serve slot lands nothing
  const int len = __ldg(land_len + item);
  const int* row =
      rows_flat + ((long long)src * (n_loc + 1) + loc) * row_stride;
  int* out = landing + __ldg(land_off + item);
  for (int k = lane; k < len; k += 32) out[k] = __ldg(row + k);
}

}  // namespace

extern "C" int epoch_count_launch(
    const void* rows_flat, long long row_stride, const void* deg_ext,
    const void* cache_rows, long long cache_stride, const void* cache_len,
    int n_cache, const void* landing, const void* land_off,
    const void* land_len, const void* edge_u, const void* edge_vc,
    const void* edge_mask, int p, int n_loc, int s_max, long long e_max,
    long long e_chunk, int round, int method, int stage_cap, void* acc,
    void* stream) {
  const long long n_slots = (long long)p * e_chunk;
  if (n_slots <= 0) return 0;
  const long long blocks = (n_slots + kTile - 1) / kTile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (stage_cap < 0 || stage_cap > kStageCap) {
    return (int)cudaErrorInvalidValue;
  }
  const CountArgs args{
      (const int*)rows_flat, row_stride, (const int*)deg_ext,
      (const int*)cache_rows, cache_stride, (const int*)cache_len, n_cache,
      (const int*)landing, (const long long*)land_off, (const int*)land_len,
      (const int*)edge_u, (const int*)edge_vc,
      (const unsigned char*)edge_mask, p, n_loc, s_max, e_max, e_chunk,
      round, method, stage_cap, (int*)acc};
  epoch_count_kernel<<<(unsigned)blocks, kThreads,
                       (size_t)stage_cap * sizeof(int),
                       (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

extern "C" int epoch_land_launch(const void* rows_flat, long long row_stride,
                                 const void* serve_idx, const void* land_off,
                                 const void* land_len, void* landing, int p,
                                 int n_loc, int s_max, int n_rounds, int round,
                                 void* stream) {
  const long long n_items = (long long)p * p * s_max;
  if (n_items <= 0) return 0;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  epoch_land_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows_flat, row_stride, (const int*)serve_idx,
      (const long long*)land_off, (const int*)land_len, (int*)landing, p,
      n_loc, s_max, n_rounds, round);
  return (int)cudaGetLastError();
}

extern "C" int epoch_count_stage_cap() { return kStageCap; }
