// One round of the LCC epoch for Hopper (sm_90a): the landing of the pulled
// rows and the fused count, two entry points of one library.
//
// Replaces the body of the reference's compiled epoch,
// src/repro/core/async_engine.py::_shard_body (the `body` closure: fetch,
// combined[evc] and rows_ext[eu] gathers, the count, acc.at[eu].add), with
// B1's count (src/repro/kernels/intersect_count.py) inside it. The TPU
// program moves whole padded rows: a [p*S_max, W] fetch block a round and two
// [E, W] operands. Here nothing padded is moved or held: the local rows are
// one ragged store, row g = rank * (n_loc + 1) + row at row_ids + row_off[g]
// with deg_ext[g] ids (kron S19's rows take 62 MB so, 84.9 GB padded to its
// largest degree).
//
//   epoch_land   the all-to-all as the block transpose got[dst, src] =
//                to_send[src, dst]: for every real serve slot
//                (serve_idx < n_loc) the valid prefix of the pulled row is
//                copied from the store, packed, to the landing buffer at its
//                offset (an
//                exclusive cumsum of the pulled degrees, made once an epoch).
//                One warp an item, lane-strided copies.
//   epoch_count  every edge slot of the round reads its two rows where they
//                lie, by index, with their valid lengths: u from the store
//                (length from deg_ext), v by edge_vc's combined index from
//                the store [0, n_loc], the cache rows [n_loc+1, n_loc+1+C) or
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
// Hub runs by bitmap. Slots come in CSR order, so a hub u owns a run of
// deg(u) consecutive slots, and a tile of 16 re-walks u's row for every one
// of them (on the kron S18 epoch, 80% of the compares are such runs' merges
// and searches: a chain of dependent loads each). The run table
// (kernels/epoch_count.py::count_runs, built once a problem) lists pieces of
// the runs worth a bitmap; a launch's first n_pieces blocks are piece blocks,
// one a piece: clear a bitmap of [0, sentinel) in the dynamic shared memory,
// set u's ids in it, then stream every slot's v row against it (one bit test
// an id, coalesced loads, kPieceIlp in flight a lane) in work items of at
// most kItemIds ids, so a long v row spreads over the block's warps; the
// piece's hits go to acc[u] by one atomicAdd. The other blocks are tile
// blocks as above, over the table's tiles (runs of at most kTile real slots
// no piece covers) or, where the problem has no piece, over every kTile
// slots of the round. A piece block takes the bitmap, rounded to 16 bytes,
// and 16 B a thread for its slots, and the table keeps no piece where that
// exceeds the stage the launch takes anyway or 24 KB (with which 8 blocks,
// the thread limit, still fit an SM): a piece never costs a tile block
// occupancy. At S18 it is 36 KB beside the 40 KB stage; at urand S19 it
// would be 68 KB beside a 244-byte stage, and 186 pieces there (a rule
// without this limit) took the epoch from 17.4 to 31.6 ms.
// The constants were chosen on the H100, on the kron S18 epoch (40.4 ms
// with no piece; PERF.md, B7): runs of at least 32 slots (16: 11.9 ms, 64:
// 13.1, 128: 13.9), pieces of at most 256 (128: 11.6, 384: 12.2, 1,024:
// 15.6), keep a run iff 4 * (bitmap clears and sets + ids streamed) <= 64 *
// its hybrid compares (4: 17.7, 16: 12.6, 128 and above as 64), 8 ids in
// flight a lane (4: 24.3, 16: 11.6) and items of 2,048 ids (1,024: 11.8):
// 11.5 ms.
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
constexpr int kPieceIlp = 8;      // ids a lane of a piece block has in flight
constexpr int kItemIds = 32 * kPieceIlp * 8;  // ids of a piece's work item
// most shared memory a launch takes: above it the kernel needs an opt-in
constexpr size_t kSmemCap = 48 << 10;

struct CountArgs {
  const int* row_ids;        // the local rows' ids, back to back
  const long long* row_off;  // [p * (n_loc + 1) + 1] start of each row
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
  const long long* piece_e;  // [n_pieces] first slot (rank * e_max + ...)
  const int* piece_n;        // [n_pieces] slots of each piece
  int n_pieces;
  const long long* tiles;  // [n_tiles] e * 32 + slots, or null
  int bitmap_words;        // words of the bitmap, a multiple of 4
  int* acc;  // [p * (n_loc + 1)]
};

// a piece block's view of one of its slots: v's row, its valid length and
// the index of its first work item
struct PieceSlot {
  const int* b;
  int nb, first_item;
};

// v's row (b, nb) of a real slot by its combined index
__device__ __forceinline__ void row_of_v(const CountArgs& args, int rank,
                                         long long base, int vc,
                                         const int*& b, int& nb) {
  if (vc <= args.n_loc) {
    b = args.row_ids + __ldg(args.row_off + base + vc);
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
}

// One piece: u's ids set in a bitmap of [0, sentinel), then every slot's v
// row tested against it. The slots are taken kThreads at a time: each
// thread resolves one and counts its work items (kItemIds ids each), a
// block scan numbers the items, and the warps take them in turn.
__device__ __forceinline__ void count_piece(const CountArgs& args,
                                            int piece, unsigned* bitmap,
                                            int* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PieceSlot* slots =
      reinterpret_cast<PieceSlot*>(bitmap + args.bitmap_words);
  const long long e0 = args.piece_e[piece];
  const int n = args.piece_n[piece];
  const int rank = (int)(e0 / args.e_max);
  const long long base = (long long)rank * (args.n_loc + 1);
  const int u = args.edge_u[e0];
  const int* a = args.row_ids + __ldg(args.row_off + base + u);
  const int na = args.deg_ext[base + u];

  uint4* words = reinterpret_cast<uint4*>(bitmap);
  for (int i = tid; i < args.bitmap_words / 4; i += kThreads) {
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  for (int i = tid; i < na; i += kThreads) {
    const int id = __ldg(a + i);
    atomicOr(bitmap + (id >> 5), 1u << (id & 31));
  }
  __syncthreads();

  int hits = 0;
  for (int s0 = 0; s0 < n; s0 += kThreads) {
    const int* b = nullptr;
    int nb = 0;
    if (s0 + tid < n) {
      row_of_v(args, rank, base, args.edge_vc[e0 + s0 + tid], b, nb);
    }
    const int items = (nb + kItemIds - 1) / kItemIds;
    int incl = items;  // inclusive scan over the warp, then the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(pi::kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? red[w] : 0;
      total += red[w];
    }
    slots[tid] = PieceSlot{b, nb, before + incl - items};
    __syncthreads();
    for (int k = warp; k < total; k += kWarps) {
      // the last slot whose first item is <= k holds item k
      int lo = 0, hi = kThreads - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (slots[mid].first_item <= k) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const PieceSlot q = slots[lo];
      const int off = (k - q.first_item) * kItemIds;
      hits += pi::bitmap_part<kPieceIlp>(q.b + off, min(kItemIds, q.nb - off),
                                         bitmap, lane);
    }
    __syncthreads();  // slots and red are rewritten next
  }
  hits = __reduce_add_sync(pi::kFull, hits);
  if (lane == 0) red[warp] = hits;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    if (total != 0) atomicAdd(args.acc + base + u, total);
  }
}

// acc[rank, u] += the pair's count: exact and order-free
struct AddCount {
  int* acc;
  __device__ __forceinline__ void operator()(const pi::Pair& pr,
                                             int c) const {
    if (c != 0) atomicAdd(acc + pr.dst, c);
  }
};

__global__ void __launch_bounds__(kThreads)
epoch_land_kernel(const int* __restrict__ row_ids,
                  const long long* __restrict__ row_off,
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
      row_ids + __ldg(row_off + (long long)src * (n_loc + 1) + loc);
  int* out = landing + __ldg(land_off + item);
  for (int k = lane; k < len; k += 32) out[k] = __ldg(row + k);
}

}  // namespace

// Outside the anonymous namespace, so that a profiler names an instantiation
// `void epoch::epoch_count_kernel<true>(...)`: the bare name every trace
// reader takes as epoch_count_kernel. kRuns: the problem has a run table
// (piece blocks first, then tile blocks over its tiles); without one the
// kernel is the tile kernel alone, at 32 registers (kRuns takes 40, which
// costs occupancy where shared memory does not already bound it: on the
// H100, urand S19's count took 10.9 ms an epoch as one kernel, 8.1 before).
namespace epoch {

template <bool kRuns>
__global__ void __launch_bounds__(kThreads)
epoch_count_kernel(const CountArgs args) {
  __shared__ pi::Tile<kTile> tile;
  __shared__ int red[kWarps];
  extern __shared__ __align__(16) int stage[];

  if constexpr (kRuns) {
    if ((int)blockIdx.x < args.n_pieces) {
      count_piece(args, blockIdx.x, reinterpret_cast<unsigned*>(stage), red);
      return;
    }
  }
  const int tid = threadIdx.x;
  pi::tile_init(tile);
  __syncthreads();

  // this thread's slot: e = rank * e_max + round * e_chunk + j
  const long long t = (long long)blockIdx.x - args.n_pieces;
  long long e = -1;
  int rank = 0;
  if constexpr (kRuns) {
    const long long packed = args.tiles[t];
    if (tid < (int)(packed & 31)) {
      e = (packed >> 5) + tid;
      rank = (int)(e / args.e_max);
    }
  } else {
    const long long slot = t * kTile + tid;
    if (tid < kTile && slot < (long long)args.p * args.e_chunk) {
      rank = (int)(slot / args.e_chunk);
      e = (long long)rank * args.e_max + (long long)args.round * args.e_chunk +
          slot % args.e_chunk;
    }
  }
  if (e >= 0 && args.edge_mask[e]) {
    const int u = args.edge_u[e];
    const long long base = (long long)rank * (args.n_loc + 1);
    const int na = args.deg_ext[base + u];
    const int* b;
    int nb;
    row_of_v(args, rank, base, args.edge_vc[e], b, nb);
    if (u < args.n_loc && na > 0 && nb > 0) {
      const bool merge = pi::use_merge(args.method, na, nb);
      pi::tile_add<kTile, kLightWork, kHeavyWork>(
          tile, tid,
          pi::Pair{args.row_ids + __ldg(args.row_off + base + u), b, na, nb,
                   (int)(base + u), merge ? 1 : 0});
    }
  }
  __syncthreads();
  pi::tile_count<kThreads, kGroup>(tile, stage, args.stage_cap, red,
                                   AddCount{args.acc});
}

}  // namespace epoch

extern "C" int epoch_count_launch(
    const void* row_ids, const void* row_off, const void* deg_ext,
    const void* cache_rows, long long cache_stride, const void* cache_len,
    int n_cache, const void* landing, const void* land_off,
    const void* land_len, const void* edge_u, const void* edge_vc,
    const void* edge_mask, int p, int n_loc, int s_max, long long e_max,
    long long e_chunk, int round, int method, int stage_cap,
    const void* piece_e, const void* piece_n, int n_pieces, const void* tiles,
    long long n_tiles, int bitmap_words, void* acc, void* stream) {
  // n_tiles < 0: no tile table, the tile blocks take every kTile slots
  const long long tile_blocks =
      n_tiles >= 0 ? n_tiles : ((long long)p * e_chunk + kTile - 1) / kTile;
  // pieces come with a run table, and so with its tiles (n_tiles >= 0)
  if ((n_tiles > 0 && tiles == nullptr) || (n_tiles < 0 && tiles != nullptr) ||
      n_pieces < 0 || (n_pieces > 0 && n_tiles < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = n_pieces + tile_blocks;
  if (blocks <= 0) return 0;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (stage_cap < 0 || stage_cap > kStageCap) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = (size_t)stage_cap * sizeof(int);
  if (n_pieces > 0) {
    const size_t need =
        (size_t)bitmap_words * sizeof(unsigned) + kThreads * sizeof(PieceSlot);
    if (bitmap_words <= 0 || bitmap_words % 4 != 0 || need > kSmemCap) {
      return (int)cudaErrorInvalidValue;
    }
    if (need > smem) smem = need;
  }
  const CountArgs args{
      (const int*)row_ids, (const long long*)row_off, (const int*)deg_ext,
      (const int*)cache_rows, cache_stride, (const int*)cache_len, n_cache,
      (const int*)landing, (const long long*)land_off, (const int*)land_len,
      (const int*)edge_u, (const int*)edge_vc,
      (const unsigned char*)edge_mask, p, n_loc, s_max, e_max, e_chunk,
      round, method, stage_cap, (const long long*)piece_e,
      (const int*)piece_n, n_pieces, (const long long*)tiles, bitmap_words,
      (int*)acc};
  if (n_tiles >= 0) {
    epoch::epoch_count_kernel<true><<<(unsigned)blocks, kThreads, smem,
                                      (cudaStream_t)stream>>>(args);
  } else {
    epoch::epoch_count_kernel<false><<<(unsigned)blocks, kThreads, smem,
                                       (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}

extern "C" int epoch_land_launch(const void* row_ids, const void* row_off,
                                 const void* serve_idx, const void* land_off,
                                 const void* land_len, void* landing, int p,
                                 int n_loc, int s_max, int n_rounds, int round,
                                 void* stream) {
  const long long n_items = (long long)p * p * s_max;
  if (n_items <= 0) return 0;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  epoch_land_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)row_ids, (const long long*)row_off, (const int*)serve_idx,
      (const long long*)land_off, (const int*)land_len, (int*)landing, p,
      n_loc, s_max, n_rounds, round);
  return (int)cudaGetLastError();
}

extern "C" int epoch_count_stage_cap() { return kStageCap; }

extern "C" int epoch_count_tile_slots() { return kTile; }
