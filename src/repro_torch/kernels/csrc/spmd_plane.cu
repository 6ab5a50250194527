// The two device programs of the SPMD data plane for Hopper (sm_90a): the
// serve block (B5) and the pair counts (B6), two entry points of one library.
//
// Replaces src/repro/distributed/spmd_runtime.py::_body_serve (B5) and
// ::_body_pairs (B6), the two shard_map programs of one execution unit. On
// one card the p ranks are the leading axis of every tensor, and the
// all_to_all is the block transpose got[dst, src] = to_send[src, dst].
//
//   serve_block  for requester j, width rung b = (s_b, w_b) (windowed
//                capacities, rungs in ladder order, base(b) = p * the sum of
//                the earlier s_b), source rank k and position pos < s_b:
//                  out[j, base(b) + k * s_b + pos, :w_b]
//                    = rows[k, serve_idx[k, j, off(b) + pos], :w_b],
//                columns [w_b, W) the sentinel, and rows [n_rows, f_pad) of
//                the block all sentinel: the [p, f_pad, W] fetched block the
//                reference builds by per-rung gather, all_to_all, re-pad and
//                concatenate. One warp an output row, lane-strided 16-byte
//                copies (as epoch_land_kernel in epoch_count.cu), one launch
//                a unit over every rung. Bound: bytes, the block written
//                whole at W (the reference's layout; a packed landing of the
//                valid prefixes, as B7 has, is a later redesign).
//   pair_counts  for every worklist position (j, e) of the unit's [p, E_tot]
//                list, |A ∩ B| of two rows read by index where they lie: an
//                index < H reads rows[j, idx], otherwise fetched[j, idx - H],
//                each over its valid length a_len / b_len (the widths the
//                host already holds for every ref). A phantom position
//                (mask false, pointed at the pad slot) writes 0. One warp a
//                pair counts with pair_intersect.cuh's merge or search, chosen
//                by the hybrid rule, as B1 does; lane 0 stores int32.
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
// or merge (the bytes, valid prefixes read once, are small); a work classing
// as B7 has (heavy pairs split by a block, light ones by 8 lanes) is a later
// redesign.
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

struct PairArgs {
  const int* rows;     // [p, h, w]
  const int* fetched;  // [p, f_pad, w]
  const int* a_idx;    // [p, e_tot] combined index: < h resident, else fetched
  const int* b_idx;
  const int* a_len;    // [p, e_tot] valid length of each side
  const int* b_len;
  const unsigned char* mask;  // [p, e_tot] bool: real sub-pair
  int* out;                   // [p, e_tot]
  int p, h, f_pad, w;
  long long e_tot;
};

__device__ __forceinline__ const int* row_at(const PairArgs& a, int j,
                                             int idx) {
  return idx < a.h ? a.rows + ((long long)j * a.h + idx) * a.w
                   : a.fetched + ((long long)j * a.f_pad + (idx - a.h)) * a.w;
}

constexpr int kPairWarps = 4;

__global__ void __launch_bounds__(kPairWarps * 32)
pair_counts_kernel(const PairArgs a) {
  const long long i =
      (long long)blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (i >= (long long)a.p * a.e_tot) return;  // whole warps: no sync below
  const int lane = threadIdx.x & 31;
  if (!a.mask[i]) {
    if (lane == 0) a.out[i] = 0;
    return;
  }
  const int j = (int)(i / a.e_tot);
  const int na = __ldg(a.a_len + i), nb = __ldg(a.b_len + i);
  const int* ra = row_at(a, j, __ldg(a.a_idx + i));
  const int* rb = row_at(a, j, __ldg(a.b_idx + i));
  const int hits = pi::group_count<32>(ra, na, rb, nb, pi::merges(na, nb),
                                       lane, pi::kFull);
  if (lane == 0) a.out[i] = hits;
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

extern "C" int spmd_pair_counts_launch(
    const void* rows, const void* fetched, const void* a_idx,
    const void* b_idx, const void* a_len, const void* b_len,
    const void* mask, void* out, int p, int h, int f_pad, int w,
    long long e_tot, void* stream) {
  const long long n = (long long)p * e_tot;
  if (n <= 0) return 0;
  const long long blocks = (n + kPairWarps - 1) / kPairWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const PairArgs a{(const int*)rows,  (const int*)fetched, (const int*)a_idx,
                   (const int*)b_idx, (const int*)a_len,   (const int*)b_len,
                   (const unsigned char*)mask, (int*)out, p, h, f_pad, w,
                   e_tot};
  pair_counts_kernel<<<(unsigned)blocks, kPairWarps * 32, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
