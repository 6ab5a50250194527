// Batched sorted-row intersection count for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/intersect_count.py::intersect_count
// (_kernel): for E pairs of sorted, deduplicated, sentinel-padded int32 rows
//   counts[e] = #{(s, t) : a[e, s] == b[e, t], a[e, s] < sentinel}.
//
// What is computed is the same; how is not. The TPU kernel compares all
// WA x WB slots because a merge or a search is anti-SIMD on its vector unit.
// Counts are integers, so any exact algorithm gives the same bits, and on
// this card the padding is the cost to avoid: a power-law graph pads every
// row to the maximum degree, so an all-pairs pass (or any pass that reads the
// whole padded rows) moves mostly sentinels.
//
// Bound: memory. The least work is one read of each row's valid prefix plus
// one int32 store per pair, over the card's 3.35 TB/s; the arithmetic is a
// few compares per element read. Design: one warp per pair. This API carries
// no lengths, so the warp finds each row's valid length: the first id >=
// sentinel, by rounds of 32 probes and one ballot each — positions [0, 32)
// (one coalesced 128-byte read settles every row shorter than 32), then
// 32 * 2^k (one sector a probe, brackets the length within a factor of 2),
// then 33-way splits of what is left until 32 positions remain, read
// together. A row of degree d takes ~2 + log33(d) rounds where a binary
// search over the padded width takes log2(W) dependent loads (14 for
// W = 9,754), and reads few sectors: most rows are short. Then it counts the
// two valid prefixes with pair_intersect.cuh's warp merge or search, chosen
// per pair by the hybrid rule; lane 0 stores. Validity is decided on the A
// side as in the reference: B's padding is >= sentinel, so B's valid prefix
// drops no match.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_intersect.cuh"

namespace {

namespace pi = pair_intersect;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

// first index of row[0, w) whose id is >= sentinel (w if none), by all 32
// lanes of a warp; every lane returns it
__device__ __forceinline__ int valid_length(const int* __restrict__ row, int w,
                                            int sentinel, int lane) {
  unsigned ge =
      __ballot_sync(pi::kFull, lane < w && __ldg(row + lane) >= sentinel);
  if (ge) return __ffs(ge) - 1;
  if (w <= 32) return w;
  // row[0, 32) is valid; lane k probes 32 * 2^k
  const long long q2 = 32LL << min(lane, 30);
  ge = __ballot_sync(pi::kFull, q2 < w && __ldg(row + q2) >= sentinel);
  int lo, hi;  // the answer lies in [lo, hi]
  if (ge) {
    const int k0 = __ffs(ge) - 1;
    hi = 32 << k0;
    lo = k0 > 0 ? (32 << (k0 - 1)) + 1 : 32;
  } else {
    const unsigned below = __ballot_sync(pi::kFull, q2 < w);
    lo = (32 << (31 - __clz(below))) + 1;
    hi = w;
  }
  while (hi - lo > 32) {
    const int span = hi - lo;
    const int q = lo + (int)(((long long)(lane + 1) * span) / 33);
    ge = __ballot_sync(pi::kFull, __ldg(row + q) >= sentinel);
    if (ge == 0) {
      lo = __shfl_sync(pi::kFull, q, 31) + 1;
    } else {
      const int k0 = __ffs(ge) - 1;
      const int q_prev = __shfl_sync(pi::kFull, q, k0 > 0 ? k0 - 1 : 0);
      hi = __shfl_sync(pi::kFull, q, k0);
      if (k0 > 0) lo = q_prev + 1;
    }
  }
  const int i = lo + lane;
  ge = __ballot_sync(pi::kFull, i < hi && __ldg(row + i) >= sentinel);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const int* __restrict__ rows_a,
                       const int* __restrict__ rows_b,
                       int* __restrict__ counts, long long n_pairs, int wa,
                       int wb, int sentinel) {
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // ragged edge: whole warps only, no sync below
  const int lane = threadIdx.x & 31;
  const int* a = rows_a + pair * (long long)wa;
  const int* b = rows_b + pair * (long long)wb;
  const int na = valid_length(a, wa, sentinel, lane);
  const int nb = valid_length(b, wb, sentinel, lane);
  const int hits = pi::group_count<32>(a, na, b, nb, pi::merges(na, nb), lane,
                                       pi::kFull);
  if (lane == 0) counts[pair] = hits;
}

}  // namespace

extern "C" int intersect_count_launch(const void* rows_a, const void* rows_b,
                                      void* counts, long long n_pairs, int wa,
                                      int wb, int sentinel, void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  intersect_count_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)rows_a, (const int*)rows_b, (int*)counts, n_pairs, wa, wb,
      sentinel);
  return (int)cudaGetLastError();
}
