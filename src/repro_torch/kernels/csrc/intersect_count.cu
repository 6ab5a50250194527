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
// few compares per element read. Design: one warp per pair, the sentinel-
// prefix search and the search of the shorter prefix in the longer one of
// warp_intersect.cuh (shared with resident_intersect.cu); lane 0 stores.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_intersect.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const int* __restrict__ rows_a,
                       const int* __restrict__ rows_b,
                       int* __restrict__ counts, long long n_pairs, int wa,
                       int wb, int sentinel) {
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // ragged edge: whole warps only, no sync below
  const int lane = threadIdx.x & 31;
  const int hits = warp_intersect::count(rows_a + pair * (long long)wa, wa,
                                         rows_b + pair * (long long)wb, wb,
                                         sentinel, lane);
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
