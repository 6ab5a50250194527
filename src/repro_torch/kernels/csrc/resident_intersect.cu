// Intersection count against device-resident rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/resident_intersect.py::
// resident_intersect (_kernel, called by _vs_rows and _vs_slots): for E pairs
//   counts[e] = |residency[slots_a[e]] ∩ B[e]|,
// where B[e] is rows_b[e] (one uploaded side, [E, WB]) or
// residency[slots_b[e]] (both sides resident). residency is the device tier's
// persistent [S, W] int32 tensor of sorted, sentinel-padded rows.
//
// On the TPU, scalar prefetch of the slot ids drives one DMA of the resident
// row per program into VMEM, followed by the all-pairs compare. Here each
// warp reads its pair's slot id(s) at the start and points straight into the
// resident tensor: no [E, W] A operand is ever materialised and the resident
// rows never leave the device. The count itself is B1's (warp_intersect.cuh):
// binary search of the sentinel for each row's valid prefix, then the shorter
// prefix searched in the longer, so the work follows the degrees, not W.
// One warp per pair masks the ragged edge: no power-of-two padding of E.
//
// Bound: memory — one read of each row's valid prefix, the slot ids and one
// int32 store per pair; a few compares per element read.
//
// Slots are checked on the host by the wrapper (0 <= slot < S); a slot out of
// range is read here as an empty row (count 0), never out of bounds.
// Evicted slots are all-sentinel rows and count 0.
//
// Plain C interface (no PyTorch headers): slots_b == nullptr selects the
// one-resident-side variant (rows_b given), otherwise rows_b is ignored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_intersect.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
resident_intersect_kernel(const int* __restrict__ residency, int n_slots,
                          int w, const int* __restrict__ slots_a,
                          const int* __restrict__ slots_b,
                          const int* __restrict__ rows_b, int wb,
                          int* __restrict__ counts, long long n_pairs,
                          int sentinel) {
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // ragged edge: whole warps only, no sync below
  const int lane = threadIdx.x & 31;
  const int sa = __ldg(slots_a + pair);
  const bool a_ok = sa >= 0 && sa < n_slots;
  const int* a = residency + (long long)(a_ok ? sa : 0) * w;
  const int a_w = a_ok ? w : 0;
  const int* b;
  int b_w;
  if (slots_b != nullptr) {
    const int sb = __ldg(slots_b + pair);
    const bool b_ok = sb >= 0 && sb < n_slots;
    b = residency + (long long)(b_ok ? sb : 0) * w;
    b_w = b_ok ? w : 0;
  } else {
    b = rows_b + pair * (long long)wb;
    b_w = wb;
  }
  const int hits = warp_intersect::count(a, a_w, b, b_w, sentinel, lane);
  if (lane == 0) counts[pair] = hits;
}

}  // namespace

extern "C" int resident_intersect_launch(const void* residency, int n_slots,
                                         int w, const void* slots_a,
                                         const void* slots_b,
                                         const void* rows_b, int wb,
                                         void* counts, long long n_pairs,
                                         int sentinel, void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  resident_intersect_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int*)residency, n_slots, w, (const int*)slots_a,
      (const int*)slots_b, (const int*)rows_b, wb, (int*)counts, n_pairs,
      sentinel);
  return (int)cudaGetLastError();
}
