// Warp-cooperative count of the common ids of two sorted rows — the device
// code of resident_intersect.cu (B3); B1 and B7 use pair_intersect.cuh.
//
// A row is sorted ascending, deduplicated and padded with ids >= sentinel,
// so its padding is a suffix. One warp handles one pair:
//   1. every lane binary-searches the sentinel in each row: O(log W)
//      broadcast loads find the valid lengths na, nb, and the padding is
//      never touched again;
//   2. the shorter prefix is walked with coalesced, lane-strided loads; each
//      element is binary-searched in the longer prefix, which stays hot in
//      L1/L2 for the warp. Work ~ min(na, nb) * log2 max(na, nb);
//   3. __reduce_add_sync folds the 32 partial counts.
// Validity is checked on the A side only, as in the reference: a valid id is
// < sentinel and B's padding is >= sentinel, so restricting B to its valid
// prefix drops no match, and sentinel == sentinel is never counted (an
// all-sentinel row, e.g. an evicted resident slot, counts 0). Searching the
// shorter row in the longer one relies on the rows being deduplicated.
#pragma once

#include <cuda_runtime.h>

namespace warp_intersect {

// first index in row[0, n) whose value is >= key
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// |a[0, wa) ∩ b[0, wb)| over the valid (< sentinel) prefixes; called by all
// 32 lanes of a warp, every lane returns the full count.
__device__ __forceinline__ int count(const int* __restrict__ a, int wa,
                                     const int* __restrict__ b, int wb,
                                     int sentinel, int lane) {
  const int na = lower_bound(a, wa, sentinel);
  const int nb = lower_bound(b, wb, sentinel);
  const int* s_row = a;
  const int* l_row = b;
  int ns = na, nl = nb;
  if (na > nb) {
    s_row = b;
    l_row = a;
    ns = nb;
    nl = na;
  }
  int hits = 0;
  for (int i = lane; i < ns; i += 32) {
    const int x = __ldg(s_row + i);
    const int pos = lower_bound(l_row, nl, x);
    hits += (pos < nl && __ldg(l_row + pos) == x) ? 1 : 0;
  }
  return __reduce_add_sync(0xffffffffu, hits);
}

}  // namespace warp_intersect
