// Bitmap AND + popcount intersection count, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_popcount.py::
// bitmap_intersect_count (_kernel, _popcount_u32): for E pairs of rows packed
// into 32-bit bitmap words over one vertex window
//   counts[e] = sum_w popcount(words_a[e, w] & words_b[e, w]).
// The words arrive as int32 bit patterns (torch has little uint32 support);
// the kernel reads them as unsigned.
//
// On the TPU the popcount is a SWAR bit-slice (add/shift/and on the VPU) over
// [block_e, W] tiles, and E must be a multiple of block_e. Here the hardware
// __popc does it in one instruction, and one warp handles one pair: lanes
// stride over the row's words, with 16-byte loads when the row allows it
// (W % 4 == 0 and 16-byte aligned operands), so a warp moves 512 contiguous
// bytes of each operand per step; __reduce_add_sync folds the 32 partial
// counts and lane 0 stores. Any E and any W are accepted: whole warps beyond
// E return before any shuffle.
//
// Bound: memory — every word of both operands is read once (2 * E * W * 4
// bytes) and one int32 is written per pair; the arithmetic is an AND, a
// popcount and an add per word.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
bitmap_popcount_kernel(const unsigned* __restrict__ words_a,
                       const unsigned* __restrict__ words_b,
                       int* __restrict__ counts, long long n_pairs,
                       long long n_words, int vec) {
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // ragged edge: whole warps only, no sync below
  const int lane = threadIdx.x & 31;
  const unsigned* a = words_a + pair * n_words;
  const unsigned* b = words_b + pair * n_words;
  int bits = 0;
  if (vec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    const long long n4 = n_words >> 2;
    for (long long i = lane; i < n4; i += 32) {
      const uint4 x = __ldg(a4 + i);
      const uint4 y = __ldg(b4 + i);
      bits += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
              __popc(x.w & y.w);
    }
  } else {
    for (long long i = lane; i < n_words; i += 32) {
      bits += __popc(__ldg(a + i) & __ldg(b + i));
    }
  }
  bits = __reduce_add_sync(0xffffffffu, bits);
  if (lane == 0) counts[pair] = bits;
}

}  // namespace

extern "C" int bitmap_popcount_launch(const void* words_a, const void* words_b,
                                      void* counts, long long n_pairs,
                                      long long n_words, int vec,
                                      void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  bitmap_popcount_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const unsigned*)words_a, (const unsigned*)words_b, (int*)counts,
      n_pairs, n_words, vec);
  return (int)cudaGetLastError();
}
