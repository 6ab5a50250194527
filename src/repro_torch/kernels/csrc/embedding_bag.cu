// EmbeddingBag (gather + weighted reduce), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::embedding_bag
// (_kernel) behind src/repro/kernels/ops.py::embedding_bag: for a table
// [N, D] (fp32, bf16 or fp16), ids [B, L] int32 and weights [B, L] fp32
//   pooled[b, :] = sum_l w[b, l] * table[ids[b, l], :]   (fp32 out [B, D]).
// The wrapper computes w from the mask exactly as the reference does (mask,
// or mask / max(sum(mask), 1) for "mean"). As jnp.take does in the
// reference's oracle, a negative id counts from the end of the table and an
// id outside [-N, N) contributes NaN.
//
// On the TPU the ids and weights are scalar-prefetched and each grid step
// slices rows of an HBM table into VMEM one at a time, with B a multiple of
// block_b. Here one warp owns one bag and any B is accepted. A row is read
// in chunks of VB bytes (the widest of 16, 8, 4 or 2 that divides the row
// and the table's alignment); `lpr` lanes (the chunk count rounded up to a
// power of two, at most 32) cover one row, so 32 / lpr positions of the bag
// are in flight per step — at DIN's D = 18 fp32 (72-byte rows, 8-byte
// chunks) two rows per step. Each lane accumulates its chunk in fp32, the
// position groups are folded with xor shuffles, and the first group writes.
// Rows wider than 32 chunks are walked 32 chunks at a time.
//
// Bound: memory. Each table row a bag touches is read once (random rows of
// a table far larger than L2), plus the ids, the weights and the fp32
// output; the arithmetic is one FMA per element read.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ w, float* __restrict__ out,
                     long long n_rows, long long n_bags, int bag, int d,
                     int chunks, int lpr) {
  constexpr int VE = VB / sizeof(T);  // elements per chunk
  const long long bi = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bi >= n_bags) return;  // whole warps only: no shuffle below is split
  const int lane = threadIdx.x & 31;
  const int ppw = 32 / lpr;  // positions in flight per warp
  const int grp = lane / lpr, sub = lane % lpr;
  const int* bid = ids + bi * bag;
  const float* bw = w + bi * bag;
  const float nan = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < chunks; c0 += lpr) {
    const int c = c0 + sub;
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
    if (c < chunks) {
#pragma unroll 4
      for (int l = grp; l < bag; l += ppw) {
        long long id = __ldg(bid + l);
        const float wt = __ldg(bw + l);
        if (id < 0) id += n_rows;  // counts from the end, as jnp.take does
        if (id < 0 || id >= n_rows) {
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[e] += nan;
        } else {
          float x[VE];
          elem::load_widen<T, VB>(table + id * d + c * VE, x);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
        }
      }
    }
    for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (grp == 0 && c < chunks) {
      float* o = out + bi * d + c * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] = acc[e];
    }
  }
}

template <typename T, int VB>
int launch_t(const void* table, const void* ids, const void* w, void* out,
             long long n_rows, long long n_bags, int bag, int d,
             cudaStream_t stream) {
  constexpr int VE = VB / sizeof(T);
  if (d % VE != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d / VE;
  int lpr = 1;
  while (lpr < chunks && lpr < 32) lpr <<= 1;
  const long long blocks = (n_bags + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VB><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<float*>(out), n_rows, n_bags,
      bag, d, chunks, lpr);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_vb(int vb, const void* table, const void* ids, const void* w,
                void* out, long long n_rows, long long n_bags, int bag, int d,
                cudaStream_t stream) {
  switch (vb) {
    case 16:
      return launch_t<T, 16>(table, ids, w, out, n_rows, n_bags, bag, d,
                             stream);
    case 8:
      return launch_t<T, 8>(table, ids, w, out, n_rows, n_bags, bag, d,
                            stream);
    case 4:
      return launch_t<T, 4>(table, ids, w, out, n_rows, n_bags, bag, d,
                            stream);
    default:
      if constexpr (sizeof(T) == 2) {
        if (vb == 2)
          return launch_t<T, 2>(table, ids, w, out, n_rows, n_bags, bag, d,
                                stream);
      }
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of the table: 0 float32, 1 bfloat16, 2 float16. vb: bytes per load.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    const void* w, void* out, int dtype,
                                    int vb, long long n_rows, long long n_bags,
                                    int bag, int d, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_vb<float>(vb, table, ids, w, out, n_rows, n_bags, bag,
                                d, st);
    case 1:
      return dispatch_vb<__nv_bfloat16>(vb, table, ids, w, out, n_rows,
                                        n_bags, bag, d, st);
    case 2:
      return dispatch_vb<__half>(vb, table, ids, w, out, n_rows, n_bags, bag,
                                 d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
