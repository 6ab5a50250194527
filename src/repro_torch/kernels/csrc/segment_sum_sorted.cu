// Segment sum over edge-sorted segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/segment_sum_sorted.py::segment_sum_sorted (_kernel):
// for values [E, D] fp32 and seg [E] int32
//   out[n, :] = sum over e with seg[e] == n of values[e, :]   (fp32 [N, D])
// where ids outside [0, N) (the padding id N, negative ids) are dropped, as
// jax.ops.segment_sum drops them. It is the GNN message-passing reduction:
// the edges come sorted by destination, so the ids ascend.
//
// On the TPU the grid walks the edge blocks in order on one core and adds a
// one-hot [rows, block_e] x [block_e, D] product into an output block that
// stays in VMEM: an MXU stand-in for a scatter, O(N * E * D) work. Blocks
// here run in parallel and in no order, so nothing carries over between
// them. The edge axis is cut into runs of `ept` edges; a thread owns one
// run and one chunk of VEC columns (16-byte loads where D % 4 == 0, 8 or 4
// bytes otherwise). It walks its run in order, keeps a register sum while
// the id stays the same, and when the id changes, and at the end of the
// run, adds the sum into out[id, chunk] with one atomicAdd per column if
// 0 <= id < N (otherwise it drops the sum). Neighbouring threads hold
// neighbouring chunks of one run, so a row of values is read in one sweep.
// Each thread loads kUnroll edges (ids and values) before it sums them, to
// keep several loads in flight.
//
// The atomics are the price of exactness in any order: the result is right
// for unsorted ids too, at one atomic per column per change of id. With
// sorted ids that is about (segments + runs) * D atomics; their order, and
// so the fp32 rounding, changes from run to run. The wrapper zeroes `out`
// (torch.zeros); this file allocates nothing.
//
// Bound: memory. Values and ids are read once and out written once: at
// gin-tu x ogb_products, layers 2-5 ([61,859,140 x 64], N = 2,449,029),
// 16.71 GB / 3.35 TB/s = 4.99 ms; layer 1 (D = 100) 25.97 GB -> 7.75 ms.
// The arithmetic is one add per element read.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on a non-zero return.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int VEC>
struct Chunk {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Chunk<VEC> load_chunk(const float* __restrict__ p) {
  Chunk<VEC> c;
  if constexpr (VEC == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = r.x;
    c.v[1] = r.y;
    c.v[2] = r.z;
    c.v[3] = r.w;
  } else if constexpr (VEC == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p));
    c.v[0] = r.x;
    c.v[1] = r.y;
  } else {
    static_assert(VEC == 1, "VEC must be 1, 2 or 4");
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void flush(float* __restrict__ out, int id,
                                      long long n, int d, int col,
                                      const float* acc) {
  if (id < 0 || id >= n) return;  // outside [0, N): dropped
  float* o = out + (long long)id * d + col;
#pragma unroll
  for (int k = 0; k < VEC; ++k) atomicAdd(o + k, acc[k]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals, const int* __restrict__ seg,
                   float* __restrict__ out, long long e, int d, int chunks,
                   long long n, int ept, long long n_threads) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_threads) return;
  const int col = (int)(g % chunks) * VEC;
  const long long e0 = (g / chunks) * ept;
  const long long e1 = min(e, e0 + ept);
  const float* base = vals + col;
  int cur = __ldg(seg + e0);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  long long i = e0;
  for (; i + kUnroll <= e1; i += kUnroll) {
    int id[kUnroll];
    Chunk<VEC> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      id[u] = __ldg(seg + i + u);
      x[u] = load_chunk<VEC>(base + (i + u) * d);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (id[u] != cur) {
        flush<VEC>(out, cur, n, d, col, acc);
        cur = id[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += x[u].v[k];
    }
  }
  for (; i < e1; ++i) {
    const int id = __ldg(seg + i);
    const Chunk<VEC> x = load_chunk<VEC>(base + i * d);
    if (id != cur) {
      flush<VEC>(out, cur, n, d, col, acc);
      cur = id;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += x.v[k];
  }
  flush<VEC>(out, cur, n, d, col, acc);
}

template <int VEC>
int launch_vec(const float* vals, const int* seg, float* out, long long e,
               int d, long long n, int ept, cudaStream_t stream) {
  if (d % VEC != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d / VEC;
  const long long runs = (e + ept - 1) / ept;
  const long long n_threads = runs * chunks;
  const long long blocks = (n_threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  segment_sum_kernel<VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      vals, seg, out, e, d, chunks, n, ept, n_threads);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: floats per load (4, 2 or 1; the wrapper picks the widest that
// divides D and the values' alignment). ept: edges per run (> 0). `out`
// must hold N * D zeros.
extern "C" int segment_sum_sorted_launch(const void* values, const void* seg,
                                         void* out, long long e, int d,
                                         long long n, int vec, int ept,
                                         void* stream) {
  if (e <= 0 || d <= 0 || n <= 0) return 0;
  if (ept <= 0) return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(values);
  const int* s = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4:
      return launch_vec<4>(v, s, o, e, d, n, ept, st);
    case 2:
      return launch_vec<2>(v, s, o, e, d, n, ept, st);
    case 1:
      return launch_vec<1>(v, s, o, e, d, n, ept, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
