// Segment sum over edge-sorted segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/segment_sum_sorted.py::segment_sum_sorted (_kernel):
// for values [E, D] fp32 and seg [E] int32
//   out[n, :] = sum over e with seg[e] == n of values[e, :]   (fp32 [N, D])
// where ids outside [0, N) (the padding id N, negative ids) are dropped, as
// jax.ops.segment_sum drops them. It is the GNN message-passing reduction:
// the edges come sorted by destination, so the ids ascend; the result is
// exact (up to the fp32 order of the sums) for ids in any order.
//
// On the TPU the grid walks the edge blocks in order on one core and adds a
// one-hot [rows, block_e] x [block_e, D] product into an output block that
// stays in VMEM: an MXU stand-in for a scatter. Blocks here run in
// parallel and in no order, so nothing carries over between them:
//
// - A row of D floats is read in chunks of VEC (16-byte loads where D % 4
//   == 0 and the values are 16-byte aligned, else 8 or 4 bytes). `lpr`
//   lanes hold a piece of a row, a chunk each: the whole row when it has
//   at most 32 chunks, else one of `pieces` equal pieces (D = 640: 5 x 32
//   lanes x 16 B). A warp holds `groups` = 32 / lpr lane groups (D = 64: 2
//   groups of 16 lanes; D = 8: 16 groups of 2; D = 1: 32 groups of 1).
// - The edge axis is cut into runs of groups x steps edges, one warp a
//   (run, piece). Group k of the warp walks its `steps` consecutive edges
//   in order, kUnroll edges' loads (ids and chunks) in flight at a time,
//   and keeps a register sum while the id stays the same. A segment that
//   starts and ends inside the group is flushed where it ends; the group's
//   first run of ids (its head) and its last (its tail) are kept.
// - At the end of the run the groups' heads and tails are joined across
//   the warp, on adjacency alone: group k joins group k - 1 when its first
//   edge has the id of k - 1's last. A chain of tails (a group that is one
//   run of ids and joins on passes its sum to the next) is summed by a
//   segmented scan of shuffles (log2 groups steps); the group where a chain
//   ends flushes it, or adds it to its own head. So each maximal run of
//   equal consecutive ids inside the warp's run is flushed once a chunk:
//   one flush per (segment, run, chunk) for sorted ids, and every flush
//   exact for ids in any order (equal ids that are not adjacent are never
//   joined, they are flushed apart).
// - A flush is one atomicAdd of a float4 (float2) in global memory, which
//   sm_90 does as one vector reduction (red.global.add.v4.f32), if the id
//   lies in [0, N); otherwise the sum is dropped.
// - The wrapper (kernels/segment_sum_sorted.py::geometry) chooses steps
//   from E, D, N and the SM count: enough warps to fill the card
//   (FILL_WARPS_PER_SM) where E allows, never fewer than RUN_SEGMENTS
//   average segments (E / N edges) a run, so that flushes stay near one a
//   segment, and at most MAX_STEPS edges a group (the 256-edge runs of a
//   thread that held ogb_products at 82% of its bound in the first design).
//   At MACE's paths (E = 8,192 into 3,840) on 132 SMs that is at least 31,
//   20 and 6 warps an SM at l = 2, 1, 0 (steps 10, 9, 9).
//
// The atomics are the price of exactness in any order; their order, and so
// the fp32 rounding, changes from run to run. The wrapper zeroes `out`
// (torch.zeros); this file allocates nothing.
//
// Bound: memory. Values and ids are read once and out written once, over
// 3.35 TB/s: at gin-tu x ogb_products, layers 2-5 ([61,859,140 x 64], N =
// 2,449,029), 16.71 GB -> 4.99 ms; layer 1 (D = 100) 25.97 GB -> 7.75 ms;
// at mace x molecule's l = 2 paths ([8,192 x 640] into 3,840 segments)
// 30.8 MB -> 0.0092 ms, l = 1 (x 384) 0.0055 ms, l = 0 (x 128) 0.0018 ms.
// MACE's 31 MB fit in the card's 50 MB L2, so a time taken over repeated
// calls in a CUDA graph (warm) can read under the HBM bound. The arithmetic
// is one add per element read. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py's time_segment_sum; each call with its output's zeroing):
// warm, 20 calls in a CUDA graph, the bound's share of the time is 83% at
// MACE's l = 2 paths (0.0111 ms), 71% at l = 1, 37% at l = 0, 23% at
// gat-cora's [10,556 x 8 x 8]; the readout and gat-cora's denominator
// (31 KB, 0.47 MB) are two launches' latency (3.4-3.6 us). Cold (16.7 and
// 26 GB, beyond L2), ogb_products' two widths are at 83% (5.99 / 9.32 ms).
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, the geometry and the current stream, and raises on a
// non-zero return. It narrows int64 ids to int32 first (ids outside [0, N)
// to -1), so the kernel is built for int32 ids alone.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // edges a lane loads before it sums them
constexpr unsigned kAll = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p,
                                           float* o) {
  if constexpr (VEC == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = r.x;
    o[1] = r.y;
    o[2] = r.z;
    o[3] = r.w;
  } else if constexpr (VEC == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = r.x;
    o[1] = r.y;
  } else {
    static_assert(VEC == 1, "VEC must be 1, 2 or 4");
    o[0] = __ldg(p);
  }
}

// One vector reduction into out[id, col : col + VEC] if 0 <= id < N.
template <int VEC>
__device__ __forceinline__ void flush(float* __restrict__ out, int id,
                                      long long n, int d, int col,
                                      const float* s) {
  if (id < 0 || id >= n) return;  // outside [0, N): dropped
  float* o = out + (long long)id * d + col;
  if constexpr (VEC == 4)
    atomicAdd(reinterpret_cast<float4*>(o),
              make_float4(s[0], s[1], s[2], s[3]));
  else if constexpr (VEC == 2)
    atomicAdd(reinterpret_cast<float2*>(o), make_float2(s[0], s[1]));
  else
    atomicAdd(o, s[0]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals, const int* __restrict__ seg,
                   float* __restrict__ out, long long e, int d, long long n,
                   int lpr, int groups, int pieces, int steps,
                   long long warps) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= warps) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long run = w / pieces;
  const int piece = (int)(w - run * pieces);
  const int k = lane / lpr, sub = lane - k * lpr;
  const int col = (piece * lpr + sub) * VEC;
  const long long b = (run * groups + k) * (long long)steps;
  const bool has = k < groups && b < e;  // the group has edges
  const bool on = has && col < d;        // the lane has a chunk
  const long long end = has ? min(e, b + steps) : b;
  const float* src = vals + col;
  const int first = has ? __ldg(seg + b) : 0;
  int cur = first;
  bool split = false;  // the group's head (its first run of ids) is closed
  float acc[VEC], head[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = head[v] = 0.f;

  for (long long i = b; i < end; i += kUnroll) {
    int id[kUnroll];
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load out before any sum
      const long long q = i + u;
      const bool in = q < end;
      id[u] = in ? __ldg(seg + q) : (u > 0 ? id[u - 1] : cur);
      if (in && on) {
        load_chunk<VEC>(src + q * d, x[u]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[u][v] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (id[u] != cur) {
        if (split) {
          if (on) flush<VEC>(out, cur, n, d, col, acc);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) head[v] = acc[v];
          split = true;
        }
        cur = id[u];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += x[u][v];
    }
  }

  // Join the groups: k joins k - 1 if its first id is k - 1's last.
  const int prev_last = __shfl_up_sync(kAll, cur, lpr);
  const bool joins = has && k > 0 && prev_last == first;
  // A chain of tails starts at every group but one that is a single run
  // and joins on; k's chain starts at the nearest such start at or below k.
  const unsigned starts =
      __ballot_sync(kAll, sub == 0 && !(joins && !split));
  const int k0 = (31 - __clz(starts & (kAll >> (31 - k * lpr)))) / lpr;
  float tail[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) tail[v] = acc[v];
  for (int s = 1; s < groups; s <<= 1) {  // segmented inclusive scan
    float up[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      up[v] = __shfl_up_sync(kAll, tail[v], s * lpr);
    if (k - s >= k0) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) tail[v] += up[v];
    }
  }
  float before[VEC];  // the chain that ends in group k - 1
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    before[v] = __shfl_up_sync(kAll, tail[v], lpr);
  const bool next_joins =
      __shfl_down_sync(kAll, (int)joins, lpr) != 0 && k + 1 < groups;
  if (on) {
    if (split) {  // the head closes the chain of k - 1 if it joins on
      if (joins) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) head[v] += before[v];
      }
      flush<VEC>(out, first, n, d, col, head);
    }
    if (!next_joins) flush<VEC>(out, cur, n, d, col, tail);
  }
}

template <int VEC>
int launch_vec(const float* vals, const int* seg, float* out, long long e,
               int d, long long n, int lpr, int pieces, int steps,
               cudaStream_t stream) {
  if (d % VEC != 0 || lpr < 1 || lpr > 32 || pieces < 1 ||
      (long long)pieces * lpr * VEC < d || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = 32 / lpr;
  const long long run = (long long)groups * steps;
  const long long warps = (e + run - 1) / run * pieces;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  segment_sum_kernel<VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      vals, seg, out, e, d, n, lpr, groups, pieces, steps, warps);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: floats a load (4, 2 or 1; the widest that divides D and the values'
// alignment). seg: int32 ids (the wrapper narrows int64 ids). lpr, pieces,
// steps: the wrapper's geometry; the lane groups a warp (32 / lpr) and the
// grid follow from them. `out` must hold N * D zeros.
extern "C" int segment_sum_sorted_launch(const void* values, const void* seg,
                                         void* out, long long e, int d,
                                         long long n, int vec, int lpr,
                                         int pieces, int steps,
                                         void* stream) {
  if (e <= 0 || d <= 0 || n <= 0) return 0;
  const float* v = static_cast<const float*>(values);
  const int* s = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4:
      return launch_vec<4>(v, s, o, e, d, n, lpr, pieces, steps, st);
    case 2:
      return launch_vec<2>(v, s, o, e, d, n, lpr, pieces, steps, st);
    case 1:
      return launch_vec<1>(v, s, o, e, d, n, lpr, pieces, steps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
