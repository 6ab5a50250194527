// EmbeddingBag (gather + masked reduce), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::embedding_bag
// (_kernel) behind src/repro/kernels/ops.py::embedding_bag: for a table
// [N, D] (fp32, bf16 or fp16), ids [B, L] (int32 or int64) and a mask
// [B, L] (bool, one byte a position)
//   pooled[b, :] = sum_l w[b, l] * table[ids[b, l], :]   (fp32 out [B, D]),
// w = mask ("sum") or mask / max(sum(mask), 1) ("mean"), as the reference
// computes it. The kernel reads the mask itself: a bag's count is a ballot
// and popc over its mask, its weight 1.0f / max(count, 1) (an IEEE-rounded
// division, the number the reference's fp32 w holds). As jnp.take does in
// the reference's oracle, a negative id counts from the end of the table
// and an id outside [-N, N) contributes NaN, masked or not (0 x NaN); a
// masked id in range still reads its row, so a masked Inf or NaN gives NaN
// as the reference's emb * w does. An all-masked bag is 0 in both modes.
//
// On the TPU the ids and weights are scalar-prefetched and each grid step
// slices rows of an HBM table into VMEM one at a time. Here:
//
// - A bag belongs to one warp (`wpb` = 1; a block of 8 warps holds 8 bags)
//   or to a whole block (`wpb` = 8). The bag's first warp loads its ids and
//   mask once (a tile's loads all issued before any is used) and stages in
//   shared memory, in order of position, the address of each row in range
//   with the mask in bit 0 (rows are at least 2-byte aligned). An id out of
//   range is left out and flags the bag, whose every element is then NaN:
//   such an id adds NaN, masked or not. Every lane takes its rows from
//   there: one shared load a row, no id -> row chain from global memory.
// - A row is read in chunks of VB bytes (the widest of 16, 8, 4, 2 that
//   divides the row and the table's alignment). `lpr` lanes cover one row
//   (the chunk count, at most 32), and a warp holds `gpw` = 32 / lpr groups,
//   a number that need not be a power of two: at DIN's D = 18 fp32 (72-byte
//   rows, 8-byte chunks) 3 groups of 9 lanes, 27 lanes loading. Rows wider
//   than 32 chunks are walked in pieces of 32.
// - Group k of the bag's G = wpb x gpw groups takes staged rows k, k + G,
//   ...; a lane's loop is unrolled by U rows (8 at 8-byte chunks), their
//   loads issued ahead of their FMAs.
// - The groups' partial sums go to shared memory and are folded once per
//   bag in a fixed order: no atomics, the same bits from run to run.
// - wpb = 8 spreads a small batch over the card (the served batch, 512
//   bags, 8 warps a bag); the wrapper chooses it, and the rest of the
//   geometry, from B, L, D, the element size and the SM count.
//
// Bound: bytes. The function reads each distinct row it touches once, the
// ids (4 or 8 B a position) and the mask (1 B a position), and writes the
// fp32 output: at serve_bulk (262,144 x 100 Zipf ids over a 10^8 x 18 fp32
// table, ~700,000 distinct rows) 200.3 MB, 0.0598 ms at 3.35 TB/s. Most of
// the 26 M row reads hit rows that L1 and L2 hold (83.9% of lookups fall on
// ids 0-255): the kernel takes about as long when every id is below 256,
// so it is held by the load and shared-memory instructions a row costs
// (PERF.md), not by HBM bytes.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, the geometry and the current stream, and raises on a
// non-zero return.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Rows a lane loads before their FMAs: U x VE floats of registers.
template <int VE>
__host__ __device__ constexpr int unroll() {
  return VE >= 8 ? 2 : (VE >= 4 ? 4 : 8);
}

// Shared memory of one bag: its staged rows (8 bytes each), its groups'
// partial sums and two ints (the staged count, the out-of-range flag),
// rounded up to 16 bytes (mirrored by the wrapper's geometry).
__host__ __device__ inline size_t unit_bytes(int tile, int groups,
                                             int piece) {
  const size_t b = (size_t)tile * 8 + (size_t)groups * piece * 4 + 8;
  return (b + 15) & ~(size_t)15;
}

constexpr int kMaxTile = 256;  // positions staged at a time, at most

// The warps of one bag meet: a warp alone, or the whole block.
__device__ __forceinline__ void unit_sync(int wpb) {
  if (wpb == 1)
    __syncwarp();
  else
    __syncthreads();
}

template <typename T, int VB, typename IdT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const IdT* __restrict__ ids,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ out, long long n_rows,
                     long long n_bags, int bag, int d, int mean, int lpr,
                     int gpw, int wpb, int tile) {
  constexpr int VE = VB / sizeof(T);  // elements per chunk
  constexpr int U = unroll<VE>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp / wpb, wu = warp - unit * wpb;
  const long long bi = (long long)blockIdx.x * (kWarps / wpb) + unit;
  if (bi >= n_bags) return;  // a whole warp (wpb = 1) or block (wpb = 8)
  const int ut = wu * 32 + lane, unit_threads = wpb * 32;
  const int groups = wpb * gpw, chunks = d / VE, piece = lpr * VE;
  unsigned char* base = smem + unit * unit_bytes(tile, groups, piece);
  unsigned long long* s_row = reinterpret_cast<unsigned long long*>(base);
  float* s_fold = reinterpret_cast<float*>(s_row + tile);
  int* s_meta = reinterpret_cast<int*>(s_fold + groups * piece);
  const IdT* bid = ids + bi * bag;
  const unsigned char* bm = mask + bi * bag;

  float inv = 1.f;
  if (mean) {  // every warp of the bag counts its mask itself
    int cnt = 0;
    for (int l0 = 0; l0 < bag; l0 += 32) {
      const int l = l0 + lane;
      cnt += __popc(__ballot_sync(0xffffffffu, l < bag && __ldg(bm + l)));
    }
    inv = 1.0f / (float)max(cnt, 1);  // IEEE division (no fast-math)
  }
  // The bag's first warp stages positions [l0, l0 + n): the address of each
  // row in range, its mask in bit 0 (rows are 2-byte aligned), in order of
  // position; an id out of range is left out and flags the bag, whose
  // every element is then NaN (it adds NaN, masked or not).
  bool bad = false;
  auto stage = [&](int l0, int n) {
    if (wu != 0) return;
    IdT id[kMaxTile / 32];
    bool m[kMaxTile / 32];
#pragma unroll
    for (int j = 0; j < kMaxTile / 32; ++j) {  // all loads out at once
      const int p = j * 32 + lane;
      id[j] = p < n ? __ldg(bid + l0 + p) : IdT(0);
      m[j] = p < n && __ldg(bm + l0 + p);
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kMaxTile / 32; ++j) {
      if (j * 32 >= n) break;
      const bool in = j * 32 + lane < n;
      long long r = (long long)id[j];
      if (r < 0) r += n_rows;  // counts from the end, as jnp.take does
      const bool ok = in && r >= 0 && r < n_rows;
      bad |= __any_sync(0xffffffffu, in && !ok);
      const unsigned keep = __ballot_sync(0xffffffffu, ok);
      if (ok)
        s_row[cnt + __popc(keep & ((1u << lane) - 1u))] =
            reinterpret_cast<unsigned long long>(table + r * d) | m[j];
      cnt += __popc(keep);
    }
    if (lane == 0) {
      s_meta[0] = cnt;
      s_meta[1] = bad;
    }
  };

  const int grp = lane / lpr, sub = lane - grp * lpr;
  const int k = wu * gpw + grp;  // this lane's group within the bag
  const bool one_tile = bag <= tile;
  int n = 0;
  if (one_tile) {
    stage(0, bag);
    unit_sync(wpb);
    n = s_meta[0];
  }
  for (int c0 = 0; c0 < chunks; c0 += lpr) {
    if (c0 > 0) unit_sync(wpb);  // the last piece's fold was read
    const int c = c0 + sub;
    const bool on = grp < gpw && c < chunks;
    const int coff = c * VB;  // this lane's bytes in a row
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
    for (int l0 = 0; l0 < bag; l0 += tile) {
      if (!one_tile) {
        unit_sync(wpb);  // the last tile's rows were read
        stage(l0, min(tile, bag - l0));
        unit_sync(wpb);
        n = s_meta[0];
      }
      if (!on) continue;
      float x[U][VE];
      float wt[U];
      int p = k;
      for (; p + (U - 1) * groups < n; p += U * groups) {
#pragma unroll
        for (int u = 0; u < U; ++u) {  // U row loads go out together
          const unsigned long long s = s_row[p + u * groups];
          wt[u] = s & 1 ? inv : 0.f;
          elem::load_widen<T, VB>(
              reinterpret_cast<const T*>((s & ~1ull) + coff), x[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[e] = fmaf(wt[u], x[u][e], acc[e]);
      }
#pragma unroll
      for (int u = 0; u < U - 1; ++u) {  // the last, fewer than U
        const int q = p + u * groups;
        wt[u] = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) x[u][e] = 0.f;
        if (q < n) {
          const unsigned long long s = s_row[q];
          wt[u] = s & 1 ? inv : 0.f;
          elem::load_widen<T, VB>(
              reinterpret_cast<const T*>((s & ~1ull) + coff), x[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U - 1; ++u)
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(wt[u], x[u][e], acc[e]);
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < VE; ++e) s_fold[k * piece + sub * VE + e] = acc[e];
    }
    unit_sync(wpb);
    const int width = min(lpr, chunks - c0) * VE;
    const float poison = s_meta[1] ? __int_as_float(0x7fc00000) : 0.f;
    float* o = out + bi * d + (long long)c0 * VE;
    for (int t = ut; t < width; t += unit_threads) {
      float s = poison;
      for (int q = 0; q < groups; ++q) s += s_fold[q * piece + t];  // fixed
      o[t] = s;
    }
  }
}

template <typename T, int VB, typename IdT>
int launch_t(const void* table, const void* ids, const void* mask, void* out,
             long long n_rows, long long n_bags, int bag, int d, int mean,
             int lpr, int gpw, int wpb, int tile, long long blocks,
             long long smem, cudaStream_t stream) {
  constexpr int VE = VB / sizeof(T);
  if (d % VE != 0 || lpr < 1 || lpr > 32 || gpw < 1 || lpr * gpw > 32 ||
      (wpb != 1 && wpb != kWarps) || tile < 32 || tile % 32 != 0 ||
      tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  const int units = kWarps / wpb;
  const size_t need = units * unit_bytes(tile, wpb * gpw, lpr * VE);
  if (smem < (long long)need || smem > 48 * 1024 ||
      blocks * units < n_bags || blocks > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VB, IdT><<<(unsigned)blocks, kThreads,
                                     (size_t)smem, stream>>>(
      static_cast<const T*>(table), static_cast<const IdT*>(ids),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out),
      n_rows, n_bags, bag, d, mean, lpr, gpw, wpb, tile);
  return (int)cudaGetLastError();
}

template <typename T, typename IdT>
int dispatch_vb(int vb, const void* table, const void* ids, const void* mask,
                void* out, long long n_rows, long long n_bags, int bag, int d,
                int mean, int lpr, int gpw, int wpb, int tile,
                long long blocks, long long smem, cudaStream_t st) {
#define EB_LAUNCH(VB)                                                        \
  launch_t<T, VB, IdT>(table, ids, mask, out, n_rows, n_bags, bag, d, mean, \
                       lpr, gpw, wpb, tile, blocks, smem, st)
  switch (vb) {
    case 16:
      return EB_LAUNCH(16);
    case 8:
      return EB_LAUNCH(8);
    case 4:
      return EB_LAUNCH(4);
    default:
      if constexpr (sizeof(T) == 2) {
        if (vb == 2) return EB_LAUNCH(2);
      }
      return (int)cudaErrorInvalidValue;
  }
#undef EB_LAUNCH
}

template <typename IdT>
int dispatch_dtype(int dtype, int vb, const void* table, const void* ids,
                   const void* mask, void* out, long long n_rows,
                   long long n_bags, int bag, int d, int mean, int lpr,
                   int gpw, int wpb, int tile, long long blocks,
                   long long smem, cudaStream_t st) {
  switch (dtype) {
    case 0:
      return dispatch_vb<float, IdT>(vb, table, ids, mask, out, n_rows,
                                     n_bags, bag, d, mean, lpr, gpw, wpb,
                                     tile, blocks, smem, st);
    case 1:
      return dispatch_vb<__nv_bfloat16, IdT>(vb, table, ids, mask, out,
                                             n_rows, n_bags, bag, d, mean,
                                             lpr, gpw, wpb, tile, blocks,
                                             smem, st);
    case 2:
      return dispatch_vb<__half, IdT>(vb, table, ids, mask, out, n_rows,
                                      n_bags, bag, d, mean, lpr, gpw, wpb,
                                      tile, blocks, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of the table: 0 float32, 1 bfloat16, 2 float16. id_bytes: 4 (int32)
// or 8 (int64). vb: bytes per load. mean: 0 sum, 1 mean. lpr, gpw, wpb,
// tile, blocks, smem: the wrapper's geometry (embedding_bag.py::geometry),
// checked here against what the kernel needs.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    const void* mask, void* out, int dtype,
                                    int id_bytes, int vb, long long n_rows,
                                    long long n_bags, int bag, int d,
                                    int mean, int lpr, int gpw, int wpb,
                                    int tile, long long blocks,
                                    long long smem, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (id_bytes == 4)
    return dispatch_dtype<int>(dtype, vb, table, ids, mask, out, n_rows,
                               n_bags, bag, d, mean, lpr, gpw, wpb, tile,
                               blocks, smem, st);
  if (id_bytes == 8)
    return dispatch_dtype<long long>(dtype, vb, table, ids, mask, out,
                                     n_rows, n_bags, bag, d, mean, lpr, gpw,
                                     wpb, tile, blocks, smem, st);
  return (int)cudaErrorInvalidValue;
}
