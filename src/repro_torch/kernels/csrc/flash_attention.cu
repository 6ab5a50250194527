// Blocked (flash) attention with online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel) behind the GQA wrapper src/repro/kernels/ops.py::
// flash_attention_gqa. For q [B, S, K, G, dh] and k, v [B, T, K, dh]:
//   out[b, i, h, g] = sum_j softmax_j(s_ij) v[b, j, h],
//   s_ij = cap(scale * q[b, i, h, g] . k[b, j, h])  (cap = softcap * tanh(x /
//   softcap) when softcap > 0), with (i, j) kept by the causal mask (j <= i)
//   and the sliding window (i - j < window) when set; masked scores are
//   -1e30 and the final divide is by max(l, 1e-30), as in the reference.
//   Scores, softmax and accumulator are fp32; out is written in q's dtype.
//
// On the TPU the wrapper folds (B, K, G) into the kernel's batch, repeats K/V
// G times (jnp.repeat), transposes every operand to [B*K*G, S, dh], and the
// grid's innermost axis walks KV blocks in order, carrying (m, l, acc) in
// VMEM scratch; blocks outside the mask are skipped with @pl.when. Here:
//   - one thread block per (q tile, head = kh * G + g, b). K/V are read at
//     head // G, so no repeat is materialised, and q/k/v are read in the
//     model's own layout through strides, so nothing is transposed;
//   - the sequential grid axis becomes a loop inside the block over only the
//     live KV tiles: the @pl.when(live) skip turned into loop bounds from
//     the causal limit and the window;
//   - each tile of K and V is staged in shared memory as fp32 (q too,
//     pre-scaled, as the reference scales q in fp32 before the product);
//   - each warp owns RPW query rows: a lane computes the scores of keys
//     lane + 32 j for all its rows (dot over dh with 16-byte shared loads;
//     K rows are padded by 4 floats so the lanes' loads hit distinct banks),
//     the row max and sum are warp reductions, p goes through shared memory,
//     and a lane accumulates dh / 32 output dims of every row;
//   - q tiles are issued heaviest-first (the last causal tiles see the most
//     keys) so the tail of the grid is short.
// Any S and T are accepted (rows past S are not written, keys past T are
// masked); dh is 64, 128 or 256. No tensor cores yet (fp32 FMA): wgmma and
// TMA are later work.
//
// Bound: operations. Per live (query, key) pair 4 * dh FLOP (QK^T and PV);
// at gemma2-27b's prefill (S = T = 8192, 32 heads, dh 128) that is ~5.5e11
// FLOP for a global layer, ~0.56 ms at the card's bf16 tensor-core peak,
// while q + k + v + out are 100 MB, ~0.03 ms at 3.35 TB/s. This fp32 FMA
// design is bounded at the fp32 peak, ~15x below that.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, strides in elements and the current stream, and raises
// on a non-zero return.

#include <climits>
#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous [B, S, K, G, dh]
  int S, T, KH, G;
  long long qsb, qss, qsk, qsg;  // q strides (elements): b, s, kv head, group
  long long ksb, kst, ksk;       // k strides: b, t, kv head
  long long vsb, vst, vsk;       // v strides: b, t, kv head
  float scale, softcap;
  int causal, window;
  int vec;  // 1: every row start is 16-byte aligned (16-byte loads)
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [pos0, pos0 + R) of an operand with row stride `stride` (elements)
// into dst (row pitch LD floats), times mul; rows at or past `limit` are 0.
template <typename T, int DH, int R, int LD>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long long stride, int pos0,
                                           int limit, float mul, int vec) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
    constexpr int CPR = DH / VE;        // loads per row
    for (int i = threadIdx.x; i < R * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const int pos = pos0 + r;
      float x[VE];
      if (pos < limit) {
        elem::load_widen<T, 16>(src + (long long)pos * stride + c * VE, x);
#pragma unroll
        for (int e = 0; e < VE; ++e) x[e] *= mul;
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) x[e] = 0.f;
      }
      float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c * VE);
#pragma unroll
      for (int e = 0; e < VE / 4; ++e)
        d4[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < R * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const int pos = pos0 + r;
      dst[r * LD + c] =
          pos < limit
              ? elem::Traits<T>::widen(src[(long long)pos * stride + c]) * mul
              : 0.f;
    }
  }
}

template <typename T, int DH, int RPW, int KPL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int BQ = kWarps * RPW;  // query rows per block
  constexpr int BK = 32 * KPL;      // keys per tile
  constexpr int KS = DH + 4;        // padded K row pitch (floats)
  constexpr int CW = DH >= 128 ? 4 : 2;  // contiguous output dims per chunk
  constexpr int NC = DH / (32 * CW);     // chunks per lane
  constexpr int DPL = NC * CW;           // output dims per lane
  static_assert(DPL * 32 == DH, "dh must be 64, 128 or 256");

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][DH], pre-scaled
  float* sK = sQ + BQ * DH;                     // [BK][KS]
  float* sV = sK + BK * KS;                     // [BK][DH]
  float* sP = sV + BK * DH;                     // [kWarps * RPW][BK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int head = blockIdx.y;
  const int kh = head / p.G, g = head % p.G;
  const int b = blockIdx.z;
  const int q_lo = qt * BQ;
  const int q_last = min(q_lo + BQ, p.S) - 1;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + kh * p.qsk + g * p.qsg;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kh * p.ksk;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kh * p.vsk;

  stage_rows<T, DH, BQ, DH>(sQ, qb, p.qss, q_lo, p.S, p.scale, p.vec);

  // live KV tiles: the reference's @pl.when(live) as loop bounds
  const int k_first = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.T, q_last + 1) : p.T;  // exclusive
  const int t_begin = k_first / BK;
  const int t_end = (k_end + BK - 1) / BK;

  float acc[RPW][DPL];
  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  float* pw = sP + warp * RPW * BK;  // this warp's rows of p

  for (int t = t_begin; t < t_end; ++t) {
    const int k_lo = t * BK;
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, DH, BK, KS>(sK, kb, p.kst, k_lo, p.T, 1.f, p.vec);
    stage_rows<T, DH, BK, DH>(sV, vb, p.vst, k_lo, p.T, 1.f, p.vec);
    __syncthreads();

    // scores of keys lane + 32 j for the warp's RPW rows
    float s[RPW][KPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (lane + 32 * j) * KS + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (warp * RPW + r) * DH + d);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          float a = s[r][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          a = fmaf(qv.w, kv[j].w, a);
          s[r][j] = a;
        }
      }
    }

    // softcap, mask, online softmax; p to shared memory
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q_lo + warp * RPW + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kpos = k_lo + lane + 32 * j;
        float x = s[r][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.T;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        x = ok ? x : kNeg;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float e = expf(s[r][j] - m_new);
        pw[r * BK + lane + 32 * j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += p V: a lane owns dims ci * 32 * CW + lane * CW + [0, CW)
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sV + (c + cc) * DH;
#pragma unroll
        for (int ci = 0; ci < NC; ++ci) {
          const float* src = vrow + ci * 32 * CW + lane * CW;
          if constexpr (CW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[cc][ci * 4 + 0] = x.x;
            vv[cc][ci * 4 + 1] = x.y;
            vv[cc][ci * 4 + 2] = x.z;
            vv[cc][ci * 4 + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[cc][ci * 2 + 0] = x.x;
            vv[cc][ci * 2 + 1] = x.y;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * BK + c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[r][i];
          a = fmaf(p4.x, vv[0][i], a);
          a = fmaf(p4.y, vv[1][i], a);
          a = fmaf(p4.z, vv[2][i], a);
          a = fmaf(p4.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out);
  const int heads = p.KH * p.G;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q_lo + warp * RPW + r;
    if (qpos >= p.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = out + (((long long)b * p.S + qpos) * heads + head) * DH;
#pragma unroll
    for (int ci = 0; ci < NC; ++ci)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        orow[ci * 32 * CW + lane * CW + e] =
            elem::Traits<T>::narrow(acc[r][ci * CW + e] / den);
  }
}

template <typename T, int DH, int RPW, int KPL>
int launch_t(const Params& p, int B, cudaStream_t stream) {
  constexpr int BQ = kWarps * RPW, BK = 32 * KPL;
  constexpr size_t smem =
      (size_t)(BQ * DH + BK * (DH + 4) + BK * DH + kWarps * RPW * BK) *
      sizeof(float);
  auto kern = flash_attention_kernel<T, DH, RPW, KPL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // the whole shared-memory carveout, so two blocks of 113 KB fit on an SM
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           100);
  if (e != cudaSuccess) return (int)e;
  const long long n_qt = ((long long)p.S + BQ - 1) / BQ;
  const long long heads = (long long)p.KH * p.G;
  if (n_qt > INT_MAX || heads > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_qt, (unsigned)heads, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const Params& p, int B, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_t<T, 64, 16, 2>(p, B, stream);
    case 128:
      return launch_t<T, 128, 16, 2>(p, B, stream);
    case 256:
      return launch_t<T, 256, 8, 1>(p, B, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and out alike).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int dh,
    int B, int S, int T, int KH, int G, long long qsb, long long qss,
    long long qsk, long long qsg, long long ksb, long long kst, long long ksk,
    long long vsb, long long vst, long long vsk, float scale, float softcap,
    int causal, int window, int vec, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KH <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   out, S,   T,     KH,      G,
                 qsb, qss, qsk, qsg, ksb, kst,   ksk,     vsb,
                 vst, vsk, scale, softcap, causal, window, vec};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(dh, p, B, st);
    case 1:
      return dispatch_dh<__nv_bfloat16>(dh, p, B, st);
    case 2:
      return dispatch_dh<__half>(dh, p, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
