// Blocked (flash) attention with online softmax on Hopper's tensor cores
// (sm_90a): the bf16 / fp16 variant of B8, at dh 64 and 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel) behind the GQA wrapper src/repro/kernels/ops.py::
// flash_attention_gqa, for the 16-bit inputs every model of the repo feeds
// it. Same function as csrc/flash_attention.cu: for q [B, S, K, G, dh] and
// k, v [B, T, K, dh],
//   out[b, i, h, g] = sum_j softmax_j(s_ij) v[b, j, h],
//   s_ij = cap(scale * q[b, i, h, g] . k[b, j, h])  (cap = softcap * tanh(x /
//   softcap) when softcap > 0), with (i, j) kept by the causal mask (j <= i)
//   and the sliding window (i - j < window) when set; masked scores are
//   -1e30 and the final divide is by max(l, 1e-30), as in the reference.
//   Softmax and accumulator are fp32; out is written in q's dtype.
//
// Dispatch (kernels/flash_attention.py): bf16 and fp16 at dh 64 and 128 come
// here; fp32 (the tensor cores cannot meet its 2e-5 check without TF32) and
// dh 256 (no configuration of the repo uses it) keep the fp32 FMA kernel
// csrc/flash_attention.cu. The choice depends on dtype and dh only; a build
// or launch failure here raises, it never falls back.
//
// Design. One thread block of three warpgroups per (q tile, pair of query
// heads or of 64-row blocks, b):
//   - warpgroup 0 is the producer: it gives its registers away (setmaxnreg
//     24) and one thread starts TMA loads. Q is loaded once per block; K and
//     V tiles of BK = 128 keys arrive in a ring of STAGES buffers, each with
//     a "full" mbarrier (TMA transaction bytes) and an "empty" one the
//     consumers arrive on, for K and for V apart. Every tile is a TMA box of
//     64 columns (128 bytes) x rows with the 128-byte swizzle, so dh 128 is
//     two boxes; the wgmma descriptors name the same swizzle.
//   - warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows
//     each. With G even they take query groups 2j and 2j + 1 of one KV head
//     at the same 64 positions (pack), so each K/V tile is loaded once for
//     128 rows and both see the same live tiles; with G odd they take
//     positions q0 and q0 + 64 of one head.
//   - S = Q K^T: wgmma m64nBKk16, Q and K both K-major from shared memory,
//     the fp32 accumulator in registers.
//   - O += P V: P is the S fragment converted to 16 bits in place (the
//     accumulator layout of m64nN is the A-register layout of m64k16), V is
//     the B operand in its natural [BK, dh] layout through the descriptor's
//     transpose bit (MN-major). P is carried as hi + lo, two 16-bit values
//     whose sum is P to ~2^-17, and multiplied twice: one rounded P moves an
//     output by up to ~2^-9 of its largest terms, beyond the one-ulp checks
//     the outputs are held to (tests/test_torch_flash_numerics.py). The row
//     sum l is taken from the fp32 P.
//   - step it starts S of tile it and P V of tile it - 1 together; the
//     softmax of tile it runs while that P V does. K is released as soon as
//     S is done, V once P V is, so the producer keeps a tile ahead.
//   - softmax in registers on the wgmma fragment: a thread holds two rows;
//     the row max is a quad shuffle, the row sum stays a per-thread partial
//     until the end. exp2 with log2(e) folded into the scale; the
//     accumulator is rescaled only when a row's max moved.
//   - only live KV tiles are visited (the reference's @pl.when(live) as loop
//     bounds); tiles wholly inside the causal limit, the window and T run
//     without mask arithmetic, the diagonal, window-edge and ragged tiles
//     with it. q tiles go heaviest-first.
//   - the softcap's tanh: its Taylor series to y^13 on the FMA pipe when
//     every |y| = |s / softcap| of a warp's tile is below 1/2 (error < 1e-7
//     of y), else 1 - 2 / (1 + 2^(2 y log2 e)), one ex2 and one rcp on the
//     special-function units. Both are accurate to fp32 rounding; the
//     one-instruction tanh.approx.f32 (relative error ~2^-11) moves capped
//     scores by ~|s| 2^-11, which the checks' limits do not absorb.
//
// Bound: operations. Per live (query, key) pair 4 * dh tensor FLOP (6 * dh
// as executed, with the hi + lo P V) and 1 special-function op (exp2; 3 when
// the softcap's tanh takes the ex2 + rcp path); at gemma2-27b's global layer
// (S = T = 8192, 32 heads, dh 128) that is 5.5e11 FLOP (0.556 ms at 989
// TFLOP/s) and 1.07e9 to 3.2e9 SFU ops (0.26 to 0.77 ms at 16 a clock per
// SM); q + k + v + out are 100 MB.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, strides in elements and the current stream, and raises
// on a non-zero return. Links libcuda (-lcuda) for the tensor maps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;  // query rows of one consumer
// the softcap's tanh: none, 1 - 2 / (1 + 2^(2 y log2 e)) on the SFUs, or
// its Taylor series to y^13 on the FMA pipe (|y| < 1/2: error < 1e-7 y)
constexpr int kCapNone = 0, kCapExp = 1, kCapSeries = 2;
constexpr float kTanh3 = -1.f / 3, kTanh5 = 2.f / 15, kTanh7 = -17.f / 315,
                kTanh9 = 62.f / 2835, kTanh11 = -1382.f / 155925,
                kTanh13 = 21844.f / 6081075;

struct Params {
  void* out;  // contiguous [B, S, K, G, dh]
  int S, T, KH, G;
  int pack;  // 1: the consumers take groups 2j, 2j + 1 at the same rows
  int causal, window;
  float scale_log2;  // scale * log2(e)            (no softcap)
  float cap_x;       // scale / softcap                 (softcap)
  float cap_in;      // 2 * log2(e) * scale / softcap   (softcap)
  float cap_out;     // softcap * log2(e)               (softcap)
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor, 128-byte swizzle. lbo / sbo in bytes:
// K-major operands use only sbo (1,024: the next 8 rows); the MN-major V
// uses lbo for the next 64 columns and sbo for the next 8 keys.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: keep the compiler from
// moving their uses across the wait (or reusing them before it).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ------------------------------------------------------ wgmma instructions

#define WG_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define WG_D64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT32(C, d)                                                        \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),     \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),     \
      C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]),   \
      C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]),   \
      C(d[29]), C(d[30]), C(d[31])
#define WG_OUT64(C, d)                                                        \
  WG_OUT32(C, d), C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), \
      C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), C(d[43]), C(d[44]),   \
      C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]), C(d[50]), C(d[51]),   \
      C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), C(d[57]), C(d[58]),   \
      C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])

// D (+)= A B with A [64 x 16] and B [16 x N] both K-major in shared memory.
// ACC 0 writes D ("=f"); 1 adds to it.
#define WG_SS(N, DREGS, OUTS, IA, IB, IS, TY, CON, ACC)                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY    \
               " " DREGS ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"            \
               : OUTS(CON, d)                                                 \
               : "l"(a), "l"(b), "r"(ACC))
// D += A B with A [64 x 16] in registers (4 x 2 16-bit values a thread) and
// B [16 x N] MN-major in shared memory (transpose bit set).
#define WG_RS(N, DREGS, OUTS, I0, I1, I2, I3, IB, IS, TY)                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY    \
               " " DREGS ", {%" I0 ", %" I1 ", %" I2 ", %" I3 "}, %" IB       \
               ", p, 1, 1, 1;\n}\n"                                           \
               : OUTS("+f", d)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <bool kBf16, bool kAcc>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b) {
  if constexpr (kBf16 && kAcc)
    WG_SS(64, WG_D32, WG_OUT32, "32", "33", "34", "bf16", "+f", 1);
  else if constexpr (kBf16)
    WG_SS(64, WG_D32, WG_OUT32, "32", "33", "34", "bf16", "=f", 0);
  else if constexpr (kAcc)
    WG_SS(64, WG_D32, WG_OUT32, "32", "33", "34", "f16", "+f", 1);
  else
    WG_SS(64, WG_D32, WG_OUT32, "32", "33", "34", "f16", "=f", 0);
}

template <bool kBf16, bool kAcc>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a,
                                       uint64_t b) {
  if constexpr (kBf16 && kAcc)
    WG_SS(128, WG_D64, WG_OUT64, "64", "65", "66", "bf16", "+f", 1);
  else if constexpr (kBf16)
    WG_SS(128, WG_D64, WG_OUT64, "64", "65", "66", "bf16", "=f", 0);
  else if constexpr (kAcc)
    WG_SS(128, WG_D64, WG_OUT64, "64", "65", "66", "f16", "+f", 1);
  else
    WG_SS(128, WG_D64, WG_OUT64, "64", "65", "66", "f16", "=f", 0);
}

template <bool kBf16>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (kBf16)
    WG_RS(64, WG_D32, WG_OUT32, "32", "33", "34", "35", "36", "37", "bf16");
  else
    WG_RS(64, WG_D32, WG_OUT32, "32", "33", "34", "35", "36", "37", "f16");
}

template <bool kBf16>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (kBf16)
    WG_RS(128, WG_D64, WG_OUT64, "64", "65", "66", "67", "68", "69", "bf16");
  else
    WG_RS(128, WG_D64, WG_OUT64, "64", "65", "66", "67", "68", "69", "f16");
}

// ------------------------------------------------------- 16-bit pairs

// (lo, hi) -> one 32-bit register, lo in the low half (the lower column)
template <bool kBf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (kBf16) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &h, 4);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    memcpy(&u, &h, 4);
  }
  return u;
}

template <bool kBf16>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (kBf16) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  } else {
    __half2 h;
    memcpy(&h, &u, 4);
    return __half22float2(h);
  }
}

// ------------------------------------------------------------- softmax

// One consumer's online-softmax step on a tile's scores s (the m64nBK
// fragment: register i of a thread is row r + 8 * ((i >> 1) & 1), column
// (i >> 2) * 8 + 2 * (lane % 4) + (i & 1)), in two parts so the first can
// run while the previous tile's P V product still writes o. softmax_exp:
// softcap, mask, row max, s -> exp2(s - max), row sums; the rows whose max
// moved get their factor in scale (others 1).
template <bool kMask, int kCap, int BK>
__device__ __forceinline__ void softmax_exp(float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&scale)[2],
                                            const Params& p, int qpos0,
                                            int kpos0) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x;
    if constexpr (kCap == kCapSeries) {  // softcap * tanh(y), log2 units
      const float y = s[i] * p.cap_x, y2 = y * y;
      float t = fmaf(y2, kTanh13, kTanh11);
      t = fmaf(t, y2, kTanh9);
      t = fmaf(t, y2, kTanh7);
      t = fmaf(t, y2, kTanh5);
      t = fmaf(t, y2, kTanh3);
      t = fmaf(t, y2, 1.f);
      x = p.cap_out * (y * t);
    } else if constexpr (kCap == kCapExp) {
      const float e = ex2(s[i] * p.cap_in);
      x = fmaf(-2.f * p.cap_out, rcp(1.f + e), p.cap_out);
    } else {
      x = s[i] * p.scale_log2;
    }
    if constexpr (kMask) {
      const int kpos = kpos0 + (i >> 2) * 8 + (i & 1);
      const int qpos = qpos0 + ((i & 2) ? 8 : 0);
      bool ok = kpos < p.T;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      x = ok ? x : kNeg;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    scale[r] = 1.f;
    if (mx[r] > m[r]) {  // the row max moved
      scale[r] = ex2(m[r] - mx[r]);
      l[r] *= scale[r];
      m[r] = mx[r];
    }
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// The second part, once the previous P V is done: rescale the rows of o
// whose max moved, and leave P = hi + lo in the A-register layout of the
// P V product (register j of k-step kk holds s[8 kk + 2 j], s[8 kk + 2 j +
// 1]).
template <bool kBf16, int BK, int DH>
__device__ __forceinline__ void rescale_pack(const float (&s)[BK / 2],
                                             float (&o)[DH / 2],
                                             uint32_t (&ph)[BK / 16][4],
                                             uint32_t (&pl)[BK / 16][4],
                                             const float (&scale)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (scale[r] != 1.f) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 2 * r] *= scale[r];
        o[4 * j + 2 * r + 1] *= scale[r];
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * kk + 2 * j;
      const uint32_t h = pack2<kBf16>(s[i], s[i + 1]);
      const float2 hf = unpack2<kBf16>(h);
      ph[kk][j] = h;
      pl[kk][j] = pack2<kBf16>(s[i] - hf.x, s[i + 1] - hf.y);
    }
  }
}

// --------------------------------------------------------------- kernel

template <bool kBf16, int DH, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const Params p) {
  using T = typename std::conditional<kBf16, __nv_bfloat16, __half>::type;
  constexpr int NB = DH / 64;                   // 64-column boxes of a row
  constexpr uint32_t Q_BOX = kRows * 128;       // bytes of a [64][64] box
  constexpr uint32_t KV_BOX = BK * 128;         // bytes of a [BK][64] box
  constexpr uint32_t Q_BYTES = NB * Q_BOX;      // one consumer's Q tile
  constexpr uint32_t KV_BYTES = NB * KV_BOX;    // one K or V tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atom
  const uint32_t sK = sQ + kConsumers * Q_BYTES;  // [STAGES][NB][BK][64]
  const uint32_t sV = sK + STAGES * KV_BYTES;
  const uint32_t bars = sV + STAGES * KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * STAGES + st); };

  // this block's rows: consumer c takes query group g[c] of KV head kh at
  // positions q0[c] .. q0[c] + 63
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.z;
  int kh, g[kConsumers], q0[kConsumers];
  if (p.pack) {
    const int pairs = p.G / kConsumers;
    kh = blockIdx.y / pairs;
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      g[c] = kConsumers * (blockIdx.y % pairs) + c;
      q0[c] = qt * kRows;
    }
  } else {
    kh = blockIdx.y / p.G;
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      g[c] = blockIdx.y % p.G;
      q0[c] = (qt * kConsumers + c) * kRows;
    }
  }
  // live KV tiles: the reference's @pl.when(live) as loop bounds, the union
  // over the consumers whose rows start before S
  int t_lo = INT_MAX, t_hi = 0, n_active = 0;
#pragma unroll
  for (int c = 0; c < kConsumers; ++c) {
    if (q0[c] >= p.S) continue;
    const int q_last = min(q0[c] + kRows, p.S) - 1;
    const int k_first = p.window > 0 ? max(0, q0[c] - p.window + 1) : 0;
    const int k_end = p.causal ? min(p.T, q_last + 1) : p.T;
    ++n_active;
    t_lo = min(t_lo, k_first / BK);
    t_hi = max(t_hi, (k_end + BK - 1) / BK);
  }
  t_hi = max(t_hi, t_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers * 4);  // one arrival a consumer warp
      mbar_init(v_empty(st), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, n_active * Q_BYTES);
      for (int c = 0; c < kConsumers; ++c) {
        if (q0[c] >= p.S) continue;
        for (int nb = 0; nb < NB; ++nb)
          tma_5d(sQ + c * Q_BYTES + nb * Q_BOX, &tm_q, q_full, nb * 64, g[c],
                 kh, q0[c], b);
      }
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int st = it % STAGES;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        if (it >= STAGES) mbar_wait(k_empty(st), parity);
        mbar_expect_tx(k_full(st), KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          tma_4d(sK + st * KV_BYTES + nb * KV_BOX, &tm_k, k_full(st), nb * 64,
                 kh, t * BK, b);
        if (it >= STAGES) mbar_wait(v_empty(st), parity);
        mbar_expect_tx(v_full(st), KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          tma_4d(sV + st * KV_BYTES + nb * KV_BOX, &tm_v, v_full(st), nb * 64,
                 kh, t * BK, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int my_q0 = c ? q0[1] : q0[0], my_g = c ? g[1] : g[0];
  const int qpos0 = my_q0 + warp * 16 + lane / 4;  // this thread's rows: +0, +8

  float o[DH / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, scale[2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  const uint64_t dq = make_desc(sQ + c * Q_BYTES, 16, 1024);

  // start S = Q K^T of stage st, 16 columns (32 bytes of a row) a step
  auto start_scores = [&](int st) {
    const uint64_t dk = make_desc(sK + st * KV_BYTES, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t qo = ((kk / 4) * Q_BOX + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * KV_BOX + (kk % 4) * 32) >> 4;
      if (kk == 0)
        mma_ss<kBf16, false>(s, dq + qo, dk + ko);
      else
        mma_ss<kBf16, true>(s, dq + qo, dk + ko);
    }
    wg_commit();
  };
  // start O += (P_hi + P_lo) V of stage st, 16 keys (rows of V) a step
  auto start_values = [&](int st) {
    const uint64_t dv = make_desc(sV + st * KV_BYTES, KV_BOX, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mma_rs<kBf16>(o, ph[kk], dv + ((kk * 16 * 128) >> 4));
      mma_rs<kBf16>(o, pl[kk], dv + ((kk * 16 * 128) >> 4));
    }
    wg_commit();
  };
  auto exp_step = [&](int t) {
    const int k_lo = t * BK;
    const bool edge = k_lo + BK > p.T || (p.causal && k_lo + BK - 1 > my_q0) ||
                      (p.window > 0 && my_q0 + kRows - 1 - k_lo >= p.window);
    const int kpos0 = k_lo + 2 * (lane % 4);
    int cap = kCapNone;
    if (p.cap_x != 0.f) {  // the series when the warp's |s / softcap| < 1/2
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) amax = fmaxf(amax, fabsf(s[i]));
      cap = __all_sync(0xffffffffu, amax * p.cap_x < 0.5f) ? kCapSeries
                                                             : kCapExp;
    }
    if (cap == kCapSeries) {
      if (edge)
        softmax_exp<true, kCapSeries, BK>(s, m, l, scale, p, qpos0, kpos0);
      else
        softmax_exp<false, kCapSeries, BK>(s, m, l, scale, p, qpos0, kpos0);
    } else if (cap == kCapExp) {
      if (edge)
        softmax_exp<true, kCapExp, BK>(s, m, l, scale, p, qpos0, kpos0);
      else
        softmax_exp<false, kCapExp, BK>(s, m, l, scale, p, qpos0, kpos0);
    } else {
      if (edge)
        softmax_exp<true, kCapNone, BK>(s, m, l, scale, p, qpos0, kpos0);
      else
        softmax_exp<false, kCapNone, BK>(s, m, l, scale, p, qpos0, kpos0);
    }
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // Both consumers walk the union of their live tiles (a tile wholly
  // masked for one's rows leaves its sums as the reference's would). Step
  // it starts S of tile it and P V of tile it - 1 together; the softmax of
  // tile it runs while that P V does (and while the other consumer's
  // products do). K is released once S is done, V once P V is. Each batch
  // of wgmma sits in straight-line code right after its fence: ptxas
  // serialises wgmma whose fence it cannot see.
  const int n = t_hi - t_lo;
  auto k_ready = [&](int it) {
    mbar_wait(k_full(it % STAGES), (it / STAGES) & 1);
  };
  auto v_ready = [&](int it) {
    mbar_wait(v_full(it % STAGES), (it / STAGES) & 1);
  };
  mbar_wait(q_full, 0);
  if (n > 0) {
    k_ready(0);
    wg_fence();
    start_scores(0);
    wg_wait0();
    keep(s);
    release(k_empty(0));
    exp_step(t_lo);
    rescale_pack<kBf16, BK, DH>(s, o, ph, pl, scale);
    for (int it = 1; it < n; ++it) {
      k_ready(it);
      v_ready(it - 1);
      wg_fence();
      start_scores(it % STAGES);
      start_values((it - 1) % STAGES);
      wg_wait1();  // S of tile it; P V of tile it - 1 still running
      keep(s);
      release(k_empty(it % STAGES));
      exp_step(t_lo + it);
      wg_wait0();
      keep(o);
      keep(ph);
      keep(pl);
      release(v_empty((it - 1) % STAGES));
      rescale_pack<kBf16, BK, DH>(s, o, ph, pl, scale);
    }
    v_ready(n - 1);
    wg_fence();
    start_values((n - 1) % STAGES);
    wg_wait0();
    keep(o);
    release(v_empty((n - 1) % STAGES));
  }

  // out = o / max(l, 1e-30): the row sums are quad partials until here
  T* out = static_cast<T*>(p.out);
  const long long heads = (long long)p.KH * p.G;
  const int head = kh * p.G + my_g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qpos = qpos0 + 8 * r;
    if (qpos >= p.S) continue;
    T* orow = out + (((long long)b * p.S + qpos) * heads + head) * DH +
              2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack2<kBf16>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------------ host

// A tensor map over a strided 16-bit tensor: dims innermost first, strides
// in bytes for dims 1.., boxes of 64 columns (128 bytes, swizzled).
int encode(CUtensorMap* map, bool bf16, int rank, const void* ptr,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      rank, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // CUresult codes do not overlap the small cudaError_t ones used here
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

struct Strides {
  long long qsb, qss, qsk, qsg, ksb, kst, ksk, vsb, vst, vsk;
};

template <bool kBf16, int DH, int BK, int STAGES>
int launch_t(const void* q, const void* k, const void* v, const Params& p,
             const Strides& x, int B, cudaStream_t stream) {
  constexpr size_t smem = 1024 + (size_t)kConsumers * DH * kRows * 2 +
                          (size_t)2 * STAGES * DH * BK * 2 +
                          8 * (1 + 4 * STAGES);
  constexpr cuuint64_t e = 2;  // bytes per element
  CUtensorMap tq, tk, tv;
  const cuuint64_t qd[5] = {(cuuint64_t)DH, (cuuint64_t)p.G, (cuuint64_t)p.KH,
                            (cuuint64_t)p.S, (cuuint64_t)B};
  const cuuint64_t qs[4] = {x.qsg * e, x.qsk * e, x.qss * e, x.qsb * e};
  const cuuint32_t qbox[5] = {64, 1, 1, kRows, 1};
  const cuuint64_t kd[4] = {(cuuint64_t)DH, (cuuint64_t)p.KH, (cuuint64_t)p.T,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {x.ksk * e, x.kst * e, x.ksb * e};
  const cuuint64_t vs[3] = {x.vsk * e, x.vst * e, x.vsb * e};
  const cuuint32_t kvbox[4] = {64, 1, BK, 1};
  int err = encode(&tq, kBf16, 5, q, qd, qs, qbox);
  if (!err) err = encode(&tk, kBf16, 4, k, kd, ks, kvbox);
  if (!err) err = encode(&tv, kBf16, 4, v, kd, vs, kvbox);
  if (err) return err;

  auto kern = flash_attention_wgmma_kernel<kBf16, DH, BK, STAGES>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const int rows = p.pack ? kRows : kRows * kConsumers;  // positions a block
  const long long n_qt = ((long long)p.S + rows - 1) / rows;
  const long long ys = p.pack ? (long long)p.KH * p.G / kConsumers
                              : (long long)p.KH * p.G;
  if (n_qt > INT_MAX || ys > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_qt, (unsigned)ys, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (q, k, v and out alike); dh 64 or 128. Every
// pointer 16-byte aligned and every stride but the last (1) a multiple of 8
// elements (the tensor maps' 16 bytes). pack: 1 pairs query groups in a
// block (needs G even), 0 stacks 128 positions of one head, -1 picks 1 for
// an even G.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int dh,
    int B, int S, int T, int KH, int G, long long qsb, long long qss,
    long long qsk, long long qsg, long long ksb, long long kst, long long ksk,
    long long vsb, long long vst, long long vsk, float scale, float softcap,
    int causal, int window, int pack, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KH <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (pack < 0) pack = G % kConsumers == 0;
  if (pack && G % kConsumers != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.out = out;
  p.S = S;
  p.T = T;
  p.KH = KH;
  p.G = G;
  p.pack = pack;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  p.cap_x = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_in = 2.f * kLog2e * p.cap_x;
  p.cap_out = softcap * kLog2e;
  const Strides x{qsb, qss, qsk, qsg, ksb, kst, ksk, vsb, vst, vsk};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && dh == 64)
    return launch_t<true, 64, 128, 3>(q, k, v, p, x, B, st);
  if (dtype == 1 && dh == 128)
    return launch_t<true, 128, 128, 2>(q, k, v, p, x, B, st);
  if (dtype == 2 && dh == 64)
    return launch_t<false, 64, 128, 3>(q, k, v, p, x, B, st);
  if (dtype == 2 && dh == 128)
    return launch_t<false, 128, 128, 2>(q, k, v, p, x, B, st);
  return (int)cudaErrorInvalidValue;
}
