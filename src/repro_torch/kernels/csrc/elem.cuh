// Element types of the float kernels (flash_attention.cu, embedding_bag.cu):
// fp32, bf16 and fp16 tensors are read with 2- to 16-byte loads and widened
// to fp32 in registers, and results are narrowed with round-to-nearest-even,
// as torch's .to(dtype) does. Type codes match the Python wrappers:
// 0 = float32, 1 = bfloat16, 2 = float16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace elem {

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  // one 32-bit word holds one element
  __device__ __forceinline__ static void unpack(unsigned w, float* o) {
    o[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static float widen(float x) { return x; }
  __device__ __forceinline__ static float narrow(float x) { return x; }
};

template <>
struct Traits<__nv_bfloat16> {
  // little-endian: element 0 is the low half of the word
  __device__ __forceinline__ static void unpack(unsigned w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Traits<__half> {
  __device__ __forceinline__ static void unpack(unsigned w, float* o) {
    o[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    o[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  __device__ __forceinline__ static float widen(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static __half narrow(float x) {
    return __float2half_rn(x);
  }
};

// Loads VB bytes (16, 8, 4, or 2 for a 16-bit T; VB-aligned) at p and
// widens the VB / sizeof(T) elements into o[].
template <typename T, int VB>
__device__ __forceinline__ void load_widen(const T* __restrict__ p,
                                           float* o) {
  constexpr int kPerWord = sizeof(T) <= 4 ? 4 / sizeof(T) : 1;
  if constexpr (VB == 2) {
    static_assert(sizeof(T) == 2, "2-byte loads are for 16-bit types");
    o[0] = Traits<T>::widen(p[0]);
  } else if constexpr (VB == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    Traits<T>::unpack(r.x, o);
    Traits<T>::unpack(r.y, o + kPerWord);
    Traits<T>::unpack(r.z, o + 2 * kPerWord);
    Traits<T>::unpack(r.w, o + 3 * kPerWord);
  } else if constexpr (VB == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    Traits<T>::unpack(r.x, o);
    Traits<T>::unpack(r.y, o + kPerWord);
  } else {
    static_assert(VB == 4, "VB must be 16, 8 or 4 bytes");
    Traits<T>::unpack(__ldg(reinterpret_cast<const unsigned*>(p)), o);
  }
}

}  // namespace elem
