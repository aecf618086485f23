// The I/O element types of the kernels: every kernel is compiled for fp32
// and for bf16 I/O, and keeps its math in fp32 either way. A value is taken
// to fp32 as it is loaded (exact from bf16) and rounded to the I/O type, to
// nearest even, only as it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fm_io {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the value a store of T keeps
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// element i of a parameter (a weight, a bias, a scale) as fp32: bf16 where
// `bf16_params` is nonzero (a bf16 step's cast, read as it is and widened
// exactly), else fp32
__device__ __forceinline__ float param(const void* p, int i, int bf16_params) {
  return bf16_params ? __bfloat162float(static_cast<const bf16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

// 4 consecutive elements (8 or 16 bytes, aligned to their size) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}
// 2 consecutive elements (4 or 8 bytes, aligned to their size)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace fm_io
