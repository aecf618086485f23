// The row machinery that the LayerNorm kernels share (layer_norm_bwd.cu's two
// backwards, ln_mean_fwd.cu's LN-mean forward), fp32, for Hopper (sm_90a).
//
// A group of G lanes owns one row of C channels at a time; lane l holds
// channels l, l + G, ..., l + (V-1) G in registers, so every load and store
// is a coalesced run of the row. The templates (FM_LN_TEMPLATES below,
// ops/layer_norm.py's TEMPLATES) have V * G = C exactly at the model's
// widths (3 * 2^k), so no lane is idle there; any other C takes a masked
// variant of 12 values a lane whose lanes past C hold zeros. A row's sums
// are xor-shuffle butterflies inside a warp (every lane ends with the same
// bits) and, for rows wider than a warp, one exchange through shared memory
// summed in warp order.
//
// The bf16 designs (the LN backward's, the LN-mean forward's and backward's)
// lay a row out in quads instead: a lane owns Q runs of 4 consecutive
// channels, quad q being channels 4 (lane + q G) .. +3, so that every load
// and store of a bf16 row moves 8 bytes a lane (load_quad, unpack below).
// Their templates are FM_LN_BF16_TEMPLATES (layer_norm.py's BF16_TEMPLATES:
// C / 12 lanes at the model's widths, masked variants for any other C that
// is a multiple of 4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fm_ln {

constexpr int kBlock = 256;  // threads of a backward block of groups of at most 256 lanes

// The sums of each of N pairs over a group of G lanes, the same bits in every
// lane. For G above 32 the warps meet in red (N * blockDim.x / 32 slots), behind
// one barrier that every thread of the block reaches.
template <int G, int N>
__device__ __forceinline__ void group_sums(float2 (&v)[N], float2* red) {
#pragma unroll
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n].x += __shfl_xor_sync(0xffffffffu, v[n].x, off);
      v[n].y += __shfl_xor_sync(0xffffffffu, v[n].y, off);
    }
  }
  if constexpr (G > 32) {
    const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
    const int first = warp / (G / 32) * (G / 32);
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) red[n * warps + warp] = v[n];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = red[n * warps + first];
#pragma unroll
      for (int i = 1; i < G / 32; ++i) {
        v[n].x += red[n * warps + first + i].x;
        v[n].y += red[n * warps + first + i].y;
      }
    }
  }
}

// One pair's sums over a group (red: blockDim.x / 32 slots).
template <int G>
__device__ __forceinline__ float2 group_sum(float2 v, float2* red) {
  float2 one[1] = {v};
  group_sums<G, 1>(one, red);
  return one[0];
}

// 4 consecutive bf16, 8 bytes on an 8-byte boundary, raw and as fp32
__device__ __forceinline__ uint2 load_quad(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 unpack(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

}  // namespace fm_ln

// The templates (values a lane, lanes a row, masked) that the LN kernels
// compile: layer_norm.py's TEMPLATES and its masked variants.
#define FM_LN_TEMPLATES(X) \
  X(3, 8, false)           \
  X(3, 32, false)          \
  X(6, 32, false)          \
  X(12, 32, false)         \
  X(12, 64, false)         \
  X(12, 128, false)        \
  X(12, 32, true)          \
  X(12, 128, true)         \
  X(12, 512, true)

// The bf16 templates on quads (quads a lane, lanes a row, masked):
// layer_norm.py's BF16_QUADS, BF16_TEMPLATES and its masked variants.
#define FM_LN_BF16_TEMPLATES(Q) \
  Q(3, 2, false)                \
  Q(3, 8, false)                \
  Q(3, 16, false)               \
  Q(3, 32, false)               \
  Q(3, 64, false)               \
  Q(3, 128, false)              \
  Q(3, 32, true)                \
  Q(3, 128, true)               \
  Q(3, 512, true)
