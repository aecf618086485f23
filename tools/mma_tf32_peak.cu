// Peak rate of the TF32 tensor-core products that the fused-MLP kernels'
// mma.sync engine (fusionmamba_torch/csrc/mma_tf32x3.cuh) is built from, on
// the card it runs on: each warp issues the engine's 3xTF32 pattern (48
// m16n8k8 products for 24 operand values, as one 64x32 warp tile does per
// 8 of K) in three modes:
//   0  the products alone, operands in registers;
//   1  plus the big/small split of the 24 operands;
//   2  plus their loads from shared memory.
// Rates are TF32 FLOP/s and, divided by three, fp32 work.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/mma_tf32_peak tools/mma_tf32_peak.cu
//   /tmp/mma_tf32_peak
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int kMode>
__global__ void __launch_bounds__(256) peak_kernel(float* out, int iters, float seed) {
  __shared__ float sm[4096];
  for (int i = threadIdx.x; i < 4096; i += 256) sm[i] = seed * i;
  __syncthreads();
  float acc[4][4][4] = {};
  uint32_t a[4][4], b[4][2], al[4][4], bl[4][2];
  const float v = seed + threadIdx.x;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = __float_as_uint(v + i + j);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) b[i][j] = __float_as_uint(v - i - j);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kMode == 0) {
          al[i][j] = a[i][j] ^ 1u;
        } else {
          const float x = kMode == 2 ? sm[(threadIdx.x * 2 + i * 64 + j * 8 + it) & 4095]
                                     : __uint_as_float(a[i][j]) + 1e-3f;
          split(x, a[i][j], al[i][j]);
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kMode == 0) {
          bl[i][j] = b[i][j] ^ 1u;
        } else {
          const float x = kMode == 2 ? sm[(threadIdx.x * 2 + i * 128 + j * 16 + it + 7) & 4095]
                                     : __uint_as_float(b[i][j]) + 1e-3f;
          split(x, b[i][j], bl[i][j]);
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], b[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a[i], bl[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a[i], b[j]);
    }
  }
  float s = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int kMode>
void run(float* out, int blocks_per_sm, int sms) {
  const int iters = 4096, blocks = blocks_per_sm * sms;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  peak_kernel<kMode><<<blocks, 256>>>(out, 16, 1.f);  // warm-up
  cudaEventRecord(e0);
  peak_kernel<kMode><<<blocks, 256>>>(out, iters, 1.f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * 8 * 48.0 * iters * 8 * blocks;  // 48 products a warp
  printf("mode %d, %d blocks of 8 warps an SM: %.3f ms, %.1f TFLOP/s TF32, %.1f of fp32 work\n",
         kMode, blocks_per_sm, ms, flop / ms / 1e9, flop / ms / 3e9);
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, (size_t)4 * sms * 256 * sizeof(float));
  for (int per_sm : {1, 2, 4}) {
    run<0>(out, per_sm, sms);
    run<1>(out, per_sm, sms);
    run<2>(out, per_sm, sms);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
