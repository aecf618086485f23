// y = x W^T in fp32 for Hopper (sm_90a): the Mamba mixer's four projections
// and the LM's tied head (ops/linear.py). x (M, K) has rows `ldx` floats
// apart, W (N, K) rows `ldw` apart (nn.Linear's layout), y (M, N) is
// row-major.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA. On
// this card a plain fp32 product runs on the CUDA cores (67 TFLOP/s);
// 3xTF32 on the tensor cores keeps fp32-class accuracy at up to 165.
//
// What bounds it: operations, 2 M N K of them (each formed as three TF32
// products), for every shape of the LMs but dt_proj's (K = 48 or 256),
// which writes more bytes than it computes. The design, on the 3xTF32
// wgmma engine fed by TMA (wgmma_tf32x3.cuh):
//  - Both operands are read K-major, as they lie: every landed piece is in
//    the planes' own layout and is split element for element, with no
//    transpose. Rows of any 16-byte-aligned stride (x = in_proj(...)'s dt
//    columns, rows 80 floats apart) go into the tensor map as they are.
//  - One persistent block an SM walks the 128 x 128 output tiles t = b,
//    b + grid, ... in bands of kBand row tiles, row tiles fastest within a
//    band (ops/linear.py::tile_of, the same arithmetic): the tiles in flight
//    at one time share a few rows of x and of W, which L2 then serves. Each
//    tile takes its whole depth (no split-K), and the producer runs ahead
//    across tiles, so the next tile's first stages load during this tile's
//    epilogue.
//  - The tensor cores round each depth step's sum toward zero, which over
//    K = 8192 drifts by ~1e-4 of the sum: every kPromote slices the
//    partial sum is added to an fp32 sum in registers, rounded to nearest.
//  - Ragged M, N and K: TMA fills zeros outside x and W, and the epilogue
//    stores only what lies inside y.
// No atomics: two launches give bit-identical results.
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32x3.cuh"

namespace {

using fm_tc::kTile;
using fm_wg::cdiv;
using fm_wg::kConsumers;
using fm_wg::Pos;
using fm_wg::Ring;

// row tiles a band of the walk (ops/linear.py::BAND): bands of 2 to 16
// measured within 2% of each other at the LM shapes (PERF.md)
constexpr int kBand = 8;

// output tile t -> its first row m0 and column n0 (ops/linear.py::tile_of)
struct Walk {
  int tiles_m, tiles_n;
  __device__ __forceinline__ void tile(int t, int& m0, int& n0) const {
    const int per = kBand * tiles_n, b = t / per, r = t - b * per;
    const int rows = min(kBand, tiles_m - b * kBand);
    m0 = (b * kBand + r % rows) * kTile;
    n0 = r / rows * kTile;
  }
};

// depth slices between the promotions of the tensor cores' sums into fp32
// registers (wgmma_tf32x3.cuh's consume): every 1, 2, 4 and 8 slices
// measured 12-16%, 8-12%, 5-11% and 5-20% slower than none at the LM
// shapes; at K = 8192 none reads 16 times cuBLAS's error against float64,
// every 4 a quarter of it (PERF.md)
constexpr int kPromote = 4;

__global__ void __launch_bounds__(fm_tc::kThreads, 1)
linear_tf32x3_kernel(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
                     float* __restrict__ y, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* planes = fm_tc::aligned_shared(smem_raw);
  const Ring r = fm_tc::ring_after_planes(planes);
  if (threadIdx.x == 0) fm_wg::mbar_init_fence();
  __syncthreads();
  const Walk walk{cdiv(M, kTile), cdiv(N, kTile)};
  const int tiles = walk.tiles_m * walk.tiles_n, nk = cdiv(K, fm_tc::kBK);
  Pos pos;
  if (threadIdx.x >= 128 * kConsumers) {
    if (threadIdx.x == 128 * kConsumers) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        walk.tile(t, m0, n0);
        fm_tc::produce<0, 0>(r, pos, &xm, m0, &wm, n0, 0, nk);
      }
    }
    return;
  }
  const fm_tc::SplitAt at(threadIdx.x);
  const bool pairs = (N & 1) == 0;  // float2 stores: n is even, so n + 1 < N too
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    walk.tile(t, m0, n0);
    float acc[kTile / 2], sum[kTile / 2];
    fm_wg::zero(acc);
    fm_wg::zero(sum);
    fm_tc::consume<0, 0, true, kPromote>(acc, r, pos, planes, nk, at, 0, sum);
    fm_wg::for_each_pair<kTile / 8>(m0, n0, [&](int e, int m, int n) {
      if (m >= M || n >= N) return;
      float* dst = y + (size_t)m * N + n;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(sum[e], sum[e + 1]);
      } else {
        dst[0] = sum[e];
        if (n + 1 < N) dst[1] = sum[e + 1];
      }
    });
  }
}

}  // namespace

// y (M, N) = x W^T: x (M, K) with rows ldx floats apart, W (N, K) with rows
// ldw apart; ldx and ldw multiples of 4 (16 bytes), x and W 16-byte
// aligned. blocks: the persistent grid (ops/linear.py::grid).
extern "C" int fm_linear(const float* x, const float* w, float* y, int M, int N, int K, int ldx,
                         int ldw, int blocks, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || ldx < K || ldw < K || ldx % 4 || ldw % 4 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  // the kernel's shared memory first: a runtime call, which makes the
  // device's context current on this thread, as cuTensorMapEncodeTiled needs
  cudaError_t err = cudaFuncSetAttribute(linear_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fm_tc::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, wm;
  if (!fm_tc::make_map(&xm, x, K, M, false, ldx) || !fm_tc::make_map(&wm, w, K, N, false, ldw))
    return (int)cudaErrorInvalidValue;
  linear_tf32x3_kernel<<<blocks, fm_tc::kThreads, fm_tc::kSmem, stream>>>(xm, wm, y, M, N, K);
  return (int)cudaGetLastError();
}
