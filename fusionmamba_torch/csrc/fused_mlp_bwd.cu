// Fused two-layer MLP backward for Hopper (sm_90a), fp32. The forward
// (fused_mlp_fwd.cu) is y = gelu(x @ W1^T + b1) @ W2^T + b2, gelu exact (erf),
// weights in torch's nn.Linear layout: W1 (H, C), W2 (C_out, H).
//
// Replaces fusionmamba_tpu/ops/mlp_pallas.py::_bwd_kernel (built by
// _bwd_pallas). Given dy (M, C_out):
//   h = x W1^T + b1 (recomputed),  a = gelu(h),  g = (dy W2) * gelu'(h)
//   dx = g W1,  dW1 = g^T x,  db1 = sum_m g,  dW2 = dy^T a,  db2 = sum_m dy
// with gelu'(h) = Phi(h) + h phi(h) from erff and expf.
//
// What bounds it: operations, 10*M*C*H flops per call on the fp32 CUDA cores
// (no tensor cores yet, for fp32 parity). The TPU kernel carries dW1 and dW2
// across a sequential grid; here blocks run in parallel in no order, and one
// block cannot hold its own copy of dW1 (9.4 MB at C=768). So the backward is
// five tiled products that share one 64x64 shared-memory tile loop (256
// threads, 4x4 results per thread):
//   1. per (64 rows, 64 hidden) tile: h and dy W2 in registers, then a and g,
//      written to device memory as scratch (2 * M * H floats, read back by 2-4);
//   2. dx = g W1, one tile of dx per block, summed over all of H in order;
//   3. dW1 and dW2 as partials over S slices of the rows, one tile per block;
//   4. db1 and db2 as partials over the same slices.
// The caller sums the partials over S in a fixed order: no atomics, so the
// result repeats bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

struct Tiles {
  float a[kBK][kTile + 1];  // a[k][m]; the pad spreads the stores over the banks
  float b[kBK][kTile + 1];  // b[k][n]
};

// acc[i][j] += sum_{k in [k_begin, k_end)} A(m0+ty+16i, k) * B(k, n0+tx+16j), where
// A(m, k) = kAK ? A[m*lda + k] : A[k*lda + m] and B(k, n) = kBKMajor ? B[n*ldb + k] : B[k*ldb + n];
// rows m >= rows and columns n >= cols read as 0.
template <bool kAK, bool kBKMajor>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb, int rows,
                                          int cols, int k_begin, int k_end, int m0, int n0,
                                          float (&acc)[4][4], Tiles& s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tiles are consumed
    for (int i = tid; i < kTile * kBK; i += kThreads) {
      const int m = kAK ? i / kBK : i % kTile, kk = kAK ? i % kBK : i / kTile;
      const int gm = m0 + m, gk = k0 + kk;
      s.a[kk][m] = (gm < rows && gk < k_end)
                       ? (kAK ? A[(size_t)gm * lda + gk] : A[(size_t)gk * lda + gm])
                       : 0.f;
      const int n = kBKMajor ? i / kBK : i % kTile, kb = kBKMajor ? i % kBK : i / kTile;
      const int gn = n0 + n, gkb = k0 + kb;
      s.b[kb][n] = (gn < cols && gkb < k_end)
                       ? (kBKMajor ? B[(size_t)gn * ldb + gkb] : B[(size_t)gkb * ldb + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// 1. a = gelu(h), g = (dy W2) * gelu'(h) for a (64 rows, 64 hidden) tile
__global__ void __launch_bounds__(kThreads)
mlp_bwd_hidden_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ a_out,
                      float* __restrict__ g_out, int M, int C, int H, int Cout) {
  __shared__ Tiles s;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  float hacc[4][4] = {}, dacc[4][4] = {};
  gemm_tile<true, true>(x, C, w1, C, M, H, 0, C, m0, n0, hacc, s);         // x W1^T
  gemm_tile<true, false>(dy, Cout, w2, H, M, H, 0, Cout, m0, n0, dacc, s);  // dy W2
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= H) continue;
    const float bn = b1[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
      const float h = hacc[i][j] + bn;
      const float e = erff(h * 0.70710678118654752f);
      const float cdf = 0.5f * (1.f + e);
      const float pdf = 0.39894228040143268f * expf(-0.5f * h * h);
      a_out[(size_t)m * H + n] = 0.5f * h * (1.f + e);
      g_out[(size_t)m * H + n] = dacc[i][j] * fmaf(h, pdf, cdf);
    }
  }
}

// 2. dx (M, C) = g (M, H) W1 (H, C)
__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ w1,
                  float* __restrict__ dx, int M, int C, int H) {
  __shared__ Tiles s;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  float acc[4][4] = {};
  gemm_tile<true, false>(g, H, w1, C, M, C, 0, H, m0, n0, acc, s);  // g W1
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < C) dx[(size_t)m * C + n] = acc[i][j];
    }
  }
}

// 3. part[s] (P_cols, Q_cols) = sum over the rows m of slice s of P[m]^T Q[m],
// P (M, P_cols) and Q (M, Q_cols) row-major
__global__ void __launch_bounds__(kThreads)
mlp_bwd_weight_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                      float* __restrict__ part, int M, int p_cols, int q_cols, int slice) {
  __shared__ Tiles s;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int k_begin = blockIdx.z * slice, k_end = min(M, k_begin + slice);
  float acc[4][4] = {};
  gemm_tile<false, false>(P, p_cols, Q, q_cols, p_cols, q_cols, k_begin, k_end, m0, n0, acc, s);
  float* out = part + (size_t)blockIdx.z * p_cols * q_cols;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < p_cols && n < q_cols) out[(size_t)m * q_cols + n] = acc[i][j];
    }
  }
}

// 4. part[s] (N,) = sum over the rows of slice s of X (M, N)
__global__ void __launch_bounds__(kThreads)
mlp_bwd_colsum_kernel(const float* __restrict__ X, float* __restrict__ part, int M, int N,
                      int slice) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int m_end = min(M, (int)(blockIdx.y + 1) * slice);
  float acc = 0.f;
  for (int m = blockIdx.y * slice; m < m_end; ++m) acc += X[(size_t)m * N + n];
  part[(size_t)blockIdx.y * N + n] = acc;
}

unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// a_buf, g_buf: (M, H) scratch; dx (M, C); dw1_p (S, H, C); db1_p (S, H);
// dw2_p (S, C_out, H); db2_p (S, C_out), S = ceil(M / slice).
extern "C" int fm_fused_mlp_bwd(const float* x, const float* dy, const float* w1,
                                const float* b1, const float* w2, float* a_buf, float* g_buf,
                                float* dx, float* dw1_p, float* db1_p, float* dw2_p,
                                float* db2_p, int M, int C, int H, int Cout, int slice,
                                cudaStream_t stream) {
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || slice < 1 || cdiv(M, kTile) > 65535u) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned S = cdiv(M, slice);
  if (S > 65535u) return (int)cudaErrorInvalidValue;
  mlp_bwd_hidden_kernel<<<dim3(cdiv(H, kTile), cdiv(M, kTile)), kThreads, 0, stream>>>(
      x, dy, w1, b1, w2, a_buf, g_buf, M, C, H, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_dx_kernel<<<dim3(cdiv(C, kTile), cdiv(M, kTile)), kThreads, 0, stream>>>(
      g_buf, w1, dx, M, C, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlp_bwd_weight_kernel<<<dim3(cdiv(C, kTile), cdiv(H, kTile), S), kThreads, 0, stream>>>(
      g_buf, x, dw1_p, M, H, C, slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlp_bwd_weight_kernel<<<dim3(cdiv(H, kTile), cdiv(Cout, kTile), S), kThreads, 0, stream>>>(
      dy, a_buf, dw2_p, M, Cout, H, slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlp_bwd_colsum_kernel<<<dim3(cdiv(H, kThreads), S), kThreads, 0, stream>>>(g_buf, db1_p, M, H,
                                                                             slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlp_bwd_colsum_kernel<<<dim3(cdiv(Cout, kThreads), S), kThreads, 0, stream>>>(dy, db2_p, M,
                                                                                Cout, slice);
  return (int)cudaGetLastError();
}
