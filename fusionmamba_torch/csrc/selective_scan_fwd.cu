// Selective-scan forward for Hopper (sm_90a), fp32.
//
// Replaces fusionmamba_tpu/ops/scan_pallas.py::_fwd_kernel (built by
// _fwd_pallas, with _delta_raw_from_refs and _fwd_readout). For every
// (b, k, d) channel and every step l:
//   delta = softplus(sum_r dt[b,k,l,r] * W[k,d,r] + bias[k,d])
//   h_n   = exp(delta * A[k,d,n]) * h_n + delta * u[b,k,l,d] * B[b,k,l,n]
//   y     = sum_n C[b,k,l,n] * h_n + D[k,d] * u[b,k,l,d]
// Layouts are channels-last: u, y (B,K,L,D); dt (B,K,L,R) low-rank, or
// (B,K,L,D) when R == 0; W (K,D,R); A (K,D,N); B, C (B,K,L,N); D, bias (K,D).
//
// What bounds it: the bytes of u and y (a few flops per byte at N=16), and
// at the deep stages the small number of independent channels (B*K*D
// threads), since each channel walks its L steps in order.
// Design: one thread per channel, its N states in registers, so the state
// never leaves the chip; neighbouring threads own neighbouring d, so u and y
// move as coalesced rows. dt, B and C of one (b,k,l) are the same for the
// whole block: a chunk of steps is staged in shared memory, once per block.
// exp runs on every step, so the result is exact at any delta magnitude (the
// TPU kernel's rescale clip and repair have no counterpart here). The
// softplus is max(x,0) + log1p(exp(-|x|)), the form the reference uses.
// For training, `hsave` (may be null) receives the N states at the start of
// every `save_every` steps, laid out (B*K, ceil(L/save_every), N, D) so that a
// warp's stores are coalesced; the backward kernel restarts from them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kChunk = 32;    // steps staged in shared memory at a time
constexpr int kMaxN = 16;     // largest state size held in registers

__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ W, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ Dp, const float* __restrict__ bias,
                          float* __restrict__ out, float* __restrict__ hsave, int K, int L,
                          int dim, int N, int R, int softplus, int save_every) {
  extern __shared__ float smem[];
  float* w_s = smem;                  // [R][kThreads]: this block's W columns
  float* dt_s = w_s + R * kThreads;   // [kChunk][R]
  float* b_s = dt_s + kChunk * R;     // [kChunk][N]
  float* c_s = b_s + kChunk * N;      // [kChunk][N]

  const int bk = blockIdx.y;          // b * K + k
  const int k = bk % K;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + threadIdx.x;
  const bool active = d < dim;
  const int dc = active ? d : dim - 1;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = n < N ? A[((size_t)k * dim + dc) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dskip = Dp ? Dp[(size_t)k * dim + dc] : 0.f;
  const float dbias = bias ? bias[(size_t)k * dim + dc] : 0.f;
  for (int i = threadIdx.x; i < R * kThreads; i += kThreads) {
    const int r = i / kThreads, dd = d0 + i % kThreads;
    w_s[i] = dd < dim ? W[((size_t)k * dim + dd) * R + r] : 0.f;
  }

  const size_t row0 = (size_t)bk * L;
  const int n_save = hsave ? (L + save_every - 1) / save_every : 0;
  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int T = min(kChunk, L - l0);
    __syncthreads();  // the previous chunk is consumed
    if (R > 0) {
      for (int i = threadIdx.x; i < T * R; i += kThreads) dt_s[i] = dt[(row0 + l0) * R + i];
    }
    for (int i = threadIdx.x; i < T * N; i += kThreads) {
      b_s[i] = Bm[(row0 + l0) * N + i];
      c_s[i] = Cm[(row0 + l0) * N + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < T; ++t) {
      const size_t idx = (row0 + l0 + t) * dim + d;
      if (hsave && (l0 + t) % save_every == 0) {
        float* hs = hsave + ((size_t)bk * n_save + (l0 + t) / save_every) * N * dim + d;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < N) hs[(size_t)n * dim] = h[n];  // h stays in registers
        }
      }
      float x;
      if (R > 0) {
        x = 0.f;
        for (int r = 0; r < R; ++r) x = fmaf(dt_s[t * R + r], w_s[r * kThreads + threadIdx.x], x);
      } else {
        x = dt[idx];
      }
      x += dbias;
      const float delta = softplus ? fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) : x;
      const float uv = u[idx];
      const float du = delta * uv;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          h[n] = expf(delta * a[n]) * h[n] + du * b_s[t * N + n];
          y = fmaf(c_s[t * N + n], h[n], y);
        }
      }
      out[idx] = fmaf(dskip, uv, y);
    }
  }
}

}  // namespace

extern "C" int fm_selective_scan_fwd(const float* u, const float* dt, const float* W,
                                     const float* A, const float* Bm, const float* Cm,
                                     const float* Dp, const float* bias, float* out, float* hsave,
                                     int batch, int K, int L, int dim, int N, int R, int softplus,
                                     int save_every, cudaStream_t stream) {
  if (N < 1 || N > kMaxN || R < 0 || dim < 1 || L < 1 || batch * K < 1 || save_every < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)R * kThreads + (size_t)kChunk * (R + 2 * N));
  const dim3 grid((dim + kThreads - 1) / kThreads, batch * K);
  selective_scan_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      u, dt, W, A, Bm, Cm, Dp, bias, out, hsave, K, L, dim, N, R, softplus, save_every);
  return (int)cudaGetLastError();
}
