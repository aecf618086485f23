// Selective-scan backward for Hopper (sm_90a), fp32.
//
// Replaces fusionmamba_tpu/ops/scan_pallas.py::_bwd_kernel (built by
// _bwd_pallas, summed by _core_bwd). The forward (selective_scan_fwd.cu) is,
// for every (b, k, d) channel and step l,
//   x     = sum_r dt[b,k,l,r] * W[k,d,r] + bias[k,d]     (x = dt[b,k,l,d] + bias when R == 0)
//   delta = softplus(x)
//   h_n   = exp(delta * A[k,d,n]) * h_n + delta * u * B[b,k,l,n]
//   y     = sum_n C[b,k,l,n] * h_n + D[k,d] * u.
// Given dy, the adjoint state g_l = C_l * dy_l + exp(delta_{l+1} A) * g_{l+1}
// runs in reverse, and
//   du     = D dy + sum_n g delta B               d(delta) = sum_n g (A e h_{l-1} + u B)
//   dA_n  += g delta e h_{l-1}                    dB_n = sum_d g delta u,  dC_n = sum_d dy h_l
//   dx     = d(delta) * sigmoid(x)                dbias += dx,  dD += dy u
//   d(dt)_r = sum_d dx W[d,r],                    dW_r += dx dt_r
// with e = exp(delta A). The state before a step is never recovered by
// dividing by e, which underflows to 0 at large delta; it is recomputed.
//
// What bounds it: latency. Each channel walks its L steps in order twice
// (recompute, then the adjoint), and at the first stage there are only
// B*K*D = 9,216 channels for 132 SMs; the bytes (u, dy, du, the low-rank dt,
// B, C and their gradients, and the saved states) would take far less.
// Design: one thread per channel, as in the forward. The forward saved the N
// states at the start of every T steps (hsave, (B*K, ceil(L/T), N, D)). The
// backward walks the chunks of T steps in reverse: it recomputes the chunk's
// states from the saved ones into shared memory (one column per thread, so
// no bank conflicts), then runs the adjoint over the chunk with g, dA in
// registers. Sums over d (dB, dC, d(dt)) are reduced across the warp with
// shuffles and across the block's two warps in shared memory, and written as
// per-d-block partials; per-channel sums (dA, dD, dbias, dW) are written per
// (b, k) channel. The caller sums both kinds in a fixed order, so there are
// no atomics and the result repeats bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16;     // largest state size held in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t smem_floats(int N, int R, int T) {
  return 2 * (size_t)R * kThreads         // w_s, dw_s
         + (size_t)T * (R + 2 * N)        // dt_s, b_s, c_s
         + 2 * (size_t)T * kThreads       // del_s, dsp_s
         + (size_t)(T + 1) * N * kThreads // h_s
         + (size_t)kWarps * T * (2 * N + R);  // red_s
}

__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ W, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ Dp, const float* __restrict__ bias,
                          const float* __restrict__ hsave, const float* __restrict__ dy,
                          float* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dW_p, float* __restrict__ dA_p,
                          float* __restrict__ dB_p, float* __restrict__ dC_p,
                          float* __restrict__ dD_p, float* __restrict__ dbias_p, int K, int L,
                          int dim, int N, int R, int T, int softplus) {
  extern __shared__ float smem[];
  float* w_s = smem;                          // [R][kThreads]
  float* dw_s = w_s + R * kThreads;           // [R][kThreads]
  float* dt_s = dw_s + R * kThreads;          // [T][R]
  float* b_s = dt_s + T * R;                  // [T][N]
  float* c_s = b_s + T * N;                   // [T][N]
  float* del_s = c_s + T * N;                 // [T][kThreads]
  float* dsp_s = del_s + T * kThreads;        // [T][kThreads]
  float* h_s = dsp_s + T * kThreads;          // [(T+1)*N][kThreads]
  float* red_s = h_s + (T + 1) * N * kThreads;  // [kWarps][T][2N+R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bk = blockIdx.y;
  const int k = bk % K;
  const int dblk = blockIdx.x, n_dblk = gridDim.x;
  const int d = dblk * kThreads + tid;
  const bool active = d < dim;
  const int dc = active ? d : dim - 1;
  const int V = 2 * N + R;

  float a[kMaxN], gc[kMaxN], dA[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = n < N ? A[((size_t)k * dim + dc) * N + n] : 0.f;
    gc[n] = 0.f;
    dA[n] = 0.f;
  }
  const float dskip = Dp ? Dp[(size_t)k * dim + dc] : 0.f;
  const float dbias = bias ? bias[(size_t)k * dim + dc] : 0.f;
  for (int r = 0; r < R; ++r) {
    w_s[r * kThreads + tid] = W[((size_t)k * dim + dc) * R + r];
    dw_s[r * kThreads + tid] = 0.f;
  }
  float dD = 0.f, dbias_acc = 0.f;

  const size_t row0 = (size_t)bk * L;
  const int n_chunk = (L + T - 1) / T;
  for (int c = n_chunk - 1; c >= 0; --c) {
    const int l0 = c * T;
    const int Tc = min(T, L - l0);
    __syncthreads();  // the previous chunk's staged inputs and red_s are consumed
    for (int i = tid; i < Tc * R; i += kThreads) dt_s[i] = dt[(row0 + l0) * R + i];
    for (int i = tid; i < Tc * N; i += kThreads) {
      b_s[i] = Bm[(row0 + l0) * N + i];
      c_s[i] = Cm[(row0 + l0) * N + i];
    }
    __syncthreads();

    // recompute the chunk's states from the saved start state
    {
      float h[kMaxN];
      const float* hs = hsave + ((size_t)bk * n_chunk + c) * N * dim + dc;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          h[n] = hs[(size_t)n * dim];
          h_s[n * kThreads + tid] = h[n];
        }
      }
      for (int t = 0; t < Tc; ++t) {
        const size_t idx = (row0 + l0 + t) * dim + dc;
        float x;
        if (R > 0) {
          x = 0.f;
          for (int r = 0; r < R; ++r) x = fmaf(dt_s[t * R + r], w_s[r * kThreads + tid], x);
        } else {
          x = dt[idx];
        }
        x += dbias;
        float delta = x, dsp = 1.f;
        if (softplus) {
          const float e = expf(-fabsf(x));
          delta = fmaxf(x, 0.f) + log1pf(e);
          dsp = x >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);  // sigmoid(x)
        }
        del_s[t * kThreads + tid] = delta;
        dsp_s[t * kThreads + tid] = dsp;
        const float dbu = delta * u[idx];
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < N) {
            h[n] = expf(delta * a[n]) * h[n] + dbu * b_s[t * N + n];
            h_s[((t + 1) * N + n) * kThreads + tid] = h[n];
          }
        }
      }
    }

    // the adjoint over the chunk, last step first
    for (int t = Tc - 1; t >= 0; --t) {
      const size_t idx = (row0 + l0 + t) * dim + dc;
      const float dyv = active ? dy[idx] : 0.f;  // inactive lanes contribute 0
      const float uv = u[idx];
      const float delta = del_s[t * kThreads + tid];
      float* red = red_s + ((size_t)warp * T + t) * V;
      float ddelta = 0.f, du_acc = dskip * dyv;
      dD = fmaf(dyv, uv, dD);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float bn = b_s[t * N + n];
          const float hprev = h_s[(t * N + n) * kThreads + tid];
          const float hcur = h_s[((t + 1) * N + n) * kThreads + tid];
          const float g = fmaf(c_s[t * N + n], dyv, gc[n]);
          const float e = expf(delta * a[n]);
          const float eh = e * hprev;
          ddelta = fmaf(g, fmaf(a[n], eh, uv * bn), ddelta);
          dA[n] = fmaf(g * delta, eh, dA[n]);
          du_acc = fmaf(g * delta, bn, du_acc);
          gc[n] = e * g;
          const float sb = warp_sum(g * delta * uv);
          const float sc = warp_sum(dyv * hcur);
          if (lane == 0) {
            red[n] = sb;
            red[N + n] = sc;
          }
        }
      }
      const float dx = ddelta * dsp_s[t * kThreads + tid];
      dbias_acc += dx;
      if (active) du[idx] = du_acc;
      if (R > 0) {
        for (int r = 0; r < R; ++r) {
          dw_s[r * kThreads + tid] = fmaf(dx, dt_s[t * R + r], dw_s[r * kThreads + tid]);
          const float s = warp_sum(dx * w_s[r * kThreads + tid]);
          if (lane == 0) red[2 * N + r] = s;
        }
      } else if (active) {
        ddt[idx] = dx;
      }
    }
    __syncthreads();
    // the block's sums over d of this chunk, in a fixed order
    for (int i = tid; i < Tc * V; i += kThreads) {
      const int t = i / V, v = i % V;
      float s = red_s[(size_t)t * V + v];
      for (int w = 1; w < kWarps; ++w) s += red_s[((size_t)w * T + t) * V + v];
      const size_t row = ((size_t)bk * n_dblk + dblk) * L + l0 + t;
      if (v < N) {
        dB_p[row * N + v] = s;
      } else if (v < 2 * N) {
        dC_p[row * N + v - N] = s;
      } else {
        ddt[row * R + v - 2 * N] = s;
      }
    }
  }

  if (!active) return;
  const size_t ch = (size_t)bk * dim + d;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    if (n < N) dA_p[ch * N + n] = dA[n];
  }
  if (dD_p) dD_p[ch] = dD;
  if (dbias_p) dbias_p[ch] = dbias_acc;
  for (int r = 0; r < R; ++r) dW_p[ch * R + r] = dw_s[r * kThreads + tid];
}

}  // namespace

// ddt is (B*K, n_dblk, L, R) partials when R > 0 (summed over n_dblk by the
// caller), else (B*K, L, D); dW_p (B*K, D, R), dA_p (B*K, D, N), dB_p and
// dC_p (B*K, n_dblk, L, N), dD_p and dbias_p (B*K, D) or null, with
// n_dblk = ceil(D / 64).
extern "C" int fm_selective_scan_bwd(const float* u, const float* dt, const float* W,
                                     const float* A, const float* Bm, const float* Cm,
                                     const float* Dp, const float* bias, const float* hsave,
                                     const float* dy, float* du, float* ddt, float* dW_p,
                                     float* dA_p, float* dB_p, float* dC_p, float* dD_p,
                                     float* dbias_p, int batch, int K, int L, int dim, int N,
                                     int R, int T, int softplus, cudaStream_t stream) {
  if (N < 1 || N > kMaxN || R < 0 || dim < 1 || L < 1 || T < 1 || batch * K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * smem_floats(N, R, T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((dim + kThreads - 1) / kThreads, batch * K);
  selective_scan_bwd_kernel<<<grid, kThreads, smem, stream>>>(
      u, dt, W, A, Bm, Cm, Dp, bias, hsave, dy, du, ddt, dW_p, dA_p, dB_p, dC_p, dD_p, dbias_p,
      K, L, dim, N, R, T, softplus);
  return (int)cudaGetLastError();
}
