// Shared pieces of the selective-scan kernels (selective_scan_fwd.cu,
// selective_scan_bwd.cu): the thread layout, the cp.async ring's copies, the
// dt expansion with its softplus, and the short pass that joins the chunks
// of L by their carries.
//
// Thread layout. A block owns DB neighbouring channels d of one (b, k) and
// one chunk of steps. Each channel is spread over kGroups = 4 neighbouring
// lanes, and each lane holds 4 of the (at most) 16 states: thread `tid` owns
// channel tid / 4 and states 4 * (tid % 4) .. +3. Sums over the states are
// two xor-shuffles. States n >= N are zeros that stay zeros.
//
// Chunks and carries. The recurrence h_l = e_l h_{l-1} + x_l is linear and
// diagonal, so a chunk of steps maps its start state to
//   h_end = P h_start + h_local,   P = exp(A * sum of delta over the chunk),
// with h_local the chunk's end state from a zero start. P is a product of
// the step factors: where it underflows to 0 that is the right answer, and
// nothing is ever divided by it. `carry_kernel` walks the chunks of each
// (b, k, d, n) in order and replaces every chunk's h_local by its true start
// state. The adjoint recurrence g_l = C_l dy_l + e_{l+1} g_{l+1} is linear in
// the same factors, and the same kernel walks it in reverse.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fm_scan {

constexpr int kMaxN = 16;    // largest state size
constexpr int kGroups = 4;   // lanes per channel
constexpr int kPer = 4;      // states per lane

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Asynchronous copy of n contiguous floats into shared memory (dst 16-byte
// aligned): 16 bytes a request where the source is aligned too.
__device__ __forceinline__ void stage_span(float* dst, const float* src, int n, int tid,
                                           int nthreads) {
  if ((((uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads) cp_async_16(dst + 4 * i, src + 4 * i);
    for (int i = (n4 << 2) + tid; i < n; i += nthreads) cp_async_4(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async_4(dst + i, src + i);
  }
}

// Asynchronous copy of a rows x cols tile (source row stride src_ld floats)
// into shared memory, row stride DB; cols == DB but for a block at the edge
// of D.
template <int DB>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t src_ld, int rows,
                                           int cols, int tid, int nthreads) {
  if ((((uintptr_t)src) & 15) == 0 && (src_ld & 3) == 0 && cols == DB) {
    for (int i = tid; i < rows * (DB / 4); i += nthreads) {
      const int r = i / (DB / 4), c = (i % (DB / 4)) * 4;
      cp_async_16(dst + r * DB + c, src + r * src_ld + c);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      cp_async_4(dst + r * DB + c, src + r * src_ld + c);
    }
  }
}

// A rows x cols tile from shared memory (row stride DB) to device memory, 16
// bytes a thread where the destination allows it.
template <int DB>
__device__ __forceinline__ void store_rows(float* dst, size_t dst_ld, const float* src, int rows,
                                           int cols, int tid, int nthreads) {
  if ((((uintptr_t)dst) & 15) == 0 && (dst_ld & 3) == 0 && cols == DB) {
    for (int i = tid; i < rows * (DB / 4); i += nthreads) {
      const int r = i / (DB / 4), c = (i % (DB / 4)) * 4;
      *reinterpret_cast<float4*>(dst + r * dst_ld + c) =
          *reinterpret_cast<const float4*>(src + r * DB + c);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_ld + c] = src[r * DB + c];
    }
  }
}

// The 4 values of this lane's state group from a staged [t][N] row of B or
// C; zeros for n >= N.
template <bool FULL>
__device__ __forceinline__ void load_group(const float* row, int N, int g, float (&v)[kPer]) {
  if (FULL) {
    const float4 q = *reinterpret_cast<const float4*>(row + g * kPer);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = g * kPer + j < N ? row[g * kPer + j] : 0.f;
  }
}

// This lane's 4 states of channel d from / to a (.., D, N) array in device
// memory, `p` pointing at the (.., 0, 0) entry; 16 bytes when N == 16.
template <bool FULL>
__device__ __forceinline__ void load_states(const float* p, int d, int N, int g,
                                            float (&v)[kPer]) {
  if (FULL) {
    const float4 q = *reinterpret_cast<const float4*>(p + (size_t)d * kMaxN + g * kPer);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = g * kPer + j < N ? p[(size_t)d * N + g * kPer + j] : 0.f;
    }
  }
}
template <bool FULL>
__device__ __forceinline__ void store_states(float* p, int d, int N, int g,
                                             const float (&v)[kPer]) {
  if (FULL) {
    *reinterpret_cast<float4*>(p + (size_t)d * kMaxN + g * kPer) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (g * kPer + j < N) p[(size_t)d * N + g * kPer + j] = v[j];
    }
  }
}

// exp(delta * A) is taken as 2^(delta * (A log2 e)), one multiply and one
// special-function instruction (ex2.approx, 2 ulp; results below 2^-126 are
// flushed to 0). Rounding the exponent moves the result by at most
// |x| e^x * 2^-24 <= 2.2e-8 absolutely: where the exponent is large the
// factor is tiny. It is computed on every step, with no clip.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum over the 4 lanes of a channel; every lane gets the same bits.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// delta (and, where dsp_s is given, the softplus' slope) of a staged tile of
// Tc steps x DB channels, threads laid over (t, d) so that no lane repeats
// another's exp and log:
//   x = sum_r dt[t][r] W[d][r] + bias[d]      (x = dt[t][d] + bias[d] when R == 0)
//   delta = max(x, 0) + log1p(exp(-|x|)),  slope = sigmoid(x).
// dt_s is [t][R] (or [t][DB] when R == 0), w_s [r][DB + 1], bias_s [DB].
template <int DB>
__device__ __forceinline__ void delta_phase(const float* dt_s, const float* w_s,
                                            const float* bias_s, float* del_s, float* dsp_s,
                                            int Tc, int R, int softplus, int tid, int nthreads) {
  for (int i = tid; i < Tc * DB; i += nthreads) {
    const int t = i / DB, dl = i % DB;
    float x;
    if (R > 0) {
      x = 0.f;
      for (int r = 0; r < R; ++r) x = fmaf(dt_s[t * R + r], w_s[r * (DB + 1) + dl], x);
    } else {
      x = dt_s[i];
    }
    x += bias_s[dl];
    float delta = x, dsp = 1.f;
    if (softplus) {
      const float e = expf(-fabsf(x));
      delta = fmaxf(x, 0.f) + log1pf(e);
      if (dsp_s) {  // sigmoid(x) through one reciprocal of a number in (1, 2]
        const float inv = __fdividef(1.f, 1.f + e);
        dsp = x >= 0.f ? inv : e * inv;
      }
    }
    del_s[i] = delta;
    if (dsp_s) dsp_s[i] = dsp;
  }
}

// This block's W columns ([r][DB + 1], zeros past `dim`) and biases.
template <int DB>
__device__ __forceinline__ void load_w_bias(const float* W, const float* bias, float* w_s,
                                            float* bias_s, int k, int d0, int dim, int R,
                                            int tid, int nthreads) {
  for (int i = tid; i < DB * R; i += nthreads) {
    const int dl = i / R, r = i - dl * R;   // consecutive threads read consecutive floats
    w_s[r * (DB + 1) + dl] = d0 + dl < dim ? W[((size_t)k * dim + d0 + dl) * R + r] : 0.f;
  }
  for (int i = tid; i < DB; i += nthreads) {
    bias_s[i] = (bias && d0 + i < dim) ? bias[(size_t)k * dim + d0 + i] : 0.f;
  }
}

// Joins the chunks. buf is (B*K, n_chunk, D, N): on entry each chunk's local
// result from a zero start, on exit the true state with which the chunk
// starts (ascending: the forward's h; descending: the adjoint's g entering
// from the right). sdel (B*K, n_chunk, D) holds each chunk's sum of delta.
static __global__ void carry_kernel(float* __restrict__ buf, const float* __restrict__ sdel,
                             const float* __restrict__ A, int K, int dim, int N, int n_chunk,
                             int total, int descending) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // (bk, d, n)
  if (i >= total) return;
  const int n = i % N, d = (i / N) % dim, bk = i / (N * dim);
  const float a = A[((size_t)(bk % K) * dim + d) * N + n];
  float h = 0.f;
  for (int j = 0; j < n_chunk; ++j) {
    const int c = descending ? n_chunk - 1 - j : j;
    const size_t at = ((size_t)bk * n_chunk + c) * dim + d;
    const float local = buf[at * N + n];
    buf[at * N + n] = h;
    h = fmaf(expf(a * sdel[at]), h, local);
  }
}

static inline cudaError_t launch_carry(float* buf, const float* sdel, const float* A, int batch, int K,
                                int dim, int N, int n_chunk, int descending,
                                cudaStream_t stream) {
  const int total = batch * K * dim * N;
  carry_kernel<<<(total + 255) / 256, 256, 0, stream>>>(buf, sdel, A, K, dim, N, n_chunk, total,
                                                        descending);
  return cudaGetLastError();
}

}  // namespace fm_scan
