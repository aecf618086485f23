// Shared pieces of the selective-scan kernels (selective_scan_fwd.cu,
// selective_scan_bwd.cu): the thread layout, the cp.async ring's copies, the
// dt expansion with its softplus, and the short pass that joins the chunks
// of L by their carries.
//
// I/O types. Each kernel is compiled for fp32 and for bf16 I/O (IO): u, dt,
// its low-rank weight, B, C, dy and the gradients of those are IO, while A,
// D, the dt bias, the saved states, the carries and all the math are fp32.
// The cp.async ring stages the IO tiles as they are (a bf16 tile is half the
// bytes) and every read of a staged value takes it to fp32; results are
// rounded to IO only where they are stored.
//
// Thread layout. A block owns DB neighbouring channels d of one (b, k) and
// one chunk of steps. Each channel is spread over kGroups = 4 neighbouring
// lanes, and each lane holds 4 of the (at most) 16 states: thread `tid` owns
// channel tid / 4 and states 4 * (tid % 4) .. +3. Sums over the states are
// two xor-shuffles. States n >= N are zeros that stay zeros.
//
// The bf16 variants (the bf16_path section below; the fp32 instances use none
// of it and compile as they did). dt and W are bf16 there, and a product of
// two bf16 values is exact in fp32, so the low-rank expansion
// x = sum_r dt[t][r] W[d][r] runs on the tensor cores: warp-level
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulation, which gives the
// fp32 sum with its adds in the tensor core's order. One warp multiplies the
// tile of its own 8 channels (16 or 8 steps by 8 channels, k = R padded to a
// multiple of 16 with zeros) in one to three instructions, taking its
// operands straight from the staged bf16 tiles: `wgmma` wants 64-row tiles
// and a warpgroup, far more than this product holds, and mma.sync needs no
// descriptor, fence or barrier. A warp then reads only delta of its own
// channels, so the expansion needs a __syncwarp where the fp32 variant's
// needs a block barrier. The softplus and its slope take their MUFU form
// (`softplus_mufu`).
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
#include <type_traits>

#include "io_types.cuh"

namespace fm_scan {

using fm_io::from_f;
using fm_io::to_f;

constexpr int kMaxN = 16;    // largest state size
constexpr int kGroups = 4;   // lanes per channel
constexpr int kPer = 4;      // states per lane

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// elements of IO in 16 bytes, and n rounded up to a multiple of them (so that
// every staged tile starts 16-byte aligned)
template <class IO>
constexpr int kVec = 16 / (int)sizeof(IO);
template <class IO>
__host__ __device__ inline int round_vec(int n) {
  return (n + kVec<IO> - 1) / kVec<IO> * kVec<IO>;
}

// one element into shared memory, asynchronously where it is 4 bytes
__device__ __forceinline__ void stage_one(float* dst, const float* src) { cp_async_4(dst, src); }
__device__ __forceinline__ void stage_one(fm_io::bf16* dst, const fm_io::bf16* src) {
  *dst = *src;  // no 2-byte cp.async: a plain copy, read after the tile's barrier
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Asynchronous copy of n contiguous elements into shared memory (dst 16-byte
// aligned): 16 bytes a request where the source is aligned too.
template <class IO>
__device__ __forceinline__ void stage_span(IO* dst, const IO* src, int n, int tid, int nthreads) {
  constexpr int V = kVec<IO>;
  if ((((uintptr_t)src) & 15) == 0) {
    const int nv = n / V;
    for (int i = tid; i < nv; i += nthreads) cp_async_16(dst + V * i, src + V * i);
    for (int i = nv * V + tid; i < n; i += nthreads) stage_one(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) stage_one(dst + i, src + i);
  }
}

// Asynchronous copy of a rows x cols tile (source row stride src_ld
// elements) into shared memory, row stride DB; cols == DB but for a block at
// the edge of D.
template <int DB, class IO>
__device__ __forceinline__ void stage_rows(IO* dst, const IO* src, size_t src_ld, int rows,
                                           int cols, int tid, int nthreads) {
  constexpr int V = kVec<IO>;
  if ((((uintptr_t)src) & 15) == 0 && src_ld % V == 0 && cols == DB) {
    for (int i = tid; i < rows * (DB / V); i += nthreads) {
      const int r = i / (DB / V), c = (i % (DB / V)) * V;
      cp_async_16(dst + r * DB + c, src + r * src_ld + c);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      stage_one(dst + r * DB + c, src + r * src_ld + c);
    }
  }
}

// A rows x cols tile from shared memory (row stride DB) to device memory, 16
// bytes a thread where the types agree and the destination allows it, else
// a value at a time, rounded to the destination's type.
template <int DB, class D, class S>
__device__ __forceinline__ void store_rows(D* dst, size_t dst_ld, const S* src, int rows,
                                           int cols, int tid, int nthreads) {
  constexpr int V = kVec<D>;
  if (sizeof(D) == sizeof(S) && (((uintptr_t)dst) & 15) == 0 && dst_ld % V == 0 && cols == DB) {
    for (int i = tid; i < rows * (DB / V); i += nthreads) {
      const int r = i / (DB / V), c = (i % (DB / V)) * V;
      *reinterpret_cast<uint4*>(dst + r * dst_ld + c) =
          *reinterpret_cast<const uint4*>(src + r * DB + c);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dst_ld + c] = from_f<D>(to_f(src[r * DB + c]));
    }
  }
}

// The 4 values of this lane's state group from a staged [t][N] row of B or
// C (or of the saved states); zeros for n >= N.
template <bool FULL, class IO>
__device__ __forceinline__ void load_group(const IO* row, int N, int g, float (&v)[kPer]) {
  if (FULL) {
    const float4 q = fm_io::load4(row + g * kPer);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = g * kPer + j < N ? to_f(row[g * kPer + j]) : 0.f;
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

// ---------------------------------------------------------------------------
// bf16_path: the pieces of the bf16 variants.

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(x) = max(x, 0) + log1p(e), e = exp(-|x|) in (0, 1], in MUFU form:
// e = ex2.approx(-|x| log2 e), which flushes results below 2^-126 to 0 (at
// |x| > 87.3 the softplus is then max(x, 0) and the slope 0 or 1: off by
// less than 1.2e-38). With u = 1 + e,
//   e >= 1/16:  log1p(e) = lg2.approx(u) ln 2. lg2.approx's absolute error
//               (about 2^-22) is under 2.7e-6 of log2(u) >= 0.087 there, and
//               u's own rounding (at most 2^-24) under 1e-6 of log(u) >= 0.06;
//   e <  1/16:  log1p(e) = e (1 - e/2 + e^2/3 - e^3/4 + e^4/5), whose
//               truncation is under e^5/6 < 1.6e-7 of log1p(e). Near u = 1
//               lg2.approx would be no good: its absolute error is about 1e-4
//               of log2(u) at e = 2^-10.
// The exponent's rounding moves e by up to |x| 2^-24 ln 2 relatively (4.8e-6
// at |x| = 80). In all, within 1e-5 of log1pf(expf(-|x|)) at every x, two
// special-function calls and a dozen fp32 instructions. The slope,
// sigmoid(x) = 1/u for x >= 0 and e/u below, takes one rcp.approx of the same
// u. tests/test_torch_scan_bf16_plans.py holds the formula against
// jax.nn.softplus and jax.nn.sigmoid over x in [-80, 80].
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSoftplusCut = 0.0625f;
__device__ __forceinline__ float log1p_of_exp(float e, float u) {
  float p = fmaf(e, 0.2f, -0.25f);
  p = fmaf(e, p, 0.333333343f);
  p = fmaf(e, p, -0.5f);
  p = fmaf(e, p, 1.f);
  return e < kSoftplusCut ? e * p : lg2_approx(u) * kLn2;
}
// delta = softplus(x) (x where `softplus` is 0) and its slope
__device__ __forceinline__ void softplus_slope(float x, int softplus, float& delta, float& slope) {
  delta = x;
  slope = 1.f;
  if (softplus) {
    const float e = exp2_approx(-kLog2e * fabsf(x)), u = 1.f + e;
    delta = fmaxf(x, 0.f) + log1p_of_exp(e, u);
    const float inv = rcp_approx(u);
    slope = x >= 0.f ? inv : e * inv;
  }
}
__device__ __forceinline__ float softplus_mufu(float x, int softplus) {
  if (!softplus) return x;
  const float e = exp2_approx(-kLog2e * fabsf(x));
  return fmaxf(x, 0.f) + log1p_of_exp(e, 1.f + e);
}

// One warp's D += A B on the tensor cores: A 16 x 16 (row), B 16 x 8 (col),
// bf16 operands, fp32 sums. Lane (g, q) = (lane / 4, lane % 4) holds
//   A: a0 = (row g, k 2q and 2q+1), a1 = (row g+8, k 2q..), a2 = (row g,
//      k 2q+8..), a3 = (row g+8, k 2q+8..), the lower half the smaller k;
//   B: b0 = (k 2q and 2q+1, column g), b1 = (k 2q+8.., column g);
//   D: d[0], d[1] = (row g, columns 2q, 2q+1), d[2], d[3] = (row g+8, ..).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(fm_io::bf16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t pack2(fm_io::bf16 lo, fm_io::bf16 hi) {
  return bits(lo) | (bits(hi) << 16);
}
// elements k and k+1 of a row of n bf16 values as one operand, zeros past n.
// A row of even n starts 4-byte aligned in its staged tile (every R the
// model uses is even: a dt row at R = 6 is 12 bytes), so the pair is one
// 32-bit load; an odd n takes two 16-bit loads.
__device__ __forceinline__ uint32_t pair_of(const fm_io::bf16* row, int k, int n) {
  if (k >= n) return 0u;
  if ((n & 1) == 0) return *reinterpret_cast<const uint32_t*>(row + k);
  return k + 1 < n ? pack2(row[k], row[k + 1]) : bits(row[k]);
}
// Two fp32 values as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi):
// for a bf16 B, hi B + lo B is v B with about 16 of v's bits (a relative
// error near 2^-17), where one bf16 product would keep 8.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Row stride of the bf16 W tile [channel][r] that the delta products read
// (R rounded up to 16, plus 8: 4 words past a multiple of 8, so that the 8
// channels' rows of one load fall in distinct banks).
__host__ __device__ inline int w16_ld(int R) { return (R + 15) / 16 * 16 + 8; }
// This block's W as bf16 [DB][w16_ld(R)], zeros past R and past `dim`.
template <int DB>
__device__ __forceinline__ void load_w16(const fm_io::bf16* W, fm_io::bf16* w16_s, int k, int d0,
                                         int dim, int R, int tid, int nthreads) {
  const int ld = w16_ld(R);
  for (int i = tid; i < DB * ld; i += nthreads) {
    const int dl = i / ld, r = i - dl * ld;
    w16_s[i] = (r < R && d0 + dl < dim) ? W[((size_t)k * dim + d0 + dl) * R + r]
                                        : __float2bfloat16_rn(0.f);
  }
}
template <int DB>
__device__ __forceinline__ void load_bias(const float* bias, float* bias_s, int k, int d0, int dim,
                                          int tid, int nthreads) {
  for (int i = tid; i < DB; i += nthreads) {
    bias_s[i] = (bias && d0 + i < dim) ? bias[(size_t)k * dim + d0 + i] : 0.f;
  }
}

// x = sum_r dt[t][r] W[c][r] on the tensor cores for the 8 channels c0 ..
// c0+7 of a warp and the first ROWS (16 or 8) steps of a staged dt tile
// ([t][R]): lane (g, q) gets x[g][c0 + 2q + j] in x[j] and, where ROWS is
// 16, x[g + 8][c0 + 2q + j] in x[2 + j]. Products of bf16 values are exact
// in fp32, so this is the fp32 sum in another order. Rows past the tile's
// steps hold whatever their staged values give; nothing reads them.
template <int ROWS>
__device__ __forceinline__ void delta_products(const fm_io::bf16* dt_s, int R,
                                               const fm_io::bf16* w16_s, int c0, int lane,
                                               float (&x)[4]) {
  const int g = lane >> 2, q = lane & 3;
  x[0] = x[1] = x[2] = x[3] = 0.f;
  const fm_io::bf16* a_lo = dt_s + g * R;
  const fm_io::bf16* a_hi = dt_s + (g + 8) * R;
  const fm_io::bf16* b = w16_s + (c0 + g) * w16_ld(R) + 2 * q;
  for (int k0 = 0; k0 < R; k0 += 16) {
    const int k = k0 + 2 * q;
    const uint32_t a1 = ROWS == 16 ? pair_of(a_hi, k, R) : 0u;
    const uint32_t a3 = ROWS == 16 ? pair_of(a_hi, k + 8, R) : 0u;
    mma_bf16(x, pair_of(a_lo, k, R), a1, pair_of(a_lo, k + 8, R), a3,
             *reinterpret_cast<const uint32_t*>(b + k0),
             *reinterpret_cast<const uint32_t*>(b + k0 + 8));
  }
}
// ---------------------------------------------------------------------------

// delta (and, where dsp_s is given, the softplus' slope) of a staged tile of
// Tc steps x DB channels, threads laid over (t, d) so that no lane repeats
// another's exp and log:
//   x = sum_r dt[t][r] W[d][r] + bias[d]      (x = dt[t][d] + bias[d] when R == 0)
//   delta = max(x, 0) + log1p(exp(-|x|)),  slope = sigmoid(x).
// dt_s is [t][R] (or [t][DB] when R == 0), w_s [r][DB + 1], bias_s [DB].
// The bf16 variants call it only at R == 0 (the full-rank dt), with the
// softplus in its MUFU form; at R > 0 they take `delta_products`.
template <int DB, class IO>
__device__ __forceinline__ void delta_phase(const IO* dt_s, const float* w_s,
                                            const float* bias_s, float* del_s, float* dsp_s,
                                            int Tc, int R, int softplus, int tid, int nthreads) {
  for (int i = tid; i < Tc * DB; i += nthreads) {
    const int t = i / DB, dl = i % DB;
    float x;
    if (R > 0) {
      x = 0.f;
      for (int r = 0; r < R; ++r) x = fmaf(to_f(dt_s[t * R + r]), w_s[r * (DB + 1) + dl], x);
    } else {
      x = to_f(dt_s[i]);
    }
    x += bias_s[dl];
    float delta = x, dsp = 1.f;
    if constexpr (std::is_same<IO, fm_io::bf16>::value) {  // the MUFU form
      if (dsp_s) {
        softplus_slope(x, softplus, delta, dsp);
      } else {
        delta = softplus_mufu(x, softplus);
      }
    } else if (softplus) {
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

// This block's W columns ([r][DB + 1] in fp32, zeros past `dim`) and biases.
template <int DB, class IO>
__device__ __forceinline__ void load_w_bias(const IO* W, const float* bias, float* w_s,
                                            float* bias_s, int k, int d0, int dim, int R,
                                            int tid, int nthreads) {
  for (int i = tid; i < DB * R; i += nthreads) {
    const int dl = i / R, r = i - dl * R;   // consecutive threads read consecutive floats
    w_s[r * (DB + 1) + dl] = d0 + dl < dim ? to_f(W[((size_t)k * dim + d0 + dl) * R + r]) : 0.f;
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
