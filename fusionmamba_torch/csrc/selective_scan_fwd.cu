// Selective-scan forward for Hopper (sm_90a), fp32 or bf16 I/O (u, dt, W, B,
// C and y; A, D, the bias and the saved states fp32; the math fp32 either
// way, so the low-rank dt is expanded with fp32 sums and delta is never
// rounded to bf16).
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
// What bounds it on this card. Per (b,k,l,d) element it moves 8 bytes (u in,
// y out), does about 7N + 2R + 7 fp32 operations and N + 2 special-function
// calls (one exp per state, the softplus' exp and log). At N = 16 the
// special-function units (16 results a clock an SM) set the bound, ahead of
// the bytes and the fp32 operations. What a design can lose beyond that is
// latency: every channel walks its steps in order, one fused multiply-add
// deep per state and step, so the card is full only if enough channels and
// chunks are in flight and none of them waits on device memory.
//
// Design (scan_common.cuh has the layout and the algebra).
//  * A block owns 32 channels of one (b, k) and one chunk of steps; a
//    channel's 16 states lie over 4 lanes, so a block is 4 warps; each lane
//    leaves its part of y in shared memory and the parts are summed when the
//    tile is stored. No exp is computed twice within a pass: delta is
//    expanded for a tile of 16 steps x 32 channels with threads laid over
//    (t, d) before the serial loop reads it.
//  * Nothing in the serial loop touches device memory. Tiles of 16 steps of
//    u, dt, B and C arrive through a two-stage cp.async ring, one tile ahead
//    of use; y leaves as whole tiles, 16 bytes a thread.
//  * Where B*K*D channels cannot fill the card (the first stages), L is cut
//    into chunks that run in parallel: a local pass finds every chunk's end
//    state from a zero start and its sum of delta, the carry pass turns
//    them into true start states, and the main pass restarts every chunk
//    from its start state and writes y. With one chunk there is one pass.
//    The chunked form costs a second exp per state and step.
//  * exp runs on every step, so the result is exact at any delta (the TPU
//    kernel's rescale clip and repair have no counterpart here); the
//    softplus is max(x,0) + log1p(exp(-|x|)), the reference's form.
//  * For training, `hsave` (may be null) receives the states at the start of
//    every `save_every` steps, (B*K, ceil(L/save_every), D, N), 16 bytes a
//    thread; the backward restarts from them. Serving writes no states but
//    the carries.
#include "scan_common.cuh"

namespace {

using namespace fm_scan;

constexpr int kDB = 32;                  // channels per block
constexpr int kThreads = kDB * kGroups;  // 128
constexpr int kTile = 16;                // steps per staged tile

// elements of a ring stage (u, dt, B and C tiles of IO, each a multiple of
// 16 elements, so 16-byte aligned in either type)
__host__ __device__ inline int stage_elems(int N, int R) {
  return kTile * kDB + (R > 0 ? kTile * R : kTile * kDB) + 2 * kTile * N;
}
__host__ __device__ inline int w_floats(int R) { return (R * (kDB + 1) + 3) & ~3; }
template <class IO>
__host__ __device__ inline size_t smem_bytes(int N, int R) {
  return sizeof(float) * ((size_t)w_floats(R) + kDB + kTile * kDB + kTile * kThreads) +
         sizeof(IO) * 2 * (size_t)stage_elems(N, R);
}

// y of a tile: the sum of each channel's 4 lane parts, to device memory as
// 16 bytes a thread where the rows allow it.
__device__ __forceinline__ float lane_parts_sum(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return (q.x + q.y) + (q.z + q.w);
}
template <class IO>
__device__ __forceinline__ void store_y(IO* dst, size_t ld, const float* y_s, int rows, int cols,
                                        int tid) {
  if ((((uintptr_t)dst) & (4 * sizeof(IO) - 1)) == 0 && (ld & 3) == 0 && (cols & 3) == 0) {
    const int cpr = cols >> 2;
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) << 2;
      const float* p = y_s + r * kThreads + c * kGroups;
      fm_io::store4(dst + r * ld + c,
                    make_float4(lane_parts_sum(p), lane_parts_sum(p + 4), lane_parts_sum(p + 8),
                                lane_parts_sum(p + 12)));
    }
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = from_f<IO>(lane_parts_sum(y_s + r * kThreads + c * kGroups));
    }
  }
}

// LOCAL: the chunk's end state from a zero start and its sum of delta go to
// `carry` and `sdel`; nothing else is written. Otherwise the chunk starts
// from `carry` (zero where it is null), and y and hsave are written.
template <class IO, bool LOCAL, bool FULL>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const IO* __restrict__ u, const IO* __restrict__ dt,
                          const IO* __restrict__ W, const float* __restrict__ A,
                          const IO* __restrict__ Bm, const IO* __restrict__ Cm,
                          const float* __restrict__ Dp, const float* __restrict__ bias,
                          IO* __restrict__ out, float* __restrict__ hsave,
                          float* __restrict__ carry, float* __restrict__ sdel, int K, int L,
                          int dim, int N, int R, int softplus, int save_every, int chunk_len,
                          int n_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                       // [R][kDB + 1]
  float* bias_s = w_s + w_floats(R);       // [kDB]
  float* del_s = bias_s + kDB;             // [kTile][kDB]
  float* y_s = del_s + kTile * kDB;        // [kTile][kThreads]: each lane's part of y
  IO* ring = reinterpret_cast<IO*>(y_s + kTile * kThreads);  // 2 stages of u, dt, B, C tiles
  const int stage_sz = stage_elems(N, R);
  const int dt_sz = R > 0 ? kTile * R : kTile * kDB;

  const int tid = threadIdx.x, dl = tid / kGroups, g = tid % kGroups;
  const int bk = blockIdx.z, k = bk % K, c = blockIdx.y;
  const int d0 = blockIdx.x * kDB, d = d0 + dl;
  const bool active = d < dim;
  const int dc = active ? d : dim - 1;
  const int cols = min(kDB, dim - d0);
  const int l_begin = c * chunk_len, l_end = min(L, l_begin + chunk_len);
  const int n_tiles = (l_end - l_begin + kTile - 1) / kTile;
  const size_t row0 = (size_t)bk * L;

  if (cols < kDB) {  // the columns past `dim` are never copied: they read as 0
    for (int i = tid; i < 2 * stage_sz; i += kThreads) ring[i] = from_f<IO>(0.f);
  }
  load_w_bias<kDB>(W, bias, w_s, bias_s, k, d0, dim, R, tid, kThreads);

  float a[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = g * kPer + j;
    a[j] = n < N ? kLog2e * A[((size_t)k * dim + dc) * N + n] : 0.f;  // for exp2_approx
    h[j] = 0.f;
  }
  if (!LOCAL && carry && active) {  // lanes past `dim` stay at 0
    load_states<FULL>(carry + ((size_t)bk * n_chunk + c) * dim * N, d, N, g, h);
  }
  const float dskip = (Dp && g == 0) ? Dp[(size_t)k * dim + dc] : 0.f;  // one lane adds D u
  float sum_delta = 0.f;
  const int n_save = (L + save_every - 1) / save_every;
  const int save_shift = __ffs(save_every) - 1;              // save_every is a power of two
  const int run = (!LOCAL && hsave) ? save_every : kTile;    // steps between two saves

  auto prefetch = [&](int i) {
    IO* u_s = ring + (i & 1) * stage_sz;
    IO* dt_s = u_s + kTile * kDB;
    IO* b_s = dt_s + dt_sz;
    const int l0 = l_begin + i * kTile, Tc = min(kTile, l_end - l0);
    stage_rows<kDB>(u_s, u + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    if (R > 0) {
      stage_span(dt_s, dt + (row0 + l0) * R, Tc * R, tid, kThreads);
    } else {
      stage_rows<kDB>(dt_s, dt + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    }
    stage_span(b_s, Bm + (row0 + l0) * N, Tc * N, tid, kThreads);
    if (!LOCAL) stage_span(b_s + kTile * N, Cm + (row0 + l0) * N, Tc * N, tid, kThreads);
    cp_async_commit();
  };

  __syncthreads();
  prefetch(0);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has arrived; tile i - 1 and its y are consumed
    if (i + 1 < n_tiles) prefetch(i + 1);
    const IO* u_s = ring + (i & 1) * stage_sz;
    const IO* dt_s = u_s + kTile * kDB;
    const IO* b_s = dt_s + dt_sz;
    const IO* c_s = b_s + kTile * N;
    const int l0 = l_begin + i * kTile, Tc = min(kTile, l_end - l0);
    delta_phase<kDB>(dt_s, w_s, bias_s, del_s, nullptr, Tc, R, softplus, tid, kThreads);
    __syncthreads();

    // the serial loop, in runs of `run` steps with no branch inside, so that
    // the compiler overlaps the steps' loads and exps; states are saved
    // between runs
    for (int t0 = 0; t0 < Tc; t0 += run) {
      if (!LOCAL && hsave && active) {
        store_states<FULL>(hsave + ((size_t)bk * n_save + ((l0 + t0) >> save_shift)) * dim * N, d,
                           N, g, h);
      }
      const int t1 = min(t0 + run, Tc);
#pragma unroll 4
      for (int t = t0; t < t1; ++t) {
        const float delta = del_s[t * kDB + dl];
        const float uv = to_f(u_s[t * kDB + dl]);
        const float dbu = delta * uv;
        float bv[kPer];
        load_group<FULL>(b_s + t * N, N, g, bv);
        if (LOCAL) {
          sum_delta += delta;
#pragma unroll
          for (int j = 0; j < kPer; ++j) h[j] = fmaf(exp2_approx(delta * a[j]), h[j], dbu * bv[j]);
        } else {
          float cv[kPer];
          load_group<FULL>(c_s + t * N, N, g, cv);
          float y = dskip * uv;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            h[j] = fmaf(exp2_approx(delta * a[j]), h[j], dbu * bv[j]);
            y = fmaf(cv[j], h[j], y);
          }
          y_s[t * kThreads + tid] = y;
        }
      }
    }
    if (!LOCAL) {
      __syncthreads();
      store_y(out + (row0 + l0) * dim + d0, dim, y_s, Tc, cols, tid);
    }
  }

  if (LOCAL && active) {
    const size_t at = ((size_t)bk * n_chunk + c) * dim;
    store_states<FULL>(carry + at * N, d, N, g, h);
    if (g == 0) sdel[at + d] = sum_delta;
  }
}

template <class IO, bool LOCAL, bool FULL>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const IO* u, const IO* dt,
                   const IO* W, const float* A, const IO* Bm, const IO* Cm, const float* Dp,
                   const float* bias, IO* out, float* hsave, float* carry, float* sdel, int K,
                   int L, int dim, int N, int R, int softplus, int save_every, int chunk_len,
                   int n_chunk) {
  auto kernel = selective_scan_fwd_kernel<IO, LOCAL, FULL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(u, dt, W, A, Bm, Cm, Dp, bias, out, hsave, carry, sdel,
                                           K, L, dim, N, R, softplus, save_every, chunk_len,
                                           n_chunk);
  return cudaGetLastError();
}

template <class IO>
int scan_fwd(const IO* u, const IO* dt, const IO* W, const float* A, const IO* Bm, const IO* Cm,
             const float* Dp, const float* bias, IO* out, float* hsave, float* carry, float* sdel,
             int batch, int K, int L, int dim, int N, int R, int softplus, int save_every,
             int chunk_len, cudaStream_t stream) {
  if (N < 1 || N > kMaxN || R < 0 || dim < 1 || L < 1 || batch * K < 1 || save_every < 1 ||
      kTile % save_every != 0 || (save_every & (save_every - 1)) != 0 || chunk_len < kTile ||
      chunk_len % kTile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunk = (L + chunk_len - 1) / chunk_len;
  if (n_chunk > 1 && (!carry || !sdel)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<IO>(N, R);
  const int n_dblk = (dim + kDB - 1) / kDB;
  const bool full = N == kMaxN;
  cudaError_t err = cudaSuccess;
#define FM_FWD(LOCAL, FULL, GRID, CARRY)                                                       \
  launch<IO, LOCAL, FULL>(GRID, smem, stream, u, dt, W, A, Bm, Cm, Dp, bias, out, hsave, CARRY, \
                          sdel, K, L, dim, N, R, softplus, save_every, chunk_len, n_chunk)
  if (n_chunk > 1) {
    const dim3 grid(n_dblk, n_chunk - 1, batch * K);  // the last chunk's end state is not needed
    err = full ? FM_FWD(true, true, grid, carry) : FM_FWD(true, false, grid, carry);
    if (err != cudaSuccess) return (int)err;
    err = launch_carry(carry, sdel, A, batch, K, dim, N, n_chunk, 0, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_dblk, n_chunk, batch * K);
  float* start = n_chunk > 1 ? carry : nullptr;
  err = full ? FM_FWD(false, true, grid, start) : FM_FWD(false, false, grid, start);
#undef FM_FWD
  return (int)err;
}

}  // namespace

// hsave (B*K, ceil(L/save_every), D, N) or null. With ceil(L/chunk_len) > 1
// chunks, carry (B*K, n_chunk, D, N) and sdel (B*K, n_chunk, D) are scratch;
// chunk_len is a multiple of 16 and save_every divides 16. The _bf16 entry
// takes u, dt, W, B, C and out as bf16.
extern "C" int fm_selective_scan_fwd(const float* u, const float* dt, const float* W,
                                     const float* A, const float* Bm, const float* Cm,
                                     const float* Dp, const float* bias, float* out, float* hsave,
                                     float* carry, float* sdel, int batch, int K, int L, int dim,
                                     int N, int R, int softplus, int save_every, int chunk_len,
                                     cudaStream_t stream) {
  return scan_fwd(u, dt, W, A, Bm, Cm, Dp, bias, out, hsave, carry, sdel, batch, K, L, dim, N, R,
                  softplus, save_every, chunk_len, stream);
}
extern "C" int fm_selective_scan_fwd_bf16(const fm_io::bf16* u, const fm_io::bf16* dt,
                                          const fm_io::bf16* W, const float* A,
                                          const fm_io::bf16* Bm, const fm_io::bf16* Cm,
                                          const float* Dp, const float* bias, fm_io::bf16* out,
                                          float* hsave, float* carry, float* sdel, int batch,
                                          int K, int L, int dim, int N, int R, int softplus,
                                          int save_every, int chunk_len, cudaStream_t stream) {
  return scan_fwd(u, dt, W, A, Bm, Cm, Dp, bias, out, hsave, carry, sdel, batch, K, L, dim, N, R,
                  softplus, save_every, chunk_len, stream);
}
