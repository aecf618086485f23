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
// What bounds it on this card. Per (b,k,l,d) element it moves 12 bytes (u
// and dy in, du out) plus the saved states, does about 20N + 6R + 15 fp32
// operations and needs N + 3 special-function calls (an exp per state; the
// softplus' exp and log and the slope's reciprocal). At N = 16 the fp32
// operations set the bound, ahead of the special-function units (16 results
// a clock an SM) and the bytes. This design takes 2N + 3 special-function
// calls: the adjoint repeats the recompute's exp(delta A) rather than keep
// it beside each state in the shared-memory tile, which would double the
// tile. Beyond the bound a design loses to latency (each channel walks its
// steps in order, twice) and to the sums over d.
//
// Design (scan_common.cuh has the layout and the algebra).
//  * A block owns 64 channels of one (b, k) and one chunk of steps; a
//    channel's 16 states lie over 4 lanes (8 warps a block), so g, A and dA
//    are 4 registers each and du and d(delta) two shuffles a step.
//  * The forward saved the states at the start of every T steps (hsave,
//    (B*K, ceil(L/T), D, N)). The block walks its chunk's tiles of T steps in
//    reverse: recompute the tile's states from the saved ones into shared
//    memory, then the adjoint over the tile. Nothing in either serial loop
//    touches device memory: u, dy, dt, B, C and the saved states of the next
//    tile arrive through a two-stage cp.async ring while this one runs; du
//    (and d(dt) when R == 0) leave as whole tiles, 16 bytes a thread.
//  * No shuffle tree per step for the sums over d. dC_n[t] = sum_d dy h is
//    taken once a tile from the recomputed states in shared memory, with
//    threads laid over (t, n). The adjoint overwrites each state it has used
//    with its term g delta u, and dB_n[t] is the same sum over those. d(dt)
//    and dW are sums over the tile's dx in shared memory, threads over (t, r)
//    and (d, r). All in a fixed order: no atomics, two launches agree bit
//    for bit.
//  * Where B*K*D channels cannot fill the card, L is cut into chunks that
//    run in parallel. A local pass runs the adjoint of every chunk from a
//    zero start (g only: one exp and two multiply-adds a state), the carry
//    pass turns the results into the true g entering each chunk, and the
//    main pass starts every chunk from it. The recompute needs no carries:
//    the saved states are true states.
//  * Sums over d are written as per-d-block partials, per-channel sums (dA,
//    dD, dbias, dW) as per-(b, k, chunk) partials; one more launch sums all
//    of them in a fixed order.
#include "scan_common.cuh"

namespace {

using namespace fm_scan;

constexpr int kDB = 64;                    // channels per block
constexpr int kThreads = kDB * kGroups;    // 256
constexpr int kHS = kDB * kMaxN + 16;      // floats between two steps of h_s: the pad
                                           // shifts the banks of neighbouring steps
constexpr int kTileL = 16;                 // steps per tile of the local pass

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int w_floats(int R) { return round4(R * (kDB + 1)); }
__host__ __device__ inline int dt_floats(int R, int T) { return R > 0 ? round4(T * R) : T * kDB; }
__host__ __device__ inline int stage_floats(int N, int R, int T) {
  return 2 * T * kDB + dt_floats(R, T) + 2 * round4(T * N) + kDB * kMaxN;
}
__host__ __device__ inline size_t smem_floats(int N, int R, int T) {
  return 2 * (size_t)w_floats(R) + kDB + 2 * (size_t)T * kDB + (size_t)(T + 1) * kHS +
         2 * (size_t)stage_floats(N, R, T);
}
__host__ __device__ inline int local_stage_floats(int N, int R) {
  return kTileL * kDB + dt_floats(R, kTileL) + kTileL * N;
}
__host__ __device__ inline size_t local_smem_floats(int N, int R) {
  return (size_t)w_floats(R) + kDB + kTileL * kDB + 2 * (size_t)local_stage_floats(N, R);
}

// The adjoint of chunks 1 .. n_chunk-1 from a zero start: what each hands to
// the chunk before it (e g at its first step) goes to `carry`, its sum of
// delta to `sdel`.
template <bool FULL>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_local_kernel(const float* __restrict__ dt, const float* __restrict__ W,
                                const float* __restrict__ A, const float* __restrict__ Cm,
                                const float* __restrict__ bias, const float* __restrict__ dy,
                                float* __restrict__ carry, float* __restrict__ sdel, int K, int L,
                                int dim, int N, int R, int softplus, int chunk_len,
                                int n_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* bias_s = w_s + w_floats(R);
  float* del_s = bias_s + kDB;
  float* ring = del_s + kTileL * kDB;
  const int stage_sz = local_stage_floats(N, R);

  const int tid = threadIdx.x, dl = tid / kGroups, g = tid % kGroups;
  const int bk = blockIdx.z, k = bk % K, c = blockIdx.y + 1;
  const int d0 = blockIdx.x * kDB, d = d0 + dl;
  const bool active = d < dim;
  const int dc = active ? d : dim - 1;
  const int cols = min(kDB, dim - d0);
  const int l_begin = c * chunk_len, l_end = min(L, l_begin + chunk_len);
  const int n_tiles = (l_end - l_begin + kTileL - 1) / kTileL;
  const size_t row0 = (size_t)bk * L;

  if (cols < kDB) {
    for (int i = tid; i < 2 * stage_sz; i += kThreads) ring[i] = 0.f;
  }
  load_w_bias<kDB>(W, bias, w_s, bias_s, k, d0, dim, R, tid, kThreads);
  float a2[kPer], gc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = g * kPer + j;
    a2[j] = n < N ? kLog2e * A[((size_t)k * dim + dc) * N + n] : 0.f;  // for exp2_approx
    gc[j] = 0.f;
  }
  float sum_delta = 0.f;

  auto prefetch = [&](int i) {  // the i-th tile from the chunk's end
    float* dy_s = ring + (i & 1) * stage_sz;
    float* dt_s = dy_s + kTileL * kDB;
    float* c_s = dt_s + dt_floats(R, kTileL);
    const int l0 = l_begin + (n_tiles - 1 - i) * kTileL, Tc = min(kTileL, l_end - l0);
    stage_rows<kDB>(dy_s, dy + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    if (R > 0) {
      stage_span(dt_s, dt + (row0 + l0) * R, Tc * R, tid, kThreads);
    } else {
      stage_rows<kDB>(dt_s, dt + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    }
    stage_span(c_s, Cm + (row0 + l0) * N, Tc * N, tid, kThreads);
    cp_async_commit();
  };

  __syncthreads();
  prefetch(0);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_tiles) prefetch(i + 1);
    const float* dy_s = ring + (i & 1) * stage_sz;
    const float* dt_s = dy_s + kTileL * kDB;
    const float* c_s = dt_s + dt_floats(R, kTileL);
    const int l0 = l_begin + (n_tiles - 1 - i) * kTileL, Tc = min(kTileL, l_end - l0);
    delta_phase<kDB>(dt_s, w_s, bias_s, del_s, nullptr, Tc, R, softplus, tid, kThreads);
    __syncthreads();
#pragma unroll 4
    for (int t = Tc - 1; t >= 0; --t) {
      const float delta = del_s[t * kDB + dl];
      const float dyv = dy_s[t * kDB + dl];
      float cv[kPer];
      load_group<FULL>(c_s + t * N, N, g, cv);
      sum_delta += delta;
#pragma unroll
      for (int j = 0; j < kPer; ++j) gc[j] = exp2_approx(delta * a2[j]) * fmaf(cv[j], dyv, gc[j]);
    }
  }
  if (active) {
    const size_t at = ((size_t)bk * n_chunk + c) * dim;
    store_states<FULL>(carry + at * N, d, N, g, gc);
    if (g == 0) sdel[at + d] = sum_delta;
  }
}

template <bool FULL>
__global__ void __launch_bounds__(kThreads, 3)
selective_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ W, const float* __restrict__ A,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ Dp, const float* __restrict__ bias,
                          const float* __restrict__ hsave, const float* __restrict__ carry,
                          const float* __restrict__ dy, float* __restrict__ du,
                          float* __restrict__ ddt, float* __restrict__ dW_p,
                          float* __restrict__ dA_p, float* __restrict__ dB_p,
                          float* __restrict__ dC_p, float* __restrict__ dD_p,
                          float* __restrict__ dbias_p, int K, int L, int dim, int N, int R, int T,
                          int softplus, int chunk_len, int n_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // [R][kDB + 1]
  float* dw_s = w_s + w_floats(R);          // [R][kDB + 1]
  float* bias_s = dw_s + w_floats(R);       // [kDB]
  float* del_s = bias_s + kDB;              // [T][kDB] delta
  float* dx_s = del_s + T * kDB;            // [T][kDB] sigmoid(x), then the gradient of x
  float* h_s = dx_s + T * kDB;              // [T + 1][kHS]: states, then the terms of dB
  float* ring = h_s + (T + 1) * kHS;        // 2 stages of u, dy, dt, B, C, saved states
  const int stage_sz = stage_floats(N, R, T);
  const int dt_sz = dt_floats(R, T), bc_sz = round4(T * N);

  const int tid = threadIdx.x, dl = tid / kGroups, g = tid % kGroups;
  const int bk = blockIdx.z, k = bk % K, c = blockIdx.y;
  const int dblk = blockIdx.x, n_dblk = gridDim.x;
  const int d0 = dblk * kDB, d = d0 + dl;
  const bool active = d < dim;
  const int dc = active ? d : dim - 1;
  const int cols = min(kDB, dim - d0);
  const int l_begin = c * chunk_len, l_end = min(L, l_begin + chunk_len);
  const int n_tiles = (l_end - l_begin + T - 1) / T;
  const int n_save = (L + T - 1) / T;
  const size_t row0 = (size_t)bk * L;

  if (cols < kDB) {  // the columns past `dim` are never copied: they read as 0
    for (int i = tid; i < 2 * stage_sz; i += kThreads) ring[i] = 0.f;
  }
  load_w_bias<kDB>(W, bias, w_s, bias_s, k, d0, dim, R, tid, kThreads);
  for (int i = tid; i < w_floats(R); i += kThreads) dw_s[i] = 0.f;

  float a[kPer], a2[kPer], gc[kPer], dA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = g * kPer + j;
    a[j] = n < N ? A[((size_t)k * dim + dc) * N + n] : 0.f;
    a2[j] = kLog2e * a[j];  // for exp2_approx
    gc[j] = 0.f;
    dA[j] = 0.f;
  }
  // Lanes past `dim` keep g = 0: with their dy reading as 0 everything they
  // write into the staged tiles (du, dx, the terms of dB) is 0, which the
  // sums over the block's 64 columns rely on.
  if (carry && active) {
    load_states<FULL>(carry + ((size_t)bk * n_chunk + c) * dim * N, d, N, g, gc);
  }
  const float dskip = Dp ? Dp[(size_t)k * dim + dc] : 0.f;
  float dD = 0.f, dbias_acc = 0.f;

  auto prefetch = [&](int i) {  // the i-th tile from the chunk's end
    float* u_s = ring + (i & 1) * stage_sz;
    float* dy_s = u_s + T * kDB;
    float* dt_s = dy_s + T * kDB;
    float* b_s = dt_s + dt_sz;
    float* c_s = b_s + bc_sz;
    float* h0_s = c_s + bc_sz;
    const int l0 = l_begin + (n_tiles - 1 - i) * T, Tc = min(T, l_end - l0);
    stage_rows<kDB>(u_s, u + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    stage_rows<kDB>(dy_s, dy + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    if (R > 0) {
      stage_span(dt_s, dt + (row0 + l0) * R, Tc * R, tid, kThreads);
    } else {
      stage_rows<kDB>(dt_s, dt + (row0 + l0) * dim + d0, dim, Tc, cols, tid, kThreads);
    }
    stage_span(b_s, Bm + (row0 + l0) * N, Tc * N, tid, kThreads);
    stage_span(c_s, Cm + (row0 + l0) * N, Tc * N, tid, kThreads);
    stage_span(h0_s, hsave + (((size_t)bk * n_save + l0 / T) * dim + d0) * N, cols * N, tid,
               kThreads);
    cp_async_commit();
  };

  __syncthreads();
  prefetch(0);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has arrived; tile i - 1 is consumed
    if (i + 1 < n_tiles) prefetch(i + 1);
    float* u_s = ring + (i & 1) * stage_sz;  // u, then du
    const float* dy_s = u_s + T * kDB;
    const float* dt_s = dy_s + T * kDB;
    const float* b_s = dt_s + dt_sz;
    const float* c_s = b_s + bc_sz;
    const float* h0_s = c_s + bc_sz;
    const int l0 = l_begin + (n_tiles - 1 - i) * T, Tc = min(T, l_end - l0);
    delta_phase<kDB>(dt_s, w_s, bias_s, del_s, dx_s, Tc, R, softplus, tid, kThreads);
    __syncthreads();

    // recompute the tile's states from the saved start state
    {
      float h[kPer];
      load_group<FULL>(h0_s + dl * N, N, g, h);
      float* hp = h_s + tid * kPer;
      *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll 4
      for (int t = 0; t < Tc; ++t) {
        const float delta = del_s[t * kDB + dl];
        const float dbu = delta * u_s[t * kDB + dl];
        float bv[kPer];
        load_group<FULL>(b_s + t * N, N, g, bv);
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = fmaf(exp2_approx(delta * a2[j]), h[j], dbu * bv[j]);
        hp += kHS;
        *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    __syncthreads();
    // dC_n[t] = sum over the block's d of dy * h_l: threads over (t, half of
    // the d, n), the two halves joined by one shuffle
    for (int j = tid; j < Tc * 2 * kMaxN; j += kThreads) {
      const int t = j / (2 * kMaxN), half = (j / kMaxN) % 2, n = j % kMaxN;
      const float* hv = h_s + (t + 1) * kHS + half * (kDB / 2) * kMaxN + n;
      const float* dv = dy_s + t * kDB + half * (kDB / 2);
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < kDB / 2; ++dd) s = fmaf(dv[dd], hv[dd * kMaxN], s);
      s += __shfl_xor_sync(0xffffffffu, s, kMaxN);
      if (half == 0 && n < N) dC_p[(((size_t)bk * n_dblk + dblk) * L + l0 + t) * N + n] = s;
    }
    __syncthreads();

    // the adjoint over the tile, last step first
#pragma unroll 2
    for (int t = Tc - 1; t >= 0; --t) {
      const float delta = del_s[t * kDB + dl];
      const float uv = u_s[t * kDB + dl];
      const float dyv = dy_s[t * kDB + dl];
      float bv[kPer], cv[kPer], term[kPer];
      load_group<FULL>(b_s + t * N, N, g, bv);
      load_group<FULL>(c_s + t * N, N, g, cv);
      float* hp = h_s + t * kHS + tid * kPer;
      const float4 hq = *reinterpret_cast<const float4*>(hp);
      const float hprev[kPer] = {hq.x, hq.y, hq.z, hq.w};
      float ddelta = 0.f, du_acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float gv = fmaf(cv[j], dyv, gc[j]);
        const float e = exp2_approx(delta * a2[j]);
        const float eh = e * hprev[j];
        const float gd = gv * delta;
        ddelta = fmaf(gv, fmaf(a[j], eh, uv * bv[j]), ddelta);
        dA[j] = fmaf(gd, eh, dA[j]);
        du_acc = fmaf(gd, bv[j], du_acc);
        gc[j] = e * gv;
        term[j] = gd * uv;
      }
      *reinterpret_cast<float4*>(hp) = make_float4(term[0], term[1], term[2], term[3]);
      ddelta = group_sum(ddelta);
      du_acc = group_sum(du_acc);
      if (g == 0) {  // the shuffles above order the other lanes' reads of u before this
        const float dx = ddelta * dx_s[t * kDB + dl];
        dx_s[t * kDB + dl] = dx;
        u_s[t * kDB + dl] = fmaf(dskip, dyv, du_acc);
        dbias_acc += dx;
        dD = fmaf(dyv, uv, dD);
      }
    }
    __syncthreads();

    // the tile's sums over d, in a fixed order, and its whole-tile stores
    for (int j = tid; j < Tc * 2 * kMaxN; j += kThreads) {
      const int t = j / (2 * kMaxN), half = (j / kMaxN) % 2, n = j % kMaxN;
      const float* tv = h_s + t * kHS + half * (kDB / 2) * kMaxN + n;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < kDB / 2; ++dd) s += tv[dd * kMaxN];
      s += __shfl_xor_sync(0xffffffffu, s, kMaxN);
      if (half == 0 && n < N) dB_p[(((size_t)bk * n_dblk + dblk) * L + l0 + t) * N + n] = s;
    }
    store_rows<kDB>(du + (row0 + l0) * dim + d0, dim, u_s, Tc, cols, tid, kThreads);
    if (R > 0) {
      for (int j = tid; j < Tc * R; j += kThreads) {
        const int t = j / R, r = j - t * R;
        float s = 0.f;
        for (int dd = 0; dd < kDB; ++dd) s = fmaf(dx_s[t * kDB + dd], w_s[r * (kDB + 1) + dd], s);
        ddt[(((size_t)bk * n_dblk + dblk) * L + l0 + t) * R + r] = s;
      }
      for (int j = tid; j < kDB * R; j += kThreads) {
        const int dd = j % kDB, r = j / kDB;
        float s = dw_s[r * (kDB + 1) + dd];
        for (int t = 0; t < Tc; ++t) s = fmaf(dx_s[t * kDB + dd], dt_s[t * R + r], s);
        dw_s[r * (kDB + 1) + dd] = s;
      }
    } else {
      store_rows<kDB>(ddt + (row0 + l0) * dim + d0, dim, dx_s, Tc, cols, tid, kThreads);
    }
  }

  // this chunk's per-channel partials
  const size_t at = ((size_t)bk * n_chunk + c) * dim;
  if (active) {
    store_states<FULL>(dA_p + at * N, d, N, g, dA);
    if (g == 0) {
      if (dD_p) dD_p[at + d] = dD;
      if (dbias_p) dbias_p[at + d] = dbias_acc;
    }
  }
  if (R > 0) {
    __syncthreads();
    for (int j = tid; j < cols * R; j += kThreads) {
      const int dd = j / R, r = j - dd * R;
      dW_p[(at + d0 + dd) * R + r] = dw_s[r * (kDB + 1) + dd];
    }
  }
}

// One launch sums every partial in a fixed order. A segment's output (o, r),
// o < O, r < inner, is the sum over q < Q and p < P of
// src[((q * O + o) * P + p) * inner + r]: the d-blocks of a (b, k) row
// (Q = 1, O = B*K, P = n_dblk), or the batch and the chunks of a parameter's
// gradient (Q = B, O = K, P = n_chunk).
struct ReduceSeg {
  const float* src;
  float* dst;
  int Q, O, P, inner, begin;
};
constexpr int kMaxSeg = 7;
struct ReduceArgs {
  ReduceSeg seg[kMaxSeg];
  int n_seg, total;
};

__global__ void __launch_bounds__(256) scan_bwd_reduce_kernel(const ReduceArgs args) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= args.total) return;
  int s = 0;
  while (s + 1 < args.n_seg && i >= args.seg[s + 1].begin) ++s;
  const ReduceSeg seg = args.seg[s];
  const int j = i - seg.begin, o = j / seg.inner, r = j - o * seg.inner;
  float acc = 0.f;
  for (int q = 0; q < seg.Q; ++q) {
    const float* p = seg.src + (((size_t)q * seg.O + o) * seg.P) * seg.inner + r;
    for (int pp = 0; pp < seg.P; ++pp) acc += p[(size_t)pp * seg.inner];
  }
  seg.dst[j] = acc;
}

inline size_t round4s(size_t x) { return (x + 3) & ~(size_t)3; }

}  // namespace

// hsave (B*K, ceil(L/T), D, N) from the forward. The gradients come out in
// their inputs' shapes: du (B,K,L,D); ddt (B,K,L,R), or (B,K,L,D) when R == 0;
// dW (K,D,R); dA (K,D,N); dB, dC (B,K,L,N); dD, dbias (K,D) or null. `scratch`
// holds the partials and the carries, each segment rounded up to 4 floats,
// with n_chunk = ceil(L/chunk_len), n_dblk = ceil(D/64), BK = B*K: ddt's
// BK*n_dblk*L*R, dB's and dC's BK*n_dblk*L*N each, dA's BK*n_chunk*D*N, dD's
// and dbias' BK*n_chunk*D each, dW's BK*n_chunk*D*R, the carries BK*n_chunk*D*N
// and the chunks' sums of delta BK*n_chunk*D. chunk_len is a multiple of 16
// and T divides 16.
extern "C" int fm_selective_scan_bwd(const float* u, const float* dt, const float* W,
                                     const float* A, const float* Bm, const float* Cm,
                                     const float* Dp, const float* bias, const float* hsave,
                                     const float* dy, float* du, float* ddt, float* dW, float* dA,
                                     float* dB, float* dC, float* dD, float* dbias, float* scratch,
                                     int batch, int K, int L, int dim, int N, int R, int T,
                                     int softplus, int chunk_len, cudaStream_t stream) {
  if (N < 1 || N > kMaxN || R < 0 || dim < 1 || L < 1 || T < 1 || batch * K < 1 ||
      kTileL % T != 0 || chunk_len < kTileL || chunk_len % kTileL != 0 || !scratch) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunk = (L + chunk_len - 1) / chunk_len;
  const int n_dblk = (dim + kDB - 1) / kDB;
  const size_t BK = (size_t)batch * K;
  float* next = scratch;
  auto take = [&](size_t n) {
    float* p = next;
    next += round4s(n);
    return p;
  };
  float* ddt_p = take(BK * n_dblk * L * R);
  float* dB_p = take(BK * n_dblk * L * N);
  float* dC_p = take(BK * n_dblk * L * N);
  float* dA_p = take(BK * n_chunk * dim * N);
  float* dD_p = take(BK * n_chunk * dim);
  float* dbias_p = take(BK * n_chunk * dim);
  float* dW_p = take(BK * n_chunk * dim * R);
  float* carry = take(BK * n_chunk * dim * N);
  float* sdel = take(BK * n_chunk * dim);

  const bool full = N == kMaxN;
  cudaError_t err;
  if (n_chunk > 1) {
    const size_t smem = sizeof(float) * local_smem_floats(N, R);
    auto kernel = full ? selective_scan_bwd_local_kernel<true>
                       : selective_scan_bwd_local_kernel<false>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(n_dblk, n_chunk - 1, batch * K);  // chunk 0 hands nothing on
    kernel<<<grid, kThreads, smem, stream>>>(dt, W, A, Cm, bias, dy, carry, sdel, K, L, dim, N, R,
                                             softplus, chunk_len, n_chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_carry(carry, sdel, A, batch, K, dim, N, n_chunk, 1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = sizeof(float) * smem_floats(N, R, T);
  auto kernel = full ? selective_scan_bwd_kernel<true> : selective_scan_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_dblk, n_chunk, batch * K);
  kernel<<<grid, kThreads, smem, stream>>>(
      u, dt, W, A, Bm, Cm, Dp, bias, hsave, n_chunk > 1 ? carry : nullptr, dy, du,
      R > 0 ? ddt_p : ddt, dW_p, dA_p, dB_p, dC_p, dD ? dD_p : nullptr,
      dbias ? dbias_p : nullptr, K, L, dim, N, R, T, softplus, chunk_len, n_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ReduceArgs args;
  int n_seg = 0, total = 0;
  auto add = [&](const float* src, float* dst, int Q, int O, int P, size_t inner) {
    if (!dst || inner == 0) return;
    args.seg[n_seg++] = ReduceSeg{src, dst, Q, O, P, (int)inner, total};
    total += O * (int)inner;
  };
  add(ddt_p, R > 0 ? ddt : nullptr, 1, (int)BK, n_dblk, (size_t)L * R);
  add(dB_p, dB, 1, (int)BK, n_dblk, (size_t)L * N);
  add(dC_p, dC, 1, (int)BK, n_dblk, (size_t)L * N);
  add(dA_p, dA, batch, K, n_chunk, (size_t)dim * N);
  add(dD_p, dD, batch, K, n_chunk, dim);
  add(dbias_p, dbias, batch, K, n_chunk, dim);
  add(dW_p, R > 0 ? dW : nullptr, batch, K, n_chunk, (size_t)dim * R);
  args.n_seg = n_seg;
  args.total = total;
  scan_bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(args);
  return (int)cudaGetLastError();
}
