// Selective-scan backward for Hopper (sm_90a), fp32 or bf16 I/O (u, dt, W, B,
// C, dy and du, d(dt), dW, dB, dC; A, D, the bias, the saved states, dA, dD,
// dbias and every partial fp32; the math fp32 either way: the sums are
// taken in fp32 and a bf16 gradient is rounded once, where it is stored).
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
//  * The bf16 variant's main pass is a kernel of its own,
//    selective_scan_bwd_bf16_kernel (below, with its design): the low-rank
//    products (delta's expansion, d(dt), dW) on the tensor cores, the MUFU
//    softplus, and the sums over d taken first within each warp, so that a
//    tile of 8 steps takes 2 block barriers instead of 5. Its local pass
//    shares the fp32 one's code but for the expansion and the softplus. The
//    fp32 instances are unchanged, and give the same bits.
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
// The ring's stages hold IO tiles (each a multiple of 16 bytes) and, in the
// main pass, the fp32 saved states after them.
template <class IO>
__host__ __device__ inline int dt_elems(int R, int T) {
  return R > 0 ? round_vec<IO>(T * R) : T * kDB;
}
template <class IO>
__host__ __device__ inline int stage_elems(int N, int R, int T) {  // IO elements before h0
  return 2 * T * kDB + dt_elems<IO>(R, T) + 2 * round_vec<IO>(T * N);
}
template <class IO>
__host__ __device__ inline int stage_bytes(int N, int R, int T) {
  return (int)sizeof(IO) * stage_elems<IO>(N, R, T) + (int)sizeof(float) * kDB * kMaxN;
}
template <class IO>
__host__ __device__ inline size_t smem_bytes(int N, int R, int T) {
  return sizeof(float) * (2 * (size_t)w_floats(R) + kDB + 2 * (size_t)T * kDB +
                          (size_t)(T + 1) * kHS) +
         2 * (size_t)stage_bytes<IO>(N, R, T);
}
template <class IO>
__host__ __device__ inline int local_stage_elems(int N, int R) {
  return kTileL * kDB + dt_elems<IO>(R, kTileL) + round_vec<IO>(kTileL * N);
}
// floats before the bias: fp32 W [r][kDB + 1]; bf16 W [kDB][w16_ld(R)] as bf16
template <class IO>
__host__ __device__ inline int w_region_floats(int R) {
  if constexpr (std::is_same<IO, fm_io::bf16>::value) return R > 0 ? kDB * w16_ld(R) / 2 : 0;
  return w_floats(R);
}
template <class IO>
__host__ __device__ inline size_t local_smem_bytes(int N, int R) {
  return sizeof(float) * ((size_t)w_region_floats<IO>(R) + kDB + kTileL * kDB) +
         sizeof(IO) * 2 * (size_t)local_stage_elems<IO>(N, R);
}

// The adjoint of chunks 1 .. n_chunk-1 from a zero start: what each hands to
// the chunk before it (e g at its first step) goes to `carry`, its sum of
// delta to `sdel`.
template <class IO, bool FULL>
__device__ __forceinline__ void bwd_local_pass(const IO* __restrict__ dt, const IO* __restrict__ W,
                                               const float* __restrict__ A,
                                               const IO* __restrict__ Cm,
                                               const float* __restrict__ bias,
                                               const IO* __restrict__ dy,
                                               float* __restrict__ carry,
                                               float* __restrict__ sdel, int K, int L, int dim,
                                               int N, int R, int softplus, int chunk_len,
                                               int n_chunk) {
  constexpr bool kBf16 = std::is_same<IO, fm_io::bf16>::value;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* bias_s = w_s + w_region_floats<IO>(R);
  float* del_s = bias_s + kDB;
  IO* ring = reinterpret_cast<IO*>(del_s + kTileL * kDB);
  const int stage_sz = local_stage_elems<IO>(N, R);
  const int dt_sz = dt_elems<IO>(R, kTileL);

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
    for (int i = tid; i < 2 * stage_sz; i += kThreads) ring[i] = from_f<IO>(0.f);
  }
  if constexpr (kBf16) {
    if (R > 0) load_w16<kDB>(W, reinterpret_cast<IO*>(w_s), k, d0, dim, R, tid, kThreads);
    load_bias<kDB>(bias, bias_s, k, d0, dim, tid, kThreads);
  } else {
    load_w_bias<kDB>(W, bias, w_s, bias_s, k, d0, dim, R, tid, kThreads);
  }
  float a2[kPer], gc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = g * kPer + j;
    a2[j] = n < N ? kLog2e * A[((size_t)k * dim + dc) * N + n] : 0.f;  // for exp2_approx
    gc[j] = 0.f;
  }
  float sum_delta = 0.f;

  auto prefetch = [&](int i) {  // the i-th tile from the chunk's end
    IO* dy_s = ring + (i & 1) * stage_sz;
    IO* dt_s = dy_s + kTileL * kDB;
    IO* c_s = dt_s + dt_sz;
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
    const IO* dy_s = ring + (i & 1) * stage_sz;
    const IO* dt_s = dy_s + kTileL * kDB;
    const IO* c_s = dt_s + dt_sz;
    const int l0 = l_begin + (n_tiles - 1 - i) * kTileL, Tc = min(kTileL, l_end - l0);
    if constexpr (kBf16) {
      if (R > 0) {  // on the tensor cores; a warp reads its own channels' delta
        const int lane = tid & 31, c0 = tid / 32 * 8;
        float x[4];
        delta_products<kTileL>(dt_s, R, reinterpret_cast<const IO*>(w_s), c0, lane, x);
        const int t = lane >> 2, cl = c0 + 2 * (lane & 3);
        const float b0 = bias_s[cl], b1 = bias_s[cl + 1];
        *reinterpret_cast<float2*>(del_s + t * kDB + cl) =
            make_float2(softplus_mufu(x[0] + b0, softplus), softplus_mufu(x[1] + b1, softplus));
        *reinterpret_cast<float2*>(del_s + (t + 8) * kDB + cl) =
            make_float2(softplus_mufu(x[2] + b0, softplus), softplus_mufu(x[3] + b1, softplus));
        __syncwarp();
      } else {
        delta_phase<kDB>(dt_s, w_s, bias_s, del_s, nullptr, Tc, R, softplus, tid, kThreads);
        __syncthreads();
      }
    } else {
      delta_phase<kDB>(dt_s, w_s, bias_s, del_s, nullptr, Tc, R, softplus, tid, kThreads);
      __syncthreads();
    }
#pragma unroll 4
    for (int t = Tc - 1; t >= 0; --t) {
      const float delta = del_s[t * kDB + dl];
      const float dyv = to_f(dy_s[t * kDB + dl]);
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

template <class IO, bool FULL>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_local_kernel(const IO* __restrict__ dt, const IO* __restrict__ W,
                                const float* __restrict__ A, const IO* __restrict__ Cm,
                                const float* __restrict__ bias, const IO* __restrict__ dy,
                                float* __restrict__ carry, float* __restrict__ sdel, int K, int L,
                                int dim, int N, int R, int softplus, int chunk_len,
                                int n_chunk) {
  bwd_local_pass<IO, FULL>(dt, W, A, Cm, bias, dy, carry, sdel, K, L, dim, N, R, softplus,
                           chunk_len, n_chunk);
}
// The bf16 variant's local pass (16 states a channel, as its main pass), at 3
// blocks an SM: with that target ptxas fits it in 80 registers, where on its
// own it took 64 and spilled.
__global__ void __launch_bounds__(kThreads, 3)
selective_scan_bwd_local_bf16_kernel(const fm_io::bf16* __restrict__ dt,
                                     const fm_io::bf16* __restrict__ W,
                                     const float* __restrict__ A,
                                     const fm_io::bf16* __restrict__ Cm,
                                     const float* __restrict__ bias,
                                     const fm_io::bf16* __restrict__ dy, float* __restrict__ carry,
                                     float* __restrict__ sdel, int K, int L, int dim, int N,
                                     int R, int softplus, int chunk_len, int n_chunk) {
  bwd_local_pass<fm_io::bf16, true>(dt, W, A, Cm, bias, dy, carry, sdel, K, L, dim, N, R,
                                    softplus, chunk_len, n_chunk);
}

template <class IO, bool FULL>
__global__ void __launch_bounds__(kThreads, 3)
selective_scan_bwd_kernel(const IO* __restrict__ u, const IO* __restrict__ dt,
                          const IO* __restrict__ W, const float* __restrict__ A,
                          const IO* __restrict__ Bm, const IO* __restrict__ Cm,
                          const float* __restrict__ Dp, const float* __restrict__ bias,
                          const float* __restrict__ hsave, const float* __restrict__ carry,
                          const IO* __restrict__ dy, IO* __restrict__ du,
                          float* __restrict__ ddt_p, IO* __restrict__ ddt_full,
                          float* __restrict__ dW_p,
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
  char* ring = reinterpret_cast<char*>(h_s + (T + 1) * kHS);  // 2 stages of u, dy, dt, B, C,
                                                               // then the saved states
  const int stage_sz = stage_bytes<IO>(N, R, T);
  const int dt_sz = dt_elems<IO>(R, T), bc_sz = round_vec<IO>(T * N);

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
    for (int i = tid; i < 2 * stage_sz / 4; i += kThreads) reinterpret_cast<float*>(ring)[i] = 0.f;
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
    IO* u_s = reinterpret_cast<IO*>(ring + (i & 1) * stage_sz);
    IO* dy_s = u_s + T * kDB;
    IO* dt_s = dy_s + T * kDB;
    IO* b_s = dt_s + dt_sz;
    IO* c_s = b_s + bc_sz;
    float* h0_s = reinterpret_cast<float*>(c_s + bc_sz);
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
    IO* u_s = reinterpret_cast<IO*>(ring + (i & 1) * stage_sz);  // u, then du
    const IO* dy_s = u_s + T * kDB;
    const IO* dt_s = dy_s + T * kDB;
    const IO* b_s = dt_s + dt_sz;
    const IO* c_s = b_s + bc_sz;
    const float* h0_s = reinterpret_cast<const float*>(c_s + bc_sz);
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
        const float dbu = delta * to_f(u_s[t * kDB + dl]);
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
      const IO* dv = dy_s + t * kDB + half * (kDB / 2);
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < kDB / 2; ++dd) s = fmaf(to_f(dv[dd]), hv[dd * kMaxN], s);
      s += __shfl_xor_sync(0xffffffffu, s, kMaxN);
      if (half == 0 && n < N) dC_p[(((size_t)bk * n_dblk + dblk) * L + l0 + t) * N + n] = s;
    }
    __syncthreads();

    // the adjoint over the tile, last step first
#pragma unroll 2
    for (int t = Tc - 1; t >= 0; --t) {
      const float delta = del_s[t * kDB + dl];
      const float uv = to_f(u_s[t * kDB + dl]);
      const float dyv = to_f(dy_s[t * kDB + dl]);
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
        u_s[t * kDB + dl] = from_f<IO>(fmaf(dskip, dyv, du_acc));
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
        ddt_p[(((size_t)bk * n_dblk + dblk) * L + l0 + t) * R + r] = s;
      }
      for (int j = tid; j < kDB * R; j += kThreads) {
        const int dd = j % kDB, r = j / kDB;
        float s = dw_s[r * (kDB + 1) + dd];
        for (int t = 0; t < Tc; ++t) s = fmaf(dx_s[t * kDB + dd], to_f(dt_s[t * R + r]), s);
        dw_s[r * (kDB + 1) + dd] = s;
      }
    } else {
      store_rows<kDB>(ddt_full + (row0 + l0) * dim + d0, dim, dx_s, Tc, cols, tid, kThreads);
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

// ---------------------------------------------------------------------------
// The bf16 variant's main pass. The same algebra and outputs as
// selective_scan_bwd_kernel, with these changes of design:
//  * delta and the slope of a tile come from the warp's own products on the
//    tensor cores (`delta_products`) and the MUFU softplus; a warp's
//    recompute and adjoint read only its own 8 channels' delta.
//  * The recompute and the adjoint of a thread touch only its own states in
//    the tile of states, so the sums over d of dC and dB are taken in two
//    steps: each warp sums its own 8 channels (lanes over (t, n), four
//    independent sums a lane), right after the recompute for dC and after
//    the adjoint for dB, and leaves its part where its own states lay (dC's
//    in slot T, which the adjoint does not read, dB's in slot 0, once summed);
//    after one block barrier, a thread a (kind, t, n) joins the 8 warp parts
//    in a fixed order. So a warp never waits for another within a tile but
//    at that barrier and the tile's arrival: 2 block barriers a tile of 8
//    steps, where the fp32 variant takes 5.
//  * dW += dx^T dt runs on the tensor cores within each warp (its 8
//    channels, k = the tile's 8 steps padded to 16 with zeros) into fp32
//    accumulators that each lane keeps in shared memory; d(dt) = dx W over the
//    block's 64 channels on the tensor cores of warp j < ceil(R / 8) (the r
//    columns 8j .. 8j+7), after the barrier. dx is fp32, so each product
//    takes it in two bf16 terms, hi = bf16(dx) and lo = bf16(dx - hi), into
//    one fp32 sum: with W and dt exactly bf16 that keeps about 16 bits of
//    dx (a relative error near 2^-17 a product). The TPU kernel's single
//    bf16 pass rounds dx once (scan_pallas.py `bprec`); the port's plain
//    version does not round it, and neither do the kernel's sums here.
// The tile is the forward's save interval, 8 steps (kT8), and a channel has
// 16 states: the entry point rejects any other T or N for bf16, and the
// wrapper pads a smaller state to 16 (A, B, C and the saved states with
// zeros, which keep the states past N at zero).
constexpr int kT8 = 8;
constexpr int kWarps = kThreads / 32;        // 8
constexpr int kWtLd = kDB + 8;               // row stride of the [r][d] bf16 W tile
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int m_tiles(int R) { return (R + 15) / 16; }
// the byte sizes of the bf16 main pass's shared-memory regions, in order
struct Bf16Layout {
  int w16, wt, dw, bias, del, dx, h, stage;
  __host__ __device__ explicit Bf16Layout(int R)
      : w16(R > 0 ? 2 * kDB * w16_ld(R) : 0),
        wt(2 * round8(R) * kWtLd),
        dw(16 * m_tiles(R) * kThreads),
        bias(4 * kDB),
        del(4 * kT8 * kDB),
        dx(4 * kT8 * kDB),
        h(4 * (kT8 + 1) * kHS),
        stage(stage_bytes<fm_io::bf16>(kMaxN, R, kT8)) {}
  __host__ __device__ size_t total() const {
    return (size_t)w16 + wt + dw + bias + del + dx + h + 2 * (size_t)stage;
  }
};

// Two blocks an SM (128 registers a thread): at three (80 registers) ptxas
// spilled 12 to 44 bytes in every arrangement of this pass that was tried.
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_bf16_kernel(const fm_io::bf16* __restrict__ u, const fm_io::bf16* __restrict__ dt,
                               const fm_io::bf16* __restrict__ W, const float* __restrict__ A,
                               const fm_io::bf16* __restrict__ Bm,
                               const fm_io::bf16* __restrict__ Cm, const float* __restrict__ Dp,
                               const float* __restrict__ bias, const float* __restrict__ hsave,
                               const float* __restrict__ carry,
                               const fm_io::bf16* __restrict__ dy, fm_io::bf16* __restrict__ du,
                               float* __restrict__ ddt_p, fm_io::bf16* __restrict__ ddt_full,
                               float* __restrict__ dW_p, float* __restrict__ dA_p,
                               float* __restrict__ dB_p, float* __restrict__ dC_p,
                               float* __restrict__ dD_p, float* __restrict__ dbias_p, int K,
                               int L, int dim, int N, int R, int softplus, int chunk_len,
                               int n_chunk) {
  using IO = fm_io::bf16;
  constexpr int T = kT8;
  extern __shared__ __align__(16) float smem[];
  const Bf16Layout lay(R);
  char* p = reinterpret_cast<char*>(smem);
  IO* w16_s = reinterpret_cast<IO*>(p);         // [kDB][w16_ld(R)]: delta's products
  IO* wt_s = reinterpret_cast<IO*>(p += lay.w16);  // [round8(R)][kWtLd]: d(dt)'s
  float* dw_s = reinterpret_cast<float*>(p += lay.wt);  // [m tile][thread][4]: dW's sums
  float* bias_s = reinterpret_cast<float*>(p += lay.dw);  // [kDB]
  float* del_s = reinterpret_cast<float*>(p += lay.bias);  // [T][kDB] delta
  float* dx_s = reinterpret_cast<float*>(p += lay.del);  // [T][kDB] the slope, then dx
  float* h_s = reinterpret_cast<float*>(p += lay.dx);  // [T + 1][kHS]: states, then dB's terms
  // 2 stages of u, dy, B, C (T x 16 each, room for N = 16), the saved states
  // and dt: all but dt at fixed offsets from the stage, so that ptxas
  // addresses them from one register a tile
  char* ring = p + lay.h;
  const int stage_sz = lay.stage;

  const int tid = threadIdx.x, dl = tid / kGroups, g = tid % kGroups;
  const int lane = tid & 31, warp = tid >> 5, c0 = warp * 8;  // the warp's channels
  const int fg = lane >> 2, fq = lane & 3;                      // its mma fragment's row, pair
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
    for (int i = tid; i < 2 * stage_sz / 4; i += kThreads) reinterpret_cast<float*>(ring)[i] = 0.f;
  }
  if (R > 0) {
    load_w16<kDB>(W, w16_s, k, d0, dim, R, tid, kThreads);
    for (int i = tid; i < round8(R) * kDB; i += kThreads) {
      const int r = i / kDB, j = i - r * kDB;
      wt_s[r * kWtLd + j] = (r < R && d0 + j < dim) ? W[((size_t)k * dim + d0 + j) * R + r]
                                                    : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < 4 * m_tiles(R) * kThreads; i += kThreads) dw_s[i] = 0.f;
  }
  load_bias<kDB>(bias, bias_s, k, d0, dim, tid, kThreads);

  // exp(delta A) is taken as 2^((delta log2 e) A): no second copy of A
  // scaled by log2 e, which 4 more registers a thread would hold
  float a[kPer], gc[kPer], dA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = g * kPer + j;
    a[j] = n < N ? A[((size_t)k * dim + dc) * N + n] : 0.f;
    gc[j] = 0.f;
    dA[j] = 0.f;
  }
  // Lanes past `dim` keep g = 0: with their dy reading as 0 everything they
  // write into the staged tiles (du, dx, the terms of dB) is 0, which the
  // sums over the block's 64 columns rely on.
  if (carry && active) {
    load_states<true>(carry + ((size_t)bk * n_chunk + c) * dim * N, d, N, g, gc);
  }
  const float dskip = Dp ? Dp[(size_t)k * dim + dc] : 0.f;
  float dD = 0.f, dbias_acc = 0.f;

  auto prefetch = [&](int i) {  // the i-th tile from the chunk's end
    IO* u_s = reinterpret_cast<IO*>(ring + (i & 1) * stage_sz);
    IO* dy_s = u_s + T * kDB;
    IO* b_s = dy_s + T * kDB;
    IO* c_s = b_s + T * kMaxN;
    float* h0_s = reinterpret_cast<float*>(c_s + T * kMaxN);
    IO* dt_s = reinterpret_cast<IO*>(h0_s + kDB * kMaxN);
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
    IO* u_s = reinterpret_cast<IO*>(ring + (i & 1) * stage_sz);  // u, then du
    const IO* dy_s = u_s + T * kDB;
    const IO* b_s = dy_s + T * kDB;
    const IO* c_s = b_s + T * kMaxN;
    const float* h0_s = reinterpret_cast<const float*>(c_s + T * kMaxN);
    const IO* dt_s = reinterpret_cast<const IO*>(h0_s + kDB * kMaxN);
    const int l0 = l_begin + (n_tiles - 1 - i) * T, Tc = min(T, l_end - l0);
    const size_t prow = ((size_t)bk * n_dblk + dblk) * L + l0;  // the tile's rows of the partials

    // delta and the slope: the warp's channels on the tensor cores, or (R == 0)
    // the whole block's from the full dt
    if (R > 0) {
      float x[4];
      delta_products<kT8>(dt_s, R, w16_s, c0, lane, x);
      const int cl = c0 + 2 * fq;
      float2 del, sl;
      softplus_slope(x[0] + bias_s[cl], softplus, del.x, sl.x);
      softplus_slope(x[1] + bias_s[cl + 1], softplus, del.y, sl.y);
      *reinterpret_cast<float2*>(del_s + fg * kDB + cl) = del;
      *reinterpret_cast<float2*>(dx_s + fg * kDB + cl) = sl;
      __syncwarp();
    } else {
      delta_phase<kDB>(dt_s, nullptr, bias_s, del_s, dx_s, Tc, 0, softplus, tid, kThreads);
      __syncthreads();
    }

    // recompute the tile's states from the saved start state (each thread its own)
    {
      float h[kPer];
      load_group<true>(h0_s + dl * N, N, g, h);
      float* hp = h_s + tid * kPer;
      *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll 4
      for (int t = 0; t < Tc; ++t) {
        const float delta = del_s[t * kDB + dl];
        const float dbu = delta * to_f(u_s[t * kDB + dl]);
        float bv[kPer];
        load_group<true>(b_s + t * kMaxN, N, g, bv);
        const float dl2 = delta * kLog2e;
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = fmaf(exp2_approx(dl2 * a[j]), h[j], dbu * bv[j]);
        hp += kHS;
        *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    __syncwarp();
    // dC's warp part: sum over the warp's 8 channels of dy * h_l, lanes over
    // (t, n), four t's a lane, each sum in two halves joined in order; the
    // part [t][n] goes where the warp's states of slot T lay
    float* const part_c = h_s + T * kHS + c0 * kMaxN;
    float* const part_b = h_s + c0 * kMaxN;
    {
      const int n = lane & 15;
      float sum[T / 2];
#pragma unroll
      for (int jt = 0; jt < T / 2; ++jt) {
        const int t = 2 * jt + (lane >> 4);
        const uint4 dq = *reinterpret_cast<const uint4*>(dy_s + t * kDB + c0);
        const float dv[8] = {__uint_as_float(dq.x << 16), __uint_as_float(dq.x & 0xffff0000u),
                             __uint_as_float(dq.y << 16), __uint_as_float(dq.y & 0xffff0000u),
                             __uint_as_float(dq.z << 16), __uint_as_float(dq.z & 0xffff0000u),
                             __uint_as_float(dq.w << 16), __uint_as_float(dq.w & 0xffff0000u)};
        const float* hv = h_s + (t + 1) * kHS + c0 * kMaxN + n;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s0 = fmaf(dv[cc], hv[cc * kMaxN], s0);
          s1 = fmaf(dv[cc + 4], hv[(cc + 4) * kMaxN], s1);
        }
        sum[jt] = s0 + s1;
      }
      __syncwarp();  // slot T read
#pragma unroll
      for (int jt = 0; jt < T / 2; ++jt) part_c[(2 * jt + (lane >> 4)) * kMaxN + n] = sum[jt];
    }
    __syncwarp();  // the warp's reads of its states come before the adjoint's overwrites

    // the adjoint over the tile, last step first
#pragma unroll 2
    for (int t = Tc - 1; t >= 0; --t) {
      const float delta = del_s[t * kDB + dl];
      const float uv = to_f(u_s[t * kDB + dl]);
      const float dyv = to_f(dy_s[t * kDB + dl]);
      float bv[kPer], cv[kPer], term[kPer];
      load_group<true>(b_s + t * kMaxN, N, g, bv);
      load_group<true>(c_s + t * kMaxN, N, g, cv);
      float* hp = h_s + t * kHS + tid * kPer;
      const float4 hq = *reinterpret_cast<const float4*>(hp);
      const float hprev[kPer] = {hq.x, hq.y, hq.z, hq.w};
      const float dl2 = delta * kLog2e;
      float ddelta = 0.f, du_acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float gv = fmaf(cv[j], dyv, gc[j]);
        const float e = exp2_approx(dl2 * a[j]);
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
        u_s[t * kDB + dl] = from_f<IO>(fmaf(dskip, dyv, du_acc));
        dbias_acc += dx;
        dD = fmaf(dyv, uv, dD);
      }
    }
    __syncwarp();
    // dB's warp part, as dC's, over the terms g delta u the adjoint left; the
    // part goes where the warp's terms of slot 0 lay
    {
      const int n = lane & 15;
      float sum[T / 2];
#pragma unroll
      for (int jt = 0; jt < T / 2; ++jt) {
        const int t = 2 * jt + (lane >> 4);
        const float* tv = h_s + t * kHS + c0 * kMaxN + n;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s0 += tv[cc * kMaxN];
          s1 += tv[(cc + 4) * kMaxN];
        }
        sum[jt] = s0 + s1;
      }
      __syncwarp();  // slot 0 read
#pragma unroll
      for (int jt = 0; jt < T / 2; ++jt) part_b[(2 * jt + (lane >> 4)) * kMaxN + n] = sum[jt];
    }
    // dW^T[r][d] += sum_t dt[t][r] dx[t][d] over the warp's channels: k = t
    // (the tile's 8 steps; zeros past Tc and in k 8..15), rows r in tiles of
    // 16, dx in its hi and lo terms
    if (R > 0) {
      const int t0 = 2 * fq;
      const float x0 = t0 < Tc ? dx_s[t0 * kDB + c0 + fg] : 0.f;
      const float x1 = t0 + 1 < Tc ? dx_s[(t0 + 1) * kDB + c0 + fg] : 0.f;
      uint32_t bhi, blo;
      split2(x0, x1, bhi, blo);
      const IO zero = __float2bfloat16_rn(0.f);
      for (int m = 0; m < m_tiles(R); ++m) {
        const int r = 16 * m + fg;
        auto dtv = [&](int t, int rr) { return t < Tc && rr < R ? dt_s[t * R + rr] : zero; };
        const uint32_t a0 = pack2(dtv(t0, r), dtv(t0 + 1, r));
        const uint32_t a1 = pack2(dtv(t0, r + 8), dtv(t0 + 1, r + 8));
        float4* acc = reinterpret_cast<float4*>(dw_s) + m * kThreads + tid;
        const float4 v = *acc;
        float cacc[4] = {v.x, v.y, v.z, v.w};
        mma_bf16(cacc, a0, a1, 0u, 0u, bhi, 0u);
        mma_bf16(cacc, a0, a1, 0u, 0u, blo, 0u);
        *acc = make_float4(cacc[0], cacc[1], cacc[2], cacc[3]);
      }
    }
    __syncthreads();  // every warp's parts, dx and du are in

    // the tile's sums over d: the 8 warp parts of each (kind, t, n) in order
    {
      const int kind = tid >> 7, t = (tid >> 4) & (T - 1), n = tid & 15;  // kind 1: dB
      const float* ps = h_s + (kind ? 0 : T * kHS) + t * kMaxN + n;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps / 2; ++w) {
        s0 += ps[w * 8 * kMaxN];
        s1 += ps[(w + kWarps / 2) * 8 * kMaxN];
      }
      if (t < Tc && n < N) (kind ? dB_p : dC_p)[(prow + t) * N + n] = s0 + s1;
    }
    store_rows<kDB>(du + (row0 + l0) * dim + d0, dim, u_s, Tc, cols, tid, kThreads);
    if (R > 0) {
      // d(dt)[t][r] = sum over the block's 64 channels of dx[t][d] W[d][r]:
      // warp j takes the column groups 8j, 8j + 64, ... (8 columns each)
      // below R, rows t = the tile's 8 steps
      for (int cg = c0; cg < R; cg += 8 * kWarps) {
        float cacc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xrow = dx_s + fg * kDB + 2 * fq;
        const IO* wrow = wt_s + (cg + fg) * kWtLd + 2 * fq;
#pragma unroll
        for (int k0 = 0; k0 < kDB; k0 += 16) {
          const float2 v0 = *reinterpret_cast<const float2*>(xrow + k0);
          const float2 v1 = *reinterpret_cast<const float2*>(xrow + k0 + 8);
          uint32_t h0, lo0, h1, lo1;
          split2(v0.x, v0.y, h0, lo0);
          split2(v1.x, v1.y, h1, lo1);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wrow + k0);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wrow + k0 + 8);
          mma_bf16(cacc, h0, 0u, h1, 0u, b0, b1);
          mma_bf16(cacc, lo0, 0u, lo1, 0u, b0, b1);
        }
        const int r = cg + 2 * fq;
        if (fg < Tc) {
          if (r < R) ddt_p[(prow + fg) * R + r] = cacc[0];
          if (r + 1 < R) ddt_p[(prow + fg) * R + r + 1] = cacc[1];
        }
      }
    } else {
      store_rows<kDB>(ddt_full + (row0 + l0) * dim + d0, dim, dx_s, Tc, cols, tid, kThreads);
    }
  }

  // this chunk's per-channel partials
  const size_t at = ((size_t)bk * n_chunk + c) * dim;
  if (active) {
    store_states<true>(dA_p + at * N, d, N, g, dA);
    if (g == 0) {
      if (dD_p) dD_p[at + d] = dD;
      if (dbias_p) dbias_p[at + d] = dbias_acc;
    }
  }
  // each lane's dW fragments: (r, d) = (16m + fg (+8), c0 + 2fq (+1))
  if (R > 0) {
    for (int m = 0; m < m_tiles(R); ++m) {
      const float4 v = reinterpret_cast<const float4*>(dw_s)[m * kThreads + tid];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * m + fg + 8 * (j >> 1), ch = c0 + 2 * fq + (j & 1);
        if (r < R && ch < cols) dW_p[(at + d0 + ch) * R + r] = vals[j];
      }
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
  void* dst;      // bf16 when `bf16`, else fp32
  int Q, O, P, inner, begin, bf16;
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
  if (seg.bf16) {
    static_cast<fm_io::bf16*>(seg.dst)[j] = from_f<fm_io::bf16>(acc);
  } else {
    static_cast<float*>(seg.dst)[j] = acc;
  }
}

inline size_t round4s(size_t x) { return (x + 3) & ~(size_t)3; }

template <class IO>
int scan_bwd(const IO* u, const IO* dt, const IO* W, const float* A, const IO* Bm, const IO* Cm,
             const float* Dp, const float* bias, const float* hsave, const IO* dy, IO* du,
             IO* ddt, IO* dW, float* dA, IO* dB, IO* dC, float* dD, float* dbias, float* scratch,
             int batch, int K, int L, int dim, int N, int R, int T, int softplus, int chunk_len,
             cudaStream_t stream) {
  if (N < 1 || N > kMaxN || R < 0 || dim < 1 || L < 1 || T < 1 || batch * K < 1 ||
      kTileL % T != 0 || chunk_len < kTileL || chunk_len % kTileL != 0 || !scratch) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr bool kBf16 = std::is_same<IO, fm_io::bf16>::value;
  if (kBf16 && (T != kT8 || N != kMaxN)) return (int)cudaErrorInvalidValue;
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
    const size_t smem = local_smem_bytes<IO>(N, R);
    void (*kernel)(const IO*, const IO*, const float*, const IO*, const float*, const IO*, float*,
                   float*, int, int, int, int, int, int, int, int);
    if constexpr (kBf16) {
      kernel = selective_scan_bwd_local_bf16_kernel;
    } else {
      kernel = full ? selective_scan_bwd_local_kernel<IO, true>
                    : selective_scan_bwd_local_kernel<IO, false>;
    }
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
  const dim3 grid(n_dblk, n_chunk, batch * K);
  if constexpr (kBf16) {
    const size_t smem = Bf16Layout(R).total();
    auto kernel = selective_scan_bwd_bf16_kernel;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        u, dt, W, A, Bm, Cm, Dp, bias, hsave, n_chunk > 1 ? carry : nullptr, dy, du, ddt_p,
        R > 0 ? nullptr : ddt, dW_p, dA_p, dB_p, dC_p, dD ? dD_p : nullptr,
        dbias ? dbias_p : nullptr, K, L, dim, N, R, softplus, chunk_len, n_chunk);
  } else {
    const size_t smem = smem_bytes<IO>(N, R, T);
    auto kernel = full ? selective_scan_bwd_kernel<IO, true> : selective_scan_bwd_kernel<IO, false>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        u, dt, W, A, Bm, Cm, Dp, bias, hsave, n_chunk > 1 ? carry : nullptr, dy, du, ddt_p,
        R > 0 ? nullptr : ddt, dW_p, dA_p, dB_p, dC_p, dD ? dD_p : nullptr,
        dbias ? dbias_p : nullptr, K, L, dim, N, R, T, softplus, chunk_len, n_chunk);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ReduceArgs args;
  int n_seg = 0, total = 0;
  // the IO gradients (d(dt), dB, dC, dW) are rounded to IO as they are stored
  constexpr int io_bf16 = sizeof(IO) == sizeof(fm_io::bf16);
  auto add = [&](const float* src, void* dst, int Q, int O, int P, size_t inner, int bf16) {
    if (!dst || inner == 0) return;
    args.seg[n_seg++] = ReduceSeg{src, dst, Q, O, P, (int)inner, total, bf16};
    total += O * (int)inner;
  };
  add(ddt_p, R > 0 ? ddt : nullptr, 1, (int)BK, n_dblk, (size_t)L * R, io_bf16);
  add(dB_p, dB, 1, (int)BK, n_dblk, (size_t)L * N, io_bf16);
  add(dC_p, dC, 1, (int)BK, n_dblk, (size_t)L * N, io_bf16);
  add(dA_p, dA, batch, K, n_chunk, (size_t)dim * N, 0);
  add(dD_p, dD, batch, K, n_chunk, dim, 0);
  add(dbias_p, dbias, batch, K, n_chunk, dim, 0);
  add(dW_p, R > 0 ? dW : nullptr, batch, K, n_chunk, (size_t)dim * R, io_bf16);
  args.n_seg = n_seg;
  args.total = total;
  scan_bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// hsave (B*K, ceil(L/T), D, N) from the forward. The gradients come out in
// their inputs' shapes: du (B,K,L,D); ddt (B,K,L,R), or (B,K,L,D) when R == 0;
// dW (K,D,R); dA (K,D,N); dB, dC (B,K,L,N); dD, dbias (K,D) or null. `scratch`
// holds the partials and the carries, each segment rounded up to 4 floats,
// with n_chunk = ceil(L/chunk_len), n_dblk = ceil(D/64), BK = B*K: ddt's
// BK*n_dblk*L*R, dB's and dC's BK*n_dblk*L*N each, dA's BK*n_chunk*D*N, dD's
// and dbias' BK*n_chunk*D each, dW's BK*n_chunk*D*R, the carries BK*n_chunk*D*N
// and the chunks' sums of delta BK*n_chunk*D. chunk_len is a multiple of 16
// and T divides 16. The _bf16 entry takes u,
// dt, W, B, C, dy, du, ddt, dW, dB and dC as bf16.
extern "C" int fm_selective_scan_bwd(const float* u, const float* dt, const float* W,
                                     const float* A, const float* Bm, const float* Cm,
                                     const float* Dp, const float* bias, const float* hsave,
                                     const float* dy, float* du, float* ddt, float* dW, float* dA,
                                     float* dB, float* dC, float* dD, float* dbias, float* scratch,
                                     int batch, int K, int L, int dim, int N, int R, int T,
                                     int softplus, int chunk_len, cudaStream_t stream) {
  return scan_bwd(u, dt, W, A, Bm, Cm, Dp, bias, hsave, dy, du, ddt, dW, dA, dB, dC, dD, dbias,
                  scratch, batch, K, L, dim, N, R, T, softplus, chunk_len, stream);
}
extern "C" int fm_selective_scan_bwd_bf16(
    const fm_io::bf16* u, const fm_io::bf16* dt, const fm_io::bf16* W, const float* A,
    const fm_io::bf16* Bm, const fm_io::bf16* Cm, const float* Dp, const float* bias,
    const float* hsave, const fm_io::bf16* dy, fm_io::bf16* du, fm_io::bf16* ddt,
    fm_io::bf16* dW, float* dA, fm_io::bf16* dB, fm_io::bf16* dC, float* dD, float* dbias,
    float* scratch, int batch, int K, int L, int dim, int N, int R, int T, int softplus,
    int chunk_len, cudaStream_t stream) {
  return scan_bwd(u, dt, W, A, Bm, Cm, Dp, bias, hsave, dy, du, ddt, dW, dA, dB, dC, dD, dbias,
                  scratch, batch, K, L, dim, N, R, T, softplus, chunk_len, stream);
}
