// Fused two-layer MLP forward for Hopper (sm_90a), fp32 or bf16 in and out:
//   y = gelu(x @ W1^T + b1) @ W2^T + b2, gelu exact (erf).
//
// Replaces fusionmamba_tpu/ops/mlp_pallas.py::_fwd_kernel (built by
// _fwd_pallas). Weights are in torch's nn.Linear layout: W1 (H, C), W2 (C_out, H).
//
// What bounds it: operations, 4*C*H flops per row against 8*C bytes of x
// and y in fp32, 4*C bytes in bf16. Each I/O type has its own kernels.
//
// fp32: the products run on the tensor cores as three TF32 products each
// (mma_tf32x3.cuh: fp32-class accuracy at 165 TFLOP/s of fp32 work). Two
// designs, chosen by the wrapper (ops/mlp.py) from the output width:
//  - fused (narrow outputs, the shallow stages): one block per 64 rows and
//    up to 96 output columns walks the hidden layer in chunks of 128 units
//    (wider outputs take several column tiles, each recomputing fc1).
//    fc1 of a chunk goes through the tile engine; bias and GELU run on its
//    accumulators in registers and the chunk is written once to shared
//    memory, where it is fc2's A operand; fc2's sums for the block's rows x
//    outputs stay in registers across chunks. The hidden layer never
//    reaches device memory, as in the TPU kernel. x, W1 and W2 slices stream
//    through one cp.async ring in a single sequence of slices (fc1 slices of
//    a chunk, then its fc2 slices), so the copies of the next chunk overlap
//    the products of this one.
//  - two passes (wider outputs): fc1 with a bias+GELU epilogue into an
//    (M, H) scratch, which stays in L2 at the deep stages, then fc2 with a
//    bias epilogue, each in 128x128 tiles through the warpgroup (wgmma)
//    engine of mma_tf32x3.cuh. Where fc2's output tiles alone cannot fill
//    the card (the deep stages, M only hundreds of rows), its depth H is
//    cut into slices (chosen by ops/mlp.py) whose partials a third launch
//    sums in a fixed order, adding the bias.
//
// bf16 (x, W1, b1, W2, b2 and y bf16): Hopper's bf16 wgmma on operands that
// TMA copies into shared memory (wgmma_bf16.cuh), every product bf16 x bf16
// with fp32 sums; h and its GELU are fp32 and the hidden a = gelu(h) is
// rounded to bf16 before fc2, as the TPU kernel rounds it. Two designs, as
// ops/mlp.py's plan chooses:
//  - fused (C and C_out up to 192): one block per 128 rows, two consumer
//    warpgroups of 64 rows and a producer warp. The block's x rows are
//    copied once and stay in shared memory; the hidden layer is walked in
//    chunks of 64 units, each chunk's W1 rows and W2 columns one stage of a
//    TMA ring. h_j = x W1_j^T goes through wgmma into registers, b1 and the
//    GELU are applied there, and a_j, rounded to bf16, is fc2's A operand
//    straight from the registers (the accumulator's layout is the A
//    fragment's): acc2 += a_j W2_j^T, fc2's sums for the block's rows x
//    outputs held in registers across chunks. The hidden layer never leaves
//    the SM.
//  - two passes: fc1 with a bias+GELU epilogue into a bf16 (M, H) scratch,
//    then fc2 with a bias epilogue, each through the engine's 128 x 64
//    product kernel; fc2's depth H cut into slices where its
//    tiles give fewer than half the SMs a block, their fp32 partials summed
//    in a fixed order by a reduce launch that adds the bias.
// The GELU is erff; the TPU kernel's polynomial erf was a compiler workaround.
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace fm;

constexpr int kFRows = 64;  // rows per block of the fused kernel
constexpr int kHC = 128;    // hidden units per chunk

// the hidden chunk in shared memory, fc2's A operand: [row][kHC], its
// 16-byte chunks swizzled as Staged's (a pointer offset by a multiple of
// kBK keeps the pattern)
struct Hidden {
  __device__ __forceinline__ static int index(int r, int k) {
    return r * kHC + (((k >> 2) ^ ((r & 3) << 1)) << 2) + (k & 3);
  }
  __device__ __forceinline__ static float2 pair(const float* s, int r, int k) {
    return *reinterpret_cast<const float2*>(s + index(r, k));
  }
};

template <class IO, int kNT2>
struct Fused {
  using W1 = Warps<2, 2, 4>;              // fc1 chunk: 64 rows x kHC hidden units
  using W2 = Warps<2, 2, kNT2>;           // fc2: 64 rows x 32 * kNT2 outputs
  using XT = Staged<kFRows, true, IO>;    // x rows, K = C
  using H1T = Staged<kHC, true, IO>;      // W1 rows (hidden units), K = C
  using O2T = Staged<W2::BN, true, IO>;   // W2 rows (outputs), K = H
  static constexpr int kStage = XT::kFloats + H1T::kFloats > O2T::kFloats
                                    ? XT::kFloats + H1T::kFloats
                                    : O2T::kFloats;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kStages * kStage + (size_t)kFRows * kHC);
  static_assert(W1::BM == kFRows && W1::BN == kHC && W2::BM == kFRows, "tile shapes");
};

template <class IO, int kNT2>
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_fused_kernel(const IO* __restrict__ x, const IO* __restrict__ w1,
                     const IO* __restrict__ b1, const IO* __restrict__ w2,
                     const IO* __restrict__ b2, IO* __restrict__ y, int M, int C, int H,
                     int Cout) {
  using F = Fused<IO, kNT2>;
  using W1 = typename F::W1;
  using W2 = typename F::W2;
  using XT = typename F::XT;
  using H1T = typename F::H1T;
  using O2T = typename F::O2T;
  extern __shared__ __align__(1024) float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* hid = ring + kStages * F::kStage;  // [kFRows][kHC]

  const int m0 = blockIdx.x * kFRows, o0 = blockIdx.y * W2::BN;
  const int n1 = (C + kBK - 1) / kBK;  // fc1 slices per chunk
  constexpr int n2 = kHC / kBK;        // fc2 slices per chunk
  const int per = n1 + n2;
  const int total = (int)cdiv(H, kHC) * per;

  auto issue = [&](int t) {
    if (t < total) {
      float* s = ring + (t % kStages) * F::kStage;
      const int j0 = t / per * kHC, r = t % per;
      if (r < n1) {
        XT::load(s, x, C, m0, M, r * kBK, C);
        H1T::load(s + XT::kFloats, w1, C, j0, H, r * kBK, C);
      } else {
        O2T::load(s, w2, H, o0, Cout, j0 + (r - n1) * kBK, H);
      }
    }
    cp_async_commit();
  };

  typename W1::Acc acc1;
  typename W2::Acc acc2;
  W1::zero(acc1);
  W2::zero(acc2);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    // slice t has landed for all; slot (t - 1) % kStages is consumed; the
    // hidden chunk written at the end of fc1 is visible, or (at a chunk's
    // last fc1 slice) no longer read by the previous chunk's fc2
    __syncthreads();
    issue(t + kStages - 1);
    const float* s = ring + (t % kStages) * F::kStage;
    const int j0 = t / per * kHC, r = t % per;
    if (r < n1) {
      mma_slice<W1::MT, W1::NT, XT, H1T>(acc1, s, s + XT::kFloats, W1::wm0(), W1::wn0());
      if (r == n1 - 1) {
        // bias and exact GELU on the accumulators, rounded to IO (fc2's A
        // operand is the hidden in the I/O type); H % 4 == 0, so columns
        // j and j + 1 are both inside H or both outside
        W1::for_each_pair(0, 0, [&](int i, int j, int h, int m, int n) {
          float2 v = make_float2(0.f, 0.f);
          if (j0 + n < H) {
            v.x = fm_io::round_to<IO>(gelu_exact(acc1[i][j][2 * h] + to_f(b1[j0 + n])));
            v.y = fm_io::round_to<IO>(gelu_exact(acc1[i][j][2 * h + 1] + to_f(b1[j0 + n + 1])));
          }
          *reinterpret_cast<float2*>(hid + Hidden::index(m, n)) = v;
        });
        W1::zero(acc1);
      }
    } else {
      mma_slice<W2::MT, W2::NT, Hidden, O2T>(acc2, hid + (r - n1) * kBK, s, W2::wm0(),
                                             W2::wn0());
    }
  }
  cp_async_wait<0>();
  W2::for_each_pair(m0, o0, [&](int i, int j, int h, int m, int n) {
    if (m < M && n < Cout)
      fm_io::store2(y + (size_t)m * Cout + n, acc2[i][j][2 * h] + to_f(b2[n]),
                    acc2[i][j][2 * h + 1] + to_f(b2[n + 1]));
  });
}

// out (M, N) = act(a (M, K) w (N, K)^T + bias), act GELU or identity,
// through the warpgroup engine in 128x128 tiles, rounded to IO. With
// gridDim.z > 1 the depth is cut into slices of `slice` and block z writes
// the raw fp32 partial product of slice z to part + z M N
// (mlp_fwd_reduce_bias_kernel finishes it).
template <class IO, bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_linear_kernel(const IO* __restrict__ a, const IO* __restrict__ w,
                      const IO* __restrict__ bias, IO* __restrict__ out, float* __restrict__ part,
                      int M, int N, int K, int slice) {
  using G = WgGemm<IO>;
  extern __shared__ __align__(1024) float4 smem4[];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN, z = blockIdx.z;
  const bool partial = gridDim.z > 1;
  float acc[G::kAcc];
  G::zero(acc);
  G::run(acc, a, K, M, w, K, N, m0, n0, z * slice, min(K, (z + 1) * slice),
         reinterpret_cast<float*>(smem4));
  float* dst = part + (size_t)z * M * N;
  G::for_each_pair(m0, n0, [&](int i, int m, int n) {
    if (m < M && n < N) {
      float v0 = acc[i], v1 = acc[i + 1];
      if (partial) {
        *reinterpret_cast<float2*>(dst + (size_t)m * N + n) = make_float2(v0, v1);
        return;
      }
      v0 += to_f(bias[n]);
      v1 += to_f(bias[n + 1]);
      if (kGelu) {
        v0 = gelu_exact(v0);
        v1 = gelu_exact(v1);
      }
      fm_io::store2(out + (size_t)m * N + n, v0, v1);
    }
  });
}

// out (M, N) = bias + the sum of `slices` partials (slices, M, N), in order,
// rounded to IO
template <class IO>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_reduce_bias_kernel(const float* __restrict__ part, const IO* __restrict__ bias,
                           IO* __restrict__ out, int MN, int N, int slices) {
  const int i = 4 * (blockIdx.x * kThreads + threadIdx.x);  // N % 4 == 0
  if (i >= MN) return;
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < slices; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + (size_t)s * MN + i);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const float4 b = fm_io::load4(bias + i % N);
  fm_io::store4(out + i, make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w));
}

constexpr size_t kLinearSmem = sizeof(float) * WgGemm<>::kSmemFloats;

// out (the result, IO) or, with several slices, part (fp32 partials)
template <class IO, bool kGelu>
cudaError_t linear(const IO* a, const IO* w, const IO* bias, IO* out, float* part, int M, int N,
                   int K, int slice, cudaStream_t stream) {
  const unsigned slices = cdiv(K, slice);
  if (cdiv(M, 128) > 65535u || slices > 65535u) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mlp_fwd_linear_kernel<IO, kGelu>, kLinearSmem);
  if (err != cudaSuccess) return err;
  mlp_fwd_linear_kernel<IO, kGelu><<<dim3(cdiv(N, 128), cdiv(M, 128), slices), kThreads,
                                     kLinearSmem, stream>>>(a, w, bias, out, part, M, N, K, slice);
  return cudaGetLastError();
}

template <class IO, int kNT2>
cudaError_t fused(const IO* x, const IO* w1, const IO* b1, const IO* w2, const IO* b2, IO* y,
                  int M, int C, int H, int Cout, cudaStream_t stream) {
  using F = Fused<IO, kNT2>;
  const unsigned out_tiles = cdiv(Cout, F::W2::BN);
  if (out_tiles > 65535u) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mlp_fwd_fused_kernel<IO, kNT2>, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  mlp_fwd_fused_kernel<IO, kNT2><<<dim3(cdiv(M, kFRows), out_tiles), kThreads, F::kSmemBytes,
                                   stream>>>(x, w1, b1, w2, b2, y, M, C, H, Cout);
  return cudaGetLastError();
}

template <class IO>
int mlp_fwd(const IO* x, const IO* w1, const IO* b1, const IO* w2, const IO* b2, IO* y,
            IO* hidden, float* partial, int M, int C, int H, int Cout, int slice_h,
            cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(IO);  // widths in whole 16-byte copies
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % V || H % V || Cout % V) {
    return (int)cudaErrorInvalidValue;
  }
  if (hidden == nullptr) {
    if (Cout <= 32) return (int)fused<IO, 1>(x, w1, b1, w2, b2, y, M, C, H, Cout, stream);
    return (int)fused<IO, 3>(x, w1, b1, w2, b2, y, M, C, H, Cout, stream);
  }
  if (slice_h < 1 || slice_h % kBK) return (int)cudaErrorInvalidValue;
  cudaError_t err = linear<IO, true>(x, w1, b1, hidden, nullptr, M, H, C, C, stream);
  if (err != cudaSuccess) return (int)err;
  const int slices = (int)cdiv(H, slice_h);
  if (slices == 1) return (int)linear<IO, false>(hidden, w2, b2, y, nullptr, M, Cout, H, H, stream);
  if (partial == nullptr || (long)M * Cout > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if ((err = linear<IO, false>(hidden, w2, b2, y, partial, M, Cout, H, slice_h, stream)) !=
      cudaSuccess)
    return (int)err;
  mlp_fwd_reduce_bias_kernel<IO><<<cdiv(M * Cout / 4, kThreads), kThreads, 0, stream>>>(
      partial, b2, y, M * Cout, Cout, slices);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the wgmma kernels fed by TMA (wgmma_bf16.cuh)

namespace bf {

// the engine's names, declared here so that they, not the fp32 engine's
// (`using namespace fm` above), are found
using fm_wg::aligned_smem;
using fm_wg::cdiv;
using fm_wg::desc;
using fm_wg::fence_regs;
using fm_wg::for_each_pair;
using fm_wg::gelu_exact;
using fm_wg::kAlign;
using fm_wg::kBias;
using fm_wg::kBiasGelu;
using fm_wg::kBK;
using fm_wg::kBox;
using fm_wg::kBoxBytes;
using fm_wg::kConsumers;
using fm_wg::kStep16;
using fm_wg::kThreads;
using fm_wg::kTile;
using fm_wg::launch_products;
using fm_wg::load_piece;
using fm_wg::make_map;
using fm_wg::mbar_arrive;
using fm_wg::mbar_expect;
using fm_wg::mbar_init;
using fm_wg::mbar_init_fence;
using fm_wg::mbar_wait;
using fm_wg::pack_bf16;
using fm_wg::Pos;
using fm_wg::product;
using fm_wg::Products;
using fm_wg::Ring;
using fm_wg::tma_load;
using fm_wg::wgmma_commit;
using fm_wg::wgmma_fence;
using fm_wg::wgmma_rs;
using fm_wg::wgmma_ss;
using fm_wg::wgmma_wait;
using fm_wg::zero;

constexpr int kHC = 64;              // hidden units a chunk of the fused kernel
constexpr int kFusedMaxWidth = 192;  // the widest C and C_out it takes
constexpr int kFusedMaxStages = 4;
constexpr int kSmemLimit = 227 * 1024;

// The fused forward: 128 rows a block; fc2's accumulator in kParts parts of
// kNW columns (kParts kNW >= C_out). Shared memory: the x rows (2 boxes a
// 64-deep slice of C), then the ring (a stage: the chunk's W1 rows, one box
// a slice of C, and its W2 columns, kW2Boxes boxes of 64 outputs), its
// barriers and the x barrier.
template <int kParts, int kNW>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap w1m,
             const __grid_constant__ CUtensorMap w2m, const bf16* __restrict__ b1,
             const bf16* __restrict__ b2, bf16* __restrict__ y, int M, int C, int H, int Cout,
             int stages) {
  constexpr int kW2Boxes = cdiv(kParts * kNW, kBox);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = aligned_smem(smem_raw);
  const int nkx = cdiv(C, kBK), stage_bytes = (nkx + kW2Boxes) * kBoxBytes;
  const Ring r = Ring::make(xs + nkx * 2 * kBoxBytes, stages, stage_bytes);
  uint64_t* xbar = r.empty + stages;
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int m0 = blockIdx.x * kTile, chunks = cdiv(H, kHC);
  Pos pos;
  if (threadIdx.x >= 128 * kConsumers) {
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect(xbar, nkx * 2 * kBoxBytes);
      for (int t = 0; t < nkx; ++t) load_piece(xs + t * 2 * kBoxBytes, &xm, xbar, false, m0, t * kBK);
      for (int j = 0; j < chunks; ++j) {
        mbar_wait(r.empty + pos.stage, pos.phase ^ 1);
        uint64_t* full = r.full + pos.stage;
        uint8_t* s = r.stage(pos.stage);
        mbar_expect(full, stage_bytes);
        for (int t = 0; t < nkx; ++t) tma_load(s + t * kBoxBytes, &w1m, full, t * kBK, j * kHC);
        for (int q = 0; q < kW2Boxes; ++q)
          tma_load(s + (nkx + q) * kBoxBytes, &w2m, full, j * kHC, q * kBox);
        pos.next(stages);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int last16 = cdiv(C - (nkx - 1) * kBK, 16);
  float acc2[kParts][kNW / 2];
#pragma unroll
  for (int p = 0; p < kParts; ++p) zero(acc2[p]);
  mbar_wait(xbar, 0);
  for (int j = 0; j < chunks; ++j) {
    mbar_wait(r.full + pos.stage, pos.phase);
    const uint8_t* s = r.stage(pos.stage);
    // fc1: h_j (this warpgroup's 64 rows x kHC units) = x W1_j^T
    float acc1[kHC / 2];
    zero(acc1);
    fence_regs(acc1);
    wgmma_fence();
    for (int t = 0; t < nkx; ++t) {
      const uint64_t da = desc<0>(xs + (2 * t + wg) * kBoxBytes), db = desc<0>(s + t * kBoxBytes);
      const int steps = t + 1 < nkx ? kBK / 16 : last16;
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        if (k < steps) wgmma_ss<0, 0>(acc1, da + k * kStep16<0>, db + k * kStep16<0>);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc1);
    // bias and GELU in registers, rounded to bf16 as fc2's A fragments: the
    // k-step q of 16 units takes column groups 2q and 2q + 1, rows lane / 4
    // and + 8 (H % 8 == 0: columns n and n + 1 lie both inside H or both
    // outside, where W2's zeros meet them)
    uint32_t af[kHC / 4];
    const int col = j * kHC + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < kHC / 8; ++c) {
      const int n = col + 8 * c;
      const float bias0 = n < H ? fm_io::to_f(b1[n]) : 0.f;
      const float bias1 = n < H ? fm_io::to_f(b1[n + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        af[2 * c + h] = pack_bf16(gelu_exact(acc1[4 * c + 2 * h] + bias0),
                                  gelu_exact(acc1[4 * c + 2 * h + 1] + bias1));
    }
    // fc2: acc2 += a_j W2_j^T, W2_j K-major (outputs x kHC units)
    const uint8_t* w2s = s + nkx * kBoxBytes;
#pragma unroll
    for (int p = 0; p < kParts; ++p) fence_regs(acc2[p]);
    fence_regs(af);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kHC / 16; ++q)
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        wgmma_rs<0>(acc2[p], af + 4 * q, desc<0>(w2s + p * kNW * 128) + q * kStep16<0>);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < kParts; ++p) fence_regs(acc2[p]);
    fence_regs(af);
    if (threadIdx.x % 128 == 0) mbar_arrive(r.empty + pos.stage);
    pos.next(stages);
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    for_each_pair<kNW / 8>(m0, p * kNW, [&](int e, int m, int n) {
      if (m < M && n < Cout)
        fm_io::store2(y + (size_t)m * Cout + n, acc2[p][e] + fm_io::to_f(b2[n]),
                      acc2[p][e + 1] + fm_io::to_f(b2[n + 1]));
    });
}

template <int kParts, int kNW>
cudaError_t launch_fused(const CUtensorMap& xm, const CUtensorMap& w1m, const CUtensorMap& w2m,
                         const bf16* b1, const bf16* b2, bf16* y, int M, int C, int H, int Cout,
                         cudaStream_t stream) {
  const int nkx = cdiv(C, kBK);
  const int stage_bytes = (nkx + cdiv(kParts * kNW, kBox)) * kBoxBytes;
  const int fixed = nkx * 2 * kBoxBytes + kAlign + 8 * (2 * kFusedMaxStages + 1);
  const int fit = (kSmemLimit - fixed) / stage_bytes;
  const int stages = fit < kFusedMaxStages ? fit : kFusedMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = nkx * 2 * kBoxBytes + stages * stage_bytes + 8 * (2 * stages + 1) + kAlign;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<kParts, kNW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_kernel<kParts, kNW><<<cdiv(M, kTile), kThreads, smem, stream>>>(
      xm, w1m, w2m, b1, b2, y, M, C, H, Cout, stages);
  return cudaGetLastError();
}

int mlp_fwd(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
            bf16* y, bf16* hidden, float* partial, int M, int C, int H, int Cout, int slice_h,
            cudaStream_t stream) {
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % 8 || H % 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, w1m, w2m;
  if (!make_map(&xm, x, C, M) || !make_map(&w1m, w1, C, H) || !make_map(&w2m, w2, H, Cout))
    return (int)cudaErrorInvalidValue;
  if (hidden == nullptr) {
    if (C > kFusedMaxWidth || Cout > kFusedMaxWidth) return (int)cudaErrorInvalidValue;
    if (Cout <= 96) return (int)launch_fused<3, 32>(xm, w1m, w2m, b1, b2, y, M, C, H, Cout, stream);
    return (int)launch_fused<3, 64>(xm, w1m, w2m, b1, b2, y, M, C, H, Cout, stream);
  }
  const int slices = cdiv(H, slice_h);
  if (slice_h < 1 || (slices > 1 && (slice_h % kBK || partial == nullptr)) ||
      (long)M * Cout > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hm;
  if (!make_map(&hm, hidden, H, M)) return (int)cudaErrorInvalidValue;
  Products ps{};
  ps.count = 1;
  ps.p[0] = product(xm, false, w1m, false, M, H, C, C, kBiasGelu, b1, hidden, nullptr);
  cudaError_t err = launch_products<0>(ps, stream);
  if (err != cudaSuccess) return (int)err;
  ps.p[0] = product(hm, false, w2m, false, M, Cout, H, slice_h, kBias, b2, y, partial);
  if ((err = launch_products<0>(ps, stream)) != cudaSuccess || slices == 1) return (int)err;
  mlp_fwd_reduce_bias_kernel<bf16><<<cdiv(M * Cout / 4, fm::kThreads), fm::kThreads, 0, stream>>>(
      partial, b2, y, M * Cout, Cout, slices);
  return (int)cudaGetLastError();
}

}  // namespace bf

}  // namespace

// hidden == nullptr: the fused kernel (the hidden layer stays on chip);
// else two passes through `hidden`, an (M, H) scratch in the I/O type,
// fc2's depth H cut into slices of slice_h (a multiple of 32 in fp32, of 64
// in bf16), whose fp32 partials go to `partial` (slices, M, C_out) when
// there are several. C, H and C_out must be multiples of 16 bytes (4
// floats, 8 bf16) and every pointer 16-byte aligned. The _bf16 entry takes
// x, the weights, the biases, y and hidden as bf16 and runs the wgmma/TMA
// kernels; its fused design takes C and C_out up to 192.
extern "C" int fm_fused_mlp_fwd(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* y, float* hidden,
                                float* partial, int M, int C, int H, int Cout, int slice_h,
                                cudaStream_t stream) {
  return mlp_fwd(x, w1, b1, w2, b2, y, hidden, partial, M, C, H, Cout, slice_h, stream);
}
extern "C" int fm_fused_mlp_fwd_bf16(const bf16* x, const bf16* w1, const bf16* b1,
                                     const bf16* w2, const bf16* b2, bf16* y, bf16* hidden,
                                     float* partial, int M, int C, int H, int Cout, int slice_h,
                                     cudaStream_t stream) {
  return bf::mlp_fwd(x, w1, b1, w2, b2, y, hidden, partial, M, C, H, Cout, slice_h, stream);
}
