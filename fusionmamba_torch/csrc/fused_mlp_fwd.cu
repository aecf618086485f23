// Fused two-layer MLP forward for Hopper (sm_90a), fp32 in and out:
//   y = gelu(x @ W1^T + b1) @ W2^T + b2, gelu exact (erf).
//
// Replaces fusionmamba_tpu/ops/mlp_pallas.py::_fwd_kernel (built by
// _fwd_pallas). Weights are in torch's nn.Linear layout: W1 (H, C), W2 (C_out, H).
//
// What bounds it: operations, 4*C*H flops per row against 8*C bytes of x
// and y. The products run on the tensor cores as three TF32 products each
// (mma_tf32x3.cuh: fp32-class accuracy at 165 TFLOP/s of fp32 work).
// Two designs, chosen by the wrapper (ops/mlp.py) from the output width:
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
// The GELU is erff; the TPU kernel's polynomial erf was a compiler workaround.
#include "mma_tf32x3.cuh"

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

template <int kNT2>
struct Fused {
  using W1 = Warps<2, 2, 4>;          // fc1 chunk: 64 rows x kHC hidden units
  using W2 = Warps<2, 2, kNT2>;       // fc2: 64 rows x 32 * kNT2 outputs
  using XT = Staged<kFRows, true>;    // x rows, K = C
  using H1T = Staged<kHC, true>;      // W1 rows (hidden units), K = C
  using O2T = Staged<W2::BN, true>;   // W2 rows (outputs), K = H
  static constexpr int kStage = XT::kFloats + H1T::kFloats > O2T::kFloats
                                    ? XT::kFloats + H1T::kFloats
                                    : O2T::kFloats;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kStages * kStage + (size_t)kFRows * kHC);
  static_assert(W1::BM == kFRows && W1::BN == kHC && W2::BM == kFRows, "tile shapes");
};

template <int kNT2>
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ y, int M, int C, int H,
                     int Cout) {
  using F = Fused<kNT2>;
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
        // bias and exact GELU on the accumulators; H % 4 == 0, so columns
        // j and j + 1 are both inside H or both outside
        W1::for_each_pair(0, 0, [&](int i, int j, int h, int m, int n) {
          float2 v = make_float2(0.f, 0.f);
          if (j0 + n < H) {
            v.x = gelu_exact(acc1[i][j][2 * h] + b1[j0 + n]);
            v.y = gelu_exact(acc1[i][j][2 * h + 1] + b1[j0 + n + 1]);
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
      *reinterpret_cast<float2*>(y + (size_t)m * Cout + n) =
          make_float2(acc2[i][j][2 * h] + b2[n], acc2[i][j][2 * h + 1] + b2[n + 1]);
  });
}

// out (M, N) = act(a (M, K) w (N, K)^T + bias), act GELU or identity,
// through the warpgroup engine in 128x128 tiles. With gridDim.z > 1 the
// depth is cut into slices of `slice` and block z writes the raw partial
// product of slice z to out + z M N (mlp_fwd_reduce_bias_kernel finishes it).
template <bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_linear_kernel(const float* __restrict__ a, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
                      int slice) {
  using G = WgGemm;
  extern __shared__ __align__(1024) float4 smem4[];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN, z = blockIdx.z;
  const bool partial = gridDim.z > 1;
  float acc[G::kAcc];
  G::zero(acc);
  G::run(acc, a, K, M, w, K, N, m0, n0, z * slice, min(K, (z + 1) * slice),
         reinterpret_cast<float*>(smem4));
  float* dst = out + (size_t)z * M * N;
  G::for_each_pair(m0, n0, [&](int i, int m, int n) {
    if (m < M && n < N) {
      float v0 = acc[i], v1 = acc[i + 1];
      if (!partial) {
        v0 += bias[n];
        v1 += bias[n + 1];
        if (kGelu) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
        }
      }
      *reinterpret_cast<float2*>(dst + (size_t)m * N + n) = make_float2(v0, v1);
    }
  });
}

// out (M, N) = bias + the sum of `slices` partials (slices, M, N), in order
__global__ void __launch_bounds__(kThreads)
mlp_fwd_reduce_bias_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                           float* __restrict__ out, int MN, int N, int slices) {
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
  const float4 b = *reinterpret_cast<const float4*>(bias + i % N);
  *reinterpret_cast<float4*>(out + i) = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
}

constexpr size_t kLinearSmem = sizeof(float) * WgGemm::kSmemFloats;

template <bool kGelu>
cudaError_t linear(const float* a, const float* w, const float* bias, float* out, int M, int N,
                   int K, int slice, cudaStream_t stream) {
  const unsigned slices = cdiv(K, slice);
  if (cdiv(M, 128) > 65535u || slices > 65535u) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mlp_fwd_linear_kernel<kGelu>, kLinearSmem);
  if (err != cudaSuccess) return err;
  mlp_fwd_linear_kernel<kGelu><<<dim3(cdiv(N, 128), cdiv(M, 128), slices), kThreads, kLinearSmem,
                                 stream>>>(a, w, bias, out, M, N, K, slice);
  return cudaGetLastError();
}

template <int kNT2>
cudaError_t fused(const float* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, float* y, int M, int C, int H, int Cout, cudaStream_t stream) {
  using F = Fused<kNT2>;
  const unsigned out_tiles = cdiv(Cout, F::W2::BN);
  if (out_tiles > 65535u) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mlp_fwd_fused_kernel<kNT2>, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  mlp_fwd_fused_kernel<kNT2><<<dim3(cdiv(M, kFRows), out_tiles), kThreads, F::kSmemBytes,
                               stream>>>(x, w1, b1, w2, b2, y, M, C, H, Cout);
  return cudaGetLastError();
}

}  // namespace

// hidden == nullptr: the fused kernel (the hidden layer stays on chip);
// else two passes through `hidden`, an (M, H) scratch, fc2's depth H cut
// into slices of slice_h (a multiple of 32), whose partials go to
// `partial` (slices, M, C_out) when there are several. C, H and C_out must
// be multiples of 4 and every pointer 16-byte aligned.
extern "C" int fm_fused_mlp_fwd(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* y, float* hidden,
                                float* partial, int M, int C, int H, int Cout, int slice_h,
                                cudaStream_t stream) {
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % 4 || H % 4 || Cout % 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (hidden == nullptr) {
    if (Cout <= 32) return (int)fused<1>(x, w1, b1, w2, b2, y, M, C, H, Cout, stream);
    return (int)fused<3>(x, w1, b1, w2, b2, y, M, C, H, Cout, stream);
  }
  if (slice_h < 1 || slice_h % kBK) return (int)cudaErrorInvalidValue;
  cudaError_t err = linear<true>(x, w1, b1, hidden, M, H, C, C, stream);
  if (err != cudaSuccess) return (int)err;
  const int slices = (int)cdiv(H, slice_h);
  if (slices == 1) return (int)linear<false>(hidden, w2, b2, y, M, Cout, H, H, stream);
  if (partial == nullptr || (long)M * Cout > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if ((err = linear<false>(hidden, w2, b2, partial, M, Cout, H, slice_h, stream)) != cudaSuccess)
    return (int)err;
  mlp_fwd_reduce_bias_kernel<<<cdiv(M * Cout / 4, kThreads), kThreads, 0, stream>>>(
      partial, b2, y, M * Cout, Cout, slices);
  return (int)cudaGetLastError();
}
