// Fused two-layer MLP backward for Hopper (sm_90a), fp32 or bf16 in and out. The
// forward (fused_mlp_fwd.cu) is y = gelu(x @ W1^T + b1) @ W2^T + b2, gelu
// exact (erf), weights in torch's nn.Linear layout: W1 (H, C), W2 (C_out, H).
//
// Replaces fusionmamba_tpu/ops/mlp_pallas.py::_bwd_kernel (built by
// _bwd_pallas). Given dy (M, C_out):
//   h = x W1^T + b1 (recomputed),  a = gelu(h),  g = (dy W2) * gelu'(h)
//   dx = g W1,  dW1 = g^T x,  db1 = sum_m g,  dW2 = dy^T a,  db2 = sum_m dy
// with gelu'(h) = Phi(h) + h phi(h) from one erff and one expf.
//
// What bounds it: operations, 10*M*C*H flops per call. All five products go
// through the tensor cores as three TF32 products each (mma_tf32x3.cuh).
// The TPU kernel carries dW1 and dW2 across a sequential grid; here blocks
// run in parallel in no order and one block cannot hold all of dW1 (9.4 MB
// at C=768), so the backward is three launches:
//   1. hidden: per (128 rows, 64 hidden units) tile, h and dy W2 into the
//      registers of one tile, then a and g to an (M, H) scratch each, the
//      tile's column sums of g (db1) and of dy (db2, spread over the row
//      tile's blocks) as per-row-tile partials;
//   2. products: dx = g W1, dW1 = g^T x and dW2 = dy^T a in one grid of
//      128x128 tiles; each product's K (H for dx, the rows for dW1, dW2) is
//      cut into slices (chosen by ops/mlp.py) so that the three together
//      fill the card, each slice writing a partial where there are several;
//   3. reduce: every partial summed over its slices in a fixed order, 16
//      bytes a thread where there are few slices.
// No atomics: two launches give bit-identical results.
//
// With bf16 I/O (x, dy, the weights, b1 and every result bf16) each product
// is exact in one TF32 product with fp32 sums (mma_tf32x3.cuh); a and g are
// rounded to bf16 where the TPU kernel rounds them (the a and g scratch is
// bf16), db1 sums the rounded g, and every partial is fp32, rounded to bf16
// once, as the result is stored.
#include "mma_tf32x3.cuh"

namespace {

using namespace fm;

using HidW = Warps<4, 2, 4>;   // 128 rows x 64 hidden units, warp tiles of 32 x 32
using ProdW = Warps<2, 4, 4>;  // 128 x 128, warp tiles of 64 x 32

template <class IO>
struct Engines {
  using HidG1 = Gemm<HidW, true, true, IO>;     // x (M, C) W1 (H, C)^T
  using HidG2 = Gemm<HidW, true, false, IO>;    // dy (M, C_out) W2 (C_out, H)
  using ProdDx = Gemm<ProdW, true, false, IO>;  // g (M, H) W1 (H, C)
  using ProdDw = Gemm<ProdW, false, false, IO>; // P^T Q for P, Q row-major with shared rows
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
template <class IO>
constexpr size_t kHidSmem = sizeof(float) * cmax(Engines<IO>::HidG1::kSmemFloats,
                                                 Engines<IO>::HidG2::kSmemFloats);
template <class IO>
constexpr size_t kProdSmem = sizeof(float) * cmax(Engines<IO>::ProdDx::kSmemFloats,
                                                  Engines<IO>::ProdDw::kSmemFloats);

template <class IO>
__global__ void __launch_bounds__(kThreads, 2)
mlp_bwd_hidden_kernel(const IO* __restrict__ x, const IO* __restrict__ dy,
                      const IO* __restrict__ w1, const IO* __restrict__ b1,
                      const IO* __restrict__ w2, IO* __restrict__ a_out,
                      IO* __restrict__ g_out, float* __restrict__ db1_p,
                      float* __restrict__ db2_p, int M, int C, int H, int Cout) {
  using HidG1 = typename Engines<IO>::HidG1;
  using HidG2 = typename Engines<IO>::HidG2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * HidW::BN, m0 = blockIdx.y * HidW::BM;
  HidW::Acc hacc, dacc;
  HidW::zero(hacc);
  HidW::zero(dacc);
  HidG1::run(hacc, x, C, M, w1, C, H, m0, n0, 0, C, smem);
  HidG2::run(dacc, dy, Cout, M, w2, H, H, m0, n0, 0, Cout, smem);

  float colsum[HidW::NT][2];
#pragma unroll
  for (int j = 0; j < HidW::NT; ++j) colsum[j][0] = colsum[j][1] = 0.f;
  HidW::for_each_pair(m0, n0, [&](int i, int j, int h, int m, int n) {
    if (m >= M || n >= H) return;  // H % 4 == 0: n + 1 < H too
    float av[2], gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float hv = hacc[i][j][2 * h + e] + to_f(b1[n + e]);
      const float erf = erff(hv * 0.70710678118654752f);
      const float cdf = 0.5f * (1.f + erf);
      const float pdf = 0.39894228040143268f * expf(-0.5f * hv * hv);
      av[e] = hv * cdf;
      // g as it is stored (rounded to IO): db1 sums what the products read
      gv[e] = fm_io::round_to<IO>(dacc[i][j][2 * h + e] * fmaf(hv, pdf, cdf));
      colsum[j][e] += gv[e];
    }
    fm_io::store2(a_out + (size_t)m * H + n, av[0], av[1]);
    fm_io::store2(g_out + (size_t)m * H + n, gv[0], gv[1]);
  });

  // db1: the tile's column sums of g, over the 8 row groups of a warp
  // (lanes of one t), then over the 4 warps of a column, in that order
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < HidW::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = colsum[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      colsum[j][e] = v;
    }
  float* red = smem;  // [4 warps][BN]; the engine left smem free
  const int wm = threadIdx.x / 32 % 4;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < HidW::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[wm * HidW::BN + HidW::wn0() + 8 * j + 2 * lane + e] = colsum[j][e];
  }
  __syncthreads();
  if (threadIdx.x < HidW::BN && n0 + (int)threadIdx.x < H) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[w * HidW::BN + threadIdx.x];
    db1_p[(size_t)blockIdx.y * H + n0 + threadIdx.x] = s;
  }
  // db2: the row tile's column sums of dy; this block takes the columns
  // n0 + t + q H (t < 64, q >= 0), each summed over 4 groups of rows, then
  // the 4 in order
  const int t = threadIdx.x % HidW::BN, rg = threadIdx.x / HidW::BN;
  const int m_end = min(M, m0 + HidW::BM);
  for (int c0 = n0; c0 < Cout; c0 += H) {
    const int c = c0 + t;
    float s = 0.f;
    if (c < Cout)
      for (int m = m0 + rg; m < m_end; m += kThreads / HidW::BN) s += to_f(dy[(size_t)m * Cout + c]);
    __syncthreads();  // red is free
    red[rg * HidW::BN + t] = s;
    __syncthreads();
    if (rg == 0 && c < Cout)
      db2_p[(size_t)blockIdx.y * Cout + c] =
          red[t] + red[HidW::BN + t] + red[2 * HidW::BN + t] + red[3 * HidW::BN + t];
  }
  static_assert(kThreads / HidW::BN == 4, "four row groups");
}

// part[s] (rows, cols) = A (rows x depth) B (depth x cols) over slice s of
// the depth, for s < slices, fp32; with one slice the product goes to out
// instead, in IO. A(m, k) = A[m * lda + k] when A is K-major (dx),
// A[k * lda + m] otherwise; B(k, n) = B[k * ldb + n]
template <class IO>
struct Product {
  const IO* A;
  const IO* B;
  float* part;
  IO* out;
  int lda, ldb, rows, cols, depth, slice, tiles_n, blocks;
};

template <class G, class IO>
__device__ __forceinline__ void product_tile(const Product<IO>& p, int b, float* smem) {
  const int tiles = p.blocks / ((p.depth + p.slice - 1) / p.slice);
  const int s = b / tiles, tm = b % tiles / p.tiles_n, tn = b % tiles % p.tiles_n;
  const int m0 = tm * ProdW::BM, n0 = tn * ProdW::BN;
  const int k_begin = s * p.slice, k_end = min(p.depth, k_begin + p.slice);
  ProdW::Acc acc;
  ProdW::zero(acc);
  G::run(acc, p.A, p.lda, p.rows, p.B, p.ldb, p.cols, m0, n0, k_begin, k_end, smem);
  float* part = p.part + (size_t)s * p.rows * p.cols;
  ProdW::for_each_pair(m0, n0, [&](int i, int j, int h, int m, int n) {
    if (m < p.rows && n < p.cols) {
      if (p.part) {
        *reinterpret_cast<float2*>(part + (size_t)m * p.cols + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      } else {
        fm_io::store2(p.out + (size_t)m * p.cols + n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  });
}

template <class IO>
__global__ void __launch_bounds__(kThreads, 2)
mlp_bwd_product_kernel(Product<IO> dx, Product<IO> dw1, Product<IO> dw2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int b = blockIdx.x;
  if (b < dx.blocks) {
    product_tile<typename Engines<IO>::ProdDx>(dx, b, smem);
    return;
  }
  b -= dx.blocks;
  if (b < dw1.blocks) {
    product_tile<typename Engines<IO>::ProdDw>(dw1, b, smem);
    return;
  }
  product_tile<typename Engines<IO>::ProdDw>(dw2, b - dw1.blocks, smem);
}

// out[i] = sum over s < slices of part[s * n + i], in order of s, in IO
template <class IO>
struct Sum {
  const float* part;
  IO* out;
  int slices, n, blocks;
};
constexpr int kMaxSums = 5;
template <class IO>
struct Sums {
  Sum<IO> t[kMaxSums];
  int count;
};

constexpr int kDeep = 32;  // from this many slices on, a block splits each sum over its warps

// Few slices (dx, dW1, dW2): each thread sums 4 outputs over all slices.
// Many (db1, db2 over the row tiles): each block takes 32 outputs, its 8
// warps summing every 8th slice, then the 8 partial sums in order.
template <class IO>
__global__ void __launch_bounds__(kThreads) mlp_bwd_reduce_kernel(Sums<IO> sums) {
  __shared__ float red[8][33];
  int b = blockIdx.x, i = 0;
  while (i + 1 < sums.count && b >= sums.t[i].blocks) b -= sums.t[i++].blocks;
  const Sum<IO> s = sums.t[i];
  if (s.slices < kDeep) {
    const int col = (b * kThreads + (int)threadIdx.x) * 4;  // n % 4 == 0
    if (col >= s.n) return;
    float4 v = *reinterpret_cast<const float4*>(s.part + col);
    for (int k = 1; k < s.slices; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(s.part + (size_t)k * s.n + col);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    fm_io::store4(s.out + col, v);
    return;
  }
  const int lane = threadIdx.x & 31, row = threadIdx.x / 32, col = b * 32 + lane;
  float v = 0.f;
  if (col < s.n)
    for (int k = row; k < s.slices; k += 8) v += s.part[(size_t)k * s.n + col];
  red[row][lane] = v;
  __syncthreads();
  if (row == 0 && col < s.n) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) r += red[w][lane];
    s.out[col] = from_f<IO>(r);
  }
}

// the product into `out` where the depth is one slice, else into the
// partials `part`
template <class IO>
Product<IO> product(const IO* A, int lda, const IO* B, int ldb, float* part, IO* out, int rows,
                    int cols, int depth, int slice) {
  const bool one = cdiv(depth, slice) == 1;
  Product<IO> p{A, B, one ? nullptr : part, one ? out : nullptr, lda, ldb, rows, cols, depth,
                slice, 0, 0};
  p.tiles_n = (int)cdiv(cols, ProdW::BN);
  p.blocks = (int)(cdiv(rows, ProdW::BM) * p.tiles_n * cdiv(depth, slice));
  return p;
}

template <class IO>
void add_sum(Sums<IO>& sums, const float* part, IO* out, int slices, int n) {
  sums.t[sums.count++] =
      Sum<IO>{part, out, slices, n, (int)(slices < kDeep ? cdiv(n, 4 * kThreads) : cdiv(n, 32))};
}

template <class IO>
int mlp_bwd(const IO* x, const IO* dy, const IO* w1, const IO* b1, const IO* w2, IO* a_buf,
            IO* g_buf, float* db1_p, float* db2_p, float* dx_p, float* dw1_p, float* dw2_p,
            IO* dx, IO* dw1, IO* db1, IO* dw2, IO* db2, int M, int C, int H, int Cout,
            int slice_dx, int slice_w, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(IO);  // widths in whole 16-byte copies
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % V || H % V || Cout % V || slice_dx < 1 ||
      slice_w < 1 || slice_dx % kBK || slice_w % kBK || cdiv(M, HidW::BM) > 65535u) {
    return (int)cudaErrorInvalidValue;
  }
  const int s_dx = (int)cdiv(H, slice_dx), s_w = (int)cdiv(M, slice_w);
  if ((s_dx > 1 && dx_p == nullptr) || (s_w > 1 && (dw1_p == nullptr || dw2_p == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }

  cudaError_t err = allow_smem(mlp_bwd_hidden_kernel<IO>, kHidSmem<IO>);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_hidden_kernel<IO><<<dim3(cdiv(H, HidW::BN), cdiv(M, HidW::BM)), kThreads, kHidSmem<IO>,
                              stream>>>(x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, M, C, H,
                                        Cout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const Product<IO> pdx = product(g_buf, H, w1, C, dx_p, dx, M, C, H, slice_dx);
  const Product<IO> pw1 = product(g_buf, H, x, C, dw1_p, dw1, H, C, M, slice_w);
  const Product<IO> pw2 = product(dy, Cout, a_buf, H, dw2_p, dw2, Cout, H, M, slice_w);
  if ((err = allow_smem(mlp_bwd_product_kernel<IO>, kProdSmem<IO>)) != cudaSuccess) return (int)err;
  mlp_bwd_product_kernel<IO><<<pdx.blocks + pw1.blocks + pw2.blocks, kThreads, kProdSmem<IO>,
                               stream>>>(pdx, pw1, pw2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  Sums<IO> sums{};
  if (s_dx > 1) add_sum(sums, dx_p, dx, s_dx, M * C);
  if (s_w > 1) {
    add_sum(sums, dw1_p, dw1, s_w, H * C);
    add_sum(sums, dw2_p, dw2, s_w, Cout * H);
  }
  const int rows_t = (int)cdiv(M, HidW::BM);
  add_sum(sums, db1_p, db1, rows_t, H);
  add_sum(sums, db2_p, db2, rows_t, Cout);
  int blocks = 0;
  for (int i = 0; i < sums.count; ++i) blocks += sums.t[i].blocks;
  mlp_bwd_reduce_kernel<IO><<<blocks, kThreads, 0, stream>>>(sums);
  return (int)cudaGetLastError();
}

}  // namespace

// a_buf, g_buf: (M, H) scratch. db1_p (T, H) and db2_p (T, C_out) with
// T = ceil(M / 128). dx (M, C), dw1 (H, C), dw2 (C_out, H), db1 (H,),
// db2 (C_out,) are the results. The depth of dx (H) is cut into slices of
// slice_dx and that of dW1 and dW2 (M) into slices of slice_w, both
// multiples of 32; with more than one slice the product writes fp32
// partials to dx_p (S_dx, M, C), dw1_p (S_w, H, C), dw2_p (S_w, C_out, H),
// which may be null otherwise. C, H and C_out must be multiples of 16 bytes
// (4 floats, 8 bf16) and every pointer 16-byte aligned. The _bf16 entry
// takes x, dy, the weights, b1, the a and g scratch and the results as bf16
// (the partials stay fp32).
extern "C" int fm_fused_mlp_bwd(const float* x, const float* dy, const float* w1,
                                const float* b1, const float* w2, float* a_buf, float* g_buf,
                                float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
                                float* dw2_p, float* dx, float* dw1, float* db1, float* dw2,
                                float* db2, int M, int C, int H, int Cout, int slice_dx,
                                int slice_w, cudaStream_t stream) {
  return mlp_bwd(x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1, db1,
                 dw2, db2, M, C, H, Cout, slice_dx, slice_w, stream);
}
extern "C" int fm_fused_mlp_bwd_bf16(const bf16* x, const bf16* dy, const bf16* w1,
                                     const bf16* b1, const bf16* w2, bf16* a_buf, bf16* g_buf,
                                     float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
                                     float* dw2_p, bf16* dx, bf16* dw1, bf16* db1, bf16* dw2,
                                     bf16* db2, int M, int C, int H, int Cout, int slice_dx,
                                     int slice_w, cudaStream_t stream) {
  return mlp_bwd(x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1, db1,
                 dw2, db2, M, C, H, Cout, slice_dx, slice_w, stream);
}
