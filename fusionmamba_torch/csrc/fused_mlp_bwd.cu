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
// through the tensor cores (below: 3xTF32 in fp32, bf16 wgmma in bf16).
// The TPU kernel carries dW1 and dW2 across a sequential grid; here blocks
// run in parallel in no order and one block cannot hold all of dW1 (9.4 MB
// at C=768), so the backward is three launches:
//   1. hidden: per tile of 128 rows and a block of hidden units, h and
//      dy W2 into the registers of one tile, then a and g to an (M, H)
//      scratch each, the tile's column sums of g (db1) and of dy (db2,
//      spread over the row tile's blocks) as per-row-tile partials;
//   2. products: dx = g W1, dW1 = g^T x and dW2 = dy^T a in one launch of
//      output tiles; each product's K (H for dx, the rows for dW1, dW2) is
//      cut into slices (chosen by ops/mlp.py) so that the three together
//      fill the card, each slice writing a partial where there are several;
//   3. reduce: every partial summed over its slices in a fixed order, 16
//      bytes a thread where there are few slices.
// No atomics: two launches give bit-identical results.
//
// fp32: the three launches, each as persistent blocks (at most one an SM,
// ops/mlp.py's plan), on the 3xTF32 wgmma engine fed by TMA
// (wgmma_tf32x3.cuh); x, dy, the weights, the a and g scratch and the
// results fp32:
//   1. hidden: each block walks (128 rows, 128 hidden units) tiles, hidden
//      units fastest: h = x W1^T (both K-major) and then dy W2 (W2 read
//      MN-major) through one ring into two accumulators; the epilogue as
//      above, in registers, a and g staged in the free plane sets and
//      written by TMA stores, which run on while the next tile's products
//      start; the row tile's db2 columns shared among its tiles.
//   2. products: each block walks the items of dx = g W1 (W1 MN-major),
//      dW1 = g^T x and dW2 = dy^T a (both operands MN-major): a 128 x 128
//      output tile and one depth slice, the products of the deepest slices
//      first, tiles fastest within a slice; a cut depth writes fp32 partials.
//   3. reduce: as in bf16 below.
//
// bf16 (x, dy, the weights, b1 and every result bf16): the same three
// launches on Hopper's bf16 wgmma fed by TMA (wgmma_bf16.cuh), every product
// bf16 x bf16 with fp32 sums; a and g are rounded to bf16 where the TPU
// kernel rounds them (the a and g scratch is bf16), db1 sums the rounded g,
// and every partial is fp32, rounded to bf16 once, as the result is stored.
//   1. hidden: per (128 rows, 64 hidden units) tile, h = x W1^T and then
//      dy W2 through one TMA ring (each stage a 128 x 64 piece of x or dy
//      and a 64 x 64 piece of W1, K-major, or of W2, read MN-major as it
//      lies), two consumer warpgroups of 64 rows; the epilogue as in fp32.
//   2. products: the engine's 128 x 64 product kernel, three
//      products in one grid, each operand loaded as it lies: dx = g W1 (W1
//      MN-major), dW1 = g^T x and dW2 = dy^T a (both operands MN-major);
//      a depth cut into slices (multiples of 64) only where ops/mlp.py's
//      plan finds it much longer than a block's share.
//   3. reduce: as in fp32.
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32x3.cuh"

namespace {

using namespace fm;

// ---------------------------------------------------------------------------
// fp32: the 3xTF32 wgmma kernels fed by TMA (wgmma_tf32x3.cuh)

namespace tc {

using fm_tc::consume;
using fm_tc::kSmem;
using fm_tc::kThreads;
using fm_tc::kTile;
using fm_tc::produce;
using fm_wg::consumers_sync;
using fm_wg::for_each_pair;
using fm_wg::Pos;
using fm_wg::Ring;
using fm_wg::zero;

// the hidden launch: a 2-deep ring (the plane sets stage each tile's a and
// g for their TMA stores) and the epilogue's sums after it, a row of kTile
// a consumer warp for db1, then one for db2
constexpr int kHidStages = 2;
constexpr int kRedFloats = 2 * 4 * fm_wg::kConsumers * kTile;
constexpr int kHidSmem = fm_tc::kPlaneSets * fm_tc::kPlaneSetBytes +
                         kHidStages * fm_tc::kStageBytes + fm_wg::ring_barrier_bytes(kHidStages) +
                         4 * kRedFloats + fm_wg::kAlign;

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_tf32x3_hidden(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap w1m,
                      const __grid_constant__ CUtensorMap dym, const __grid_constant__ CUtensorMap w2m,
                      const __grid_constant__ CUtensorMap am, const __grid_constant__ CUtensorMap gm,
                      const float* __restrict__ b1, const float* __restrict__ dy,
                      float* __restrict__ db1_p, float* __restrict__ db2_p, int M, int C, int H,
                      int Cout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* planes = fm_tc::aligned_shared(smem_raw);
  const Ring r = fm_tc::ring_after_planes(planes, kHidStages);
  if (threadIdx.x == 0) fm_wg::mbar_init_fence();
  __syncthreads();
  const int tiles_n = fm_wg::cdiv(H, kTile), tiles = fm_wg::cdiv(M, kTile) * tiles_n;
  const int n1 = fm_wg::cdiv(C, fm_tc::kBK), n2 = fm_wg::cdiv(Cout, fm_tc::kBK);
  Pos pos;
  if (threadIdx.x >= 128 * fm_wg::kConsumers) {
    if (threadIdx.x == 128 * fm_wg::kConsumers) {
      for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
        const int m0 = b / tiles_n * kTile, n0 = b % tiles_n * kTile;
        // x rows with W1's hidden rows (K-major), then dy rows with W2's
        // hidden columns (stored [C_out][H]: MN-major)
        produce<0, 0>(r, pos, &xm, m0, &w1m, n0, 0, n1);
        produce<0, 1>(r, pos, &dym, m0, &w2m, n0, 0, n2);
      }
    }
    return;
  }
  float* red = reinterpret_cast<float*>(r.stage(0) + kHidStages * fm_tc::kStageBytes +
                                        fm_wg::ring_barrier_bytes(kHidStages));
  float* red2 = red + 4 * fm_wg::kConsumers * kTile;
  // a and g staged as the K-major maps' 32 x 64 boxes lie: piece j (columns
  // 32 j ..) of a 128-row tile at 16 KB j, a in plane set 0, g in set 1
  float* a_stage = reinterpret_cast<float*>(planes);
  float* g_stage = a_stage + fm_tc::kPlaneSetBytes / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, t = threadIdx.x % kTile;
  const fm_tc::SplitAt at(threadIdx.x);
  for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int tm = b / tiles_n, m0 = tm * kTile, n0 = b % tiles_n * kTile;
    // the last tile's stores have read the plane sets (consume's first
    // barrier tells the other threads)
    if (threadIdx.x == 0) fm_tc::tma_store_wait_read<0>();
    float hacc[kTile / 2], dacc[kTile / 2];
    zero(hacc);
    zero(dacc);
    // h's last slice overlaps dy W2's first, which takes the other plane set
    consume<0, 0, false>(hacc, r, pos, planes, n1, at);
    consume<0, 1>(dacc, r, pos, planes, n2, at, n1 & 1);
    fm_wg::fence_regs(hacc);

    consumers_sync();  // both warpgroups' products are done: the plane sets are free
    float colsum[kTile / 8][2];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) colsum[j][0] = colsum[j][1] = 0.f;
    for_each_pair<kTile / 8>(m0, n0, [&](int e, int m, int n) {
      if (m >= M || n >= H) return;  // H % 4 == 0: n + 1 < H too; the stores leave out the rest
      float av[2], gv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float hv = hacc[e + i] + b1[n + i];
        const float cdf = 0.5f * (1.f + erff(hv * 0.70710678118654752f));
        const float pdf = 0.39894228040143268f * expf(-0.5f * hv * hv);
        av[i] = hv * cdf;
        gv[i] = dacc[e + i] * fmaf(hv, pdf, cdf);
        colsum[e / 4][i] += gv[i];
      }
      const int off = (n - n0) / fm_tc::kBK * (kTile * fm_tc::kBK) +
                      fm_tc::plane_at(m - m0, (n - n0) % fm_tc::kBK);
      *reinterpret_cast<float2*>(a_stage + off) = make_float2(av[0], av[1]);
      *reinterpret_cast<float2*>(g_stage + off) = make_float2(gv[0], gv[1]);
    });
    fm::fence_proxy_async();
    consumers_sync();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < kTile / fm_tc::kBK; ++j)
#pragma unroll
        for (int h = 0; h < kTile / fm_tc::kRowsK; ++h) {
          const int box = j * (kTile * fm_tc::kBK) + h * (fm_tc::kRowsK * fm_tc::kBK);
          fm_tc::tma_store(&am, a_stage + box, n0 + fm_tc::kBK * j, m0 + fm_tc::kRowsK * h);
          fm_tc::tma_store(&gm, g_stage + box, n0 + fm_tc::kBK * j, m0 + fm_tc::kRowsK * h);
        }
      fm_tc::tma_store_commit();
    }

    // db1: the tile's column sums of g, over the 8 row groups of a warp
    // (lanes of one lane % 4), then over the 8 warps in row order
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = colsum[j][i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        colsum[j][i] = v;
      }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) red[warp * kTile + 8 * j + 2 * lane + i] = colsum[j][i];
    }
    consumers_sync();
    if (threadIdx.x < kTile && n0 + t < H) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * fm_wg::kConsumers; ++w) v += red[w * kTile + t];
      db1_p[(size_t)tm * H + n0 + t] = v;
    }
    // db2: the row tile's column sums of dy. The row tile's tiles share
    // its C_out columns, tile tn taking [tn share, (tn + 1) share), share a
    // multiple of 4, in windows of 128: thread (rg, q) sums columns 4q ..
    // 4q + 3 of the window over rows rg, rg + 8, ... (16 independent 16-byte
    // loads), then the 8 row groups in order
    const int tn = b % tiles_n, share = 4 * fm_wg::cdiv(fm_wg::cdiv(Cout, tiles_n), 4);
    const int c_end = min(Cout, (tn + 1) * share), q = threadIdx.x % 32, rg8 = threadIdx.x / 32;
    for (int c0 = tn * share; c0 < c_end; c0 += kTile) {
      const int c = c0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < c_end) {
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i) {
          const int m = m0 + rg8 + 8 * i;
          if (m < M) {
            const float4 d = *reinterpret_cast<const float4*>(dy + (size_t)m * Cout + c);
            v.x += d.x;
            v.y += d.y;
            v.z += d.z;
            v.w += d.w;
          }
        }
      }
      consumers_sync();  // red2 is free
      *reinterpret_cast<float4*>(red2 + rg8 * kTile + 4 * q) = v;
      consumers_sync();
      if (threadIdx.x < kTile && c0 + (int)threadIdx.x < c_end) {
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < 8; ++g) sum += red2[g * kTile + threadIdx.x];
        db2_p[(size_t)tm * Cout + c0 + threadIdx.x] = sum;
      }
    }
  }
  if (threadIdx.x == 0) fm_tc::tma_store_wait_all<0>();
}

// out (rows, cols) = A (rows x depth) B (depth x cols) over depth slices of
// `slice`: A's map covers the tensor stored [row][k], or [k][row] when
// a_mn; B's is MN-major ([k][col]). With more than one slice, slice s goes
// to part[s] (rows, cols) in fp32, else to out.
struct Product {
  CUtensorMap a, b;
  float* out;
  float* part;
  int rows, cols, depth, slice, a_mn;
  int tiles_n, tiles, items;  // items = tiles x slices
};
struct Products {
  Product p[3];
};

inline Product product(const CUtensorMap& a, bool a_mn, const CUtensorMap& b, int rows, int cols,
                       int depth, int slice, float* out, float* part) {
  const bool one = fm_wg::cdiv(depth, slice) == 1;
  Product p{a, b, one ? out : nullptr, one ? nullptr : part, rows, cols, depth, slice, a_mn, 0, 0, 0};
  p.tiles_n = fm_wg::cdiv(cols, kTile);
  p.tiles = fm_wg::cdiv(rows, kTile) * p.tiles_n;
  p.items = p.tiles * fm_wg::cdiv(depth, slice);
  return p;
}

// item b of the launch: its product, output tile and depth [k0, k1)
struct Item {
  const Product* p;
  int s, m0, n0, k0, nk;
};
__device__ __forceinline__ Item item_of(const Products& ps, int b) {
  int i = 0;
  while (i < 2 && b >= ps.p[i].items) b -= ps.p[i++].items;
  const Product& p = ps.p[i];
  const int s = b / p.tiles, k0 = s * p.slice, k1 = min(p.depth, k0 + p.slice);
  return Item{&p, s, b % p.tiles / p.tiles_n * kTile, b % p.tiles_n * kTile, k0,
              fm_wg::cdiv(k1 - k0, fm_tc::kBK)};
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_tf32x3_products(const __grid_constant__ Products ps, int items) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* planes = fm_tc::aligned_shared(smem_raw);
  const Ring r = fm_tc::ring_after_planes(planes);
  if (threadIdx.x == 0) fm_wg::mbar_init_fence();
  __syncthreads();
  Pos pos;
  if (threadIdx.x >= 128 * fm_wg::kConsumers) {
    if (threadIdx.x == 128 * fm_wg::kConsumers) {
      for (int b = blockIdx.x; b < items; b += gridDim.x) {
        const Item it = item_of(ps, b);
        if (it.p->a_mn) {
          produce<1, 1>(r, pos, &it.p->a, it.m0, &it.p->b, it.n0, it.k0, it.nk);
        } else {
          produce<0, 1>(r, pos, &it.p->a, it.m0, &it.p->b, it.n0, it.k0, it.nk);
        }
      }
    }
    return;
  }
  const fm_tc::SplitAt at(threadIdx.x);
  for (int b = blockIdx.x; b < items; b += gridDim.x) {
    const Item it = item_of(ps, b);
    float acc[kTile / 2];
    zero(acc);
    if (it.p->a_mn) {
      consume<1, 1>(acc, r, pos, planes, it.nk, at);
    } else {
      consume<0, 1>(acc, r, pos, planes, it.nk, at);
    }
    const int rows = it.p->rows, cols = it.p->cols;
    float* part = it.p->part;
    float* dst = part ? part + (size_t)it.s * rows * cols : it.p->out;
    for_each_pair<kTile / 8>(it.m0, it.n0, [&](int e, int m, int n) {
      if (m < rows && n < cols)  // cols % 4 == 0: n + 1 < cols too
        *reinterpret_cast<float2*>(dst + (size_t)m * cols + n) = make_float2(acc[e], acc[e + 1]);
    });
  }
}

}  // namespace tc

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

template <class IO>
void add_sum(Sums<IO>& sums, const float* part, IO* out, int slices, int n) {
  sums.t[sums.count++] =
      Sum<IO>{part, out, slices, n, (int)(slices < kDeep ? cdiv(n, 4 * kThreads) : cdiv(n, 32))};
}

// the partials of the cut depths and the row tiles' bias sums, summed by one
// reduce launch
template <class IO>
cudaError_t launch_reduce(const float* db1_p, const float* db2_p, const float* dx_p,
                          const float* dw1_p, const float* dw2_p, IO* dx, IO* dw1, IO* db1,
                          IO* dw2, IO* db2, int s_dx, int s_w, int rows_t, int M, int C, int H,
                          int Cout, cudaStream_t stream) {
  Sums<IO> sums{};
  if (s_dx > 1) add_sum(sums, dx_p, dx, s_dx, M * C);
  if (s_w > 1) {
    add_sum(sums, dw1_p, dw1, s_w, H * C);
    add_sum(sums, dw2_p, dw2, s_w, Cout * H);
  }
  add_sum(sums, db1_p, db1, rows_t, H);
  add_sum(sums, db2_p, db2, rows_t, Cout);
  int blocks = 0;
  for (int i = 0; i < sums.count; ++i) blocks += sums.t[i].blocks;
  mlp_bwd_reduce_kernel<IO><<<blocks, kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

namespace tc {

int mlp_bwd(const float* x, const float* dy, const float* w1, const float* b1, const float* w2,
            float* a_buf, float* g_buf, float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
            float* dw2_p, float* dx, float* dw1, float* db1, float* dw2, float* db2, int M, int C,
            int H, int Cout, int slice_dx, int slice_w, int hidden_blocks, int product_blocks,
            cudaStream_t stream) {
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % 4 || H % 4 || Cout % 4 || slice_dx < 1 ||
      slice_w < 1 || hidden_blocks < 1 || product_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int s_dx = fm_wg::cdiv(H, slice_dx), s_w = fm_wg::cdiv(M, slice_w);
  if ((s_dx > 1 && (dx_p == nullptr || slice_dx % fm_tc::kBK)) ||
      (s_w > 1 && (dw1_p == nullptr || dw2_p == nullptr || slice_w % fm_tc::kBK)))
    return (int)cudaErrorInvalidValue;
  // the kernels' shared memory first: a runtime call, which makes the
  // device's context current on this thread (autograd's backward thread
  // may have made none yet), as cuTensorMapEncodeTiled needs
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mlp_bwd_tf32x3_hidden,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kHidSmem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(mlp_bwd_tf32x3_products,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) !=
          cudaSuccess)
    return (int)err;
  // each tensor's maps: K-major ([row][k] read along k) and MN-major
  CUtensorMap xk, xn, dyk, dyn, w1k, w1n, w2n, gk, gn, ak, an;
  using fm_tc::make_map;
  if (!make_map(&xk, x, C, M, false) || !make_map(&xn, x, C, M, true) ||
      !make_map(&dyk, dy, Cout, M, false) || !make_map(&dyn, dy, Cout, M, true) ||
      !make_map(&w1k, w1, C, H, false) || !make_map(&w1n, w1, C, H, true) ||
      !make_map(&w2n, w2, H, Cout, true) || !make_map(&gk, g_buf, H, M, false) ||
      !make_map(&gn, g_buf, H, M, true) || !make_map(&ak, a_buf, H, M, false) ||
      !make_map(&an, a_buf, H, M, true))
    return (int)cudaErrorInvalidValue;

  mlp_bwd_tf32x3_hidden<<<hidden_blocks, kThreads, kHidSmem, stream>>>(
      xk, w1k, dyk, w2n, ak, gk, b1, dy, db1_p, db2_p, M, C, H, Cout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dx (M, C) = g W1: g [row][h] K-major, W1 [h][c] MN-major; dW1 (H, C) =
  // g^T x and dW2 (C_out, H) = dy^T a: both operands [row][..], MN-major;
  // the products of the deepest slices first (a stable sort)
  Products ps{{product(gk, false, w1n, M, C, H, slice_dx, dx, dx_p),
               product(gn, true, xn, H, C, M, slice_w, dw1, dw1_p),
               product(dyn, true, an, Cout, H, M, slice_w, dw2, dw2_p)}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && min(ps.p[j].slice, ps.p[j].depth) >
                                 min(ps.p[j - 1].slice, ps.p[j - 1].depth);
         --j) {
      const Product q = ps.p[j];
      ps.p[j] = ps.p[j - 1];
      ps.p[j - 1] = q;
    }
  const int items = ps.p[0].items + ps.p[1].items + ps.p[2].items;
  mlp_bwd_tf32x3_products<<<product_blocks, kThreads, kSmem, stream>>>(ps, items);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_reduce<float>(db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1, db1, dw2, db2, s_dx,
                                   s_w, fm_wg::cdiv(M, kTile), M, C, H, Cout, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16: the wgmma kernels fed by TMA (wgmma_bf16.cuh)

namespace bf {

// the engine's names, declared here so that they, not the fp32 engine's
// (`using namespace fm` above), are found
using fm_wg::aligned_smem;
using fm_wg::cdiv;
using fm_wg::consume_tile;
using fm_wg::consumers_sync;
using fm_wg::for_each_pair;
using fm_wg::kAlign;
using fm_wg::kBK;
using fm_wg::kBlocksPerSM;
using fm_wg::kConsumers;
using fm_wg::kStore;
using fm_wg::kThreads;
using fm_wg::kTile;
using fm_wg::last16_of;
using fm_wg::launch_products;
using fm_wg::make_map;
using fm_wg::mbar_init_fence;
using fm_wg::Pos;
using fm_wg::produce_tile;
using fm_wg::product;
using fm_wg::Products;
using fm_wg::ring_barrier_bytes;
using fm_wg::Ring;
using fm_wg::zero;

constexpr int kHidN = 64;  // hidden units of a hidden block's tile
constexpr int kHidStages = 4;
constexpr int kHidStageBytes = 3 * fm_wg::kBoxBytes;  // a 128-row piece, a 64-wide piece
constexpr int kGroups = 128 * kConsumers / kHidN;  // db2's groups of consumer threads
// the epilogue's sums: a row of kHidN a consumer warp (db1), one a group (db2)
constexpr int kRedFloats = (4 * kConsumers + kGroups) * kHidN;
constexpr int kHidSmem = kHidStages * kHidStageBytes + ring_barrier_bytes(kHidStages) +
                         4 * kRedFloats + kAlign;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
hidden_kernel(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap w1m,
              const __grid_constant__ CUtensorMap dym, const __grid_constant__ CUtensorMap w2m,
              const bf16* __restrict__ b1, const bf16* __restrict__ dy, bf16* __restrict__ a_out,
              bf16* __restrict__ g_out, float* __restrict__ db1_p, float* __restrict__ db2_p,
              int M, int C, int H, int Cout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Ring r = Ring::make(smem, kHidStages, kHidStageBytes);
  float* red = reinterpret_cast<float*>(smem + kHidStages * kHidStageBytes +
                                        ring_barrier_bytes(kHidStages));
  if (threadIdx.x == 0) mbar_init_fence();
  __syncthreads();
  const int n0 = blockIdx.x * kHidN, m0 = blockIdx.y * kTile;
  const int n1 = cdiv(C, kBK), n2 = cdiv(Cout, kBK);
  Pos pos;
  if (threadIdx.x >= 128 * kConsumers) {
    if (threadIdx.x == 128 * kConsumers) {
      // x rows with W1's hidden rows (K-major), then dy rows with W2's
      // hidden columns (stored [C_out][H]: MN-major)
      produce_tile(r, pos, &xm, false, m0, &w1m, false, n0, 1, 0, n1);
      produce_tile(r, pos, &dym, false, m0, &w2m, true, n0, 1, 0, n2);
    }
    return;
  }
  float hacc[kHidN / 2], dacc[kHidN / 2];
  zero(hacc);
  zero(dacc);
  consume_tile<0, 0>(hacc, r, pos, n1, last16_of(0, C));
  consume_tile<0, 1>(dacc, r, pos, n2, last16_of(0, Cout));

  float colsum[kHidN / 8][2];
#pragma unroll
  for (int j = 0; j < kHidN / 8; ++j) colsum[j][0] = colsum[j][1] = 0.f;
  for_each_pair<kHidN / 8>(m0, n0, [&](int e, int m, int n) {
    if (m >= M || n >= H) return;  // H % 8 == 0: n + 1 < H too
    float av[2], gv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float hv = hacc[e + i] + fm_io::to_f(b1[n + i]);
      const float cdf = 0.5f * (1.f + erff(hv * 0.70710678118654752f));
      const float pdf = 0.39894228040143268f * expf(-0.5f * hv * hv);
      av[i] = hv * cdf;
      // g as it is stored (bf16): db1 sums what the products read
      gv[i] = fm_io::round_to<bf16>(dacc[e + i] * fmaf(hv, pdf, cdf));
      colsum[e / 4][i] += gv[i];
    }
    fm_io::store2(a_out + (size_t)m * H + n, av[0], av[1]);
    fm_io::store2(g_out + (size_t)m * H + n, gv[0], gv[1]);
  });

  // db1: the tile's column sums of g, over the 8 row groups of a warp
  // (lanes of one lane % 4), then over the 8 warps in row order
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kHidN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = colsum[j][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      colsum[j][i] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < kHidN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) red[warp * kHidN + 8 * j + 2 * lane + i] = colsum[j][i];
  }
  consumers_sync();
  const int t = threadIdx.x % kHidN, rg = threadIdx.x / kHidN;
  if (threadIdx.x < kHidN && n0 + t < H) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4 * kConsumers; ++w) v += red[w * kHidN + t];
    db1_p[(size_t)blockIdx.y * H + n0 + t] = v;
  }
  // db2: the row tile's column sums of dy; this block takes the columns
  // n0 + t + q H (t < 64, n0 + t < H, q >= 0), each summed over kGroups
  // groups of rows, then the groups in order
  float* red2 = red + 4 * kConsumers * kHidN;
  const int m_end = min(M, m0 + kTile);
  for (int c0 = n0; c0 < Cout; c0 += H) {
    const int c = c0 + t;
    const bool mine = c < Cout && n0 + t < H;
    float v = 0.f;
    if (mine)
      for (int m = m0 + rg; m < m_end; m += kGroups) v += fm_io::to_f(dy[(size_t)m * Cout + c]);
    red2[rg * kHidN + t] = v;
    consumers_sync();
    if (rg == 0 && mine) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) sum += red2[q * kHidN + t];
      db2_p[(size_t)blockIdx.y * Cout + c] = sum;
    }
    consumers_sync();
  }
}

int mlp_bwd(const bf16* x, const bf16* dy, const bf16* w1, const bf16* b1, const bf16* w2,
            bf16* a_buf, bf16* g_buf, float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
            float* dw2_p, bf16* dx, bf16* dw1, bf16* db1, bf16* dw2, bf16* db2, int M, int C,
            int H, int Cout, int slice_dx, int slice_w, cudaStream_t stream) {
  if (M < 1 || C < 1 || H < 1 || Cout < 1 || C % 8 || H % 8 || Cout % 8 || slice_dx < 1 ||
      slice_w < 1 || cdiv(M, kTile) > 65535)
    return (int)cudaErrorInvalidValue;
  const int s_dx = cdiv(H, slice_dx), s_w = cdiv(M, slice_w);
  if ((s_dx > 1 && (dx_p == nullptr || slice_dx % kBK)) ||
      (s_w > 1 && (dw1_p == nullptr || dw2_p == nullptr || slice_w % kBK)))
    return (int)cudaErrorInvalidValue;
  // the shared memory first: a runtime call makes the device's context
  // current on this thread, as cuTensorMapEncodeTiled needs (tc::mlp_bwd)
  cudaError_t err =
      cudaFuncSetAttribute(hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHidSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, dym, w1m, w2m, am, gm;
  if (!make_map(&xm, x, C, M) || !make_map(&dym, dy, Cout, M) || !make_map(&w1m, w1, C, H) ||
      !make_map(&w2m, w2, H, Cout) || !make_map(&am, a_buf, H, M) || !make_map(&gm, g_buf, H, M))
    return (int)cudaErrorInvalidValue;

  hidden_kernel<<<dim3(cdiv(H, kHidN), cdiv(M, kTile)), kThreads, kHidSmem, stream>>>(
      xm, w1m, dym, w2m, b1, dy, a_buf, g_buf, db1_p, db2_p, M, C, H, Cout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // dx (M, C) = g W1: g [row][h] K-major, W1 [h][c] MN-major; dW1 (H, C) =
  // g^T x and dW2 (C_out, H) = dy^T a: both operands [row][..], MN-major
  Products ps{};
  ps.count = 3;
  ps.p[0] = product(gm, false, w1m, true, M, C, H, slice_dx, kStore, nullptr, dx, dx_p);
  ps.p[1] = product(gm, true, xm, true, H, C, M, slice_w, kStore, nullptr, dw1, dw1_p);
  ps.p[2] = product(dym, true, am, true, Cout, H, M, slice_w, kStore, nullptr, dw2, dw2_p);
  if ((err = launch_products<1>(ps, stream)) != cudaSuccess) return (int)err;

  return (int)launch_reduce<bf16>(db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1, db1, dw2, db2, s_dx,
                                  s_w, cdiv(M, kTile), M, C, H, Cout, stream);
}

}  // namespace bf

}  // namespace

// a_buf, g_buf: (M, H) scratch. db1_p (T, H) and db2_p (T, C_out) with
// T = ceil(M / 128). dx (M, C), dw1 (H, C), dw2 (C_out, H), db1 (H,),
// db2 (C_out,) are the results. The depth of dx (H) is cut into slices of
// slice_dx and that of dW1 and dW2 (M) into slices of slice_w, both
// multiples of 32 in fp32, of 64 in bf16, where they cut; with more than
// one slice the product writes fp32 partials to dx_p (S_dx, M, C), dw1_p
// (S_w, H, C), dw2_p (S_w, C_out, H), which may be null otherwise. C, H and C_out must be multiples of 16 bytes
// (4 floats, 8 bf16) and every pointer 16-byte aligned. The _bf16 entry
// takes x, dy, the weights, b1, the a and g scratch and the results as bf16
// (the partials stay fp32). hidden_blocks and product_blocks are the fp32
// engine's persistent grids of its first two launches; the bf16 entry's
// launches size their own grids and take no notice of them.
extern "C" int fm_fused_mlp_bwd(const float* x, const float* dy, const float* w1,
                                const float* b1, const float* w2, float* a_buf, float* g_buf,
                                float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
                                float* dw2_p, float* dx, float* dw1, float* db1, float* dw2,
                                float* db2, int M, int C, int H, int Cout, int slice_dx,
                                int slice_w, int hidden_blocks, int product_blocks,
                                cudaStream_t stream) {
  return tc::mlp_bwd(x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1,
                     db1, dw2, db2, M, C, H, Cout, slice_dx, slice_w, hidden_blocks,
                     product_blocks, stream);
}
extern "C" int fm_fused_mlp_bwd_bf16(const bf16* x, const bf16* dy, const bf16* w1,
                                     const bf16* b1, const bf16* w2, bf16* a_buf, bf16* g_buf,
                                     float* db1_p, float* db2_p, float* dx_p, float* dw1_p,
                                     float* dw2_p, bf16* dx, bf16* dw1, bf16* db1, bf16* dw2,
                                     bf16* db2, int M, int C, int H, int Cout, int slice_dx,
                                     int slice_w, int, int, cudaStream_t stream) {
  return bf::mlp_bwd(x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p, dx, dw1,
                     db1, dw2, db2, M, C, H, Cout, slice_dx, slice_w, stream);
}
