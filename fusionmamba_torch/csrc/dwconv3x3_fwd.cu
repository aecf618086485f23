// Depthwise 3x3 SAME convolution + bias (+ SiLU) for Hopper (sm_90a), NHWC, fp32
// or bf16 x and output (weight, bias and every sum fp32 either way).
//
// Replaces fusionmamba_tpu/ops/dwconv_pallas.py::_fwd_kernel (built by
// _fwd_pallas): out[b,h,w,c] = act(sum_{i,j} x[b,h+i-1,w+j-1,c] * w[c,i,j] + bias[c])
// with zero-filled borders. The weight is in torch's layout, (C, 3, 3).
//
// What bounds it: bytes. Each output needs nine multiply-adds, and device
// memory need see only one read of x and one write of the output, so the
// nine reads of each input element have to come from on-chip memory, and
// the instructions around them must not outnumber what the bytes allow.
//
// Design. A block owns a tile of TH rows x TW columns x 4*CQ channels of one
// image; a thread owns 4 neighbouring channels of one column and moves them
// as one 16-byte float4 (CQ threads cover the block's channels at a pixel,
// so a warp reads whole 16-byte-aligned runs of a row). The block first
// stages the (TH+2) x (TW+2) tile of x, halo included, into shared memory
// with 16-byte cp.async: each thread copies its own column down the tile
// and the two edge threads the halo columns; places outside the image (and
// channels past C) are written as zeros, so the taps need no bounds tests.
// Then each thread walks down its column: every staged row is read once, as
// 3 float4 from shared memory, and feeds the three output rows it touches
// (weight row 0 of the output below, 1 of this row's, 2 of the one above),
// whose three float4 sums live in registers; the finished row is stored as
// one float4. The taps reach each output in the order i, then j, as in the
// plain version. Weights (36 floats) and bias (4) stay in registers. All
// index arithmetic is 32-bit and done once per block and thread (the entry
// point rejects tensors of 2^31 elements or more). SiLU takes __expf and the
// fast division (__fdividef), whose error stays far inside the 1e-4
// tolerance. The tile sizes and the grid come from the Python wrapper
// (fusionmamba_torch/ops/dwconv.py::fwd_plan); this file checks them.
// C not a multiple of 4, or an x or out not aligned to 4 elements, takes the
// same kernel with scalar, masked loads and stores (VEC = false). With bf16
// I/O a thread's 4 channels are 8 bytes: the tile is staged as fp32 (each
// value converted as it is loaded, by plain loads, since cp.async cannot
// convert), so everything after the staging is the fp32 kernel's, and the
// output is rounded to bf16 as it is stored.
#include "io_types.cuh"

namespace {

using fm_io::from_f;
using fm_io::to_f;

constexpr int kMaxThreads = 128;
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ void cp_async_16(float4* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// acc += v0 * w[0] + v1 * w[1] + v2 * w[2], channel by channel, in that order
__device__ __forceinline__ void taps(float4& acc, const float4& v0, const float4& v1,
                                     const float4& v2, const float4* w) {
  acc.x = fmaf(v2.x, w[2].x, fmaf(v1.x, w[1].x, fmaf(v0.x, w[0].x, acc.x)));
  acc.y = fmaf(v2.y, w[2].y, fmaf(v1.y, w[1].y, fmaf(v0.y, w[0].y, acc.y)));
  acc.z = fmaf(v2.z, w[2].z, fmaf(v1.z, w[1].z, fmaf(v0.z, w[0].z, acc.z)));
  acc.w = fmaf(v2.w, w[2].w, fmaf(v1.w, w[1].w, fmaf(v0.w, w[0].w, acc.w)));
}

__device__ __forceinline__ float epilogue(float v, float b, int act_silu) {
  v += b;
  return act_silu ? __fdividef(v, 1.f + __expf(-v)) : v;
}

template <class IO, int CQ, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dwconv3x3_fwd_kernel(const IO* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, IO* __restrict__ out, int H, int W,
                     int C, int TW, int TH, int h_tiles, int act_silu) {
  constexpr bool kFloatIO = sizeof(IO) == sizeof(float);
  extern __shared__ float4 tile[];  // [TH + 2][TW + 2][CQ]
  const int tid = threadIdx.x;
  const int q = tid % CQ, tw = tid / CQ;
  const int c = (blockIdx.x * CQ + q) * 4;
  const int w0 = blockIdx.y * TW;
  const int b = blockIdx.z / h_tiles;
  const int h0 = (blockIdx.z - b * h_tiles) * TH;
  const int wi = w0 + tw;
  const int row = W * C;            // elements from one image row to the next
  const int img = b * H * row;      // this image's first element
  const int ld = (TW + 2) * CQ;     // float4s from one staged row to the next
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage x column `col` (all TH + 2 rows) into tile column j
  auto stage = [&](int j, int col) {
    const bool col_ok = col >= 0 && col < W && c < C;
    const IO* src = x + img + (h0 - 1) * row + col * C + c;
    float4* dst = tile + j * CQ + q;
    for (int k = 0; k < TH + 2; ++k, src += row, dst += ld) {
      const int hh = h0 - 1 + k;
      if (!col_ok || hh < 0 || hh >= H) {
        *dst = zero;
      } else if (VEC && kFloatIO) {
        cp_async_16(dst, reinterpret_cast<const float*>(src));
      } else if (VEC) {
        *dst = fm_io::load4(src);
      } else {
        float4 v;
        v.x = to_f(src[0]);
        v.y = c + 1 < C ? to_f(src[1]) : 0.f;
        v.z = c + 2 < C ? to_f(src[2]) : 0.f;
        v.w = c + 3 < C ? to_f(src[3]) : 0.f;
        *dst = v;
      }
    }
  };
  stage(tw + 1, wi);
  if (tw == 0) stage(0, w0 - 1);
  if (tw == TW - 1) stage(TW + 1, w0 + TW);
  if (VEC && kFloatIO) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }

  float4 wt[9], bv = zero;  // wt[i * 3 + j]: the tap (i, j) of the 4 channels
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = zero;
  const float* wc = w + c * 9;
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].x = wc[t];
    if (bias) bv.x = bias[c];
  }
  if (c + 1 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].y = wc[9 + t];
    if (bias) bv.y = bias[c + 1];
  }
  if (c + 2 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].z = wc[18 + t];
    if (bias) bv.z = bias[c + 2];
  }
  if (c + 3 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].w = wc[27 + t];
    if (bias) bv.w = bias[c + 3];
  }
  __syncthreads();
  if (wi >= W || c >= C) return;

  // staged row k feeds output rows k (weight row 0), k - 1 (row 1), k - 2
  // (row 2); a0, a1, a2 hold the sums of outputs k - 2, k - 1, k
  float4 a0 = zero, a1 = zero;
  const float4* src = tile + tw * CQ + q;
  IO* dst = out + img + (h0 - 2) * row + wi * C + c;
  for (int k = 0; k < TH + 2; ++k, src += ld, dst += row) {
    const float4 v0 = src[0], v1 = src[CQ], v2 = src[2 * CQ];
    float4 a2 = zero;
    taps(a2, v0, v1, v2, wt);
    taps(a1, v0, v1, v2, wt + 3);
    taps(a0, v0, v1, v2, wt + 6);
    if (k >= 2 && h0 + k - 2 < H) {
      const float4 r = make_float4(epilogue(a0.x, bv.x, act_silu), epilogue(a0.y, bv.y, act_silu),
                                   epilogue(a0.z, bv.z, act_silu), epilogue(a0.w, bv.w, act_silu));
      if (VEC) {
        fm_io::store4(dst, r);
      } else {
        dst[0] = from_f<IO>(r.x);
        if (c + 1 < C) dst[1] = from_f<IO>(r.y);
        if (c + 2 < C) dst[2] = from_f<IO>(r.z);
        if (c + 3 < C) dst[3] = from_f<IO>(r.w);
      }
    }
    a0 = a1;
    a1 = a2;
  }
}

template <class IO, int CQ>
int launch(bool vec, dim3 grid, int threads, int smem, cudaStream_t stream, const IO* x,
           const float* w, const float* bias, IO* out, int H, int W, int C, int tw, int th,
           int h_tiles, int act_silu) {
  if (vec) {
    dwconv3x3_fwd_kernel<IO, CQ, true><<<grid, threads, smem, stream>>>(
        x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
  } else {
    dwconv3x3_fwd_kernel<IO, CQ, false><<<grid, threads, smem, stream>>>(
        x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
  }
  return (int)cudaGetLastError();
}

template <class IO>
int dwconv3x3_fwd(const IO* x, const float* w, const float* bias, IO* out, int B, int H, int W,
                  int C, int act_silu, int cq, int tw, int th, int grid_x, int grid_y,
                  int grid_z, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (long long)B * H * W * C >= (1ll << 31) || tw < 1 ||
      th < 1 || cq * tw > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int h_tiles = (H + th - 1) / th;
  const int smem = (th + 2) * (tw + 2) * cq * (int)sizeof(float4);
  if (grid_x != (C + 4 * cq - 1) / (4 * cq) || grid_y != (W + tw - 1) / tw ||
      grid_z != B * h_tiles || grid_z > 65535 || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  // 4 elements a thread: 16 bytes in fp32, 8 in bf16
  const uintptr_t align = 4 * sizeof(IO) - 1;
  const bool vec = C % 4 == 0 && ((uintptr_t)x & align) == 0 && ((uintptr_t)out & align) == 0;
  const dim3 grid(grid_x, grid_y, grid_z);
  const int threads = cq * tw;
  switch (cq) {
    case 1: return launch<IO, 1>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 2: return launch<IO, 2>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 4: return launch<IO, 4>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 8: return launch<IO, 8>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 16: return launch<IO, 16>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cq, tw, th: the tile (4*cq channels, tw columns, th rows); grid_*: the
// grid, which must cover the output exactly as dwconv.py::fwd_plan lays it
// out: (channel blocks, column tiles, B x row tiles). The _bf16 entry takes
// x and out as bf16.
extern "C" int fm_dwconv3x3_fwd(const float* x, const float* w, const float* bias, float* out,
                                int B, int H, int W, int C, int act_silu, int cq, int tw, int th,
                                int grid_x, int grid_y, int grid_z, cudaStream_t stream) {
  return dwconv3x3_fwd(x, w, bias, out, B, H, W, C, act_silu, cq, tw, th, grid_x, grid_y, grid_z,
                       stream);
}
extern "C" int fm_dwconv3x3_fwd_bf16(const fm_io::bf16* x, const float* w, const float* bias,
                                     fm_io::bf16* out, int B, int H, int W, int C, int act_silu,
                                     int cq, int tw, int th, int grid_x, int grid_y, int grid_z,
                                     cudaStream_t stream) {
  return dwconv3x3_fwd(x, w, bias, out, B, H, W, C, act_silu, cq, tw, th, grid_x, grid_y, grid_z,
                       stream);
}
