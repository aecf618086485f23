// Depthwise 3x3 SAME convolution + bias (+ SiLU) for Hopper (sm_90a), NHWC, fp32
// or bf16 x and output (every sum fp32 either way; the weight and the bias
// fp32, or in the bf16 entry bf16 where `params` is 1).
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
// same kernel with scalar, masked loads and stores (VEC = false).
//
// bf16 I/O has a kernel of its own (dwconv3x3_fwd_kernel_bf16): the same
// tile and walk, but the tile is staged as bf16, by 8-byte cp.async (a quad
// of channels) straight from device memory, every row of a thread's column
// in flight before one commit and one wait, while the weights load. The
// tile takes half the shared memory of fp32's, which lets the plan take
// taller tiles (less halo), and each staged row is widened to fp32 as it is
// read from shared memory (3 loads of 8 bytes). After the staging the walk
// and the arithmetic are the fp32 kernel's (the tap order, the fused
// multiply-adds, the bias, the SiLU) on the same fp32 values, so the output,
// rounded to bf16 as it is stored, has the bits of the fp32-staged design it
// replaced. The weight and the bias may be bf16 (a
// bf16 step's casts, passed without a cast of their own), widened as they
// are loaded: exactly, so the output is that of their fp32 casts. C not a
// multiple of 4, or an x or out off an 8-byte boundary, takes masked scalar
// staging and stores (VEC = false). (Timed and dropped, PERF.md section 6: 8
// channels a thread by 16-byte copies across half as many threads, 41-66%
// slower at the training step's shapes; a walk that skips the halo rows'
// unstored taps and loads the next row ahead, 9% slower.)
#include "io_types.cuh"

namespace {

using fm_io::bf16;
using fm_io::from_f;
using fm_io::param;

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

// 4 bf16 (two 32-bit words of two each) as fp32
__device__ __forceinline__ float4 unpack(uint32_t lo, uint32_t hi) {
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float epilogue(float v, float b, int act_silu) {
  v += b;
  return act_silu ? __fdividef(v, 1.f + __expf(-v)) : v;
}

template <int CQ, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dwconv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                     int C, int TW, int TH, int h_tiles, int act_silu) {
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
    const float* src = x + img + (h0 - 1) * row + col * C + c;
    float4* dst = tile + j * CQ + q;
    for (int k = 0; k < TH + 2; ++k, src += row, dst += ld) {
      const int hh = h0 - 1 + k;
      if (!col_ok || hh < 0 || hh >= H) {
        *dst = zero;
      } else if (VEC) {
        cp_async_16(dst, src);
      } else {
        float4 v;
        v.x = src[0];
        v.y = c + 1 < C ? src[1] : 0.f;
        v.z = c + 2 < C ? src[2] : 0.f;
        v.w = c + 3 < C ? src[3] : 0.f;
        *dst = v;
      }
    }
  };
  stage(tw + 1, wi);
  if (tw == 0) stage(0, w0 - 1);
  if (tw == TW - 1) stage(TW + 1, w0 + TW);
  if (VEC) {
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
  float* dst = out + img + (h0 - 2) * row + wi * C + c;
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
        dst[0] = r.x;
        if (c + 1 < C) dst[1] = r.y;
        if (c + 2 < C) dst[2] = r.z;
        if (c + 3 < C) dst[3] = r.w;
      }
    }
    a0 = a1;
    a1 = a2;
  }
}

// copy the 4 bf16 channels at src (8 bytes) into shared memory, through L1
__device__ __forceinline__ void cp_async_8(uint2* dst, const bf16* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

// the 4 bf16 channels at src as a staged word, zeros from channel n on
__device__ __forceinline__ uint2 load_masked(const bf16* src, int n) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
  const uint32_t e0 = u[0], e1 = n > 1 ? u[1] : 0u, e2 = n > 2 ? u[2] : 0u, e3 = n > 3 ? u[3] : 0u;
  return make_uint2(e0 | e1 << 16, e2 | e3 << 16);
}

// BP: the weight and the bias are bf16 (else fp32); a template parameter,
// so that their 40 loads issue together (a runtime branch at each load cost
// the bf16 #8, which loads them alike, 3%: PERF.md, section 6)
template <int CQ, bool VEC, bool BP>
__global__ void __launch_bounds__(kMaxThreads)
dwconv3x3_fwd_kernel_bf16(const bf16* __restrict__ x, const void* __restrict__ w,
                          const void* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                          int C, int TW, int TH, int h_tiles, int act_silu) {
  extern __shared__ uint2 staged[];  // [TH + 2][TW + 2][CQ] quads of bf16 channels
  const int tid = threadIdx.x;
  const int q = tid % CQ, tw = tid / CQ;
  const int c = (blockIdx.x * CQ + q) * 4;
  const int w0 = blockIdx.y * TW;
  const int b = blockIdx.z / h_tiles;
  const int h0 = (blockIdx.z - b * h_tiles) * TH;
  const int wi = w0 + tw;
  const int row = W * C;            // elements from one image row to the next
  const int img = b * H * row;      // this image's first element
  const int ld = (TW + 2) * CQ;     // quads from one staged row to the next
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage x column `col` (all TH + 2 rows) into tile column j
  auto stage = [&](int j, int col) {
    const bool col_ok = col >= 0 && col < W && c < C;
    const bf16* src = x + img + (h0 - 1) * row + col * C + c;
    uint2* dst = staged + j * CQ + q;
    for (int k = 0; k < TH + 2; ++k, src += row, dst += ld) {
      const int hh = h0 - 1 + k;
      if (!col_ok || hh < 0 || hh >= H) {
        *dst = make_uint2(0u, 0u);
      } else if (VEC) {
        cp_async_8(dst, src);
      } else {
        *dst = load_masked(src, C - c);
      }
    }
  };
  stage(tw + 1, wi);
  if (tw == 0) stage(0, w0 - 1);
  if (tw == TW - 1) stage(TW + 1, w0 + TW);
  if (VEC) asm volatile("cp.async.commit_group;\n" ::);

  // the weights and the bias load while the copies are in flight
  float4 wt[9], bv = zero;  // wt[i * 3 + j]: the tap (i, j) of the 4 channels
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = zero;
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].x = param(w, c * 9 + t, BP);
    if (bias) bv.x = param(bias, c, BP);
  }
  if (c + 1 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].y = param(w, c * 9 + 9 + t, BP);
    if (bias) bv.y = param(bias, c + 1, BP);
  }
  if (c + 2 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].z = param(w, c * 9 + 18 + t, BP);
    if (bias) bv.z = param(bias, c + 2, BP);
  }
  if (c + 3 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].w = param(w, c * 9 + 27 + t, BP);
    if (bias) bv.w = param(bias, c + 3, BP);
  }
  if (VEC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (wi >= W || c >= C) return;

  // the fp32 kernel's walk, each staged row widened as it is read
  float4 a0 = zero, a1 = zero;
  const uint2* src = staged + tw * CQ + q;
  bf16* dst = out + img + (h0 - 2) * row + wi * C + c;
  for (int k = 0; k < TH + 2; ++k, src += ld, dst += row) {
    const uint2 p0 = src[0], p1 = src[CQ], p2 = src[2 * CQ];
    const float4 v0 = unpack(p0.x, p0.y), v1 = unpack(p1.x, p1.y), v2 = unpack(p2.x, p2.y);
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
        dst[0] = from_f<bf16>(r.x);
        if (c + 1 < C) dst[1] = from_f<bf16>(r.y);
        if (c + 2 < C) dst[2] = from_f<bf16>(r.z);
        if (c + 3 < C) dst[3] = from_f<bf16>(r.w);
      }
    }
    a0 = a1;
    a1 = a2;
  }
}

template <int CQ>
int launch(bool vec, dim3 grid, int threads, int smem, cudaStream_t stream, const float* x,
           const float* w, const float* bias, float* out, int H, int W, int C, int tw, int th,
           int h_tiles, int act_silu) {
  if (vec) {
    dwconv3x3_fwd_kernel<CQ, true><<<grid, threads, smem, stream>>>(
        x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
  } else {
    dwconv3x3_fwd_kernel<CQ, false><<<grid, threads, smem, stream>>>(
        x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
  }
  return (int)cudaGetLastError();
}

template <int CQ>
int launch_bf16(bool vec, dim3 grid, int threads, int smem, cudaStream_t stream, const bf16* x,
                const void* w, const void* bias, bf16* out, int H, int W, int C, int tw, int th,
                int h_tiles, int act_silu, int params) {
  auto kernel = vec ? (params ? dwconv3x3_fwd_kernel_bf16<CQ, true, true>
                              : dwconv3x3_fwd_kernel_bf16<CQ, true, false>)
                    : (params ? dwconv3x3_fwd_kernel_bf16<CQ, false, true>
                              : dwconv3x3_fwd_kernel_bf16<CQ, false, false>);
  kernel<<<grid, threads, smem, stream>>>(x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
  return (int)cudaGetLastError();
}

// Whether the tile (4 * cq channels, tw columns, th rows of `quad_bytes` a
// staged quad of channels) and the grid are those dwconv.py::fwd_plan lays
// out for the shape; h_tiles, smem: the row tiles of an image and the
// shared memory of a block.
bool plan_ok(int B, int H, int W, int C, int cq, int quad_bytes, int tw, int th, int grid_x,
             int grid_y, int grid_z, int& h_tiles, int& smem) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (long long)B * H * W * C >= (1ll << 31) || tw < 1 ||
      th < 1 || cq * tw > kMaxThreads) {
    return false;
  }
  h_tiles = (H + th - 1) / th;
  smem = (th + 2) * (tw + 2) * cq * quad_bytes;
  return grid_x == (C + 4 * cq - 1) / (4 * cq) && grid_y == (W + tw - 1) / tw &&
         grid_z == B * h_tiles && grid_z <= 65535 && smem <= kMaxSmem;
}

}  // namespace

// cq, tw, th: the tile (4*cq channels, tw columns, th rows); grid_*: the
// grid, which must cover the output exactly as dwconv.py::fwd_plan lays it
// out: (channel blocks, column tiles, B x row tiles). The _bf16 entry takes
// x and out as bf16, and w and bias as bf16 where params is 1 (the fp32
// entry takes only 0).
extern "C" int fm_dwconv3x3_fwd(const float* x, const float* w, const float* bias, float* out,
                                int B, int H, int W, int C, int act_silu, int cq, int tw, int th,
                                int grid_x, int grid_y, int grid_z, int params,
                                cudaStream_t stream) {
  int h_tiles, smem;
  if (params || !plan_ok(B, H, W, C, cq, (int)sizeof(float4), tw, th, grid_x, grid_y, grid_z,
                         h_tiles, smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = C % 4 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const dim3 grid(grid_x, grid_y, grid_z);
  const int threads = cq * tw;
  switch (cq) {
    case 1: return launch<1>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 2: return launch<2>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 4: return launch<4>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 8: return launch<8>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    case 16: return launch<16>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu);
    default: return (int)cudaErrorInvalidValue;
  }
}
extern "C" int fm_dwconv3x3_fwd_bf16(const bf16* x, const void* w, const void* bias, bf16* out,
                                     int B, int H, int W, int C, int act_silu, int cq, int tw,
                                     int th, int grid_x, int grid_y, int grid_z, int params,
                                     cudaStream_t stream) {
  int h_tiles, smem;
  if (!plan_ok(B, H, W, C, cq, (int)sizeof(uint2), tw, th, grid_x, grid_y, grid_z, h_tiles,
               smem)) {
    return (int)cudaErrorInvalidValue;
  }
  // 4 channels a thread: 8 bytes
  const bool vec = C % 4 == 0 && ((uintptr_t)x & 7) == 0 && ((uintptr_t)out & 7) == 0;
  const dim3 grid(grid_x, grid_y, grid_z);
  const int threads = cq * tw;
  switch (cq) {
    case 1: return launch_bf16<1>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu, params);
    case 2: return launch_bf16<2>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu, params);
    case 4: return launch_bf16<4>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu, params);
    case 8: return launch_bf16<8>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu, params);
    case 16: return launch_bf16<16>(vec, grid, threads, smem, stream, x, w, bias, out, H, W, C, tw, th, h_tiles, act_silu, params);
    default: return (int)cudaErrorInvalidValue;
  }
}
