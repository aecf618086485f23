// Depthwise 3x3 SAME convolution + bias (+ SiLU) backward for Hopper (sm_90a), NHWC,
// fp32 or bf16 x, dy and dx (dw, dbias and every sum fp32 either way; the
// weight and the bias fp32, or in the bf16 entry bf16 where `params` is 1,
// widened as they are loaded).
//
// Replaces fusionmamba_tpu/ops/dwconv_pallas.py::_bwd_kernel (built by
// _bwd_pallas). The forward (dwconv3x3_fwd.cu) is
//   pre[b,h,w,c] = sum_{i,j} x[b,h+i-1,w+j-1,c] * w[c,i,j] + bias[c],  out = act(pre).
// Given dy, with dz = dy * act'(pre) (dz = dy when act is none):
//   dx[b,h,w,c] = sum_{i,j} dz[b,h+1-i,w+1-j,c] * w[c,i,j]
//   dw[c,i,j]   = sum_{b,h,w} dz[b,h,w,c] * x[b,h+i-1,w+j-1,c],  dbias[c] = sum dz[..., c].
// pre is recomputed from x, w and bias, never stored.
//
// What bounds it: bytes (x and dy read once, dx written once), with some 60
// flops an element, so the many reads of each element must come from
// on-chip memory and the instructions around them must stay few.
//
// Design. A block owns 4*CQ channels (blockIdx.x) and walks tiles of TH rows
// x TW columns of the images in a grid-stride loop (blockIdx.y). A thread owns
// 4 neighbouring channels of one column and moves them as one 16-byte float4.
// For each tile the block stages, by 16-byte cp.async, x with a halo of 2
// ((TH+4) x (TW+4); a halo of 1 when act is none, which needs no pre) and dy
// with a halo of 1 ((TH+2) x (TW+2)) into shared memory, zeros outside the
// image and past C, so no tap needs a bounds test; each thread copies its
// own column of both, six threads of each channel quad the halo columns.
// With SiLU, dz is then computed once for every position of the haloed dy
// tile, in place: a thread walks down its own column of it, reading each
// staged x row once (3 float4) into the three pre rows it touches, as the
// forward does, and the two halo columns are spread over the threads a
// position each. Then each thread walks
// down its output column once: every dz row (3 float4) feeds the three dx
// rows it touches, whose sums stay in registers, and every x row (3 float4)
// meets the dz of the three outputs it touches in the 9 dw sums; dw and dbias
// (10 float4) stay in registers over all the block's tiles. At the end the
// block sums its columns' dw and dbias in column order into one (10, 4*CQ)
// slice of its (10, C) partial, and a second kernel sums the partials, 8
// interleaved slices in order and then the slices in order. No atomics, so
// two launches give the same bits. The tile, the grid and the shared memory
// come from the Python wrapper (fusionmamba_torch/ops/dwconv.py::bwd_plan);
// this file checks them. C not a multiple of 4, or an x, dy or dx not aligned
// to 4 elements, takes the same kernel with scalar, masked loads and stores
// (VEC = false). All index arithmetic is 32-bit (the entry point rejects
// tensors of 2^31 elements or more).
//
// bf16 I/O has a design of its own (dwconv3x3_bwd_kernel_bf16): the same
// walk, tiles and arithmetic, but x and dy are staged as bf16, by 8-byte
// cp.async (a quad of channels) straight from device memory, and converted
// to fp32 as they are read from shared memory. dz stays fp32, as the plain
// version computes it, in a tile of its own (the staged dy is bf16). The
// sums, dw and dbias stay fp32, and dx is rounded to bf16 as it is stored.
// The weight and the bias may be bf16 (a bf16 step's casts, read without a
// cast of their own): widened as they are loaded, exactly, so the results
// are those of their fp32 casts.
#include "io_types.cuh"

namespace {

using fm_io::from_f;
using fm_io::param;

constexpr int kMaxThreads = 128;
constexpr int kMaxSmem = 227 * 1024;  // the most a block can opt in to on the H100
constexpr int kReduceCols = 32;       // the reduce kernel: columns of a block
constexpr int kReduceSlices = 8;      // and interleaved slices of the partials

__device__ __forceinline__ void cp_async_16(float4* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_8(uint2* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a, const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

// acc += v0 * w[0] + v1 * w[1] + v2 * w[2], channel by channel, in that order
__device__ __forceinline__ void taps(float4& acc, const float4& v0, const float4& v1,
                                     const float4& v2, const float4* w) {
  fma4(acc, v0, w[0]);
  fma4(acc, v1, w[1]);
  fma4(acc, v2, w[2]);
}

// dy * silu'(pre + b), silu'(v) = s (1 + v (1 - s)), s = sigmoid(v)
__device__ __forceinline__ float dsilu(float g, float pre, float b) {
  const float v = pre + b;
  const float s = __fdividef(1.f, 1.f + __expf(-v));  // 0 where __expf(-v) is inf
  return g * s * (1.f + v * (1.f - s));
}

// Stage column ww of an image (channels c..c+3), window rows k0..k1-1,
// into dst (the window's column, one float4 a row, ld float4s apart); row k
// of the window is image row r0 + k. Zeros outside the image and past C.
template <bool VEC>
__device__ __forceinline__ void stage_col(float4* dst, int ld, const float* img, int k0, int k1,
                                          int r0, int ww, int H, int W, int C, int c) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool col_ok = ww >= 0 && ww < W && c < C;
  const float* src = img + ((r0 + k0) * W + ww) * C + c;
  dst += k0 * ld;
  for (int k = k0; k < k1; ++k, src += W * C, dst += ld) {
    const int hh = r0 + k;
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
}

// Four blocks an SM (the plan's grid where shared memory allows): it caps
// registers at 128, against 135 left to itself (three blocks an SM, which
// timed slower on the card); ptxas then spills 4 bytes in some variants.
template <int CQ, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 4)
dwconv3x3_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ part, int B, int H, int W, int C,
                     int TW, int TH, int act_silu) {
  extern __shared__ float4 smem[];
  const int q = threadIdx.x % CQ, tw = threadIdx.x / CQ;
  const int c0 = blockIdx.x * 4 * CQ, c = c0 + 4 * q;
  const int XW = TW + 4, ZW = TW + 2;  // columns of the staged x and dz tiles
  float4* xs = smem;                   // [TH + 4][TW + 4][CQ], image rows h0-2.., cols w0-2..
  float4* zs = smem + (TH + 4) * XW * CQ;  // [TH + 2][TW + 2][CQ], rows h0-1.., cols w0-1..
  const int h_tiles = (H + TH - 1) / TH, w_tiles = (W + TW - 1) / TW;
  const int tiles = B * h_tiles * w_tiles;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 wt[9];  // wt[i * 3 + j]: the tap (i, j) of the 4 channels
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = zero;
  const float* wc = w + c * 9;
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].x = wc[t];
  }
  if (c + 1 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].y = wc[9 + t];
  }
  if (c + 2 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].z = wc[18 + t];
  }
  if (c + 3 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].w = wc[27 + t];
  }
  float4 dw[9], db = zero;  // dw[i * 3 + j]
#pragma unroll
  for (int t = 0; t < 9; ++t) dw[t] = zero;

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int b = tile / (h_tiles * w_tiles), rem = tile - b * h_tiles * w_tiles;
    const int h0 = rem / w_tiles * TH, w0 = rem % w_tiles * TW;
    const int img = b * H * W * C;
    __syncthreads();  // the previous tile's reads of shared memory are done
    // each thread stages its own column of both tiles; the six halo columns
    // (x: 0, 1, TW+2, TW+3; dy: 0, TW+1) go to threads 0..5 of each channel
    // quad, x's outer ring only with SiLU
    const int k_lo = act_silu ? 0 : 1, k_hi = act_silu ? TH + 4 : TH + 3;
    stage_col<VEC>(xs + (tw + 2) * CQ + q, XW * CQ, x + img, k_lo, k_hi, h0 - 2, w0 + tw, H, W,
                   C, c);
    stage_col<VEC>(zs + (tw + 1) * CQ + q, ZW * CQ, dy + img, 0, TH + 2, h0 - 1, w0 + tw, H, W,
                   C, c);
    for (int j = tw; j < 6; j += TW) {
      if (j < 4) {
        const int col = j < 2 ? j : TW + j;  // 0, 1, TW+2, TW+3
        if (act_silu || (col != 0 && col != TW + 3)) {
          stage_col<VEC>(xs + col * CQ + q, XW * CQ, x + img, k_lo, k_hi, h0 - 2, w0 - 2 + col,
                         H, W, C, c);
        }
      } else {
        const int col = j == 4 ? 0 : TW + 1;
        stage_col<VEC>(zs + col * CQ + q, ZW * CQ, dy + img, 0, TH + 2, h0 - 1, w0 - 1 + col, H,
                       W, C, c);
      }
    }
    if (VEC) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    if (act_silu) {
      // dz over the haloed tile, in place of dy. Column cc of zs is image
      // column w0-1+cc, whose pre reads x columns cc..cc+2. A thread walks
      // its own output's column, cc = tw+1: staged x row k feeds pre rows k
      // (weight row 0), k-1 (row 1), k-2 (row 2). The halo columns 0 and
      // TW+1 are spread over the threads of the same channels, a position
      // each, its 9 taps read straight from the tile. (The bias is read here
      // each tile rather than held beside the sums.)
      float4 bv = zero;
      if (bias) {
        if (c < C) bv.x = bias[c];
        if (c + 1 < C) bv.y = bias[c + 1];
        if (c + 2 < C) bv.z = bias[c + 2];
        if (c + 3 < C) bv.w = bias[c + 3];
      }
      {
        const float4* src = xs + (tw + 1) * CQ + q;
        float4* z = zs + (tw + 1) * CQ + q;
        float4 a0 = zero, a1 = zero;  // pre of rows k-2, k-1
        for (int k = 0; k < TH + 4; ++k, src += XW * CQ) {
          const float4 v0 = src[0], v1 = src[CQ], v2 = src[2 * CQ];
          float4 a2 = zero;
          taps(a2, v0, v1, v2, wt);
          taps(a1, v0, v1, v2, wt + 3);
          taps(a0, v0, v1, v2, wt + 6);
          if (k >= 2) {
            float4& g = z[(k - 2) * ZW * CQ];
            const float4 gv = g;
            g = make_float4(dsilu(gv.x, a0.x, bv.x), dsilu(gv.y, a0.y, bv.y),
                            dsilu(gv.z, a0.z, bv.z), dsilu(gv.w, a0.w, bv.w));
          }
          a0 = a1;
          a1 = a2;
        }
      }
      for (int j = tw; j < 2 * (TH + 2); j += TW) {
        const int r = j >> 1, cc = (j & 1) * (TW + 1);
        const float4* src = xs + (r * XW + cc) * CQ + q;
        float4 a = zero;
#pragma unroll
        for (int i = 0; i < 3; ++i, src += XW * CQ) taps(a, src[0], src[CQ], src[2 * CQ], wt + 3 * i);
        float4& g = zs[(r * ZW + cc) * CQ + q];
        const float4 gv = g;
        g = make_float4(dsilu(gv.x, a.x, bv.x), dsilu(gv.y, a.y, bv.y), dsilu(gv.z, a.z, bv.z),
                        dsilu(gv.w, a.w, bv.w));
      }
      __syncthreads();
    }

    // This thread's output column w0+tw. dz row rr (image row h0-1+rr)
    // feeds dx rows t = rr (weight row 2), rr-1 (row 1), rr-2 (row 0), its
    // columns tw, tw+1, tw+2 the taps j = 2, 1, 0. Staged x row rr (image row
    // h0-2+rr), columns tw+1..tw+3 (taps j = 0, 1, 2), meets the dz of
    // outputs t = rr-1 (i = 0), rr-2 (i = 1), rr-3 (i = 2).
    const float4* zr = zs + tw * CQ + q;
    const float4* xr = xs + (tw + 1) * CQ + q;
    float* out = dx + img + ((h0 - 2) * W + w0 + tw) * C + c;
    const bool col_ok = w0 + tw < W && c < C;
    float4 d0 = zero, d1 = zero;  // dx sums of rows rr-2, rr-1
    float4 z1 = zero, z2 = zero;  // dz of outputs rr-2, rr-3
    for (int rr = 0; rr < TH + 3; ++rr, zr += ZW * CQ, xr += XW * CQ, out += W * C) {
      float4 z0 = zero;  // dz of output rr-1
      if (rr < TH + 2) {
        const float4 v0 = zr[0], v1 = zr[CQ], v2 = zr[2 * CQ];
        float4 d2 = zero;
        taps(d2, v2, v1, v0, wt + 6);
        taps(d1, v2, v1, v0, wt + 3);
        taps(d0, v2, v1, v0, wt);
        if (rr >= 2 && h0 + rr - 2 < H && col_ok) {
          if (VEC) {
            fm_io::store4(out, d0);
          } else {
            out[0] = d0.x;
            if (c + 1 < C) out[1] = d0.y;
            if (c + 2 < C) out[2] = d0.z;
            if (c + 3 < C) out[3] = d0.w;
          }
        }
        d0 = d1;
        d1 = d2;
        if (rr >= 1 && rr <= TH) z0 = v1;
      }
      if (rr >= 1) {  // x row 0 meets no output (and is not staged without SiLU)
        const float4 u0 = xr[0], u1 = xr[CQ], u2 = xr[2 * CQ];
        fma4(dw[0], z0, u0);
        fma4(dw[1], z0, u1);
        fma4(dw[2], z0, u2);
        fma4(dw[3], z1, u0);
        fma4(dw[4], z1, u1);
        fma4(dw[5], z1, u2);
        fma4(dw[6], z2, u0);
        fma4(dw[7], z2, u1);
        fma4(dw[8], z2, u2);
        db.x += z0.x;
        db.y += z0.y;
        db.z += z0.z;
        db.w += z0.w;
      }
      z2 = z1;
      z1 = z0;
    }
  }

  // the block's partial: its columns' sums, in column order
  __syncthreads();
  float4* red = smem;  // [TW][10][CQ]
#pragma unroll
  for (int t = 0; t < 9; ++t) red[(tw * 10 + t) * CQ + q] = dw[t];
  red[(tw * 10 + 9) * CQ + q] = db;
  __syncthreads();
  for (int item = threadIdx.x; item < 10 * CQ; item += blockDim.x) {
    const int k = item / CQ, qq = item % CQ, cc = c0 + 4 * qq;
    float4 s = red[k * CQ + qq];
    for (int i = 1; i < TW; ++i) {
      const float4 v = red[(i * 10 + k) * CQ + qq];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float* p = part + (blockIdx.y * 10 + k) * C + cc;
    if (cc < C) p[0] = s.x;
    if (cc + 1 < C) p[1] = s.y;
    if (cc + 2 < C) p[2] = s.z;
    if (cc + 3 < C) p[3] = s.w;
  }
}

// 4 bf16 as 8 bytes, as fp32
__device__ __forceinline__ float4 unpack(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

// Stage column ww of a bf16 image (channels c..c+3), window rows k0..k1-1,
// into dst as bf16 quads (ld quads apart), as stage_col does for fp32: by
// 8-byte cp.async (VEC), else by masked scalar loads; zeros outside the image
// and past C.
template <bool VEC>
__device__ __forceinline__ void stage_col_bf16(uint2* dst, int ld, const fm_io::bf16* img, int k0,
                                               int k1, int r0, int ww, int H, int W, int C,
                                               int c) {
  const bool col_ok = ww >= 0 && ww < W && c < C;
  const fm_io::bf16* src = img + ((r0 + k0) * W + ww) * C + c;
  dst += k0 * ld;
  for (int k = k0; k < k1; ++k, src += W * C, dst += ld) {
    const int hh = r0 + k;
    if (!col_ok || hh < 0 || hh >= H) {
      *dst = make_uint2(0u, 0u);
    } else if (VEC) {
      cp_async_8(dst, src);
    } else {
      const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
      const uint32_t e0 = u[0], e1 = c + 1 < C ? u[1] : 0u;
      const uint32_t e2 = c + 2 < C ? u[2] : 0u, e3 = c + 3 < C ? u[3] : 0u;
      *dst = make_uint2(e0 | e1 << 16, e2 | e3 << 16);
    }
  }
}

// The bf16 backward (see the header): a thread a quad of channels, as in the
// fp32 kernel. Shared memory: the fp32 dz tile, then the bf16 tiles of x
// (halo 2) and dy (halo 1). BP: the weight and the bias are bf16 (else
// fp32); a template parameter, so that their loads issue together (a
// runtime branch at each load cost 3% of the call: PERF.md, section 6).
template <int CQ, bool VEC, bool BP>
__global__ void __launch_bounds__(kMaxThreads, 4)
dwconv3x3_bwd_kernel_bf16(const fm_io::bf16* __restrict__ x, const void* __restrict__ w,
                          const void* __restrict__ bias, const fm_io::bf16* __restrict__ dy,
                          fm_io::bf16* __restrict__ dx, float* __restrict__ part, int B, int H,
                          int W, int C, int TW, int TH, int act_silu) {
  extern __shared__ float4 smem[];
  const int q = threadIdx.x % CQ, tw = threadIdx.x / CQ;
  const int c0 = blockIdx.x * 4 * CQ, c = c0 + 4 * q;
  const int XW = TW + 4, ZW = TW + 2;  // columns of the staged x and dz tiles
  const int xn = (TH + 4) * XW * CQ, zn = (TH + 2) * ZW * CQ;  // quads of each tile
  float4* zs = smem;                    // [TH + 2][TW + 2][CQ] fp32, rows h0-1.., cols w0-1..
  uint2* xs = reinterpret_cast<uint2*>(smem + zn);  // [TH + 4][TW + 4][CQ] bf16 quads
  uint2* ys = xs + xn;                              // [TH + 2][TW + 2][CQ] bf16 quads
  const int h_tiles = (H + TH - 1) / TH, w_tiles = (W + TW - 1) / TW;
  const int tiles = B * h_tiles * w_tiles;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 wt[9];  // wt[i * 3 + j]: the tap (i, j) of the 4 channels
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = zero;
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].x = param(w, c * 9 + t, BP);
  }
  if (c + 1 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].y = param(w, c * 9 + 9 + t, BP);
  }
  if (c + 2 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].z = param(w, c * 9 + 18 + t, BP);
  }
  if (c + 3 < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t].w = param(w, c * 9 + 27 + t, BP);
  }
  float4 bv = zero;
  if (bias) {
    if (c < C) bv.x = param(bias, c, BP);
    if (c + 1 < C) bv.y = param(bias, c + 1, BP);
    if (c + 2 < C) bv.z = param(bias, c + 2, BP);
    if (c + 3 < C) bv.w = param(bias, c + 3, BP);
  }
  float4 dw[9], db = zero;  // dw[i * 3 + j]
#pragma unroll
  for (int t = 0; t < 9; ++t) dw[t] = zero;

  const int k_lo = act_silu ? 0 : 1, k_hi = act_silu ? TH + 4 : TH + 3;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int b = tile / (h_tiles * w_tiles), rem = tile - b * h_tiles * w_tiles;
    const int h0 = rem / w_tiles * TH, w0 = rem % w_tiles * TW;
    const fm_io::bf16* xi = x + b * H * W * C;
    const fm_io::bf16* yi = dy + b * H * W * C;
    __syncthreads();  // the previous tile's reads of shared memory are done
    // each thread stages its own column of both tiles; the six halo columns
    // (x: 0, 1, TW+2, TW+3; dy: 0, TW+1) go to threads 0..5 of each channel
    // quad, x's outer ring only with SiLU
    stage_col_bf16<VEC>(xs + (tw + 2) * CQ + q, XW * CQ, xi, k_lo, k_hi, h0 - 2, w0 + tw, H, W,
                        C, c);
    stage_col_bf16<VEC>(ys + (tw + 1) * CQ + q, ZW * CQ, yi, 0, TH + 2, h0 - 1, w0 + tw, H, W, C,
                        c);
    for (int j = tw; j < 6; j += TW) {
      if (j < 4) {
        const int col = j < 2 ? j : TW + j;  // 0, 1, TW+2, TW+3
        if (act_silu || (col != 0 && col != TW + 3)) {
          stage_col_bf16<VEC>(xs + col * CQ + q, XW * CQ, xi, k_lo, k_hi, h0 - 2, w0 - 2 + col, H,
                              W, C, c);
        }
      } else {
        const int col = j == 4 ? 0 : TW + 1;
        stage_col_bf16<VEC>(ys + col * CQ + q, ZW * CQ, yi, 0, TH + 2, h0 - 1, w0 - 1 + col, H, W,
                            C, c);
      }
    }
    if (VEC) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    // dz over the haloed tile (see the fp32 kernel), from the staged x and
    // dy into the fp32 tile; without SiLU dz is dy
    if (act_silu) {
      {
        const uint2* src = xs + (tw + 1) * CQ + q;
        const uint2* g = ys + (tw + 1) * CQ + q;
        float4* z = zs + (tw + 1) * CQ + q;
        float4 a0 = zero, a1 = zero;  // pre of rows k-2, k-1
        for (int k = 0; k < TH + 4; ++k, src += XW * CQ) {
          const float4 v0 = unpack(src[0]), v1 = unpack(src[CQ]), v2 = unpack(src[2 * CQ]);
          float4 a2 = zero;
          taps(a2, v0, v1, v2, wt);
          taps(a1, v0, v1, v2, wt + 3);
          taps(a0, v0, v1, v2, wt + 6);
          if (k >= 2) {
            const float4 gv = unpack(g[(k - 2) * ZW * CQ]);
            z[(k - 2) * ZW * CQ] = make_float4(dsilu(gv.x, a0.x, bv.x), dsilu(gv.y, a0.y, bv.y),
                                               dsilu(gv.z, a0.z, bv.z), dsilu(gv.w, a0.w, bv.w));
          }
          a0 = a1;
          a1 = a2;
        }
      }
      for (int j = tw; j < 2 * (TH + 2); j += TW) {
        const int r = j >> 1, cc = (j & 1) * (TW + 1);
        const uint2* src = xs + (r * XW + cc) * CQ + q;
        float4 a = zero;
#pragma unroll
        for (int ii = 0; ii < 3; ++ii, src += XW * CQ) {
          taps(a, unpack(src[0]), unpack(src[CQ]), unpack(src[2 * CQ]), wt + 3 * ii);
        }
        const float4 gv = unpack(ys[(r * ZW + cc) * CQ + q]);
        zs[(r * ZW + cc) * CQ + q] = make_float4(dsilu(gv.x, a.x, bv.x), dsilu(gv.y, a.y, bv.y),
                                                 dsilu(gv.z, a.z, bv.z), dsilu(gv.w, a.w, bv.w));
      }
    } else {
      for (int k = threadIdx.x; k < zn; k += blockDim.x) zs[k] = unpack(ys[k]);
    }
    __syncthreads();

    // This thread's output column w0+tw, as in the fp32 kernel
    const float4* zr = zs + tw * CQ + q;
    const uint2* xr = xs + (tw + 1) * CQ + q;
    fm_io::bf16* out = dx + b * H * W * C + ((h0 - 2) * W + w0 + tw) * C + c;
    const bool col_ok = w0 + tw < W && c < C;
    float4 d0 = zero, d1 = zero;  // dx sums of rows rr-2, rr-1
    float4 z1 = zero, z2 = zero;  // dz of outputs rr-2, rr-3
    for (int rr = 0; rr < TH + 3; ++rr, zr += ZW * CQ, xr += XW * CQ, out += W * C) {
      float4 z0 = zero;  // dz of output rr-1
      if (rr < TH + 2) {
        const float4 v0 = zr[0], v1 = zr[CQ], v2 = zr[2 * CQ];
        float4 d2 = zero;
        taps(d2, v2, v1, v0, wt + 6);
        taps(d1, v2, v1, v0, wt + 3);
        taps(d0, v2, v1, v0, wt);
        if (rr >= 2 && h0 + rr - 2 < H && col_ok) {
          if (VEC) {
            fm_io::store4(out, d0);
          } else {
            out[0] = from_f<fm_io::bf16>(d0.x);
            if (c + 1 < C) out[1] = from_f<fm_io::bf16>(d0.y);
            if (c + 2 < C) out[2] = from_f<fm_io::bf16>(d0.z);
            if (c + 3 < C) out[3] = from_f<fm_io::bf16>(d0.w);
          }
        }
        d0 = d1;
        d1 = d2;
        if (rr >= 1 && rr <= TH) z0 = v1;
      }
      if (rr >= 1) {  // x row 0 meets no output (and is not staged without SiLU)
        const float4 u0 = unpack(xr[0]), u1 = unpack(xr[CQ]), u2 = unpack(xr[2 * CQ]);
        fma4(dw[0], z0, u0);
        fma4(dw[1], z0, u1);
        fma4(dw[2], z0, u2);
        fma4(dw[3], z1, u0);
        fma4(dw[4], z1, u1);
        fma4(dw[5], z1, u2);
        fma4(dw[6], z2, u0);
        fma4(dw[7], z2, u1);
        fma4(dw[8], z2, u2);
        db.x += z0.x;
        db.y += z0.y;
        db.z += z0.z;
        db.w += z0.w;
      }
      z2 = z1;
      z1 = z0;
    }
  }

  // the block's partial: its columns' sums, in column order
  __syncthreads();
  float4* red = smem;  // [TW][10][CQ]
#pragma unroll
  for (int t = 0; t < 9; ++t) red[(tw * 10 + t) * CQ + q] = dw[t];
  red[(tw * 10 + 9) * CQ + q] = db;
  __syncthreads();
  for (int item = threadIdx.x; item < 10 * CQ; item += blockDim.x) {
    const int k = item / CQ, qq = item % CQ, cc = c0 + 4 * qq;
    float4 s = red[k * CQ + qq];
    for (int i = 1; i < TW; ++i) {
      const float4 v = red[(i * 10 + k) * CQ + qq];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float* p = part + (blockIdx.y * 10 + k) * C + cc;
    if (cc < C) p[0] = s.x;
    if (cc + 1 < C) p[1] = s.y;
    if (cc + 2 < C) p[2] = s.z;
    if (cc + 3 < C) p[3] = s.w;
  }
}

// out[col] = sum over p of part[p][col], col < n: 8 interleaved slices of
// the P partials (at most some 90 at the model's shapes), each summed in
// order, then the slices in order
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
dwconv3x3_bwd_reduce(const float* __restrict__ part, int P, int n, float* __restrict__ out) {
  __shared__ float s[kReduceSlices][kReduceCols + 1];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (col < n) {
    for (int p = threadIdx.y; p < P; p += kReduceSlices) acc += part[p * n + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = s[0][threadIdx.x];
    for (int y = 1; y < kReduceSlices; ++y) t += s[y][threadIdx.x];
    out[col] = t;
  }
}

// above 48 KB a block's dynamic shared memory needs an opt-in, once per kernel
template <class Kernel>
int opt_in(Kernel kernel, int smem, bool& opted) {
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  return 0;
}

template <int CQ>
int launch(bool vec, dim3 grid, int threads, int smem, cudaStream_t stream, const float* x,
           const void* w, const void* bias, int, const float* dy, float* dx, float* part, int B,
           int H, int W, int C, int tw, int th, int act_silu) {
  static bool opted[2] = {false, false};
  auto kernel = vec ? dwconv3x3_bwd_kernel<CQ, true> : dwconv3x3_bwd_kernel<CQ, false>;
  if (const int err = opt_in(kernel, smem, opted[vec])) return err;
  kernel<<<grid, threads, smem, stream>>>(x, static_cast<const float*>(w),
                                          static_cast<const float*>(bias), dy, dx, part, B, H, W,
                                          C, tw, th, act_silu);
  return (int)cudaGetLastError();
}

template <int CQ>
int launch(bool vec, dim3 grid, int threads, int smem, cudaStream_t stream,
           const fm_io::bf16* x, const void* w, const void* bias, int params,
           const fm_io::bf16* dy, fm_io::bf16* dx, float* part, int B, int H, int W, int C, int tw,
           int th, int act_silu) {
  static bool opted[4] = {false, false, false, false};
  auto kernel = vec ? (params ? dwconv3x3_bwd_kernel_bf16<CQ, true, true>
                              : dwconv3x3_bwd_kernel_bf16<CQ, true, false>)
                    : (params ? dwconv3x3_bwd_kernel_bf16<CQ, false, true>
                              : dwconv3x3_bwd_kernel_bf16<CQ, false, false>);
  if (const int err = opt_in(kernel, smem, opted[2 * vec + (params != 0)])) return err;
  kernel<<<grid, threads, smem, stream>>>(x, w, bias, dy, dx, part, B, H, W, C, tw, th, act_silu);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of a block: the staged tiles (fp32: x and dz in
// place of dy; bf16: the fp32 dz tile and bf16 x and dy tiles), at least the
// block's sums at the end
inline int smem_bytes(const float*, int cq, int tw, int th) {
  const int tile = ((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * cq;
  return (tile > 10 * tw * cq ? tile : 10 * tw * cq) * (int)sizeof(float4);
}
inline int smem_bytes(const fm_io::bf16*, int cq, int tw, int th) {
  const int bytes =
      (16 * (th + 2) * (tw + 2) + 8 * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2))) * cq;
  return bytes > 160 * tw * cq ? bytes : 160 * tw * cq;
}

template <class IO>
int dwconv3x3_bwd(const IO* x, const void* w, const void* bias, int params, const IO* dy,
                  IO* dx, float* part, float* out, int B, int H, int W, int C, int act_silu,
                  int cq, int tw, int th, int grid_x, int grid_y, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (long long)B * H * W * C >= (1ll << 31) || tw < 1 ||
      th < 1 || cq * tw > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (long long)B * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int smem = smem_bytes(x, cq, tw, th);
  if (grid_x != (C + 4 * cq - 1) / (4 * cq) || grid_x > 65535 || grid_y < 1 || grid_y > tiles ||
      grid_y > 65535 || smem > kMaxSmem || (long long)grid_y * 10 * C >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  // 4 elements a thread: 16 bytes in fp32, 8 in bf16
  const uintptr_t align = 4 * sizeof(IO) - 1;
  const bool vec = C % 4 == 0 && ((uintptr_t)x & align) == 0 && ((uintptr_t)dy & align) == 0 &&
                   ((uintptr_t)dx & align) == 0;
  const dim3 grid(grid_x, grid_y);
  const int threads = cq * tw;
  int err;
  switch (cq) {
    case 1: err = launch<1>(vec, grid, threads, smem, stream, x, w, bias, params, dy, dx, part, B, H, W, C, tw, th, act_silu); break;
    case 2: err = launch<2>(vec, grid, threads, smem, stream, x, w, bias, params, dy, dx, part, B, H, W, C, tw, th, act_silu); break;
    case 4: err = launch<4>(vec, grid, threads, smem, stream, x, w, bias, params, dy, dx, part, B, H, W, C, tw, th, act_silu); break;
    case 8: err = launch<8>(vec, grid, threads, smem, stream, x, w, bias, params, dy, dx, part, B, H, W, C, tw, th, act_silu); break;
    case 16: err = launch<16>(vec, grid, threads, smem, stream, x, w, bias, params, dy, dx, part, B, H, W, C, tw, th, act_silu); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  dwconv3x3_bwd_reduce<<<(10 * C + kReduceCols - 1) / kReduceCols,
                         dim3(kReduceCols, kReduceSlices), 0, stream>>>(part, grid_y, 10 * C,
                                                                        out);
  return (int)cudaGetLastError();
}

}  // namespace

// cq, tw, th: the tile (4*cq channels, tw columns, th rows); grid_x: the
// channel blocks, ceil(C / (4 cq)); grid_y: the blocks that walk a channel
// block's tiles, each writing one (10, C) partial into part (grid_y, 10, C);
// out (10, C): rows 0..8 dw's taps i*3+j, row 9 dbias. The dynamic shared
// memory follows from the tile (dwconv.py::bwd_plan reckons it alike). The
// _bf16 entry takes x, dy and dx as bf16, and w and bias as bf16 where
// params is 1 (the fp32 entry takes only 0).
extern "C" int fm_dwconv3x3_bwd(const float* x, const float* w, const float* bias,
                                const float* dy, float* dx, float* part, float* out, int B, int H,
                                int W, int C, int act_silu, int cq, int tw, int th, int grid_x,
                                int grid_y, int params, cudaStream_t stream) {
  if (params) return (int)cudaErrorInvalidValue;
  return dwconv3x3_bwd(x, w, bias, 0, dy, dx, part, out, B, H, W, C, act_silu, cq, tw, th,
                       grid_x, grid_y, stream);
}
extern "C" int fm_dwconv3x3_bwd_bf16(const fm_io::bf16* x, const void* w, const void* bias,
                                     const fm_io::bf16* dy, fm_io::bf16* dx, float* part,
                                     float* out, int B, int H, int W, int C, int act_silu, int cq,
                                     int tw, int th, int grid_x, int grid_y, int params,
                                     cudaStream_t stream) {
  return dwconv3x3_bwd(x, w, bias, params != 0, dy, dx, part, out, B, H, W, C, act_silu, cq, tw,
                       th, grid_x, grid_y, stream);
}
