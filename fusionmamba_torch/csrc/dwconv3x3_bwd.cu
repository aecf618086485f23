// Depthwise 3x3 SAME convolution + bias (+ SiLU) backward for Hopper (sm_90a), fp32, NHWC.
//
// Replaces fusionmamba_tpu/ops/dwconv_pallas.py::_bwd_kernel (built by
// _bwd_pallas). The forward (dwconv3x3_fwd.cu) is
//   pre[b,h,w,c] = sum_{i,j} x[b,h+i-1,w+j-1,c] * w[c,i,j] + bias[c],  out = act(pre).
// Given dy, with dz = dy * act'(pre):
//   dx[b,h,w,c] = sum_{i,j} dz[b,h+1-i,w+1-j,c] * w[c,i,j]
//   dw[c,i,j]   = sum_{b,h,w} dz[b,h,w,c] * x[b,h+i-1,w+j-1,c],  dbias[c] = sum dz[..., c].
// pre is recomputed from x, w and bias, never stored.
//
// What bounds it: bytes (x and dy read, dx written), with some 60 flops per
// element. Design: one thread per (b, h, c) walks its row along w, C fastest
// across the warp so that every load and store is a coalesced row of
// channels. It keeps a 5x5 window of x and a 3x3 window of dz in registers
// and slides them one column a step: each step loads one new column of x
// (5 values) and of dy (3), recomputes pre for the new dz column, then
// writes dx and adds the centre dz's share to its 9 dw sums and its dbias
// sum. The block's 8 rows of threads reduce those sums in shared memory in a
// fixed order and write one (10, C) partial per block row; the caller sums
// the partials in a fixed order. No atomics, so results repeat bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;     // channels per block: one warp
constexpr int kRows = 8;   // (b, h) rows per block

__global__ void __launch_bounds__(kC * kRows)
dwconv3x3_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ part, int B, int H, int W, int C,
                     int act_silu) {
  __shared__ float red[kRows][10][kC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kC + tx;
  const int row = blockIdx.y * kRows + ty;  // b * H + h
  float dw[9], db = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) dw[i] = 0.f;

  if (c < C && row < B * H) {
    const int b = row / H, h = row % H;
    float wt[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) wt[i] = w[(size_t)c * 9 + i];
    const float bv = bias ? bias[c] : 0.f;
    const size_t img = (size_t)b * H * W;
    auto ld = [&](const float* p, int hh, int ww) -> float {
      return (hh >= 0 && hh < H && ww >= 0 && ww < W) ? p[(img + (size_t)hh * W + ww) * C + c]
                                                     : 0.f;
    };
    // xw[r][j]: x at row h-2+r, column wi-2+j; zw[r][j]: dz at row h-1+r, column wi-1+j
    float xw[5][5], zw[3][3];
    // dz at row h-1+r, column col, from the x window's columns j0..j0+2
    auto dz_at = [&](int r, int col, int j0) -> float {
      const int hh = h - 1 + r;
      if (hh < 0 || hh >= H || col < 0 || col >= W) return 0.f;
      const float g = dy[(img + (size_t)hh * W + col) * C + c];
      if (!act_silu) return g;
      float acc = 0.f;  // the forward's order: taps row by row
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = fmaf(xw[r + i][j0 + j], wt[i * 3 + j], acc);
      const float pre = acc + bv;
      const float s = 1.f / (1.f + expf(-pre));
      return g * s * (1.f + pre * (1.f - s));
    };
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      xw[r][0] = 0.f;
      xw[r][1] = 0.f;
      xw[r][2] = ld(x, h - 2 + r, 0);
      xw[r][3] = ld(x, h - 2 + r, 1);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      zw[r][0] = 0.f;
      zw[r][1] = dz_at(r, 0, 1);
    }
    for (int wi = 0; wi < W; ++wi) {
#pragma unroll
      for (int r = 0; r < 5; ++r) xw[r][4] = ld(x, h - 2 + r, wi + 2);
#pragma unroll
      for (int r = 0; r < 3; ++r) zw[r][2] = dz_at(r, wi + 1, 2);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = fmaf(zw[2 - i][2 - j], wt[i * 3 + j], acc);
      dx[(img + (size_t)h * W + wi) * C + c] = acc;
      const float zc = zw[1][1];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) dw[i * 3 + j] = fmaf(zc, xw[i + 1][j + 1], dw[i * 3 + j]);
      db += zc;
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) xw[r][j] = xw[r][j + 1];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        zw[r][0] = zw[r][1];
        zw[r][1] = zw[r][2];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) red[ty][i][tx] = dw[i];
  red[ty][9][tx] = db;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int i = 0; i < 10; ++i) {
      float s = red[0][i][tx];
      for (int y = 1; y < kRows; ++y) s += red[y][i][tx];
      part[((size_t)blockIdx.y * 10 + i) * C + c] = s;
    }
  }
}

}  // namespace

// part: (ceil(B*H / 8), 10, C) partials, rows 0..8 the taps of dw (i*3+j),
// row 9 dbias; the caller sums them over the first axis.
extern "C" int fm_dwconv3x3_bwd(const float* x, const float* w, const float* bias,
                                const float* dy, float* dx, float* part, int B, int H, int W,
                                int C, int act_silu, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (size_t)B * H > 65535u * kRows) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kC, kRows);
  const dim3 grid((C + kC - 1) / kC, (B * H + kRows - 1) / kRows);
  dwconv3x3_bwd_kernel<<<grid, block, 0, stream>>>(x, w, bias, dy, dx, part, B, H, W, C,
                                                   act_silu);
  return (int)cudaGetLastError();
}
