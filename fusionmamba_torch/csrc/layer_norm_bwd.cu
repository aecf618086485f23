// LayerNorm (+ gate) backward and LN-spatial-mean backward for Hopper (sm_90a), fp32.
//
// 1. The LN backward: dx, dgate, dscale, dbias. Replaces
// fusionmamba_tpu/ops/ln_pallas.py::_ln_bwd_kernel (built by _bwd_pallas).
// The forward is y = (xhat * scale + bias) * act(g) over the last axis of x
// (rows, C), xhat = (x - mean) * rs, rs = rsqrt(E[x^2] - E[x]^2 + eps) (the
// fast variance, recomputed here from x), act being silu, "silu_sum" (s1 +
// silu(s1), s1 = silu(g)) or the raw gate (gate kind 3: act(g) = g). With
// u = dy * act(g) and w = u * scale:
//   dgate  = dy * (xhat * scale + bias) * act'(g)
//   dx     = rs * (w - mean(w) - xhat * mean(w * xhat))
//   dscale = sum over rows of u * xhat,   dbias = sum over rows of u.
//
// 2. The LN-mean backward: dx, dscale, dbias of m[b] = mean over the rows of
// LN(x[b]), x (B, rows, C). Replaces ln_pallas.py::_lnm_bwd_kernel (built by
// _lnm_bwd). Its cotangent of LN(x) is row-constant: w = dm[b] * scale /
// rows, so
//   dx     = rs * (w - mean(w) - xhat * mean(w * xhat))
//   dscale = sum over b of dm[b] * (sum over rows of xhat) / rows,
//   dbias  = sum over b of dm[b].
//
// What bounds both: bytes (x, dy and the gate read once, dx and dgate
// written once; the LN-mean reads only x and writes dx), with some 20-40
// flops an element.
//
// Design. The row machinery is ln_common.cuh's: a group of G lanes owns one
// row at a time, V values a lane (V * G = C at the model's widths, a masked
// variant for any other C), and a row's two pairs of sums (of x and x^2,
// then of w and w * xhat) are its group sums. The widest rows span 4 warps
// so that a lane holds at most 12 values of each of x, dy and the gate,
// next to 12 each of scale, bias and the two gradient sums (no spills).
// The sums over rows are folded in: the grid is a few blocks an SM (the
// wrapper's plans, fusionmamba_torch/ops/layer_norm.py::bwd_plan and
// lnm_bwd_plan), each group walks rows in a grid-stride loop and keeps its
// channels' sums in registers, each block sums its groups in group order and
// writes one partial, and a second kernel sums the partials in a fixed
// order: the LN's (P, 2, C) as 32 interleaved slices in order and then the
// slices in order; the LN-mean's (B, P, C), each already times its dm[b],
// likewise, and dbias from dm in b order. The LN-mean's grid is (P, B): a block
// walks the rows of one batch row, forms w from dm, scale and 1 / rows in
// registers and takes mean(w) once. No atomics, so two launches give the
// same bits, and each call is two launches (no separate reductions, no
// elementwise ops around them).
#include <cuda_runtime.h>

#include "ln_common.cuh"

namespace {

using fm_ln::group_sum;
using fm_ln::kBlock;
constexpr int kReduceCols = 32;      // the reduce kernel: columns of a block
constexpr int kReduceSlices = 32;    // and interleaved slices of the partials

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + __expf(-v)); }

// At least two blocks of 256 threads an SM (the plan's grid for 12 values a
// lane): it caps registers at 128, under which ptxas keeps every template
// free of spills (left to itself it spilled one of them at 80).
template <int V, int G, int GATE, bool MASK>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock, G > kBlock ? 1 : 2)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gate,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const float* __restrict__ dy, float* __restrict__ dx, float* __restrict__ dg,
              float* __restrict__ part, int rows, int C, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  constexpr int GPB = T / G;  // groups (rows at a time) of a block
  // the two rounds of row sums each take their own slots, so one barrier a
  // round keeps a round's reads ahead of the next round's writes
  __shared__ float2 red[2][T / 32];
  __shared__ float sums[GPB > 1 ? GPB : 1][2][GPB > 1 ? V * G : 1];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;

  float sc[V], bi[V], ds[V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + v * G;
    const bool ok = !MASK || c < C;
    sc[v] = ok ? scale[c] : 0.f;
    bi[v] = GATE && ok ? bias[c] : 0.f;
    ds[v] = 0.f;
    db[v] = 0.f;
  }
  const float fc = (float)C;

  for (int base = blockIdx.x * GPB; base < rows; base += gridDim.x * GPB) {
    const int r = base + grp;
    const bool live = r < rows;
    const int off = r * C + lane;
    float xv[V], d[V], gv[V];
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = live && (!MASK || lane + v * G < C);
      xv[v] = ok ? x[off + v * G] : 0.f;
      d[v] = ok ? dy[off + v * G] : 0.f;
      gv[v] = GATE && ok ? gate[off + v * G] : 0.f;
      s.x += xv[v];
      s.y = fmaf(xv[v], xv[v], s.y);
    }
    s = group_sum<G>(s, red[0]);
    const float mu = s.x / fc;
    const float rs = rsqrtf(s.y / fc - mu * mu + eps);
    float2 m = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = live && (!MASK || lane + v * G < C);
      const float xh = ok ? (xv[v] - mu) * rs : 0.f;
      float u = d[v];
      if (GATE == 3) {
        if (ok) dg[off + v * G] = u * (xh * sc[v] + bi[v]);
        u *= gv[v];
      } else if (GATE) {
        const float g = gv[v], sg = sigmoid(g), s1 = g * sg;
        float dgate = sg * (1.f + g * (1.f - sg));  // silu'(g)
        float act = s1;
        if (GATE == 2) {
          const float ss = sigmoid(s1);
          act = s1 + s1 * ss;
          dgate = (1.f + ss * (1.f + s1 * (1.f - ss))) * dgate;
        }
        if (ok) dg[off + v * G] = u * (xh * sc[v] + bi[v]) * dgate;
        u *= act;
      }
      ds[v] = fmaf(u, xh, ds[v]);
      db[v] += u;
      const float wv = u * sc[v];
      m.x += wv;
      m.y = fmaf(wv, xh, m.y);
      xv[v] = xh;
      d[v] = wv;
    }
    m = group_sum<G>(m, red[1]);
    const float m1 = m.x / fc, m2 = m.y / fc;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (live && (!MASK || lane + v * G < C)) dx[off + v * G] = rs * (d[v] - m1 - xv[v] * m2);
    }
  }

  float* out = part + blockIdx.x * 2 * C;
  if constexpr (GPB == 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = lane + v * G;
      if (!MASK || c < C) {
        out[c] = ds[v];
        out[C + c] = db[v];
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sums[grp][0][lane + v * G] = ds[v];
      sums[grp][1][lane + v * G] = db[v];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      for (int c = threadIdx.x; c < C; c += T) {
        float t = sums[0][k][c];
#pragma unroll
        for (int g = 1; g < GPB; ++g) t += sums[g][k][c];
        out[k * C + c] = t;
      }
    }
  }
}

// dscale[c] and dbias[c] from the (P, 2, C) partials
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
ln_bwd_reduce(const float* __restrict__ part, int P, int C, float* __restrict__ dscale,
              float* __restrict__ dbias) {
  __shared__ float s[kReduceSlices][kReduceCols + 1];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;  // of the 2C
  float acc = 0.f;
  if (col < 2 * C) {
    for (int p = threadIdx.y; p < P; p += kReduceSlices) acc += part[p * 2 * C + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * C) {
    float t = s[0][threadIdx.x];
    for (int y = 1; y < kReduceSlices; ++y) t += s[y][threadIdx.x];
    if (col < C) {
      dscale[col] = t;
    } else {
      dbias[col - C] = t;
    }
  }
}

// The LN-mean backward's rows: grid (P, B), block b = blockIdx.y walks the
// rows of batch row b; each block writes one (C,) partial, dm[b] times the
// sum of xhat over its rows, into part (B, P, C).
template <int V, int G, bool MASK>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock, G > kBlock ? 1 : 2)
lnm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ dm, float* __restrict__ dx, float* __restrict__ part,
               int rows, int C, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  constexpr int GPB = T / G;
  // three rounds of sums, each in its own slots: mean(w) once, then the
  // row's two rounds (see ln_bwd_kernel)
  __shared__ float2 red[3][T / 32];
  __shared__ float sums[GPB > 1 ? GPB : 1][GPB > 1 ? V * G : 1];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const float fc = (float)C, fr = (float)rows;

  float wv[V], xs[V];  // the row-constant cotangent dm * scale / rows; sums of xhat
  float2 m = make_float2(0.f, 0.f);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + v * G;
    wv[v] = !MASK || c < C ? dm[b * C + c] * scale[c] / fr : 0.f;
    xs[v] = 0.f;
    m.x += wv[v];
  }
  m = group_sum<G>(m, red[2]);
  const float m1 = m.x / fc;

  for (int base = blockIdx.x * GPB; base < rows; base += gridDim.x * GPB) {
    const int r = base + grp;
    const bool live = r < rows;
    const int off = (b * rows + r) * C + lane;
    float xv[V];
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = live && (!MASK || lane + v * G < C);
      xv[v] = ok ? x[off + v * G] : 0.f;
      s.x += xv[v];
      s.y = fmaf(xv[v], xv[v], s.y);
    }
    s = group_sum<G>(s, red[0]);
    const float mu = s.x / fc;
    const float rs = rsqrtf(s.y / fc - mu * mu + eps);
    float2 n = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = live && (!MASK || lane + v * G < C);
      const float xh = ok ? (xv[v] - mu) * rs : 0.f;
      xs[v] += xh;
      n.y = fmaf(wv[v], xh, n.y);
      xv[v] = xh;
    }
    n = group_sum<G>(n, red[1]);
    const float m2 = n.y / fc;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (live && (!MASK || lane + v * G < C)) dx[off + v * G] = rs * (wv[v] - m1 - xv[v] * m2);
    }
  }

  float* out = part + (b * gridDim.x + blockIdx.x) * C;
  dm += b * C;
  if constexpr (GPB == 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = lane + v * G;
      if (!MASK || c < C) out[c] = dm[c] * xs[v];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) sums[grp][lane + v * G] = xs[v];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += T) {
      float t = sums[0][c];
#pragma unroll
      for (int g = 1; g < GPB; ++g) t += sums[g][c];
      out[c] = dm[c] * t;
    }
  }
}

// dscale[c] = (sum of the n = B * P partials part[., c]) / rows, as 32
// interleaved slices in order, then the slices in order; dbias[c] = sum over
// b of dm[b, c] in order
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
lnm_bwd_reduce(const float* __restrict__ part, const float* __restrict__ dm, int B, int n, int C,
               int rows, float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float s[kReduceSlices][kReduceCols + 1];
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (col < C) {
    for (int p = threadIdx.y; p < n; p += kReduceSlices) acc += part[p * C + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float t = s[0][threadIdx.x];
    for (int y = 1; y < kReduceSlices; ++y) t += s[y][threadIdx.x];
    dscale[col] = t / (float)rows;
  } else if (threadIdx.y == 1 && col < C) {
    float t = 0.f;
    for (int b = 0; b < B; ++b) t += dm[b * C + col];
    dbias[col] = t;
  }
}

template <int V, int G, bool MASK>
int launch_lnm(int B, int blocks, cudaStream_t stream, const float* x, const float* scale,
               const float* dm, float* dx, float* part, int rows, int C, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  lnm_bwd_kernel<V, G, MASK><<<dim3(blocks, B), T, 0, stream>>>(x, scale, dm, dx, part, rows, C,
                                                                eps);
  return (int)cudaGetLastError();
}

template <int V, int G, bool MASK>
int launch(int gate_kind, int blocks, cudaStream_t stream, const float* x, const float* gate,
           const float* scale, const float* bias, const float* dy, float* dx, float* dg,
           float* part, int rows, int C, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  switch (gate_kind) {
    case 0:
      ln_bwd_kernel<V, G, 0, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                             part, rows, C, eps);
      break;
    case 1:
      ln_bwd_kernel<V, G, 1, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                             part, rows, C, eps);
      break;
    case 3:
      ln_bwd_kernel<V, G, 3, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                             part, rows, C, eps);
      break;
    default:
      ln_bwd_kernel<V, G, 2, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                             part, rows, C, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (and gate, dg when gate_kind is 1 (silu), 2 (silu_sum) or 3 (raw)):
// (rows, C); part: (blocks, 2, C) scratch; dscale, dbias: (C,). values,
// lanes, masked: the template (bwd_plan); blocks: the grid of the first
// kernel.
extern "C" int fm_layer_norm_bwd(const float* x, const float* gate, const float* scale,
                                 const float* bias, const float* dy, float* dx, float* dg,
                                 float* part, float* dscale, float* dbias, int rows, int C,
                                 int gate_kind, int values, int lanes, int masked, int blocks,
                                 float eps, cudaStream_t stream) {
  if (rows < 1 || C < 1 || (long long)rows * C >= (1ll << 31) || blocks < 1 ||
      (long long)blocks * 2 * C >= (1ll << 31) || gate_kind < 0 || gate_kind > 3 ||
      (gate_kind && (!gate || !dg)) || (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
#define FM_LN_BWD(V, G, MASK)                                                                \
  if (values == V && lanes == G && (masked != 0) == MASK)                                    \
    err = launch<V, G, MASK>(gate_kind, blocks, stream, x, gate, scale, bias, dy, dx, dg, part, \
                             rows, C, eps);
  FM_LN_TEMPLATES(FM_LN_BWD)
#undef FM_LN_BWD
  if (err != 0) return err;
  ln_bwd_reduce<<<(2 * C + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceSlices), 0,
                  stream>>>(part, blocks, C, dscale, dbias);
  return (int)cudaGetLastError();
}

// x, dx: (B, rows, C); dm: (B, C); part: (B, blocks, C) scratch; dscale,
// dbias: (C,). values, lanes, masked: the template (lnm_bwd_plan); blocks:
// the blocks of each batch row in the first kernel's grid (blocks, B).
extern "C" int fm_ln_mean_bwd(const float* x, const float* scale, const float* dm, float* dx,
                              float* part, float* dscale, float* dbias, int B, int rows, int C,
                              int values, int lanes, int masked, int blocks, float eps,
                              cudaStream_t stream) {
  if (B < 1 || B > 65535 || rows < 1 || C < 1 || (long long)B * rows * C >= (1ll << 31) ||
      blocks < 1 || blocks > rows || (long long)B * blocks * C >= (1ll << 31) ||
      (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_BWD(V, G, MASK)                                                                \
  if (values == V && lanes == G && (masked != 0) == MASK)                                     \
    err = launch_lnm<V, G, MASK>(B, blocks, stream, x, scale, dm, dx, part, rows, C, eps);
  FM_LN_TEMPLATES(FM_LNM_BWD)
#undef FM_LNM_BWD
  if (err != 0) return err;
  lnm_bwd_reduce<<<(C + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceSlices), 0,
                   stream>>>(part, dm, B, B * blocks, C, rows, dscale, dbias);
  return (int)cudaGetLastError();
}
