// LayerNorm (+ gate) backward and LN-spatial-mean backward for Hopper (sm_90a),
// fp32 or bf16 I/O (x, the gate, dy, dx and dgate in the I/O type; dm, the
// partials, dscale and dbias fp32; scale and bias fp32, or in the bf16
// entries bf16 where `params` is 1 (a bf16 step's casts, widened as they are
// loaded); the math fp32 either way).
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
// elementwise ops around them); the LN-mean's bf16 design (4.) is one.
//
// 3. The LN backward's bf16 design (ln_bwd_kernel_quads, the bf16 entry's
// templates FM_LN_BF16_TEMPLATES). With bf16 I/O the strided layout above
// moves 2 bytes a lane a load, 64 bytes a warp, and keeps half fp32's bytes in
// flight. Here a lane owns Q quads of consecutive channels, quad q being
// channels 4 (lane + q G) .. +3, so every load and store of x, dy, the gate,
// dx and dgate moves 8 bytes a lane (a warp's load 256 bytes) and each lane
// holds 12 values at every model width (3 quads; G = C / 12 = 2 ... 128
// lanes a row, all busy; a masked variant of 32, 128 or 512 lanes for any
// other C that is a multiple of 4). The next row's raw quads are loaded
// while the current row is summed and written, so a group keeps two rows
// in flight. The math, the places of rounding (dx and dgate, at their
// stores) and the fixed-order sums over rows are the design above; a C that
// is not a multiple of 4, or a tensor not on an 8-byte boundary, takes the
// strided templates in bf16 (layer_norm.py::bwd_plan chooses).
//
// 4. The LN-mean backward's bf16 design (lnm_bwd_one_launch): one launch a
// call. dscale = sum over b of dm[b] * (sum over rows of xhat) / rows needs
// the sums of xhat over every row of a batch row, which 2 collects from its
// blocks' partials in a second kernel. At the model's small shapes that
// second launch, or any sum of the partials within the launch (a cluster's
// through distributed shared memory, then the clusters' after a ticket
// elects the last), cost as much as the rows (PERF.md, section 6). Here the
// forward's bf16 quads kernel, when it records its backward, also writes the
// mean of xhat of each batch row and column ((B, C), ln_mean_fwd.cu), so the
// backward sums only over b: block (0, 0) writes dscale = sum over b of dm[b]
// times that mean and dbias = sum over b of dm[b], in b order, while its
// loads are in flight, and every block computes dx on quads as in 3 (8-byte
// loads of x and stores of dx, the next row's quads loaded while the current
// one is summed). No partials, no scratch, no atomics: two launches give the
// same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "io_types.cuh"
#include "ln_common.cuh"

namespace {

using fm_io::from_f;
using fm_io::to_f;

using fm_io::bf16;
using fm_ln::group_sum;
using fm_ln::kBlock;
using fm_ln::load_quad;
using fm_ln::unpack;
constexpr int kReduceCols = 32;      // the reduce kernel: columns of a block
constexpr int kReduceSlices = 32;    // and interleaved slices of the partials
constexpr int kOneBlock = 512;       // threads of a block of the one-launch LN-mean backward

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + __expf(-v)); }

// element i of the LN backward's scale or bias: fp32, or with bf16 I/O bf16
// where `params` is 1 (fm_io::param; the fp32 instances read fp32 only)
template <class IO>
__device__ __forceinline__ float param(const void* p, int i, int params) {
  if constexpr (sizeof(IO) == sizeof(bf16)) return fm_io::param(p, i, params);
  return static_cast<const float*>(p)[i];
}

// At least two blocks of 256 threads an SM (the plan's grid for 12 values a
// lane): it caps registers at 128, under which ptxas keeps every template
// free of spills (left to itself it spilled one of them at 80).
template <class IO, int V, int G, int GATE, bool MASK>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock, G > kBlock ? 1 : 2)
ln_bwd_kernel(const IO* __restrict__ x, const IO* __restrict__ gate,
              const void* __restrict__ scale, const void* __restrict__ bias,
              const IO* __restrict__ dy, IO* __restrict__ dx, IO* __restrict__ dg,
              float* __restrict__ part, int rows, int C, int params, float eps) {
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
    sc[v] = ok ? param<IO>(scale, c, params) : 0.f;
    bi[v] = GATE && ok ? param<IO>(bias, c, params) : 0.f;
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
      xv[v] = ok ? to_f(x[off + v * G]) : 0.f;
      d[v] = ok ? to_f(dy[off + v * G]) : 0.f;
      gv[v] = GATE && ok ? to_f(gate[off + v * G]) : 0.f;
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
        if (ok) dg[off + v * G] = from_f<IO>(u * (xh * sc[v] + bi[v]));
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
        if (ok) dg[off + v * G] = from_f<IO>(u * (xh * sc[v] + bi[v]) * dgate);
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
      if (live && (!MASK || lane + v * G < C))
        dx[off + v * G] = from_f<IO>(rs * (d[v] - m1 - xv[v] * m2));
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

// The LN backward with bf16 I/O on quads (see 3. above); the partials as
// ln_bwd_kernel writes them. Two blocks an SM cap registers at 128, as for
// the strided templates' 12 values a lane.
template <int Q, int G, int GATE, bool MASK>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock, G > kBlock ? 1 : 2)
ln_bwd_kernel_quads(const bf16* __restrict__ x, const bf16* __restrict__ gate,
                    const void* __restrict__ scale, const void* __restrict__ bias,
                    const bf16* __restrict__ dy, bf16* __restrict__ dx, bf16* __restrict__ dg,
                    float* __restrict__ part, int rows, int C, int params, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  constexpr int GPB = T / G;  // groups (rows at a time) of a block
  constexpr int V = 4 * Q;
  __shared__ float2 red[2][T / 32];
  __shared__ __align__(16) float sums[GPB > 1 ? GPB : 1][2][GPB > 1 ? V * G : 4];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;

  bool has[Q];  // quad q holds channels of the row
  float sc[V], bi[V], ds[V], db[V];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = 4 * (lane + q * G);
    has[q] = !MASK || c < C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[4 * q + j] = has[q] ? param<bf16>(scale, c + j, params) : 0.f;
      bi[4 * q + j] = GATE && has[q] ? param<bf16>(bias, c + j, params) : 0.f;
      ds[4 * q + j] = 0.f;
      db[4 * q + j] = 0.f;
    }
  }
  const float fc = (float)C;
  const int stride = gridDim.x * GPB;
  const uint2 none = make_uint2(0u, 0u);

  // the raw quads of the row this group takes next
  uint2 px[Q], pd[Q], pg[Q];
  int r = blockIdx.x * GPB + grp;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const bool ok = r < rows && has[q];
    const int o = r * C + 4 * (lane + q * G);
    px[q] = ok ? load_quad(x + o) : none;
    pd[q] = ok ? load_quad(dy + o) : none;
    pg[q] = GATE && ok ? load_quad(gate + o) : none;
  }

  for (int base = blockIdx.x * GPB; base < rows; base += stride, r += stride) {
    const bool live = r < rows;
    const int off = r * C + 4 * lane;
    float xv[V], d[V], gv[V];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 a = unpack(px[q]), b = unpack(pd[q]), g = unpack(pg[q]);
      xv[4 * q] = a.x, xv[4 * q + 1] = a.y, xv[4 * q + 2] = a.z, xv[4 * q + 3] = a.w;
      d[4 * q] = b.x, d[4 * q + 1] = b.y, d[4 * q + 2] = b.z, d[4 * q + 3] = b.w;
      gv[4 * q] = g.x, gv[4 * q + 1] = g.y, gv[4 * q + 2] = g.z, gv[4 * q + 3] = g.w;
    }
    // the next row's loads go out before this row's sums
    const int rn = r + stride;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool ok = rn < rows && has[q];
      const int o = rn * C + 4 * (lane + q * G);
      px[q] = ok ? load_quad(x + o) : none;
      pd[q] = ok ? load_quad(dy + o) : none;
      pg[q] = GATE && ok ? load_quad(gate + o) : none;
    }

    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s.x += xv[v];
      s.y = fmaf(xv[v], xv[v], s.y);
    }
    s = group_sum<G>(s, red[0]);
    const float mu = s.x / fc;
    const float rs = rsqrtf(s.y / fc - mu * mu + eps);
    float2 m = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool ok = live && has[q];
      float dgq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = 4 * q + j;
        const float xh = ok ? (xv[v] - mu) * rs : 0.f;
        float u = d[v];
        dgq[j] = 0.f;
        if (GATE == 3) {
          dgq[j] = u * (xh * sc[v] + bi[v]);
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
          dgq[j] = u * (xh * sc[v] + bi[v]) * dgate;
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
      if (GATE && ok)
        fm_io::store4(dg + off + 4 * q * G, make_float4(dgq[0], dgq[1], dgq[2], dgq[3]));
    }
    m = group_sum<G>(m, red[1]);
    const float m1 = m.x / fc, m2 = m.y / fc;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (live && has[q]) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = rs * (d[4 * q + j] - m1 - xv[4 * q + j] * m2);
        fm_io::store4(dx + off + 4 * q * G, make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }

  float* out = part + blockIdx.x * 2 * C;
  if constexpr (GPB == 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = 4 * (lane + q * G);
      if (has[q]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out[c + j] = ds[4 * q + j];
          out[C + c + j] = db[4 * q + j];
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = 4 * (lane + q * G);
      *reinterpret_cast<float4*>(&sums[grp][0][c]) =
          make_float4(ds[4 * q], ds[4 * q + 1], ds[4 * q + 2], ds[4 * q + 3]);
      *reinterpret_cast<float4*>(&sums[grp][1][c]) =
          make_float4(db[4 * q], db[4 * q + 1], db[4 * q + 2], db[4 * q + 3]);
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

// The LN-mean backward's rows: grid (P, B), block b = blockIdx.y walks the
// rows of batch row b; each block writes one (C,) partial, dm[b] times the
// sum of xhat over its rows, into part (B, P, C).
template <class IO, class PT, int V, int G, bool MASK>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock, G > kBlock ? 1 : 2)
lnm_bwd_kernel(const IO* __restrict__ x, const PT* __restrict__ scale,
               const float* __restrict__ dm, IO* __restrict__ dx, float* __restrict__ part,
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
    wv[v] = !MASK || c < C ? dm[b * C + c] * to_f(scale[c]) / fr : 0.f;
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
      xv[v] = ok ? to_f(x[off + v * G]) : 0.f;
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
      if (live && (!MASK || lane + v * G < C))
        dx[off + v * G] = from_f<IO>(rs * (wv[v] - m1 - xv[v] * m2));
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

// The LN-mean backward's bf16 design (see 4. above): grid (P, B), a block of
// T threads walks the rows of batch row b on quads, one row a group at a time
// with the next row's quads loaded ahead. The first row's loads go out before
// anything else; w = dm * scale / rows lives in shared memory where a block
// has several groups (in registers where it has one, whose 512 lanes leave a
// block an SM); block (0, 0) sums dscale and dbias over b while its loads are
// in flight.
template <class PT, int Q, int G, bool MASK>
__global__ void __launch_bounds__(G > kOneBlock ? G : kOneBlock, G >= kOneBlock ? 1 : 2)
lnm_bwd_one_launch(const bf16* __restrict__ x, const PT* __restrict__ scale,
                   const float* __restrict__ dm, const float* __restrict__ xmean,
                   bf16* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dbias,
                   int rows, int C, float eps) {
  constexpr int T = G > kOneBlock ? G : kOneBlock;
  constexpr int GPB = T / G;
  constexpr int V = 4 * Q;
  constexpr int CW = V * G;  // channels a group holds (C, or more where masked)
  __shared__ float2 red[3][T / 32];
  __shared__ __align__(16) float wsh[GPB > 1 ? CW : 4];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.y, B = gridDim.y;
  const float fc = (float)C, fr = (float)rows;

  bool has[Q];  // quad q holds channels of the row
#pragma unroll
  for (int q = 0; q < Q; ++q) has[q] = !MASK || 4 * (lane + q * G) < C;
  const bf16* xb = x + (size_t)b * rows * C + 4 * lane;
  bf16* dxb = dx + (size_t)b * rows * C + 4 * lane;
  const int stride = gridDim.x * GPB;
  const uint2 none = make_uint2(0u, 0u);
  uint2 px[Q];  // the raw quads of the row this group takes next
  int r = blockIdx.x * GPB + grp;
#pragma unroll
  for (int q = 0; q < Q; ++q) px[q] = r < rows && has[q] ? load_quad(xb + r * C + 4 * q * G) : none;

  if (blockIdx.x == 0 && b == 0) {
    // dscale = sum over b of dm[b] * (the forward's mean of xhat), dbias =
    // sum over b of dm[b], each in b order
    for (int c = threadIdx.x; c < C; c += T) {
      float ts = 0.f, tb = 0.f;
#pragma unroll 8
      for (int k = 0; k < B; ++k) {
        const float d = dm[k * C + c];
        ts = fmaf(d, xmean[k * C + c], ts);
        tb += d;
      }
      dscale[c] = ts;
      dbias[c] = tb;
    }
  }
  // the row-constant cotangent w = dm[b] * scale / rows, and its mean
  float wr[GPB > 1 ? 1 : V];
  const auto w_of = [&](int q) {
    if constexpr (GPB > 1) {
      return *reinterpret_cast<const float4*>(&wsh[4 * (lane + q * G)]);
    } else {
      return make_float4(wr[4 * q], wr[4 * q + 1], wr[4 * q + 2], wr[4 * q + 3]);
    }
  };
  if constexpr (GPB > 1) {
    for (int c = threadIdx.x; c < CW; c += T) {
      wsh[c] = c < C ? dm[b * C + c] * to_f(scale[c]) / fr : 0.f;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 4 * (lane + v / 4 * G) + v % 4;
      wr[v] = has[v / 4] ? dm[b * C + c] * to_f(scale[c]) / fr : 0.f;
    }
  }
  float2 m = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 w = w_of(q);
    m.x += w.x;
    m.x += w.y;
    m.x += w.z;
    m.x += w.w;
  }
  m = group_sum<G>(m, red[2]);
  const float m1 = m.x / fc;

  for (int base = blockIdx.x * GPB; base < rows; base += stride, r += stride) {
    const bool live = r < rows;
    float xv[V];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 a = unpack(px[q]);
      xv[4 * q] = a.x, xv[4 * q + 1] = a.y, xv[4 * q + 2] = a.z, xv[4 * q + 3] = a.w;
    }
    // the next row's loads go out before this row's sums
    const int rn = r + stride;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      px[q] = rn < rows && has[q] ? load_quad(xb + rn * C + 4 * q * G) : none;

    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s.x += xv[v];
      s.y = fmaf(xv[v], xv[v], s.y);
    }
    s = group_sum<G>(s, red[0]);
    const float mu = s.x / fc;
    const float rs = rsqrtf(s.y / fc - mu * mu + eps);
    float2 n = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 w = w_of(q);
      const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = 4 * q + j;
        const float xh = live && has[q] ? (xv[v] - mu) * rs : 0.f;
        n.y = fmaf(wq[j], xh, n.y);
        xv[v] = xh;
      }
    }
    n = group_sum<G>(n, red[1]);
    const float m2 = n.y / fc;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (live && has[q]) {
        const float4 w = w_of(q);
        const float wq[4] = {w.x, w.y, w.z, w.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = rs * (wq[j] - m1 - xv[4 * q + j] * m2);
        fm_io::store4(dxb + r * C + 4 * q * G, make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

template <class IO, class PT, int V, int G, bool MASK>
int launch_lnm(int B, int blocks, cudaStream_t stream, const IO* x, const PT* scale,
               const float* dm, IO* dx, float* part, int rows, int C, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  lnm_bwd_kernel<IO, PT, V, G, MASK><<<dim3(blocks, B), T, 0, stream>>>(x, scale, dm, dx, part,
                                                                        rows, C, eps);
  return (int)cudaGetLastError();
}

template <class PT, int Q, int G, bool MASK>
int launch_lnm_one(int B, int blocks, cudaStream_t stream, const bf16* x, const PT* scale,
                   const float* dm, const float* xmean, bf16* dx, float* dscale, float* dbias,
                   int rows, int C, float eps) {
  constexpr int T = G > kOneBlock ? G : kOneBlock;
  lnm_bwd_one_launch<PT, Q, G, MASK><<<dim3(blocks, B), T, 0, stream>>>(
      x, scale, dm, xmean, dx, dscale, dbias, rows, C, eps);
  return (int)cudaGetLastError();
}

template <class IO, int V, int G, bool MASK>
int launch(int gate_kind, int blocks, cudaStream_t stream, const IO* x, const IO* gate,
           const void* scale, const void* bias, const IO* dy, IO* dx, IO* dg, float* part,
           int rows, int C, int params, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  switch (gate_kind) {
    case 0:
      ln_bwd_kernel<IO, V, G, 0, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                                 part, rows, C, params, eps);
      break;
    case 1:
      ln_bwd_kernel<IO, V, G, 1, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                                 part, rows, C, params, eps);
      break;
    case 3:
      ln_bwd_kernel<IO, V, G, 3, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                                 part, rows, C, params, eps);
      break;
    default:
      ln_bwd_kernel<IO, V, G, 2, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx, dg,
                                                                 part, rows, C, params, eps);
  }
  return (int)cudaGetLastError();
}

template <int Q, int G, bool MASK>
int launch_quads(int gate_kind, int blocks, cudaStream_t stream, const bf16* x, const bf16* gate,
                 const void* scale, const void* bias, const bf16* dy, bf16* dx, bf16* dg,
                 float* part, int rows, int C, int params, float eps) {
  constexpr int T = G > kBlock ? G : kBlock;
  switch (gate_kind) {
    case 0:
      ln_bwd_kernel_quads<Q, G, 0, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx,
                                                                   dg, part, rows, C, params, eps);
      break;
    case 1:
      ln_bwd_kernel_quads<Q, G, 1, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx,
                                                                   dg, part, rows, C, params, eps);
      break;
    case 3:
      ln_bwd_kernel_quads<Q, G, 3, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx,
                                                                   dg, part, rows, C, params, eps);
      break;
    default:
      ln_bwd_kernel_quads<Q, G, 2, MASK><<<blocks, T, 0, stream>>>(x, gate, scale, bias, dy, dx,
                                                                   dg, part, rows, C, params, eps);
  }
  return (int)cudaGetLastError();
}

// the quads templates for bf16 I/O; none for fp32
inline int rows_quads(int, int, int, int, int, cudaStream_t, const float*, const float*,
                      const void*, const void*, const float*, float*, float*, float*, int, int,
                      int, float) {
  return (int)cudaErrorInvalidValue;
}
inline int rows_quads(int values, int lanes, int masked, int gate_kind, int blocks,
                      cudaStream_t stream, const bf16* x, const bf16* gate, const void* scale,
                      const void* bias, const bf16* dy, bf16* dx, bf16* dg, float* part, int rows,
                      int C, int params, float eps) {
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)gate | (uintptr_t)dy | (uintptr_t)dx |
                         (uintptr_t)dg;
  if (C % 4 != 0 || (ptrs & 7) != 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
#define FM_LN_BWD_QUADS(Q, G, MASK)                                                           \
  if (values == 4 * Q && lanes == G && (masked != 0) == MASK)                                 \
    err = launch_quads<Q, G, MASK>(gate_kind, blocks, stream, x, gate, scale, bias, dy, dx, dg, \
                                   part, rows, C, params, eps);
  FM_LN_BF16_TEMPLATES(FM_LN_BWD_QUADS)
#undef FM_LN_BWD_QUADS
  return err;
}

template <class IO>
int layer_norm_bwd(const IO* x, const IO* gate, const void* scale, const void* bias,
                   const IO* dy, IO* dx, IO* dg, float* part, float* dscale, float* dbias,
                   int rows, int C, int gate_kind, int values, int lanes, int masked, int quads,
                   int blocks, int params, float eps, cudaStream_t stream) {
  if (rows < 1 || C < 1 || (long long)rows * C >= (1ll << 31) || blocks < 1 ||
      (long long)blocks * 2 * C >= (1ll << 31) || gate_kind < 0 || gate_kind > 3 ||
      (gate_kind && (!gate || !dg)) || (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
  if (quads) {
    err = rows_quads(values, lanes, masked, gate_kind, blocks, stream, x, gate, scale, bias, dy,
                     dx, dg, part, rows, C, params, eps);
  }
#define FM_LN_BWD(V, G, MASK)                                                                 \
  if (!quads && values == V && lanes == G && (masked != 0) == MASK)                           \
    err = launch<IO, V, G, MASK>(gate_kind, blocks, stream, x, gate, scale, bias, dy, dx, dg, \
                                 part, rows, C, params, eps);
  FM_LN_TEMPLATES(FM_LN_BWD)
#undef FM_LN_BWD
  if (err != 0) return err;
  ln_bwd_reduce<<<(2 * C + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceSlices), 0,
                  stream>>>(part, blocks, C, dscale, dbias);
  return (int)cudaGetLastError();
}

// the one-launch templates for bf16 I/O; none for fp32
template <class PT>
int rows_one(int, int, int, int, cudaStream_t, const float*, const PT*, const float*,
             const float*, float*, float*, float*, int, int, float) {
  return (int)cudaErrorInvalidValue;
}
template <class PT>
int rows_one(int B, int lanes, int masked, int blocks, cudaStream_t stream, const bf16* x,
             const PT* scale, const float* dm, const float* xmean, bf16* dx, float* dscale,
             float* dbias, int rows, int C, float eps) {
  if (C % 4 != 0 || (((uintptr_t)x | (uintptr_t)dx) & 7) != 0 || !xmean) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_BWD_ONE(Q, G, MASK)                                                        \
  if (lanes == G && (masked != 0) == MASK)                                                 \
    err = launch_lnm_one<PT, Q, G, MASK>(B, blocks, stream, x, scale, dm, xmean, dx, dscale, \
                                         dbias, rows, C, eps);
  FM_LN_BF16_TEMPLATES(FM_LNM_BWD_ONE)
#undef FM_LNM_BWD_ONE
  return err;
}

template <class IO, class PT>
int ln_mean_bwd(const IO* x, const PT* scale, const float* dm, const float* xmean, IO* dx,
                float* part, float* dscale, float* dbias, int B, int rows, int C, int values,
                int lanes, int masked, int quads, int blocks, float eps, cudaStream_t stream) {
  if (B < 1 || B > 65535 || rows < 1 || C < 1 || (long long)B * rows * C >= (1ll << 31) ||
      blocks < 1 || blocks > rows || (long long)B * blocks * C >= (1ll << 31) ||
      (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  if (quads) {
    return values == 12 ? rows_one(B, lanes, masked, blocks, stream, x, scale, dm, xmean, dx,
                                   dscale, dbias, rows, C, eps)
                        : (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_BWD(V, G, MASK)                                                                 \
  if (values == V && lanes == G && (masked != 0) == MASK)                                      \
    err = launch_lnm<IO, PT, V, G, MASK>(B, blocks, stream, x, scale, dm, dx, part, rows, C, eps);
  FM_LN_TEMPLATES(FM_LNM_BWD)
#undef FM_LNM_BWD
  if (err != 0) return err;
  lnm_bwd_reduce<<<(C + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceSlices), 0,
                   stream>>>(part, dm, B, B * blocks, C, rows, dscale, dbias);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (and gate, dg when gate_kind is 1 (silu), 2 (silu_sum) or 3 (raw)):
// (rows, C); part: (blocks, 2, C) scratch; dscale, dbias: (C,). scale,
// bias: fp32, or in the _bf16 entry bf16 where params is 1. values, lanes,
// masked, quads: the template (bwd_plan; quads, the bf16 design's quads a
// lane, only in the _bf16 entry); blocks: the grid of the first kernel. The
// _bf16 entry takes x, gate, dy, dx and dg as bf16.
extern "C" int fm_layer_norm_bwd(const float* x, const float* gate, const float* scale,
                                 const float* bias, const float* dy, float* dx, float* dg,
                                 float* part, float* dscale, float* dbias, int rows, int C,
                                 int gate_kind, int values, int lanes, int masked, int quads,
                                 int blocks, int params, float eps, cudaStream_t stream) {
  if (params) return (int)cudaErrorInvalidValue;
  return layer_norm_bwd(x, gate, scale, bias, dy, dx, dg, part, dscale, dbias, rows, C,
                        gate_kind, values, lanes, masked, quads, blocks, 0, eps, stream);
}
extern "C" int fm_layer_norm_bwd_bf16(const bf16* x, const bf16* gate, const void* scale,
                                      const void* bias, const bf16* dy, bf16* dx, bf16* dg,
                                      float* part, float* dscale, float* dbias, int rows, int C,
                                      int gate_kind, int values, int lanes, int masked,
                                      int quads, int blocks, int params, float eps,
                                      cudaStream_t stream) {
  return layer_norm_bwd(x, gate, scale, bias, dy, dx, dg, part, dscale, dbias, rows, C,
                        gate_kind, values, lanes, masked, quads, blocks, params != 0, eps,
                        stream);
}

// x, dx: (B, rows, C); dm: (B, C); xmean: with quads the forward's (B, C)
// means of xhat over the rows, else unused; part: (B, blocks, C) scratch
// (unused with quads); dscale, dbias: (C,). scale: fp32, or in the _bf16
// entry bf16 where params is 1. values, lanes, masked, quads: the template
// (lnm_bwd_plan; quads, the one-launch bf16 design, only in the _bf16
// entry); blocks: the blocks of each batch row in the grid (blocks, B). The
// _bf16 entry takes x and dx as bf16.
extern "C" int fm_ln_mean_bwd(const float* x, const void* scale, const float* dm,
                              const float* xmean, float* dx, float* part, float* dscale,
                              float* dbias, int B, int rows, int C, int values, int lanes,
                              int masked, int quads, int blocks, int params, float eps,
                              cudaStream_t stream) {
  if (quads || params) return (int)cudaErrorInvalidValue;
  return ln_mean_bwd(x, static_cast<const float*>(scale), dm, xmean, dx, part, dscale, dbias, B,
                     rows, C, values, lanes, masked, 0, blocks, eps, stream);
}
extern "C" int fm_ln_mean_bwd_bf16(const bf16* x, const void* scale, const float* dm,
                                   const float* xmean, bf16* dx, float* part, float* dscale,
                                   float* dbias, int B, int rows, int C, int values, int lanes,
                                   int masked, int quads, int blocks, int params, float eps,
                                   cudaStream_t stream) {
  if (params) {
    return ln_mean_bwd(x, static_cast<const bf16*>(scale), dm, xmean, dx, part, dscale, dbias,
                       B, rows, C, values, lanes, masked, quads, blocks, eps, stream);
  }
  return ln_mean_bwd(x, static_cast<const float*>(scale), dm, xmean, dx, part, dscale, dbias, B,
                     rows, C, values, lanes, masked, quads, blocks, eps, stream);
}
