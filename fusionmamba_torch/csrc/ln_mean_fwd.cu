// LN-spatial-mean forward for Hopper (sm_90a), fp32 or bf16 x (the statistics,
// the sums and the (B, C) output fp32 either way): m[b, c] = mean over the
// rows of LN(x[b])[:, c], x (B, rows, C), LN with the fast variance
// E[x^2] - E[x]^2 and rsqrt(var + eps), then scale and bias.
// Replaces fusionmamba_tpu/ops/ln_pallas.py::_lnm_fwd_kernel (built by
// _lnm_core).
//
// What bounds it: bytes. It reads x once and writes only (B, C), with some
// 8 flops an element; at the model's shapes a call moves 0.1-19 MB, so the
// small ones are set by one launch's fixed cost and the large ones by how
// many bytes are in flight.
//
// Design. One launch a call, no scratch in device memory, no atomics.
// - The rows: ln_common.cuh's templates (V values a lane x G lanes = C at
//   the model's widths, a masked variant for any other C). A block of T =
//   max(G, 512) threads holds T / G groups; each group takes U = 24 / V
//   rows at a time and loads all of their U * V values before it sums any,
//   so every thread keeps 24 loads in flight. The U rows' (sum x, sum x^2)
//   pairs take one round of group sums (one barrier for rows wider than a
//   warp). A lane adds xhat = (x - mean) * rs of its channels into
//   registers (mean and E[x^2] by multiplying with 1 / C); scale and bias are
//   folded in once at the end, m = (sum of xhat) / rows * scale + bias, from
//   registers loaded when the block starts.
// - The walk: a thread-block cluster per batch row, grid (cluster, B). Block
//   p of the cluster takes chunks p, p + cluster, ... of T / G * U
//   consecutive rows; in a chunk, group g takes rows g, g + T / G, ... So a
//   group sums its rows in increasing order.
// - The sums across groups and blocks, in a fixed order: each block sums its
//   groups' registers in group order into shared memory; after a cluster
//   barrier block 0 reads its peers' sums through distributed shared memory
//   (all of a column's at once) and adds them in rank order, and writes
//   m[b]; a second barrier keeps every peer's shared memory alive until
//   then. A cluster of one block (the small shapes) takes no cross-block
//   step. So two launches give the same bits.
// - The cluster size comes from the wrapper's plan
//   (fusionmamba_torch/ops/layer_norm.py::lnm_fwd_plan), at most 16: above
//   the portable 8 the kernel takes the non-portable attribute, and the entry
//   point refuses a size of which the card cannot hold one cluster.
//
// The bf16 design (lnm_fwd_kernel_quads). With bf16 x the strided layout
// loads 2 bytes a lane, 64 bytes a warp, and keeps half fp32's bytes in
// flight. Here the rows are ln_common.cuh's quads: a lane owns 3 runs of 4
// consecutive channels (C / 12 lanes a row at the model's widths, masked
// variants for any other C that is a multiple of 4), every load of x is 8
// bytes a lane, and a group loads U rows before it sums any: kQuadRows (48
// values a lane, the bytes of fp32's 24) where a batch row has the rows to
// fill its cluster, 2 or 1 where it has not (the plan halves U until it
// does: at the small shapes more blocks beat more bytes a lane). The raw
// quads stay packed in registers and are unpacked twice, for the row sums
// and for xhat, so that no row's values are held as fp32. The walk, the
// group and cluster sums and their order are the strided design's. A C that
// is not a multiple of 4, or an x off an 8-byte boundary, takes the strided
// templates (the plan chooses).
//
// Parameters. scale and bias are fp32, or in the bf16 entry either fp32 or
// bf16 (`params`), widened to fp32 as they are loaded (exactly), so that a
// bf16 step passes its bf16 parameters without a cast.
//
// The mean of xhat. Where the caller asks (a bf16 forward that records its
// backward), the quads kernel also writes (sum of xhat) / rows of each batch
// row and column, (B, C): the bf16 backward's dscale is the sum over b of dm
// times it, so that the backward needs no sum over rows across blocks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "io_types.cuh"
#include "ln_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFwdBlock = 512;    // threads of a block of groups of at most 512 lanes
constexpr int kRowValues = 24;    // values a lane loads ahead (U = kRowValues / V rows)
constexpr int kMaxCluster = 16;
constexpr int kQuadRows = 4;      // rows a group of the bf16 design loads at a time, at most

using fm_io::bf16;
using fm_io::to_f;

template <int V, int G>
struct Shape {
  static constexpr int T = G > kFwdBlock ? G : kFwdBlock;
  static constexpr int GPB = T / G;                        // groups of a block
  static constexpr int U = V >= kRowValues ? 1 : kRowValues / V;  // rows a group takes at a time
};

// Block 0 of the cluster, once every block holds its column sums in tot:
// adds its peers' through distributed shared memory in rank order and writes
// m[c] = sum / rows * scale + bias for the columns of this thread (sc, bi),
// and where xmean is given, the mean of xhat, sum / rows. Every thread of
// the cluster calls it: its barriers keep each peer's shared memory alive
// until block 0 has read it.
template <int T, int NC>
__device__ __forceinline__ void cluster_mean(cg::cluster_group& cluster, float* tot,
                                             const float (&sc)[NC], const float (&bi)[NC],
                                             float* m, float* xmean, int rows, int C) {
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  // blocks is the same in every block of the grid, so every thread of a
  // cluster takes the same branch and reaches its barriers
  if (blocks == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  if (rank == 0) {
    const float fr = (float)rows;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = threadIdx.x + k * T;
      if (c >= C) break;
      // every peer's value in flight at once, then the sum in rank order
      float peer[kMaxCluster];
#pragma unroll
      for (int p = 1; p < kMaxCluster; ++p) {
        peer[p] = p < blocks ? cluster.map_shared_rank(tot, p)[c] : 0.f;
      }
      float t = tot[c];
#pragma unroll
      for (int p = 1; p < kMaxCluster; ++p) {
        if (p < blocks) t += peer[p];
      }
      m[c] = t / fr * sc[k] + bi[k];
      if (xmean) xmean[c] = t / fr;
    }
  }
  if (blocks > 1) cluster.sync();
}

template <class IO, class PT, int V, int G, bool MASK>
__global__ void __launch_bounds__(Shape<V, G>::T, MASK ? 1 : 2)
lnm_fwd_kernel(const IO* __restrict__ x, const PT* __restrict__ scale,
               const PT* __restrict__ bias, float* __restrict__ out, int rows, int C,
               float eps) {
  constexpr int T = Shape<V, G>::T, GPB = Shape<V, G>::GPB, U = Shape<V, G>::U;
  constexpr int CW = V * G;  // channels a group holds (C, or more where masked)
  // the group sums' slots for rows wider than a warp, two sets taken in
  // turn so that one barrier a chunk keeps a chunk's reads ahead of the
  // next chunk's writes
  __shared__ float2 red[2][G > 32 ? U * T / 32 : 1];
  __shared__ float sums[GPB > 1 ? GPB : 1][GPB > 1 ? CW : 1];
  __shared__ float tot[CW];
  constexpr int NC = (CW + T - 1) / T;  // columns a thread writes at the end
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const IO* xb = x + (size_t)blockIdx.y * rows * C + lane;
  const float inv_c = 1.f / (float)C;
  // scale and bias of the columns this thread writes, loaded now so that
  // their latency is not on the path after the last barrier
  float sc[NC], bi[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + k * T;
    sc[k] = rank == 0 && c < C ? to_f(scale[c]) : 0.f;
    bi[k] = rank == 0 && c < C ? to_f(bias[c]) : 0.f;
  }

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  int turn = 0;
  for (int base = rank * GPB * U; base < rows; base += blocks * GPB * U, turn ^= 1) {
    float xv[U][V];
    float2 s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * GPB + grp;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool ok = r < rows && (!MASK || lane + v * G < C);
        xv[u][v] = ok ? fm_io::to_f(xb[r * C + v * G]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = make_float2(0.f, 0.f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s[u].x += xv[u][v];
        s[u].y = fmaf(xv[u][v], xv[u][v], s[u].y);
      }
    }
    fm_ln::group_sums<G, U>(s, red[turn]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float mu = s[u].x * inv_c;
      const float rs = rsqrtf(s[u].y * inv_c - mu * mu + eps);
      const bool live = base + u * GPB + grp < rows;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (live && (!MASK || lane + v * G < C)) acc[v] += (xv[u][v] - mu) * rs;
      }
    }
  }

  if constexpr (GPB == 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) tot[lane + v * G] = acc[v];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) sums[grp][lane + v * G] = acc[v];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += T) {
      float t = sums[0][c];
#pragma unroll
      for (int g = 1; g < GPB; ++g) t += sums[g][c];
      tot[c] = t;
    }
  }
  cluster_mean<T>(cluster, tot, sc, bi, out + blockIdx.y * C, nullptr, rows, C);
}

// The bf16 design (see above): Q quads a lane, G lanes a row, U rows a group
// at a time; the walk and the sums in lnm_fwd_kernel's order.
// Two blocks an SM (64 registers) where a lane's U rows of quads and group
// sums fit them; one where a row spans warps and U rows more than 128 lanes.
template <class PT, int Q, int G, int U, bool MASK>
__global__ void __launch_bounds__(Shape<4 * Q, G>::T, MASK || U * G > 128 ? 1 : 2)
lnm_fwd_kernel_quads(const bf16* __restrict__ x, const PT* __restrict__ scale,
                     const PT* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ xmean, int rows, int C, float eps) {
  static_assert(U >= 1 && U <= kQuadRows, "rows a group loads at a time");
  constexpr int V = 4 * Q, T = Shape<V, G>::T, GPB = Shape<V, G>::GPB;
  constexpr int CW = V * G;
  __shared__ float2 red[2][G > 32 ? U * T / 32 : 1];
  __shared__ __align__(16) float sums[GPB > 1 ? GPB : 1][GPB > 1 ? CW : 4];
  __shared__ __align__(16) float tot[CW];
  constexpr int NC = (CW + T - 1) / T;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const bf16* xb = x + (size_t)blockIdx.y * rows * C + 4 * lane;
  const float inv_c = 1.f / (float)C;
  float sc[NC], bi[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + k * T;
    sc[k] = rank == 0 && c < C ? to_f(scale[c]) : 0.f;
    bi[k] = rank == 0 && c < C ? to_f(bias[c]) : 0.f;
  }
  bool has[Q];  // quad q holds channels of the row
#pragma unroll
  for (int q = 0; q < Q; ++q) has[q] = !MASK || 4 * (lane + q * G) < C;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  int turn = 0;
  for (int base = rank * GPB * U; base < rows; base += blocks * GPB * U, turn ^= 1) {
    uint2 raw[U][Q];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * GPB + grp;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        raw[u][q] = r < rows && has[q] ? fm_ln::load_quad(xb + r * C + 4 * q * G)
                                       : make_uint2(0u, 0u);
      }
    }
    float2 s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 a = fm_ln::unpack(raw[u][q]);
        s[u].x += a.x;
        s[u].y = fmaf(a.x, a.x, s[u].y);
        s[u].x += a.y;
        s[u].y = fmaf(a.y, a.y, s[u].y);
        s[u].x += a.z;
        s[u].y = fmaf(a.z, a.z, s[u].y);
        s[u].x += a.w;
        s[u].y = fmaf(a.w, a.w, s[u].y);
      }
    }
    fm_ln::group_sums<G, U>(s, red[turn]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float mu = s[u].x * inv_c;
      const float rs = rsqrtf(s[u].y * inv_c - mu * mu + eps);
      const bool live = base + u * GPB + grp < rows;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (live && has[q]) {
          const float4 a = fm_ln::unpack(raw[u][q]);
          acc[4 * q] += (a.x - mu) * rs;
          acc[4 * q + 1] += (a.y - mu) * rs;
          acc[4 * q + 2] += (a.z - mu) * rs;
          acc[4 * q + 3] += (a.w - mu) * rs;
        }
      }
    }
  }

  if constexpr (GPB == 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = 4 * (lane + q * G);
      *reinterpret_cast<float4*>(&tot[c]) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = 4 * (lane + q * G);
      *reinterpret_cast<float4*>(&sums[grp][c]) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += T) {
      float t = sums[0][c];
#pragma unroll
      for (int g = 1; g < GPB; ++g) t += sums[g][c];
      tot[c] = t;
    }
  }
  cluster_mean<T>(cluster, tot, sc, bi, out + blockIdx.y * C,
                  xmean ? xmean + blockIdx.y * C : nullptr, rows, C);
}

// Launches `kernel` (threads a block) on a grid of one cluster of `cluster`
// blocks for each of the B batch rows. attr and fits are the kernel's own:
// whether its non-portable cluster attribute was set, and for each size
// whether the card was found to hold one cluster.
template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, int threads, int B, int cluster, cudaStream_t stream,
                   cudaError_t attr, bool (&fits)[kMaxCluster + 1], Args... args) {
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  // whether the card holds one cluster of this size, asked once a size
  if (!fits[cluster]) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    fits[cluster] = true;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class IO, class PT, int V, int G, bool MASK>
int launch(int B, int cluster, cudaStream_t stream, const IO* x, const PT* scale, const PT* bias,
           float* out, int rows, int C, float eps) {
  auto* kernel = lnm_fwd_kernel<IO, PT, V, G, MASK>;
  // set once for each variant: clusters above the portable 8 blocks
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  static bool fits[kMaxCluster + 1] = {};
  return launch_cluster(kernel, Shape<V, G>::T, B, cluster, stream, attr, fits, x, scale, bias,
                        out, rows, C, eps);
}

template <class PT, int Q, int G, int U, bool MASK>
int launch_quads(int B, int cluster, cudaStream_t stream, const bf16* x, const PT* scale,
                 const PT* bias, float* out, float* xmean, int rows, int C, float eps) {
  auto* kernel = lnm_fwd_kernel_quads<PT, Q, G, U, MASK>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  static bool fits[kMaxCluster + 1] = {};
  return launch_cluster(kernel, Shape<4 * Q, G>::T, B, cluster, stream, attr, fits, x, scale,
                        bias, out, xmean, rows, C, eps);
}

// the quads templates for bf16 x; none for fp32
template <class PT>
int rows_quads(const float*, const PT*, const PT*, float*, float*, int, int, int, int, int, int,
               int, float, cudaStream_t) {
  return (int)cudaErrorInvalidValue;
}
template <class PT>
int rows_quads(const bf16* x, const PT* scale, const PT* bias, float* out, float* xmean, int B,
               int rows, int C, int lanes, int masked, int unroll, int cluster, float eps,
               cudaStream_t stream) {
  if (C % 4 != 0 || ((uintptr_t)x & 7) != 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_FWD_QUADS(Q, G, MASK)                                                           \
  if (lanes == G && (masked != 0) == MASK) {                                                    \
    if (unroll == 4)                                                                            \
      err = launch_quads<PT, Q, G, 4, MASK>(B, cluster, stream, x, scale, bias, out, xmean,     \
                                            rows, C, eps);                                      \
    if (unroll == 2)                                                                            \
      err = launch_quads<PT, Q, G, 2, MASK>(B, cluster, stream, x, scale, bias, out, xmean,     \
                                            rows, C, eps);                                      \
    if (unroll == 1)                                                                            \
      err = launch_quads<PT, Q, G, 1, MASK>(B, cluster, stream, x, scale, bias, out, xmean,     \
                                            rows, C, eps);                                      \
  }
  FM_LN_BF16_TEMPLATES(FM_LNM_FWD_QUADS)
#undef FM_LNM_FWD_QUADS
  return err;
}

template <class IO, class PT>
int ln_mean_fwd(const IO* x, const PT* scale, const PT* bias, float* out, float* xmean, int B,
                int rows, int C, int values, int lanes, int masked, int quads, int unroll,
                int cluster, float eps, cudaStream_t stream) {
  if (B < 1 || B > 65535 || rows < 1 || C < 1 || (long long)B * rows * C >= (1ll << 31) ||
      cluster < 1 || cluster > kMaxCluster ||
      (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  if (quads) {
    return values == 12 ? rows_quads(x, scale, bias, out, xmean, B, rows, C, lanes, masked,
                                     unroll, cluster, eps, stream)
                        : (int)cudaErrorInvalidValue;
  }
  if (xmean) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_FWD(V, G, MASK)                                                           \
  if (values == V && lanes == G && (masked != 0) == MASK && unroll == Shape<V, G>::U)     \
    err = launch<IO, PT, V, G, MASK>(B, cluster, stream, x, scale, bias, out, rows, C, eps);
  FM_LN_TEMPLATES(FM_LNM_FWD)
#undef FM_LNM_FWD
  return err;
}

}  // namespace

// x: (B, rows, C), fp32 or (the _bf16 entry) bf16; scale, bias: (C,), fp32,
// or in the _bf16 entry bf16 where params is 1; out: (B, C) fp32; xmean:
// null, or with quads (B, C) fp32 for the mean of xhat over the rows (the
// bf16 backward's dscale reads it). values, lanes, masked, quads: the
// template (quads, the bf16 design, only in the _bf16 entry), unroll: the
// rows a group loads at a time (the strided templates' own, 24 / values),
// cluster: the blocks of each batch row (lnm_fwd_plan).
extern "C" int fm_ln_mean_fwd(const float* x, const void* scale, const void* bias, float* out,
                              float* xmean, int B, int rows, int C, int values, int lanes,
                              int masked, int quads, int unroll, int cluster, int params,
                              float eps, cudaStream_t stream) {
  if (quads || params || xmean) return (int)cudaErrorInvalidValue;
  return ln_mean_fwd(x, static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                     nullptr, B, rows, C, values, lanes, masked, 0, unroll, cluster, eps, stream);
}
extern "C" int fm_ln_mean_fwd_bf16(const bf16* x, const void* scale, const void* bias,
                                   float* out, float* xmean, int B, int rows, int C, int values,
                                   int lanes, int masked, int quads, int unroll, int cluster,
                                   int params, float eps, cudaStream_t stream) {
  if (params) {
    return ln_mean_fwd(x, static_cast<const bf16*>(scale), static_cast<const bf16*>(bias), out,
                       xmean, B, rows, C, values, lanes, masked, quads, unroll, cluster, eps,
                       stream);
  }
  return ln_mean_fwd(x, static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                     xmean, B, rows, C, values, lanes, masked, quads, unroll, cluster, eps, stream);
}
