// LN-spatial-mean forward for Hopper (sm_90a), fp32: m[b, c] = mean over the
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
//   (all of a column's at once) and adds them in rank order, and writes m[b]; a second barrier keeps every peer's shared
//   memory alive until then. A cluster of one block (the small shapes) takes
//   no cross-block step. So two launches give the same bits.
// - The cluster size comes from the wrapper's plan
//   (fusionmamba_torch/ops/layer_norm.py::lnm_fwd_plan), at most 16: above
//   the portable 8 the kernel takes the non-portable attribute, and the entry
//   point refuses a size of which the card cannot hold one cluster.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ln_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFwdBlock = 512;    // threads of a block of groups of at most 512 lanes
constexpr int kRowValues = 24;    // values a lane loads ahead (U = kRowValues / V rows)
constexpr int kMaxCluster = 16;

template <int V, int G>
struct Shape {
  static constexpr int T = G > kFwdBlock ? G : kFwdBlock;
  static constexpr int GPB = T / G;                        // groups of a block
  static constexpr int U = V >= kRowValues ? 1 : kRowValues / V;  // rows a group takes at a time
};

template <int V, int G, bool MASK>
__global__ void __launch_bounds__(Shape<V, G>::T, MASK ? 1 : 2)
lnm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ out, int rows, int C,
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
  const float* xb = x + (size_t)blockIdx.y * rows * C + lane;
  const float inv_c = 1.f / (float)C;
  // scale and bias of the columns this thread writes, loaded now so that
  // their latency is not on the path after the last barrier
  float sc[NC], bi[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + k * T;
    sc[k] = rank == 0 && c < C ? scale[c] : 0.f;
    bi[k] = rank == 0 && c < C ? bias[c] : 0.f;
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
        xv[u][v] = ok ? xb[r * C + v * G] : 0.f;
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
  // blocks is the same in every block of the grid, so every thread of a
  // cluster takes the same branch and reaches its barriers
  if (blocks == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  if (rank == 0) {
    float* m = out + blockIdx.y * C;
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
    }
  }
  if (blocks > 1) cluster.sync();
}

template <int V, int G, bool MASK>
int launch(int B, int cluster, cudaStream_t stream, const float* x, const float* scale,
           const float* bias, float* out, int rows, int C, float eps) {
  auto* kernel = lnm_fwd_kernel<V, G, MASK>;
  // set once for each variant: clusters above the portable 8 blocks
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(Shape<V, G>::T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  // whether the card holds one cluster of this size, asked once a size
  static bool fits[kMaxCluster + 1] = {};
  if (!fits[cluster]) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    fits[cluster] = true;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, scale, bias, out, rows, C, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, rows, C); scale, bias: (C,); out: (B, C). values, lanes, masked:
// the template and cluster: the blocks of each batch row (lnm_fwd_plan).
extern "C" int fm_ln_mean_fwd(const float* x, const float* scale, const float* bias, float* out,
                              int B, int rows, int C, int values, int lanes, int masked,
                              int cluster, float eps, cudaStream_t stream) {
  if (B < 1 || B > 65535 || rows < 1 || C < 1 || (long long)B * rows * C >= (1ll << 31) ||
      cluster < 1 || cluster > kMaxCluster ||
      (masked ? values * lanes < C : values * lanes != C)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaErrorInvalidValue;
#define FM_LNM_FWD(V, G, MASK)                             \
  if (values == V && lanes == G && (masked != 0) == MASK) \
    err = launch<V, G, MASK>(B, cluster, stream, x, scale, bias, out, rows, C, eps);
  FM_LN_TEMPLATES(FM_LNM_FWD)
#undef FM_LNM_FWD
  return err;
}
