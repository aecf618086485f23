// The bf16 tile engine of the fused-MLP kernels' bf16 entry points
// (fused_mlp_fwd.cu, fused_mlp_bwd.cu): Hopper's bf16 warpgroup products
// (wgmma m64nNk16.f32.bf16.bf16, fp32 sums in registers) on operands that the
// Tensor Memory Accelerator (TMA) copies into shared memory. No operand is
// converted or restaged by threads, and no TF32 instruction is involved: a
// bf16 x bf16 product is exact in the fp32 sum.
//
// What the bf16 products need, and what this engine does about it:
//  - Operands straight from device memory to the tensor cores. Every operand
//    is a row-major bf16 tensor read through one CUtensorMap in 64 x 64 boxes
//    (rows of 128 bytes) in the 128-byte swizzle, which is the layout wgmma
//    reads. Ragged edges (M = 37, C = 96 against a 64-deep slice) are the
//    zeros that TMA writes for what lies outside the tensor.
//  - Transposed operands as they lie. bf16 wgmma reads an operand K-major
//    (its depth contiguous) or MN-major (its rows or columns contiguous),
//    chosen by the instruction's transpose bits, so a product whose operand
//    is stored [k][m] (g^T x, dy^T a) or [k][n] (dy W2, g W1) loads it as it
//    is. A 128 x 64 piece is two boxes either way: K-major, 2 x 64 rows of 64
//    k; MN-major, two 64-wide chunks of 64 k rows each.
//  - The copies overlap the products: one producer thread keeps a ring of
//    stages in flight (an mbarrier "full" a stage, completed by its copies'
//    bytes, and one "empty" that each consumer warpgroup arrives on), two
//    consumer warpgroups own 64 rows each of a 128-row tile and keep one
//    group of products in flight while they wait for the next stage.
// The tensor maps are encoded in the C entry points (the driver's
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point,
// so the library links without -lcuda) and passed as __grid_constant__
// parameters. Dynamic shared memory is rounded up to the swizzle's
// 1024-byte atom in the kernel (the launch asks for kAlign bytes more).
#pragma once

#include <cuda.h>

#include "io_types.cuh"

namespace fm_wg {

using fm_io::bf16;

constexpr int kBox = 64;                   // a TMA box: 64 x 64 bf16, rows of 128 bytes
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kBK = 64;                    // depth of a staged slice: one box
constexpr int kTile = 128;                 // rows (and columns) of a product block's tile
constexpr int kConsumers = 2;              // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kAlign = 1024;               // the 128-byte swizzle's atom: 8 rows

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// host: the tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <class T>
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
template <>
constexpr CUtensorMapDataType kMapType<float> = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// the map of a row-major (outer, inner) tensor of T (bf16 or fp32), its
// rows `ld` elements apart (0: inner, contiguous), read in boxes of
// box_inner x box_outer (bf16: 64 x 64) in the 128-byte swizzle (box_inner
// of 128 bytes), zeros outside it; false where cuTensorMapEncodeTiled
// refuses it (the row stride must be a multiple of 16 bytes and the base
// 16-byte aligned)
template <class T>
inline bool make_map(CUtensorMap* map, const T* base, int inner, int outer, int box_inner = kBox,
                     int box_outer = kBox, int ld = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld ? ld : inner) * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, kMapType<T>, 2, const_cast<T*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// device: barriers, copies, descriptors

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* aligned_smem(void* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + kAlign - 1) &
                                    ~(uintptr_t)(kAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// the inits become visible to the other threads and to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` of copies to complete the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// copy the box at (inner c0, outer c1) of `map` to dst; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a (64 n) x 64 piece of an operand, n boxes: rows (or columns) r0.. and
// depth k0..; `mn` for an operand stored [k][r], else [r][k]
__device__ __forceinline__ void load_piece(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                           bool mn, int r0, int k0, int n = 2) {
  for (int h = 0; h < n; ++h) {
    if (mn) {
      tma_load(dst + h * kBoxBytes, map, bar, r0 + kBox * h, k0);
    } else {
      tma_load(dst + h * kBoxBytes, map, bar, k0, r0 + kBox * h);
    }
  }
}

// wgmma's shared-memory descriptor in the 128-byte swizzle: 8-row atoms of
// 1024 bytes one after another (the stride field); an MN-major operand's
// 64-wide chunks kBoxBytes apart (the leading field; a K-major operand in
// this swizzle ignores it)
template <int kMN>
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t lbo = kMN ? kBoxBytes >> 4 : 1;
  return ((smem_u32(p) & 0x3FFFFull) >> 4) | (lbo << 16) | (64ull << 32) | (1ull << 62);
}
// the descriptor's step to the next 16 of depth, in its 16-byte units: 32
// bytes along a K-major row, 16 rows of 128 bytes in an MN-major chunk
template <int kMN>
constexpr uint64_t kStep16 = kMN ? 2048 >> 4 : 32 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to registers that in-flight
// products read or write across the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// two fp32 values as the bf16 pair of an A fragment, lo in the low half,
// each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the products. d is this thread's share of the warpgroup's 64 x N fp32
// accumulator: d[4j + 2h + e] is row 16 (warp % 4) + lane / 4 + 8h, column
// 8j + 2 (lane % 4) + e. wgmma_ss (N = 64): d += A (64 x 16) B (16 x N), both by
// descriptor, A's and B's transpose bits kTA, kTB (1: MN-major). wgmma_rs: A
// from registers, a[0..3] rows lane / 4 (+8 in a[1], a[3]), columns
// 2 (lane % 4) (+8 in a[2], a[3]) and the next, the accumulator's layout.
// Each adds to d (the instruction's scale-d predicate set).

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTB));
}

template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTB));
}

// The ring of stages in shared memory: each stage `bytes` long, with a full
// barrier (the producer's arrival and its copies' bytes) and an empty one
// (one arrival of each consumer warpgroup).
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, bytes;

  __device__ __forceinline__ uint8_t* stage(int s) const { return base + s * bytes; }

  // `stages` stages of `bytes` from smem (aligned), the barriers after
  // them; thread 0 initialises the barriers (the kernel then fences its
  // inits and syncs the block)
  __device__ __forceinline__ static Ring make(uint8_t* smem, int stages, int bytes) {
    Ring r{smem, nullptr, nullptr, stages, bytes};
    r.full = reinterpret_cast<uint64_t*>(smem + stages * bytes);
    r.empty = r.full + stages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(r.full + s, 1);
        mbar_init(r.empty + s, kConsumers);
      }
    }
    return r;
  }
};
// the bytes of `stages` stages' barriers
__host__ __device__ constexpr int ring_barrier_bytes(int stages) { return 16 * stages; }

// a position in the ring: the stage and the parity of its current phase
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's side of a tile: nk slices of depth kBK from k0, each stage
// an A piece of 128 rows (2 boxes) then a B piece of 64 nb columns (nb
// boxes).
__device__ __forceinline__ void produce_tile(const Ring& r, Pos& pos, const CUtensorMap* a,
                                             bool a_mn, int a0, const CUtensorMap* b, bool b_mn,
                                             int b0, int nb, int k0, int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.empty + pos.stage, pos.phase ^ 1);
    uint64_t* full = r.full + pos.stage;
    uint8_t* s = r.stage(pos.stage);
    mbar_expect(full, (2 + nb) * kBoxBytes);
    load_piece(s, a, full, a_mn, a0, k0 + kt * kBK);
    load_piece(s + 2 * kBoxBytes, b, full, b_mn, b0, k0 + kt * kBK, nb);
    pos.next(r.stages);
  }
}

// The consumer's side: acc (this thread's share of its warpgroup's 64 rows
// of the tile, 64 or 128 columns wide; zeroed by the caller) += A B over nk
// slices, the last holding `last16` steps of 16 (beyond them the depth is
// zero or outside the slice). One group of products stays in
// flight while the next stage is awaited; a stage is released once its
// products are done.
template <int kTA, int kTB, int kN>
__device__ __forceinline__ void consume_tile(float (&acc)[kN], const Ring& r, Pos& pos, int nk,
                                             int last16) {
  const int wg = threadIdx.x / 128;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.full + pos.stage, pos.phase);
    const uint8_t* s = r.stage(pos.stage);
    const uint64_t da = desc<kTA>(s + wg * kBoxBytes), db = desc<kTB>(s + 2 * kBoxBytes);
    const int steps = kt + 1 < nk ? kBK / 16 : last16;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)
      if (k < steps) wgmma_ss<kTA, kTB>(acc, da + k * kStep16<kTA>, db + k * kStep16<kTB>);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(r.empty + prev);
    prev = pos.stage;
    pos.next(r.stages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(r.empty + prev);
}

// slices of kBK in [k0, k1) and the steps of 16 in the last
__device__ __forceinline__ int slices_of(int k0, int k1) { return cdiv(k1 - k0, kBK); }
__device__ __forceinline__ int last16_of(int k0, int k1) {
  return cdiv(k1 - k0 - (slices_of(k0, k1) - 1) * kBK, 16);
}

// f(i, m, n) for each pair acc[i], acc[i + 1] of this thread's share of a
// 64 x (8 kJ) accumulator of its warpgroup, the warpgroup's rows at
// m0 + 64 wg: row m, columns n and n + 1 from n0
template <int kJ, class F>
__device__ __forceinline__ void for_each_pair(int m0, int n0, F f) {
  const int t = threadIdx.x, lane = t & 31;
  const int row = m0 + (t / 128) * 64 + (t / 32 % 4) * 16 + lane / 4, col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(4 * j + 2 * h, row + 8 * h, col + 8 * j);
}

__device__ __forceinline__ float gelu_exact(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// the consumer warpgroups' barrier, without the producer warp
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

constexpr int kBlocksPerSM = 2;  // of the product kernel and the backward's hidden kernel

// ---------------------------------------------------------------------------
// The product launch: 128 x kTileN output tiles of up to three products,
// each product's depth cut into slices (multiples of kBK) where the plan
// (ops/mlp.py) finds it much longer than a block's share of the launch;
// one block a tile and slice, numbered slice-major, then by tile row, then
// tile column, the products one after another, those of the deepest slices
// first (their blocks take longest: started first, they leave the short
// ones to fill in behind them). Each block's result goes through its
// product's epilogue: stored in bf16 (+ bias, + GELU), or, for a cut depth,
// stored as the slice's fp32 partial, which a reduce launch sums in a fixed
// order. Two blocks an SM, so one's epilogue overlaps the other's products.

enum Epilogue : int { kStore = 0, kBias = 1, kBiasGelu = 2, kPartial = 3 };

// columns of a product tile: 64-wide tiles measured faster than 128-wide
// ones at the model's shapes (more blocks in flight; PERF.md)
constexpr int kTileN = 64;

// out (rows, cols) = A (rows x depth) B (depth x cols): A's map covers the
// tensor stored [row][k], or [k][row] when a_mn; B's [col][k], or [k][col]
// when b_mn
struct Product {
  CUtensorMap a, b;
  const bf16* bias;
  bf16* out;
  float* part;  // (slices, rows, cols) where the epilogue is kPartial
  int rows, cols, depth, slice, a_mn, b_mn, epilogue;
  int tiles_n, tiles, blocks;  // blocks = tiles x slices
};
constexpr int kMaxProducts = 3;
struct Products {
  Product p[kMaxProducts];
  int count;
};
constexpr int kProductStages = 4;
constexpr int kProductStageBytes = (2 + kTileN / kBox) * kBoxBytes;
constexpr int kProductSmem =
    kProductStages * kProductStageBytes + ring_barrier_bytes(kProductStages) + kAlign;

// a product whose depth is cut into slices of `slice` (a multiple of kBK);
// with more than one its epilogue is kPartial into `part`
inline Product product(const CUtensorMap& a, bool a_mn, const CUtensorMap& b, bool b_mn, int rows,
                       int cols, int depth, int slice, int epilogue, const bf16* bias, bf16* out,
                       float* part) {
  Product p{a, b, bias, out, part, rows, cols, depth, slice, a_mn, b_mn, epilogue, 0, 0, 0};
  if (cdiv(depth, slice) > 1) p.epilogue = kPartial;
  p.tiles_n = cdiv(cols, kTileN);
  p.tiles = cdiv(rows, kTile) * p.tiles_n;
  p.blocks = p.tiles * cdiv(depth, slice);
  return p;
}

// kPass (0 the forward's, 1 the backward's) only names the launches apart in
// a profile
template <int kPass>
static __global__ void __launch_bounds__(kThreads, kBlocksPerSM)
product_kernel(const __grid_constant__ Products ps) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = Ring::make(aligned_smem(smem_raw), kProductStages, kProductStageBytes);
  if (threadIdx.x == 0) mbar_init_fence();
  __syncthreads();
  int b = blockIdx.x, i = 0;
  while (i + 1 < ps.count && b >= ps.p[i].blocks) b -= ps.p[i++].blocks;
  const Product& p = ps.p[i];
  const int s = b / p.tiles, m0 = b % p.tiles / p.tiles_n * kTile, n0 = b % p.tiles_n * kTileN;
  const int k0 = s * p.slice, k1 = min(p.depth, k0 + p.slice);
  const int nk = slices_of(k0, k1);
  Pos pos;
  if (threadIdx.x >= 128 * kConsumers) {
    if (threadIdx.x == 128 * kConsumers)
      produce_tile(r, pos, &p.a, p.a_mn, m0, &p.b, p.b_mn, n0, kTileN / kBox, k0, nk);
    return;
  }
  float acc[kTileN / 2];
  zero(acc);
  const int last16 = last16_of(k0, k1);
  if (p.a_mn) {
    if (p.b_mn) consume_tile<1, 1>(acc, r, pos, nk, last16);
    else consume_tile<1, 0>(acc, r, pos, nk, last16);
  } else {
    if (p.b_mn) consume_tile<0, 1>(acc, r, pos, nk, last16);
    else consume_tile<0, 0>(acc, r, pos, nk, last16);
  }
  float* part = p.part + (size_t)s * p.rows * p.cols;
  const int epi = p.epilogue, rows = p.rows, cols = p.cols;
  for_each_pair<kTileN / 8>(m0, n0, [&](int e, int m, int n) {
    if (m >= rows || n >= cols) return;  // cols % 8 == 0: n + 1 < cols too
    float v0 = acc[e], v1 = acc[e + 1];
    if (epi == kPartial) {
      *reinterpret_cast<float2*>(part + (size_t)m * cols + n) = make_float2(v0, v1);
      return;
    }
    if (epi != kStore) {
      v0 += fm_io::to_f(p.bias[n]);
      v1 += fm_io::to_f(p.bias[n + 1]);
    }
    if (epi == kBiasGelu) {
      v0 = gelu_exact(v0);
      v1 = gelu_exact(v1);
    }
    fm_io::store2(p.out + (size_t)m * cols + n, v0, v1);
  });
}

// launch the products ps.p[0 .. count) as one grid, those of the deepest
// slices first
template <int kPass>
inline cudaError_t launch_products(Products ps, cudaStream_t stream) {
  for (int i = 1; i < ps.count; ++i)
    for (int j = i; j > 0 && min(ps.p[j].slice, ps.p[j].depth) >
                                 min(ps.p[j - 1].slice, ps.p[j - 1].depth);
         --j) {
      const Product q = ps.p[j];
      ps.p[j] = ps.p[j - 1];
      ps.p[j - 1] = q;
    }
  int blocks = 0;
  for (int i = 0; i < ps.count; ++i) blocks += ps.p[i].blocks;
  const cudaError_t err = cudaFuncSetAttribute(
      product_kernel<kPass>, cudaFuncAttributeMaxDynamicSharedMemorySize, kProductSmem);
  if (err != cudaSuccess) return err;
  product_kernel<kPass><<<blocks, kThreads, kProductSmem, stream>>>(ps);
  return cudaGetLastError();
}

}  // namespace fm_wg
