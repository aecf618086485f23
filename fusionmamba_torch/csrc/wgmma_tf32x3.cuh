// The fp32 tile engine of the fused-MLP backward (fused_mlp_bwd.cu): the
// 3xTF32 products of mma_tf32x3.cuh (big = TF32 round of x, small = x - big,
// small*big + big*small + big*big with fp32 sums) on Hopper's TF32 warpgroup
// products (wgmma m64n128k8), fed by the Tensor Memory Accelerator (TMA) as
// the bf16 engine is (wgmma_bf16.cuh: its tensor maps, mbarriers, ring and
// descriptors), in persistent blocks.
//
// What the fp32 products need, and what this engine does about it:
//  - TF32 wgmma reads both operands from shared memory K-major (its depth
//    contiguous), rounded to TF32 by truncation. So no operand can be read
//    as it lands: TMA copies each 128 x 32 piece of an operand as it lies in
//    device memory (fp32 boxes of 128-byte rows in the 128-byte swizzle,
//    zeros past every ragged edge) into a ring of raw stages, and the two
//    consumer warpgroups split each landed stage once into four planes, A
//    big, A small, B big and B small, K-major in the same swizzle, which
//    the products read. A K-major piece lands in the planes' layout and is
//    split element for element; an MN-major one (stored [k][row]: the
//    transposed operands g^T, dy^T, x and a of the weight gradients, W1 and
//    W2 read across their rows) is transposed in the same pass, each lane
//    taking one depth of 4 rows, so that its loads and stores hit every
//    bank once. The split's pointers stay in the shared window
//    (aligned_shared): generic stores there cost 11% of a product launch.
//  - The split overlaps the products: two plane sets alternate, so one
//    slice's products run while the next slice is split; the raw ring
//    (kStages deep) lets one producer thread keep copies in flight, and a
//    raw stage is released as soon as it is split. (Splitter warpgroups of
//    their own, and A split in registers, measured no faster: PERF.md.)
//  - Persistent blocks: a grid of at most one block an SM (ops/mlp.py's
//    plan) walks its work items (output tiles, or tiles and depth slices)
//    b, b + grid, ...; the producer runs ahead across items, so the next
//    item's first stages load during this item's epilogue.
// Sums stay in registers in fp32; no atomics, so two launches give
// bit-identical results.
#pragma once

#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace fm_tc {

using fm_wg::desc;
using fm_wg::fence_regs;
using fm_wg::kConsumers;
using fm_wg::mbar_arrive;
using fm_wg::mbar_expect;
using fm_wg::mbar_wait;
using fm_wg::Pos;
using fm_wg::Ring;
using fm_wg::tma_load;

constexpr int kBK = 32;        // depth of a stage: one 128-byte row of fp32
constexpr int kTile = 128;     // rows and columns of an output tile
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kPieceBytes = kTile * kBK * 4;     // a 128 x 32 piece of an operand
constexpr int kStageBytes = 2 * kPieceBytes;     // the A piece, then the B piece
constexpr int kStages = 3;                       // raw stages in the ring
constexpr int kPlaneSetBytes = 4 * kPieceBytes;  // A big, A small, B big, B small
constexpr int kPlaneSets = 2;
// dynamic shared memory: the plane sets, then the ring's stages and its
// barriers, from a 1024-byte boundary (the swizzle's atom)
constexpr int kSmem = kPlaneSets * kPlaneSetBytes + kStages * kStageBytes +
                      fm_wg::ring_barrier_bytes(kStages) + fm_wg::kAlign;
// a K-major piece: two 64-row boxes; an MN-major one: four 32-wide boxes
constexpr int kRowsK = 64, kRowsMN = 32;

// the dynamic shared memory `raw` advanced to the swizzle's 1024-byte atom
// by an offset, not through an integer, so that the compiler keeps what is
// derived from it in the shared window (LDS and STS, not generic LD and ST)
__device__ __forceinline__ uint8_t* aligned_shared(uint8_t* raw) {
  return raw + ((fm_wg::kAlign - (fm_wg::smem_u32(raw) & (fm_wg::kAlign - 1))) &
                (fm_wg::kAlign - 1));
}

// the map of a row-major (outer, inner) fp32 tensor, its rows `ld` floats
// apart (0: inner), read K-major (`mn` false: boxes of 64 rows of 32 along
// `inner`) or MN-major (32 x 32 boxes)
inline bool make_map(CUtensorMap* map, const float* base, int inner, int outer, bool mn,
                     int ld = 0) {
  return fm_wg::make_map(map, base, inner, outer, kBK, mn ? kRowsMN : kRowsK, ld);
}

// the piece of rows (or columns) r0.. and depth k0.. of an operand whose
// map reads it K-major (stored [r][k]) or MN-major (stored [k][r])
template <int kMN>
__device__ __forceinline__ void load_piece(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                           int r0, int k0) {
  if (kMN) {
#pragma unroll
    for (int h = 0; h < kTile / kRowsMN; ++h)
      tma_load(dst + h * (kPieceBytes * kRowsMN / kTile), map, bar, r0 + kRowsMN * h, k0);
  } else {
#pragma unroll
    for (int h = 0; h < kTile / kRowsK; ++h)
      tma_load(dst + h * (kPieceBytes * kRowsK / kTile), map, bar, k0, r0 + kRowsK * h);
  }
}

// The producer's side of one output tile: nk stages of depth kBK from k0,
// each the A piece at rows a0, then the B piece at columns b0.
template <int kAMN, int kBMN>
__device__ __forceinline__ void produce(const Ring& r, Pos& pos, const CUtensorMap* a, int a0,
                                        const CUtensorMap* b, int b0, int k0, int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(r.empty + pos.stage, pos.phase ^ 1);
    uint64_t* full = r.full + pos.stage;
    uint8_t* s = r.stage(pos.stage);
    mbar_expect(full, kStageBytes);
    load_piece<kAMN>(s, a, full, a0, k0 + kt * kBK);
    load_piece<kBMN>(s + kPieceBytes, b, full, b0, k0 + kt * kBK);
    pos.next(r.stages);
  }
}

// element (r, k) of a 128 x 32 plane, in floats: row r of 128 bytes, its
// 16-byte chunk k / 4 swizzled with r % 8, as the hardware's 128-byte
// swizzle places it (mma_tf32x3.cuh's Plane)
__device__ __forceinline__ int plane_at(int r, int k) { return fm::Plane<kTile>::index(r, k); }

// A consumer thread's offsets (in floats) in an MN-major split, the same
// every stage. Warp w transposes rows 16 w .. 16 w + 15, lane k taking
// depth k: 4 rows at a time (c = 4 w + i: rows 4c .. 4c + 3) from the raw
// piece, where element (r, k) lies in box r / 32, row k, chunk
// (r % 32 / 4) ^ (k % 8); row 16 w + q goes to plane_at(16 w + q, k) =
// row[q % 8] + 32 (q - q % 8) (rows 8 apart share their swizzle).
struct SplitAt {
  int raw[4];
  int row[8];
  __device__ __forceinline__ explicit SplitAt(int t) {
    const int w = t / 32, k = t & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      raw[i] = (w >> 1) * (kRowsMN * kBK) + k * kBK + (((4 * (w & 1) + i) ^ (k & 7)) << 2);
#pragma unroll
    for (int m = 0; m < 8; ++m) row[m] = plane_at(16 * w + m, k);
  }
};
static_assert(kTile / (4 * kConsumers) == 16, "16 rows a consumer warp");

// split a landed piece into its big and small planes. t: the consumer
// thread (0..255). K-major: the raw piece is in the planes' layout, 16
// bytes a thread at a time. MN-major: transposed as SplitAt says, each
// lane's loads and stores hitting every bank once.
template <int kMN>
__device__ __forceinline__ void split_piece(const float* raw, float* big, float* small, int t,
                                            const SplitAt& at) {
  if (!kMN) {
#pragma unroll
    for (int i = 0; i < kTile * kBK / 4 / (128 * kConsumers); ++i) {
      const int u = t + i * 128 * kConsumers;
      fm::split4_store(reinterpret_cast<const float4*>(raw)[u], big, small, 4 * u);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(raw + at.raw[i]);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      fm::split_tf32(e[j], hi, lo);
      const int q = 4 * i + j, p = at.row[q & 7] + kBK * (q & 8);
      reinterpret_cast<uint32_t*>(big)[p] = hi;
      reinterpret_cast<uint32_t*>(small)[p] = lo;
    }
  }
}

// The consumers' side of one output tile: acc (this thread's share of its
// warpgroup's 64 x 128 accumulator, zeroed by the caller) += A B over nk
// stages. Stage kt is split into plane set (set0 + kt) % 2 once both
// warpgroups' products of the slice before last are done, and released to
// the producer once split; one slice's products stay in flight while the
// next is split. With kDrain, returns with every product done; without, the
// last slice's products may still be in flight, reading plane set
// (set0 + nk - 1) % 2: the next call then starts at the other set (its
// set0 = (set0 + nk) % 2), and the caller waits for them before it reads acc.
//
// With kPromote > 0 (and kDrain), the sums go to `sum` (zeroed by the
// caller, kTile / 2 floats in registers) and acc holds only the products
// of the last kPromote slices: every kPromote slices, once they are done,
// acc is added to sum on the CUDA cores and zeroed. The tensor cores add
// each depth step of 8 to their accumulator and round the sum toward zero
// (PERF.md), so over a deep K the accumulator drifts toward zero by about
// half an ulp of itself a step: at K = 8192, 3 x 1024 steps, ~1e-4 of it.
// The fp32 adds round to nearest, and a partial of kPromote slices is
// small beside the whole sum, so its drift is too.
template <int kAMN, int kBMN, bool kDrain = true, int kPromote = 0>
__device__ __forceinline__ void consume(float (&acc)[kTile / 2], const Ring& r, Pos& pos,
                                        uint8_t* planes, int nk, const SplitAt& at,
                                        int set0 = 0, float* sum = nullptr) {
  static_assert(kPromote == 0 || kDrain, "a promoted sum is read once every product is done");
  const int t = threadIdx.x, wg = t / 128;
  for (int kt = 0; kt < nk; ++kt) {
    float* set = reinterpret_cast<float*>(planes + ((set0 + kt) & 1) * kPlaneSetBytes);
    float* a_big = set;
    float* a_small = set + kTile * kBK;
    float* b_big = set + 2 * kTile * kBK;
    float* b_small = set + 3 * kTile * kBK;
    mbar_wait(r.full + pos.stage, pos.phase);
    fm::wgmma_wait<1>();
    fence_regs(acc);
    fm_wg::consumers_sync();  // both warpgroups' products of the slice before last are done
    const float* raw = reinterpret_cast<const float*>(r.stage(pos.stage));
    split_piece<kAMN>(raw, a_big, a_small, t, at);
    split_piece<kBMN>(raw + kTile * kBK, b_big, b_small, t, at);
    fm::fence_proxy_async();
    fm_wg::consumers_sync();  // the planes are whole; the raw stage is read
    if (t % 128 == 0) mbar_arrive(r.empty + pos.stage);
    pos.next(r.stages);
    if (kPromote && kt > 0 && kt % kPromote == 0) {
      fm::wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        sum[i] += acc[i];
        acc[i] = 0.f;
      }
    }
    const uint64_t ab = desc<0>(a_big + wg * 64 * kBK), al = desc<0>(a_small + wg * 64 * kBK);
    const uint64_t bb = desc<0>(b_big), bl = desc<0>(b_small);
    fence_regs(acc);
    fm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      // 8 tf32 of depth are 32 bytes: 2 of the descriptor's 16-byte units;
      // the small terms first, then big*big
      fm::wgmma_m64n128k8(acc, al + 2 * kk, bb + 2 * kk);
      fm::wgmma_m64n128k8(acc, ab + 2 * kk, bl + 2 * kk);
      fm::wgmma_m64n128k8(acc, ab + 2 * kk, bb + 2 * kk);
    }
    fm::wgmma_commit();
    fence_regs(acc);
  }
  if (kDrain) {
    fm::wgmma_wait<0>();
    fence_regs(acc);
    if (kPromote) {
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) sum[i] += acc[i];
    }
  }
}

// the plane sets at the start of the (aligned) dynamic shared memory, the
// ring of `stages` after them; thread 0 initialises the ring's barriers
// (the kernel then fences its inits and syncs the block)
__device__ __forceinline__ Ring ring_after_planes(uint8_t* smem, int stages = kStages) {
  return Ring::make(smem + kPlaneSets * kPlaneSetBytes, stages, kStageBytes);
}

// TMA stores: the box of `map` at (inner c0, outer c1) from shared memory
// at src (in the map's swizzle), what lies outside the tensor left out; a
// commit closes a group of them; wait_read<N> returns once all but the
// newest N groups have read their shared memory, wait_all<N> once they
// have also written it
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(fm_wg::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fm_tc
