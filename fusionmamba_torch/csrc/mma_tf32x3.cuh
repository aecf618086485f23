// Tile engines of the fused-MLP kernels (fused_mlp_fwd.cu, fused_mlp_bwd.cu):
// fp32 matrix products on Hopper's tensor cores at fp32-class accuracy.
//
// Each fp32 operand x is split into big = tf32(x) and small = x - big, and
// every product is formed as three TF32 products, small*big + big*small +
// big*big, accumulated in fp32 (CUTLASS calls this "fast fp32"). A single
// TF32 product keeps about 3 decimal digits, which breaks a 1e-4 tolerance
// at K = 3072; the split keeps the error near fp32's
// (tests/test_torch_tf32x3.py emulates both). Three TF32 products at 495
// TFLOP/s are 165 TFLOP/s of fp32 work, 2.5x the CUDA cores' 67.
//
// Two engines, each where it measured faster (PERF.md):
//  - Gemm (mma.sync m16n8k8): operands staged in shared memory by a
//    kStages-deep ring of 16-byte cp.async copies, as [row][kBK] when K is
//    contiguous in device memory and as [k][rows] when the rows are, each
//    swizzled so that the lanes' fragment loads hit 32 different banks;
//    every fragment is split in registers as it is loaded. Small tiles and
//    two blocks an SM: it serves the fused forward and the backward, whose
//    products are short or many.
//  - WgGemm (wgmma, the only path to the full tensor-core rate; mma.sync
//    peaks near two thirds of it): each slice is split once per block into
//    shared-memory planes that wgmma reads. It serves the forward's long
//    128x128 products.
// Ragged edges read as zero, so rows, columns and K need no multiple of the
// tile; leading dimensions must be multiples of 16 bytes (4 floats, 8 bf16)
// and base pointers 16-byte aligned (the wrappers check both). No atomics
// anywhere.
//
// bf16 operands (IO = bf16). A bf16 value is exact in TF32 (8 mantissa bits
// against 10), so the product of two is exact in one TF32 product: the
// engines take one product each, not three, with fp32 accumulation, which
// is what the TPU kernels' bf16 dots with fp32 accumulation compute. The
// Gemm engine stages bf16 slices as they are (half the bytes, by the same
// 16-byte cp.async, eight values a copy, in their own swizzle) and takes a
// value to fp32 as a fragment loads it (a shift: exact); the warpgroup
// engine converts as it loads a slice into registers and stores only the
// big planes.
#pragma once

#include "io_types.cuh"

namespace fm {

using fm_io::bf16;
using fm_io::from_f;
using fm_io::to_f;

// whether products of IO operands need the 3xTF32 split (fp32) or are exact
// in one TF32 product (bf16)
template <class IO>
constexpr bool kSplitOf = sizeof(IO) == sizeof(float);

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kBK = 32;        // depth of one staged K slice
constexpr int kStages = 3;     // cp.async ring depth

// x = big + small. big is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds, but in two integer
// operations. small = x - big is exact in fp32; the tensor cores read only
// its 19 high bits, so it enters the product truncated to TF32, about
// 2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// copy `bytes` (0..16) of gmem to smem and zero the rest of the 16
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A kRows x kBK slice of an operand in shared memory, unpadded. Element
// (r, k) of the operand is g[r * ld + k] when kKMajor, g[k * ld + r]
// otherwise; it is staged as [r][kBK] or [k][kRows] with the 16-byte chunks
// of each row permuted (XOR swizzle) so that the fragment loads of
// mma_slice, pairs (r, k), (r, k + 1) with k even, hit 32 different banks.
template <int kRows, bool kKMajor, class IO = float>
struct Staged {
  static constexpr int kFloats = kRows * kBK;
  static_assert(kRows % 32 == 0, "whole swizzle groups");

  __device__ __forceinline__ static int index(int r, int k) {
    return kKMajor ? r * kBK + (((k >> 2) ^ ((r & 3) << 1)) << 2) + (k & 3)
                   : k * kRows + (((r >> 2) ^ (((k >> 1) & 3) << 1)) << 2) + (r & 3);
  }

  // elements (r, k) and (r, k + 1), k even
  __device__ __forceinline__ static float2 pair(const float* s, int r, int k) {
    if (kKMajor) return *reinterpret_cast<const float2*>(s + index(r, k));
    return make_float2(s[index(r, k)], s[index(r, k + 1)]);
  }

  // stage rows [r0, r0 + kRows) and depth [k0, k0 + kBK) of an operand of
  // `rows` rows and depth `k_end`; what lies outside reads as 0
  __device__ __forceinline__ static void load(float* s, const float* g, int ld, int r0,
                                              int rows, int k0, int k_end) {
    static_assert(sizeof(IO) == sizeof(float), "the fp32 staging");
    constexpr int kChunks = kRows * kBK / 4;
    static_assert(kChunks % kThreads == 0, "whole copy rounds");
#pragma unroll
    for (int it = 0; it < kChunks / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      int r, k, n;
      if (kKMajor) {
        r = c / (kBK / 4);
        k = (c % (kBK / 4)) * 4;
        n = r0 + r < rows ? min(4, k_end - k0 - k) : 0;
      } else {
        k = c / (kRows / 4);
        r = (c % (kRows / 4)) * 4;
        n = k0 + k < k_end ? min(4, rows - r0 - r) : 0;
      }
      n = max(n, 0);
      const float* src =
          n > 0 ? (kKMajor ? g + (size_t)(r0 + r) * ld + k0 + k : g + (size_t)(k0 + k) * ld + r0 + r)
                : g;
      cp_async16(s + index(r, k), src, 4 * n);
    }
  }
};

// The bf16 slice: [r][kBK] or [k][kRows] bf16, in 16-byte chunks of 8 values
// along the contiguous axis, swizzled so that the fragment loads (pairs
// (r, k), (r, k + 1), k even, over the 8 rows and 4 pair columns of a warp)
// fall in different banks. `s` is the stage's float pointer; kFloats counts
// the floats the slice takes (half its values).
template <int kRows, bool kKMajor>
struct Staged<kRows, kKMajor, bf16> {
  static constexpr int kFloats = kRows * kBK / 2;
  static_assert(kRows % 32 == 0, "whole swizzle groups");

  __device__ __forceinline__ static int index(int r, int k) {
    return kKMajor ? r * kBK + ((((k >> 3) ^ ((r >> 1) & 3)) << 3) | (k & 7))
                   : k * kRows + ((((r >> 3) ^ ((k >> 1) & 3)) << 3) | (r & 7));
  }

  __device__ __forceinline__ static float2 pair(const float* s, int r, int k) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(s);
    if (kKMajor) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(h + index(r, k));
      return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
    }
    return make_float2(__uint_as_float((uint32_t)h[index(r, k)] << 16),
                       __uint_as_float((uint32_t)h[index(r, k + 1)] << 16));
  }

  __device__ __forceinline__ static void load(float* s, const bf16* g, int ld, int r0, int rows,
                                              int k0, int k_end) {
    constexpr int kChunks = kRows * kBK / 8;
    bf16* sh = reinterpret_cast<bf16*>(s);
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      int r, k, n;
      if (kKMajor) {
        r = c / (kBK / 8);
        k = (c % (kBK / 8)) * 8;
        n = r0 + r < rows ? min(8, k_end - k0 - k) : 0;
      } else {
        k = c / (kRows / 8);
        r = (c % (kRows / 8)) * 8;
        n = k0 + k < k_end ? min(8, rows - r0 - r) : 0;
      }
      n = max(n, 0);
      const bf16* src =
          n > 0 ? (kKMajor ? g + (size_t)(r0 + r) * ld + k0 + k : g + (size_t)(k0 + k) * ld + r0 + r)
                : g;
      cp_async16(sh + index(r, k), src, 2 * n);
    }
  }
};

// acc[i][j] += A(wm0 + 16i + .., k) B(k, wn0 + 8j + ..) over the kBK of the
// staged slices `as` (rows of A) and `bs` (columns of B), in the mma
// accumulator layout: lane (g = lane / 4, t = lane % 4) holds rows g, g + 8
// and columns 2t, 2t + 1 of each 16x8 block. AT and BT provide pair(s, r, k).
// The mma's k slots t and t + 4 take the operands' k = 2t and 2t + 1 (the
// same permutation of the sum for A and B), so each lane loads adjacent
// pairs. Without kSplit (operands exact in TF32: bf16 values) each product
// is the one TF32 product big*big.
template <int kMT, int kNT, class AT, class BT, bool kSplit = true>
__device__ __forceinline__ void mma_slice(float (&acc)[kMT][kNT][4], const float* as,
                                          const float* bs, int wm0, int wn0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bb[kNT][2], bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float2 v = BT::pair(bs, wn0 + 8 * j + g, kk + 2 * t);
      split_tf32(v.x, bb[j][0], bl[j][0]);
      split_tf32(v.y, bb[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int m = wm0 + 16 * i + g;
      const float2 lo = AT::pair(as, m, kk + 2 * t), hi = AT::pair(as, m + 8, kk + 2 * t);
      uint32_t ab[4], al[4];
      split_tf32(lo.x, ab[0], al[0]);
      split_tf32(hi.x, ab[1], al[1]);
      split_tf32(lo.y, ab[2], al[2]);
      split_tf32(hi.y, ab[3], al[3]);
      // the small terms first, then big*big
      if (kSplit) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], al, bb[j]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ab, bl[j]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ab, bb[j]);
    }
  }
}

// A block tile of (kWarpsM * kMT * 16) x (kWarpsN * kNT * 8), 8 warps in a
// kWarpsM x kWarpsN grid, each owning kMT x kNT mma blocks.
template <int kWarpsM, int kMT, int kNT>
struct Warps {
  static constexpr int kWarpsN = kThreads / 32 / kWarpsM;
  static constexpr int MT = kMT, NT = kNT;
  static constexpr int BM = kWarpsM * kMT * 16, BN = kWarpsN * kNT * 8;
  using Acc = float[kMT][kNT][4];

  __device__ __forceinline__ static int wm0() { return (threadIdx.x / 32 % kWarpsM) * kMT * 16; }
  __device__ __forceinline__ static int wn0() { return (threadIdx.x / 32 / kWarpsM) * kNT * 8; }

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // f(i, j, h, m, n) for each pair acc[i][j][2h], acc[i][j][2h + 1]: row m,
  // columns n and n + 1 of the block tile at (m0, n0); n is even
  template <class F>
  __device__ __forceinline__ static void for_each_pair(int m0, int n0, F f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(i, j, h, m0 + wm0() + 16 * i + g + 8 * h, n0 + wn0() + 8 * j + 2 * t);
  }
};

// acc += A[m0 : m0 + BM, k_begin : k_end] B[k_begin : k_end, n0 : n0 + BN]
// for A with M rows and B with N columns, A(m, k) = A[m * lda + k] when
// kAK (else A[k * lda + m]) and B(k, n) = B[n * ldb + k] when kBKMajor
// (else B[k * ldb + n]). `smem` holds kSmemFloats; it is free again on return.
template <class W, bool kAK, bool kBKMajor, class IO = float>
struct Gemm {
  using AT = Staged<W::BM, kAK, IO>;
  using BT = Staged<W::BN, kBKMajor, IO>;
  static constexpr int kStageFloats = AT::kFloats + BT::kFloats;
  static constexpr int kSmemFloats = kStages * kStageFloats;

  __device__ __forceinline__ static void run(typename W::Acc& acc, const IO* A, int lda, int M,
                                             const IO* B, int ldb, int N, int m0, int n0,
                                             int k_begin, int k_end, float* smem) {
    const int nk = (k_end - k_begin + kBK - 1) / kBK;
    const int wm0 = W::wm0(), wn0 = W::wn0();
    auto issue = [&](int kt) {
      if (kt < nk) {
        float* s = smem + (kt % kStages) * kStageFloats;
        AT::load(s, A, lda, m0, M, k_begin + kt * kBK, k_end);
        BT::load(s + AT::kFloats, B, ldb, n0, N, k_begin + kt * kBK, k_end);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slice kt has landed for all; slot (kt - 1) % kStages is consumed
      issue(kt + kStages - 1);
      const float* s = smem + (kt % kStages) * kStageFloats;
      mma_slice<W::MT, W::NT, AT, BT, kSplitOf<IO>>(acc, s, s + AT::kFloats, wm0, wn0);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// The warpgroup engine: the same 3xTF32 products through Hopper's wgmma.
// TF32 wgmma reads both operands from shared memory with K contiguous, so
// each slice is split once per block instead of once per fragment load: the
// block's threads load it from device memory into registers (two slices
// ahead, in flight while this slice's products run), split every value
// into big and small and store four planes (A big, A small, B big, B small)
// in the 128-byte-swizzled K-major layout that wgmma reads. Two plane
// buffers alternate, so the products of one slice overlap the split and
// store of the next. Two warpgroups each own 64 rows of the 128-row tile.

// d += A (64 x 8) B (8 x 128), both from shared memory by descriptor; d is
// this thread's 64 of the warpgroup's 64 x 128 fp32 accumulator
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy stores to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across wgmma_wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory descriptor of a K-major plane: 128-byte rows (kBK
// tf32), 8-row atoms of 1024 bytes one after another, 128-byte swizzle
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// a kRows x kBK plane: element (r, k) at row r, its 16-byte chunk k / 4
// swizzled with r % 8, as the hardware's 128-byte swizzle places it
template <int kRows>
struct Plane {
  static constexpr int kFloats = kRows * kBK;
  __device__ __forceinline__ static int index(int r, int k) {
    return r * kBK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
  }
};

__device__ __forceinline__ void split4_store(float4 v, float* big, float* small, int at) {
  uint32_t b[4], l[4];
  split_tf32(v.x, b[0], l[0]);
  split_tf32(v.y, b[1], l[1]);
  split_tf32(v.z, b[2], l[2]);
  split_tf32(v.w, b[3], l[3]);
  *reinterpret_cast<uint4*>(big + at) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(small + at) = make_uint4(l[0], l[1], l[2], l[3]);
}

// This thread's share of a kRows x kBK slice of an operand whose element
// (r, k) is g[r * ld + k], held in registers (as fp32) between its load and
// its store into the planes: pieces (r, 4 k) of 4 values, eight to a row.
// Widths are multiples of 4, so each piece lies wholly inside or outside. A
// bf16 slice stores its big planes only (its small parts are zero).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) { return fm_io::load4(p); }

template <int kRows, class IO = float>
struct Slice {
  static constexpr int kPer = kRows * kBK / 4 / kThreads;
  static_assert(kPer * kThreads * 4 == kRows * kBK, "whole rounds");
  float4 v[kPer];

  __device__ __forceinline__ void load(const IO* g, int ld, int r0, int rows, int k0,
                                       int k_end) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int u = threadIdx.x + it * kThreads, r = u / (kBK / 4), k = 4 * (u % (kBK / 4));
      v[it] = r0 + r < rows && k0 + k < k_end ? ldg4(g + (size_t)(r0 + r) * ld + k0 + k)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float* big, float* small) const {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int u = threadIdx.x + it * kThreads, r = u / (kBK / 4), k = 4 * (u % (kBK / 4));
      if (kSplitOf<IO>) {
        split4_store(v[it], big, small, Plane<kRows>::index(r, k));
      } else {
        *reinterpret_cast<float4*>(big + Plane<kRows>::index(r, k)) = v[it];
      }
    }
  }
};

// acc += A[m0 : m0 + 128, k_begin : k_end] B[k_begin : k_end, n0 : n0 + 128]
// through wgmma, with A(m, k) = A[m * lda + k] and B(k, n) = B[n * ldb + k];
// rows m >= M, columns n >= N and k >= k_end read as 0. acc is this thread's
// share of its warpgroup's 64 x 128 accumulator. `smem` holds
// kSmemFloats, 1024-byte aligned; it is free again on return. bf16 operands
// (IO) take one wgmma a product (the header's note).
template <class IO = float>
struct WgGemm {
  static constexpr int BM = 128, BN = 128;
  static constexpr int kAcc = BN / 2;
  static constexpr int kBufFloats = 2 * Plane<BM>::kFloats + 2 * Plane<BN>::kFloats;
  static constexpr int kBufs = 2;  // plane buffers, alternating
  static constexpr int kSmemFloats = kBufs * kBufFloats;

  __device__ __forceinline__ static void run(float (&acc)[kAcc], const IO* A, int lda, int M,
                                             const IO* B, int ldb, int N, int m0, int n0,
                                             int k_begin, int k_end, float* smem) {
    const int nk = (k_end - k_begin + kBK - 1) / kBK;
    const int wg = threadIdx.x / 128;
    // two register stages: slice kt + 3 is loaded while slice kt's products
    // run, and stored two slices later
    Slice<BM, IO> sa0, sa1;
    Slice<BN, IO> sb0, sb1;
    auto a_big = [&](int buf) { return smem + buf * kBufFloats; };
    auto a_small = [&](int buf) { return a_big(buf) + Plane<BM>::kFloats; };
    auto b_big = [&](int buf) { return a_big(buf) + 2 * Plane<BM>::kFloats; };
    auto b_small = [&](int buf) { return b_big(buf) + Plane<BN>::kFloats; };
    auto load = [&](int kt, Slice<BM, IO>& sa, Slice<BN, IO>& sb) {
      if (kt < nk) {
        sa.load(A, lda, m0, M, k_begin + kt * kBK, k_end);
        sb.load(B, ldb, n0, N, k_begin + kt * kBK, k_end);
      }
    };
    auto store = [&](int buf, const Slice<BM, IO>& sa, const Slice<BN, IO>& sb) {
      sa.store(a_big(buf), a_small(buf));
      sb.store(b_big(buf), b_small(buf));
    };
    // the products of slice kt, then slice kt + 1 (held in sa, sb) into the
    // other buffer and slice kt + 3 into sa, sb
    auto step = [&](int kt, Slice<BM, IO>& sa, Slice<BN, IO>& sb) {
      const int buf = kt % kBufs;
      const uint64_t ab = plane_desc(a_big(buf) + wg * 64 * kBK);
      const uint64_t al = plane_desc(a_small(buf) + wg * 64 * kBK);
      const uint64_t bb = plane_desc(b_big(buf)), bl = plane_desc(b_small(buf));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        // 8 tf32 of K are 32 bytes: 2 in the descriptor's 16-byte units
        if (kSplitOf<IO>) {
          wgmma_m64n128k8(acc, al + 2 * kk, bb + 2 * kk);
          wgmma_m64n128k8(acc, ab + 2 * kk, bl + 2 * kk);
        }
        wgmma_m64n128k8(acc, ab + 2 * kk, bb + 2 * kk);
      }
      wgmma_commit();
      fence_acc(acc);
      if (kt + 1 < nk) {
        wgmma_wait<kBufs - 1>();  // this warpgroup's products of slice kt - 1 are done ...
        __syncthreads();          // ... and the other's: that slice's buffer is free
        store((kt + 1) % kBufs, sa, sb);
        load(kt + 3, sa, sb);
        fence_proxy_async();
        __syncthreads();
      }
    };
    load(0, sa0, sb0);
    load(1, sa1, sb1);
    store(0, sa0, sb0);
    load(2, sa0, sb0);
    fence_proxy_async();
    __syncthreads();
    for (int kt = 0; kt < nk; kt += 2) {
      step(kt, sa1, sb1);
      if (kt + 1 < nk) step(kt + 1, sa0, sb0);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();
  }

  __device__ __forceinline__ static void zero(float (&acc)[kAcc]) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  }

  // f(i, m, n) for each pair acc[i], acc[i + 1] (i even): row m, columns n
  // and n + 1 of the block tile at (m0, n0); n is even
  template <class F>
  __device__ __forceinline__ static void for_each_pair(int m0, int n0, F f) {
    const int t = threadIdx.x, lane = t & 31;
    const int row = m0 + (t / 128) * 64 + (t / 32 % 4) * 16 + lane / 4, col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) f(4 * j + 2 * h, row + 8 * h, col + 8 * j);
  }
};

__host__ __device__ inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

// allow `bytes` of dynamic shared memory for `kernel`
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ float gelu_exact(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

}  // namespace fm
