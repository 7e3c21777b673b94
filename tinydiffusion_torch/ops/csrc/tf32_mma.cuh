// Building blocks shared by flash_fwd.cu and flash_bwd.cu (float32): float32
// products on the tensor cores by 3xTF32 wgmma, and cp.async staging of
// (rows, N) tiles of float32 operands. The bfloat16 kernels have their own
// (bf16_mma.cuh).
//
// 3xTF32. A tensor core reads a "tf32" operand as the top 19 bits of a 32-bit
// register (sign, 8 exponent bits, 10 mantissa bits) and ignores the low 13.
// split() rounds x to the nearest tf32 (cvt.rna) for hi and masks the low bits,
// so that hi is exactly the value the tensor core sees; lo = x - hi is then
// exact, |lo| <= 2^-11 |x|, and the tensor core reads its top 19 bits, which
// leaves an error of at most 2^-21 |x| (rounding lo as well gave the same
// accuracy in a CPU emulation, and costs one more instruction a value).
// wgmma3_*() sum lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (small terms first); the
// dropped lo_a*lo_b is ~2^-22 of the product. One tf32 pass would carry ~2^-11
// relative per operand. This is the CUDA counterpart of the TPU kernel's bf16x3
// split (tinydiffusion_tpu/ops/attention.py:70-103).
//
// Accumulation. The tensor core adds into its float32 accumulators with
// truncation, so a sum kept in tensor-core accumulators over thousands of steps
// drifts past float32's tolerances. The kernels therefore start each tile's
// products from zero and add the tile's result to float32 registers with
// ordinary (round-to-nearest) adds.
//
// wgmma.mma_async m64nNk8 tf32: the 4 warps of a warpgroup issue one product of
// 64 rows; warp w owns rows 16w .. 16w + 15. For lane = 4 g + t (g = 0..7,
// t = 0..3) of a warp, its A registers (when A comes from registers) and its
// accumulators hold, within its 16 rows:
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   D (16 x N):  register 4i + e is element e of the n8 tile i:
//                e = 0 (g, 8i + 2t), 1 (g, 8i + 2t + 1), 2 (g + 8, 8i + 2t), 3 (g + 8, 8i + 2t + 1)
// A contraction does not care about the order of its K terms, so an
// accumulator tile feeds the next product's A directly: take its column 2t as
// A column t and its column 2t + 1 as A column t + 4 (a = {e0, e2, e1, e3}),
// and store the k8 step's rows of B in the same order (first rows 0, 2, 4, 6,
// then 1, 3, 5, 7).
//
// Operands in shared memory go through a descriptor. tf32 operands must be
// K-major: each of the M (or N) rows holds its K values contiguously. Without
// swizzle the unit is the core matrix, 8 rows x 16 bytes (4 tf32 of K) stored
// as 128 contiguous bytes; a k8 step spans two core matrices along K, lbo
// bytes apart, and the groups of 8 rows lie sbo bytes apart.
#pragma once

#include "sm90.cuh"

namespace tdt {

// Eight consecutive values from 16-byte aligned shared memory.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

struct Tf32x2 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32x2 split(float x) {
  uint32_t hi;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// The A registers of a warp's 16 x 8 share of a k8 step, split: a[i] holds a_i.
struct FragA8 {
  Tf32x2 a[4];
};

__device__ __forceinline__ FragA8 split_a8(float a0, float a1, float a2, float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}

// --- wgmma ---------------------------------------------------------------------

// d (m64nN, f32) += A (m64k8) B (k8nN), tf32; A in registers (rs) or in
// shared memory (ss), B in shared memory. The accumulate flag goes through a
// register, as PTX wants a predicate there.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// d += A B in 3xTF32 over k8: A split in registers, B's hi and lo planes by
// descriptor.
template <int N>
__device__ __forceinline__ void wgmma3_tf32(float (&d)[N / 2], const FragA8& a, uint64_t b_hi,
                                            uint64_t b_lo) {
  Wgmma<N>::rs(d, a.a[0].lo, a.a[1].lo, a.a[2].lo, a.a[3].lo, b_hi);
  Wgmma<N>::rs(d, a.a[0].hi, a.a[1].hi, a.a[2].hi, a.a[3].hi, b_lo);
  Wgmma<N>::rs(d, a.a[0].hi, a.a[1].hi, a.a[2].hi, a.a[3].hi, b_hi);
}

// d += A B in 3xTF32 over k8, A's and B's hi and lo planes by descriptor.
template <int N>
__device__ __forceinline__ void wgmma3_tf32_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo,
                                               uint64_t b_hi, uint64_t b_lo) {
  Wgmma<N>::ss(d, a_lo, b_hi);
  Wgmma<N>::ss(d, a_hi, b_lo);
  Wgmma<N>::ss(d, a_hi, b_hi);
}

__device__ __forceinline__ void reg_fence(FragA8& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reg_fence(f.a[i].hi);
    reg_fence(f.a[i].lo);
  }
}

// --- cp.async staging --------------------------------------------------------

// The copies of one (kRows, kCols) tile of a (kRows, n) row-major float
// matrix into dst[kRows][kStride] (shared memory) by kThreads threads, 16
// bytes each where kVec (n a multiple of 4 and src 16-byte aligned), else 4
// bytes each. A thread's chunks are fixed, so their offsets are computed once;
// issue(c0) copies columns [c0, c0 + kCols), zero-filling columns at or past n
// (src-size 0 reads nothing). Does not commit.
template <int kRows, int kCols, int kStride, int kThreads, bool kVec>
struct TileCopy {
  using T = float;
  static constexpr int kWidth = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kChunks = kRows * kCols / kWidth;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  static_assert((kCols * sizeof(T)) % 16 == 0 && (kStride * sizeof(T)) % 16 == 0,
                "16-byte rows");
  const T* src[kPerThread];
  uint32_t dst[kPerThread];  // shared-memory address
  int col[kPerThread];

  __device__ __forceinline__ TileCopy(T* smem, const T* g, int n) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int row = e / (kCols / kWidth), c = kWidth * (e % (kCols / kWidth));
      src[r] = g + static_cast<size_t>(row) * n + c;
      dst[r] = static_cast<uint32_t>(__cvta_generic_to_shared(smem + row * kStride + c));
      col[r] = c;
    }
  }

  __device__ __forceinline__ void issue(int c0, int n) const {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (kChunks % kThreads != 0 && threadIdx.x + r * kThreads >= kChunks) break;
      const bool in = c0 + col[r] < n;  // with kVec, all of the chunk in or all out
      const T* s = in ? src[r] + c0 : src[r];
      if constexpr (kVec) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst[r]), "l"(s),
                     "r"(in ? 16 : 0));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst[r]), "l"(s),
                     "r"(in ? 4 : 0));
      }
    }
  }
};

}  // namespace tdt
