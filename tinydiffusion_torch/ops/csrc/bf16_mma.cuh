// Building blocks of the bfloat16 flash kernels (flash_fwd_bf16.cu,
// flash_bwd_bf16.cu): bf16 products on the tensor cores by wgmma m64nNk16,
// float32 values as two bf16 planes, tiles staged as bf16 in the layout wgmma
// reads, and the barriers of a block whose producer warpgroup streams tiles to
// two consumer warpgroups.
//
// wgmma.mma_async m64nNk16 .f32.bf16.bf16: the 4 warps of a warpgroup issue one
// product of 64 rows; warp w owns rows 16w .. 16w + 15. For lane = 4 g + t
// (g = 0..7, t = 0..3) of a warp, its A registers (when A comes from registers,
// two bf16 a register, the lower column in the low half) and its float32
// accumulators hold, within its 16 rows:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//                a3 (g + 8, 2t+8..2t+9)
//   D (16 x N):  register 4i + e is element e of the n8 tile i:
//                e = 0 (g, 8i + 2t), 1 (g, 8i + 2t + 1), 2 (g + 8, 8i + 2t), 3 (g + 8, 8i + 2t + 1)
// So the accumulator's n8 tiles 2j and 2j + 1, packed in pairs, are the A
// fragment of k16 step j with no shuffle: a0 = (d[8j], d[8j+1]), a1 = (d[8j+2],
// d[8j+3]), a2 = (d[8j+4], d[8j+5]), a3 = (d[8j+6], d[8j+7]).
//
// Tiles. Every operand in shared memory is a tile of rows (d or c) x 64 tokens
// (keys or queries), copied from the (B, rows, N) layout as it is: each 16
// bytes of a row (8 consecutive tokens) are one row of a core matrix (8 x 16
// bytes, 128 contiguous bytes, no swizzle), at
//   tile_offset(row, tok) = (row / 8) * 1024 + (tok / 8) * 128 + (row % 8) * 16 + (tok % 8) * 2.
// wgmma reads that one layout both ways, by the descriptor:
// - tokens as the contraction (K-major: each N row holds 8 consecutive K
//   values), e.g. V in P V: kDescK, lbo = 128 (the next 8 tokens), sbo = 1024
//   (the next 8 rows); a k16 step of tokens is 256 bytes on;
// - rows as the contraction, tokens as N or M (MN-major, the transpose that
//   16-bit operands allow), e.g. K in Q K^T: kDescMN, lbo = 1024 (the next 8
//   rows of K), sbo = 128 (the next 8 tokens); a k16 step of rows is 2048
//   bytes on.
//
// Accumulation. Each product's float32 terms are exact (a product of two bf16
// values has 16 significant bits); the tensor core adds them into float32
// accumulators.
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace tdt {

using bf16 = __nv_bfloat16;

constexpr int kTileTokens = 64;
constexpr uint32_t kRowGroupBytes = 1024;  // 8 rows x 64 tokens
constexpr uint32_t kTokenGroupBytes = 128;  // one core matrix: 8 rows x 8 tokens

__host__ __device__ constexpr uint32_t tile_offset(int row, int tok) {
  return (row / 8) * kRowGroupBytes + (tok / 8) * kTokenGroupBytes + (row % 8) * 16 +
         (tok % 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptors of a tile at p read with tokens as K (kDescK) or as M/N (kDescMN).
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return smem_desc(p, kTokenGroupBytes, kRowGroupBytes);
}
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return smem_desc(p, kRowGroupBytes, kTokenGroupBytes);
}

// --- bf16 values and planes ------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two values as two bf16 planes: hi = bf16(x) (round to nearest even) and
// lo = bf16(x - hi), so hi + lo = x within 2^-16 |x|; packed a pair a register.
struct Planes {
  uint32_t hi, lo;
};

__device__ __forceinline__ Planes split_bf16(float a, float b) {
  const uint32_t hi = pack_bf16(a, b);
  return {hi, pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u))};
}

// The A fragments of an accumulator tile of 64 columns (4 k16 steps), as planes.
struct FragPlanes {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void to_planes(const float (&d)[32], FragPlanes& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const Planes p = split_bf16(d[8 * j + 2 * r], d[8 * j + 2 * r + 1]);
      f.hi[j][r] = p.hi;
      f.lo[j][r] = p.lo;
    }
  }
}

__device__ __forceinline__ void reg_fence(FragPlanes& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      reg_fence(f.hi[j][r]);
      reg_fence(f.lo[j][r]);
    }
  }
}

template <int K>
__device__ __forceinline__ void reg_fence(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) reg_fence(d[i]);
}

// --- wgmma m64nNk16, bf16 in, f32 accumulators -------------------------------------

// d (m64nN) = A B + (accumulate ? d : 0). rs: A (m64k16) from registers, B
// (k16nN) by descriptor, kTransB = 1 for an MN-major B. ss (N = 8 and 16): A
// and B by descriptor, kTransA = 1 for an MN-major A.
template <int N>
struct Wgmma16;

template <>
struct Wgmma16<8> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <>
struct Wgmma16<16> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <>
struct Wgmma16<32> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Wgmma16<64> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Wgmma16<128> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
};

// d += A B over the 64 tokens of a tile read K-major (kDescK at b), A as the
// two planes of a 64-column accumulator tile: 4 k16 steps x 2 planes.
template <int N>
__device__ __forceinline__ void wgmma_planes(float (&d)[N / 2], const FragPlanes& a,
                                             const unsigned char* b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Wgmma16<N>::template rs<0>(d, a.lo[j], desc_k(b + 2 * j * kTokenGroupBytes), 1);
    Wgmma16<N>::template rs<0>(d, a.hi[j], desc_k(b + 2 * j * kTokenGroupBytes), 1);
  }
}

// --- block barriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible before a __syncthreads publishes them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A named barrier (id 0 is __syncthreads'): waits for `count` threads.
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// This thread's warpgroup, broadcast from lane 0 so that the compiler sees a
// warp-uniform value: a branch on it that holds wgmma is then not divergent,
// which would make ptxas serialize the wgmma (C7520).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// Hands registers from the producer warpgroup to the consumers (all four warps
// of a warpgroup execute it).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// --- the producer warpgroup's copies ----------------------------------------------

// The producer warpgroup's 128 threads share each tile's copies.
constexpr int kProducerThreads = 128;

// Rows [0, kRows) x tokens [t0, t0 + 64) of a (kRows, n) row-major bf16 matrix
// into the tile at dst (shared-memory address), zero past n, by the producer
// warpgroup's thread tid. kVec (n a multiple of 8, src 16-byte aligned): a
// 16-byte cp.async a row of a core matrix, a warp's lanes on consecutive rows
// and core matrices (conflict-free); else one value a load and store,
// complete on return.
template <int kRows, bool kVec>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, int t0, int n,
                                          int tid) {
  if constexpr (kVec) {
    constexpr int kR8 = kRows < 8 ? kRows : 8;
#pragma unroll 1
    for (int e = tid; e < kRows * 8; e += kProducerThreads) {
      const int row = (e / (8 * kR8)) * 8 + e % kR8, kc = (e / kR8) % 8;
      const int tok = t0 + 8 * kc;
      const bool in = tok < n;
      const bf16* s = in ? src + static_cast<size_t>(row) * n + tok : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                       dst + tile_offset(row, 8 * kc)),
                   "l"(s), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 1
    for (int e = tid; e < kRows * kTileTokens; e += kProducerThreads) {
      const int row = e / kTileTokens, tk = e % kTileTokens;
      const unsigned short v = t0 + tk < n ? s[static_cast<size_t>(row) * n + t0 + tk] : 0;
      asm volatile("st.shared.u16 [%0], %1;" ::"r"(dst + tile_offset(row, tk)), "h"(v)
                   : "memory");
    }
  }
}

// Floats [t0, t0 + 64) of a row of n into dst[64] (shared-memory address), zero
// past n: 16-byte copies where kVec (n a multiple of 4, src 16-byte aligned),
// else 4-byte ones, by the producer warpgroup's thread tid.
template <bool kVec>
__device__ __forceinline__ void copy_row(uint32_t dst, const float* src, int t0, int n,
                                         int tid) {
  constexpr int kWidth = kVec ? 4 : 1;
#pragma unroll 1
  for (int e = tid; e < kTileTokens / kWidth; e += kProducerThreads) {
    const int tok = t0 + kWidth * e;
    const bool in = tok < n;
    const float* s = in ? src + tok : src;
    if constexpr (kVec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + 16 * e), "l"(s),
                   "r"(in ? 16 : 0)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst + 4 * e), "l"(s),
                   "r"(in ? 4 : 0)
                   : "memory");
    }
  }
}

// Each producer thread's loop over `ntiles` tiles through a ring of kStages
// stages: wait until the consumers have released the stage, issue(stage,
// tile) its copies, and once a tile's copies have landed, fence them for
// wgmma's reads and arrive on the stage's `full` barrier (kProducerThreads
// arrivals). A
// tile is published after the next one's copies are issued, so kStages >= 3
// keeps a consumer that holds two tiles (the forward's) from waiting on it.
template <int kStages, typename Issue>
__device__ __forceinline__ void produce(int ntiles, uint64_t* full, uint64_t* empty,
                                        Issue&& issue) {
  static_assert(kStages >= 3, "see above");
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(&empty[s], (it / kStages + 1) & 1);
    issue(s, it);
    cp_async_commit();
    if (it > 0) {
      cp_async_wait<1>();
      fence_proxy_async();
      mbar_arrive(&full[(it - 1) % kStages]);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  mbar_arrive(&full[(ntiles - 1) % kStages]);
}

// A consumer warp's release of a stage once its wgmma reads of it are done.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// A bf16 value of a (rows, n) matrix as the low 16 bits of a word (0 out of range).
__device__ __forceinline__ uint32_t bf16_bits(const bf16* p, bool in) {
  return in ? *reinterpret_cast<const unsigned short*>(p) : 0u;
}

}  // namespace tdt
