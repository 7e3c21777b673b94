// Unscaled flash-attention forward for Hopper (sm_90a), float32 (the bfloat16
// kernel is flash_fwd_bf16.cu).
//
// Replaces the TPU kernel tinydiffusion_tpu/ops/attention.py::_fwd_kernel
// (launched by _fwd): out = softmax(Q K^T) V with NO 1/sqrt(d) scaling, plus
// the row log-sum-exp lse, without ever building the N x N logits.
//
// Layout: the conv-VAE's SelfAttention2D produces q, k, v with the token
// axis N minor, so the kernel takes qt, kt (B, D, N) and vt (B, C, N), all
// contiguous, and writes out (B, C, N) and lse (B, 1, N) in natural-log units.
// qt, kt, vt, out and lse are float32.
//
// Design (tensor cores, every product by 3xTF32 wgmma; fragments, split and
// accumulation rule in tf32_mma.cuh):
// - A block is one warpgroup and owns 64 queries, 16 a warp (the 64 rows of
//   wgmma). Each warp loads its Q fragment once, pre-scaled by log2(e), and
//   splits it once.
// - Key tiles of kBlockK keys: the D rows of K and C rows of V, contiguous in
//   the (B, *, N) layout, are copied with cp.async (16 bytes a thread, each
//   thread's chunks fixed) into a staging buffer. After a barrier the block
//   splits the tile once into the hi and lo planes that wgmma reads; after a
//   second barrier it issues the copy of the next tile, which runs while the
//   warps compute on the planes.
// - S = Q K^T: m64n64, one k8 step for each 8 values of d (D = 4 padded to 8
//   with zeros; D = 16 two steps).
// - Online softmax in base 2 on the accumulators: a thread holds rows g and
//   g + 8 of its warp's 16; the row max is reduced over the quad with two
//   shuffles. O = alpha O + P V once per key tile, P V from zero.
// - P V: m64nCk8 per k8 step of keys, with P taken from the S accumulators by
//   the key permutation of tf32_mma.cuh (the V planes hold the keys in that
//   order); each step is issued as soon as its P is split, while the next
//   step's exps run.
// - Keys past N get s = -inf (weight 0); queries past N are computed on zeros
//   and not stored. No atomics: two calls give the same bits.
//
// Bound on an H100: 2*B*N^2*(D+C) FLOPs of products (N=16384, D=4, C=32, B=4:
// 77 GFLOP, 0.156 ms at the 495 TFLOP/s TF32 tensor-core peak; N=4096, D=16,
// C=128: 19.3 GFLOP, 0.039 ms) and one exp per (query, key) pair (1.07e9 MUFU
// ops, 0.257 ms at 16 a clock per SM), against a few MB of traffic. 3xTF32
// issues three tensor-core products for each (and pads D = 4 to 8), and the
// softmax's and the splits' fp32 work sits beside them. At C = 128 the P V
// product and its planes double: the O and P V accumulators take 128 registers
// a thread and the block ~110 KB of shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tdt;

constexpr int kWarps = 4;                // one warpgroup
constexpr int kThreads = 32 * kWarps;
constexpr int kQueriesPerBlock = 16 * kWarps;
constexpr int kBlockK = 64;              // keys per staged tile
// Staged rows: one 16-byte chunk past the tile (68 = 4 (mod 32) words,
// conflict-free splits).
constexpr int kKStride = kBlockK + 4;
constexpr int kKeySteps = kBlockK / 8;   // n8 tiles of S = k8 steps of P V
constexpr int kCore = 32;                // one core matrix: 8 rows x 4 tf32 (128 bytes)
// Core matrices of d (4 values each) a group of 8 keys: D = 4 padded to 8.
template <int D>
constexpr int kDChunks = D < 8 ? 2 : D / 4;

template <int D, int C>
struct Smem {
  // The tile split for wgmma, in core matrices (tf32_mma.cuh). K: for each
  // group of 8 keys, the d chunks of 4 in order (d 4-7 zero for D = 4). V:
  // for each group of 8 values of c, the tile's key chunks in order, P's key
  // order within a k8 step (split_v).
  uint32_t k_hi[kKeySteps * kDChunks<D> * kCore], k_lo[kKeySteps * kDChunks<D> * kCore];
  uint32_t v_hi[C * kBlockK], v_lo[C * kBlockK];
  float k[D][kKStride];  // the staging buffer cp.async fills
  float v[C][kKStride];
};

// The tile's K, split into the wgmma planes: core matrix (key group, d chunk)
// holds 8 keys x 4 values of d.
template <int D>
__device__ __forceinline__ void split_k(const float (*k)[kKStride], uint32_t* hi, uint32_t* lo) {
  for (int e = threadIdx.x; e < kDChunks<D> * kBlockK; e += kThreads) {
    const int key = e % kBlockK, dc = e / kBlockK;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (4 * dc < D) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = k[4 * dc + i][key];
    }
    const Tf32x2 a = split(x[0]), b = split(x[1]), c = split(x[2]), d = split(x[3]);
    const int off = ((key / 8) * kDChunks<D> + dc) * kCore + (key % 8) * 4;
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(a.hi, b.hi, c.hi, d.hi);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(a.lo, b.lo, c.lo, d.lo);
  }
}

// The tile's V, split into the wgmma planes. P's A fragment holds key 2t of
// a k8 step in column t and key 2t + 1 in column t + 4 (tf32_mma.cuh), so the
// planes hold the step's keys in the same order: its first core matrix keys
// 0, 2, 4, 6 and its second keys 1, 3, 5, 7.
template <int C>
__device__ __forceinline__ void split_v(const float (*v)[kKStride], uint32_t* hi, uint32_t* lo) {
  for (int e = threadIdx.x; e < C * kKeySteps; e += kThreads) {
    const int c8 = e % 8, j = (e / 8) % kKeySteps, cg = e / (8 * kKeySteps);
    float x[8];
    load8(&v[8 * cg + c8][8 * j], x);
    const Tf32x2 k0 = split(x[0]), k1 = split(x[1]), k2 = split(x[2]), k3 = split(x[3]);
    const Tf32x2 k4 = split(x[4]), k5 = split(x[5]), k6 = split(x[6]), k7 = split(x[7]);
    const int even = ((cg * kKeySteps + j) * 2 * 8 + c8) * 4;  // core matrix 2j, row c8
    const int odd = even + kCore;                               // core matrix 2j + 1
    *reinterpret_cast<uint4*>(hi + even) = make_uint4(k0.hi, k2.hi, k4.hi, k6.hi);
    *reinterpret_cast<uint4*>(hi + odd) = make_uint4(k1.hi, k3.hi, k5.hi, k7.hi);
    *reinterpret_cast<uint4*>(lo + even) = make_uint4(k0.lo, k2.lo, k4.lo, k6.lo);
    *reinterpret_cast<uint4*>(lo + odd) = make_uint4(k1.lo, k3.lo, k5.lo, k7.lo);
  }
}

template <int D, int C, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                    const float* __restrict__ vt, float* __restrict__ out,
                    float* __restrict__ lse, int n) {
  static_assert(D == 4 || D == 8 || D == 16, "the logit product is one or two k8 steps");
  static_assert(C == 32 || C == 64 || C == 128, "the value product is one m64nC");
  constexpr int kDSteps = kDChunks<D> / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D, C>& sm = *reinterpret_cast<Smem<D, C>*>(smem_raw);

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQueriesPerBlock + warp * 16 + g;  // and row0 + 8
  const size_t bn = static_cast<size_t>(b) * n;
  const float* qb = qt + bn * D;

  // Q fragments (rows g, g + 8; columns d = 8s + t, 8s + t + 4 of k8 step s),
  // split once; in base 2.
  auto q_at = [&](int d, int row) {
    return (d < D && row < n) ? qb[static_cast<size_t>(d) * n + row] * kLog2e : 0.f;
  };
  FragA8 qa[kDSteps];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks) {
    const int d0 = 8 * ks + t;
    qa[ks] = split_a8(q_at(d0, row0), q_at(d0, row0 + 8), q_at(d0 + 4, row0),
                      q_at(d0 + 4, row0 + 8));
  }
  // K's planes as B of k8 step s: its d chunks 2s and 2s + 1.
  uint64_t k_hi[kDSteps], k_lo[kDSteps];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks) {
    k_hi[ks] = smem_desc(sm.k_hi + 2 * ks * kCore, kCore * 4, kDChunks<D> * kCore * 4);
    k_lo[ks] = smem_desc(sm.k_lo + 2 * ks * kCore, kCore * 4, kDChunks<D> * kCore * 4);
  }

  float o[C / 2];  // accumulator layout: element 4i + e of the n8 tile i of c
#pragma unroll
  for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8 (base 2)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums

  const TileCopy<D, kBlockK, kKStride, kThreads, kVec> copy_k(&sm.k[0][0], kt + bn * D, n);
  const TileCopy<C, kBlockK, kKStride, kThreads, kVec> copy_v(&sm.v[0][0], vt + bn * C, n);
  const int ntiles = (n + kBlockK - 1) / kBlockK;
  copy_k.issue(0, n);
  copy_v.issue(0, n);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    cp_async_wait<0>();
    __syncthreads();  // tile it is staged; every warp is done with the planes
    split_k<D>(sm.k, sm.k_hi, sm.k_lo);
    split_v<C>(sm.v, sm.v_hi, sm.v_lo);
    fence_proxy_async();  // the planes are read by wgmma
    __syncthreads();      // the planes hold tile it; the staging buffer is free
    if (it + 1 < ntiles) {
      copy_k.issue(k0 + kBlockK, n);
      copy_v.issue(k0 + kBlockK, n);
      cp_async_commit();
    }

    // S = Q K^T (m64n64, k8 steps over d): accumulator 4j + e is element e
    // of key tile j.
    float s[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      s[i] = 0.f;
      reg_fence(s[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      wgmma3_tf32<kBlockK>(s, qa[ks], k_hi[ks], k_lo[ks]);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) reg_fence(s[i]);

    if (k0 + kBlockK > n) {  // the ragged last tile: keys past N weigh 0
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (key >= n) s[4 * j + 0] = s[4 * j + 2] = -INFINITY;
        if (key + 1 >= n) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }

    // Online softmax: the tile's row max over the quad.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, mask));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, mask));
    }
    // Key k0 < N is in every tile, so the new maxima are finite, and on the
    // first tile 2^-inf = 0 zeroes only what is already zero.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = 2^(S - m), split, and the tile's P V from zero (m64nCk8 a key tile
    // of 8), each k8 step's products issued as soon as its P is split, while
    // the next step's exps run.
    float pv[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      pv[i] = 0.f;
      reg_fence(pv[i]);
    }
    float ls0 = 0.f, ls1 = 0.f;
    FragA8 pa[kKeySteps];
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) {
      float* p = s + 4 * j;
      p[0] = ex2(p[0] - m0);
      p[1] = ex2(p[1] - m0);
      p[2] = ex2(p[2] - m1);
      p[3] = ex2(p[3] - m1);
      ls0 += p[0] + p[1];
      ls1 += p[2] + p[3];
      pa[j] = split_a8(p[0], p[2], p[1], p[3]);
      wgmma_fence();
      const uint64_t v_hi = smem_desc(sm.v_hi + 2 * j * kCore, kCore * 4, kBlockK / 4 * kCore * 4);
      wgmma3_tf32<C>(pv, pa[j], v_hi,
                     smem_desc(sm.v_lo + 2 * j * kCore, kCore * 4, kBlockK / 4 * kCore * 4));
      wgmma_commit();
      wgmma_wait<1>();  // step j - 1 is done: its P registers are free
      if (j > 0) reg_fence(pa[j - 1]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C / 2; ++i) reg_fence(pv[i]);
    reg_fence(pa[kKeySteps - 1]);

    l0 = fmaf(l0, alpha0, ls0);
    l1 = fmaf(l1, alpha1, ls1);
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      o[4 * i + 0] = fmaf(o[4 * i + 0], alpha0, pv[4 * i + 0]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], alpha0, pv[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], alpha1, pv[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], alpha1, pv[4 * i + 3]);
    }
  }

#pragma unroll
  for (int mask = 1; mask <= 2; mask <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, mask);
    l1 += __shfl_xor_sync(0xffffffffu, l1, mask);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* ob = out + bn * C;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const size_t c = 8 * i + 2 * t;
    if (row0 < n) {
      ob[c * n + row0] = o[4 * i + 0] * inv0;
      ob[(c + 1) * n + row0] = o[4 * i + 1] * inv0;
    }
    if (row0 + 8 < n) {
      ob[c * n + row0 + 8] = o[4 * i + 2] * inv1;
      ob[(c + 1) * n + row0 + 8] = o[4 * i + 3] * inv1;
    }
  }
  if (t == 0) {
    if (row0 < n) lse[bn + row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < n) lse[bn + row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D, int C, bool kVec>
cudaError_t launch_as(const void* qt, const void* kt, const void* vt, void* out, void* lse,
                      int b, int n, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<D, C>);  // above 48 KB a kernel must opt in
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, C, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
  flash_fwd_tc_kernel<D, C, kVec><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(qt), static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<float*>(out), static_cast<float*>(lse), n);
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, void* out, void* lse,
                   int b, int n, cudaStream_t stream) {
  if (n % 4 == 0 && aligned16(kt) && aligned16(vt)) {
    return launch_as<D, C, true>(qt, kt, vt, out, lse, b, n, stream);
  }
  return launch_as<D, C, false>(qt, kt, vt, out, lse, b, n, stream);
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). (d, c) must be one of the instantiated head widths below; any
// other pair returns cudaErrorInvalidValue without launching. qt, kt, vt, out
// and lse float32.
extern "C" int tdt_flash_fwd_f32(const void* qt, const void* kt, const void* vt, void* out,
                                 void* lse, int b, int n, int d, int c, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || b > 65535) return cudaErrorInvalidValue;
  if (d == 4 && c == 32) return launch<4, 32>(qt, kt, vt, out, lse, b, n, s);
  if (d == 8 && c == 64) return launch<8, 64>(qt, kt, vt, out, lse, b, n, s);
  if (d == 16 && c == 128) return launch<16, 128>(qt, kt, vt, out, lse, b, n, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of the kernel at (d, c), in bytes (-1 for a pair
// that is not instantiated), for reports.
extern "C" int tdt_flash_fwd_smem_bytes(int d, int c) {
  if (d == 4 && c == 32) return static_cast<int>(sizeof(Smem<4, 32>));
  if (d == 8 && c == 64) return static_cast<int>(sizeof(Smem<8, 64>));
  if (d == 16 && c == 128) return static_cast<int>(sizeof(Smem<16, 128>));
  return -1;
}
