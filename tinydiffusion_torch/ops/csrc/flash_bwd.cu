// Unscaled flash-attention backward for Hopper (sm_90a), float32 (the bfloat16
// kernel is flash_bwd_bf16.cu).
//
// Replaces the TPU kernel tinydiffusion_tpu/ops/attention.py::_bwd_fused_kernel
// (launched by _bwd). Given the forward's operands, its output's gradient dO,
// its row log-sum-exp lse and delta_i = sum_c dO_ic * O_ic (computed outside
// the kernel, as in JAX), it recomputes p_ij = exp(q_i . k_j - lse_i) and
// accumulates, with ds_ij = p_ij * (dO_i . v_j - delta_i):
//   dv_j = sum_i p_ij dO_i,   dk_j = sum_i ds_ij q_i,   dq_i = sum_j ds_ij k_j,
// without ever building the N x N matrices. No 1/sqrt(d) scaling.
//
// Layout, as the forward: qt, kt (B, D, N), vt, dOt (B, C, N), lse and delta
// (B, 1, N), all contiguous; outputs dqt, dkt (B, D, N), dvt (B, C, N); all
// float32, as is the dq scratch.
//
// Design (one visit per (query, key) pair, as the TPU kernel). S^T = K Q^T
// and the two products over C (dP^T and dV), which carry 2C + D of the pair's
// 2C + 3D multiply-adds, run on the tensor cores by 3xTF32 wgmma (fragments,
// split and accumulation rule in tf32_mma.cuh); dK and dQ, over D <= 16, run
// as float32 FMAs on the CUDA cores.
// - A block is one warpgroup and owns kKeysPerBlock = 64 keys, 16 a warp (the
//   64 rows of wgmma). Its V, split, sits in shared memory as wgmma's A; each
//   warp keeps its K fragment (split) and each thread its dK sums in
//   registers, the warpgroup its dV sums in wgmma accumulators.
// - Query tiles of kBlockQ queries (64; 32 at C = 128, where dO's two split
//   layouts for 64 queries beside V's planes would overflow shared memory):
//   the D rows of q, the C rows of dO, lse and delta, contiguous in the
//   (B, *, N) layout, are copied with cp.async into a staging buffer. After a
//   barrier the block splits q and dO once into the layouts wgmma reads
//   (below), takes lse to base 2 (+inf for queries past N) and copies q, lse
//   and delta out of the staging buffer; after a second barrier it issues the
//   copy of the next tile, which runs while the warps compute.
// - Per tile: S^T = K Q^T (m64 x kBlockQ, k8 steps over d, K pre-scaled by
//   log2(e)) and dP^T = V dO^T (m64 x kBlockQ, over C) are issued;
//   P^T = 2^(S^T - lse log2(e)) runs while dP^T computes; then, per k8 step
//   of queries, dV += P^T dO (m64nC) is issued with P^T taken from registers
//   by the key permutation of tf32_mma.cuh, and dS^T = P^T (dP^T - delta) and
//   dK += dS^T Q by FMAs (per thread over its queries; the quad's four partial
//   sums are added once, at the end) run while it computes.
// - dQ = dS K needs dS, not dS^T: the warps write dS^T into a shared (query,
//   key) matrix; after a barrier each thread sums one query's dS row times the
//   block's K (float32, its share of the D columns) over the block's 64 keys.
// - That sum is the block's partial dq for the tile, written to scratch
//   (B, N / kKeysPerBlock, D, N). A second kernel adds the partials of the
//   key blocks in a fixed order. No atomics: two calls give the same bits.
// - Keys past N weigh 0 (p forced to 0); queries past N are zero-filled, get
//   lse = +inf, so p = 0, and are not stored.
//
// Bound on an H100: 2*B*N^2*(3D + 2C) FLOPs of products (N=16384, D=4, C=32,
// B=4: 163 GFLOP, 0.330 ms at the 495 TFLOP/s TF32 tensor-core peak; N=4096,
// D=16, C=128: 40.8 GFLOP, 0.082 ms) and one exp per pair (0.257 ms at the MUFU
// rate). The partials add 2 * 4 * B * (N / 64) * D * N bytes (512 MiB moved at
// N=16384, D=4, B=4; 8 GiB at N=65536: the scratch grows as N^2).

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using namespace tdt;

constexpr int kWarps = 4;  // one warpgroup
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerBlock = 64;  // the wrapper's FLASH_BWD_KEYS_PER_BLOCK
static_assert(kKeysPerBlock == 16 * kWarps, "one wgmma row tile of keys");
// Queries per staged tile: at C = 128 the tile's dO planes and staging would
// not fit beside V's planes for 64 queries.
template <int C>
constexpr int kBlockQFor = C == 128 ? 32 : 64;
constexpr int kDsStride = kKeysPerBlock + 4;  // dS rows: conflict-free writes and float4 reads
constexpr int kCore = 32;  // one core matrix: 8 rows x 4 tf32 (128 bytes)
// Core matrices of d (4 values each) a group of 8 queries: D = 4 padded to 8.
template <int D>
constexpr int kDChunks = D < 8 ? 2 : D / 4;

template <int D, int C>
struct Smem {
  static constexpr int kBlockQ = kBlockQFor<C>;
  // Staged rows: one 16-byte chunk past the tile (68 or 36 = 4 (mod 32) words,
  // conflict-free splits).
  static constexpr int kQStride = kBlockQ + 4;
  // Split for wgmma, in core matrices (tf32_mma.cuh):
  // V (A of dP): for each group of 8 keys, the c chunks of 4 in order.
  uint32_t v_hi[kKeysPerBlock * C], v_lo[kKeysPerBlock * C];
  // q as B of S^T (K = d): for each group of 8 queries, the d chunks of 4 in
  // order (d 4-7 zero for D = 4).
  uint32_t qd_hi[kBlockQ * 4 * kDChunks<D>], qd_lo[kBlockQ * 4 * kDChunks<D>];
  union {
    // dO as B of dP (K = c): for each group of 8 queries, the c chunks in
    // order. Dead once dP^T is done, when dS takes its place.
    struct {
      uint32_t doc_hi[kBlockQ * C], doc_lo[kBlockQ * C];
    };
    float ds[kBlockQ][kDsStride];  // dS of the tile: [query][key]
  };
  // dO as B of dV (K = query): for each group of 8 values of c, the query
  // chunks, P's query order within a k8 step (first 0, 2, 4, 6, then 1, 3, 5, 7).
  uint32_t doq_hi[kBlockQ * C], doq_lo[kBlockQ * C];
  float q[D][kQStride];  // the staging buffer cp.async fills
  float dO[C][kQStride];
  float lse[kBlockQ];
  float delta[kBlockQ];
  float q_s[D][kBlockQ];  // the tile's q, lse and delta, out of the staging buffer
  float lse2[kBlockQ];    // lse * log2(e); +inf for queries past N
  float delta_s[kBlockQ];
  float k[kKeysPerBlock][D];              // the block's K, key-major, for dQ
};

// Blocks an SM must hold: at C = 32 the registers are capped for 3 (the shared
// memory allows 3); at C = 64 and 128 the shared memory allows only 1.
template <int C>
constexpr int kMinBlocks = C == 32 ? 3 : 1;

template <int D, int C, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>)
flash_bwd_tc_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                    const float* __restrict__ vt, const float* __restrict__ dot,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dkt, float* __restrict__ dvt,
                    float* __restrict__ dq_part, int n) {
  static_assert(D == 4 || D == 8 || D == 16, "the logit product is one or two k8 steps");
  static_assert(C == 32 || C == 64 || C == 128, "dV is one m64nC");
  constexpr int kBlockQ = Smem<D, C>::kBlockQ, kQStride = Smem<D, C>::kQStride;
  constexpr int kQuerySteps = kBlockQ / 8;
  constexpr int kDSteps = kDChunks<D> / 2;
  static_assert(D * kBlockQ % kThreads == 0, "the dQ columns split evenly over the threads");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D, C>& sm = *reinterpret_cast<Smem<D, C>*>(smem_raw);

  const int b = blockIdx.y;
  const int kb = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key_base = kb * kKeysPerBlock;
  const int key0 = key_base + warp * 16 + g;  // this thread's rows: key0 and key0 + 8
  const bool key_ok0 = key0 < n, key_ok1 = key0 + 8 < n;
  const size_t bn = static_cast<size_t>(b) * n;
  const float* kbp = kt + bn * D;
  const float* vb = vt + bn * C;

  // This warp's K as A of S^T (rows = its 16 keys, columns = d 8s + t,
  // 8s + t + 4 of k8 step s), split once, in base 2, and the block's K and V
  // in shared memory.
  auto k_at = [&](int d, int key) {
    return (d < D && key < n) ? kbp[static_cast<size_t>(d) * n + key] * kLog2e : 0.f;
  };
  FragA8 ka[kDSteps];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks) {
    const int d0 = 8 * ks + t;
    ka[ks] = split_a8(k_at(d0, key0), k_at(d0, key0 + 8), k_at(d0 + 4, key0),
                      k_at(d0 + 4, key0 + 8));
  }
  for (int e = threadIdx.x; e < kKeysPerBlock * D; e += kThreads) {
    const int key = e % kKeysPerBlock, d = e / kKeysPerBlock;
    sm.k[key][d] =
        key_base + key < n ? kbp[static_cast<size_t>(d) * n + key_base + key] : 0.f;
  }
  for (int e = threadIdx.x; e < kKeysPerBlock * C / 4; e += kThreads) {
    const int key = e % kKeysPerBlock, cc = e / kKeysPerBlock;
    Tf32x2 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = split(key_base + key < n ? vb[static_cast<size_t>(4 * cc + i) * n + key_base + key]
                                      : 0.f);
    }
    const int off = ((key / 8) * (C / 4) + cc) * kCore + (key % 8) * 4;
    *reinterpret_cast<uint4*>(sm.v_hi + off) = make_uint4(x[0].hi, x[1].hi, x[2].hi, x[3].hi);
    *reinterpret_cast<uint4*>(sm.v_lo + off) = make_uint4(x[0].lo, x[1].lo, x[2].lo, x[3].lo);
  }

  float dv[C / 2];  // accumulator layout: element 4i + e of the n8 tile i of c
#pragma unroll
  for (int i = 0; i < C / 2; ++i) dv[i] = 0.f;
  float dk0[D], dk1[D];  // this thread's share (its queries) of dK for its keys
#pragma unroll
  for (int d = 0; d < D; ++d) dk0[d] = dk1[d] = 0.f;

  const TileCopy<D, kBlockQ, kQStride, kThreads, kVec> copy_q(&sm.q[0][0], qt + bn * D, n);
  const TileCopy<C, kBlockQ, kQStride, kThreads, kVec> copy_do(&sm.dO[0][0], dot + bn * C, n);
  const TileCopy<1, kBlockQ, kBlockQ, kThreads, kVec> copy_lse(sm.lse, lse + bn, n);
  const TileCopy<1, kBlockQ, kBlockQ, kThreads, kVec> copy_delta(sm.delta, delta + bn, n);
  auto stage = [&](int q0) {
    copy_q.issue(q0, n);
    copy_do.issue(q0, n);
    copy_lse.issue(q0, n);
    copy_delta.issue(q0, n);
    cp_async_commit();
  };
  constexpr uint32_t kCoreBytes = kCore * 4;

  const int ntiles = (n + kBlockQ - 1) / kBlockQ;
  float* part = dq_part + (static_cast<size_t>(b) * gridDim.x + kb) * D * n;
  stage(0);
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * kBlockQ;
    cp_async_wait<0>();
    // Tile it is staged, and every warp is done with the planes, sm.ds and
    // sm.lse2 (the previous tile); on the first tile, sm.k and V are written.
    __syncthreads();
    for (int e = threadIdx.x; e < kBlockQ * C / 4; e += kThreads) {  // dO, K = c
      const int q = e % kBlockQ, cc = e / kBlockQ;
      const Tf32x2 a = split(sm.dO[4 * cc][q]);
      const Tf32x2 b1 = split(sm.dO[4 * cc + 1][q]);
      const Tf32x2 c2 = split(sm.dO[4 * cc + 2][q]);
      const Tf32x2 d3 = split(sm.dO[4 * cc + 3][q]);
      const int off = ((q / 8) * (C / 4) + cc) * kCore + (q % 8) * 4;
      *reinterpret_cast<uint4*>(sm.doc_hi + off) = make_uint4(a.hi, b1.hi, c2.hi, d3.hi);
      *reinterpret_cast<uint4*>(sm.doc_lo + off) = make_uint4(a.lo, b1.lo, c2.lo, d3.lo);
    }
    for (int e = threadIdx.x; e < C * kQuerySteps; e += kThreads) {  // dO, K = query
      const int c8 = e % 8, j = (e / 8) % kQuerySteps, cg = e / (8 * kQuerySteps);
      float x[8];
      load8(&sm.dO[8 * cg + c8][8 * j], x);
      const Tf32x2 e0 = split(x[0]), e1 = split(x[1]), e2 = split(x[2]), e3 = split(x[3]);
      const Tf32x2 e4 = split(x[4]), e5 = split(x[5]), e6 = split(x[6]), e7 = split(x[7]);
      const int even = ((cg * kQuerySteps + j) * 2 * 8 + c8) * 4;
      const int odd = even + kCore;
      *reinterpret_cast<uint4*>(sm.doq_hi + even) = make_uint4(e0.hi, e2.hi, e4.hi, e6.hi);
      *reinterpret_cast<uint4*>(sm.doq_hi + odd) = make_uint4(e1.hi, e3.hi, e5.hi, e7.hi);
      *reinterpret_cast<uint4*>(sm.doq_lo + even) = make_uint4(e0.lo, e2.lo, e4.lo, e6.lo);
      *reinterpret_cast<uint4*>(sm.doq_lo + odd) = make_uint4(e1.lo, e3.lo, e5.lo, e7.lo);
    }
    for (int e = threadIdx.x; e < kDChunks<D> * kBlockQ; e += kThreads) {  // q, K = d
      const int q = e % kBlockQ, dc = e / kBlockQ;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (4 * dc < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = sm.q[4 * dc + i][q];
      }
      const Tf32x2 a = split(x[0]), b1 = split(x[1]), c2 = split(x[2]), d3 = split(x[3]);
      const int off = ((q / 8) * kDChunks<D> + dc) * kCore + (q % 8) * 4;
      *reinterpret_cast<uint4*>(sm.qd_hi + off) = make_uint4(a.hi, b1.hi, c2.hi, d3.hi);
      *reinterpret_cast<uint4*>(sm.qd_lo + off) = make_uint4(a.lo, b1.lo, c2.lo, d3.lo);
    }
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      // A query past N gets lse = +inf, so p = 2^-inf = 0 and it adds nothing.
      sm.lse2[i] = q0 + i < n ? sm.lse[i] * kLog2e : INFINITY;
      sm.delta_s[i] = sm.delta[i];
#pragma unroll
      for (int d = 0; d < D; ++d) sm.q_s[d][i] = sm.q[d][i];
    }
    fence_proxy_async();  // the planes are read by wgmma
    __syncthreads();      // the planes hold tile it; the staging buffer is free
    if (it + 1 < ntiles) stage(q0 + kBlockQ);

    // S^T = K Q^T (m64 x kBlockQ, k8 steps over d, base 2) and dP^T = V dO^T (over
    // C): accumulator 4j + e is element e of the n8 tile j of the tile's
    // queries (key key0 + 8 (e >> 1), tile query 8j + 2t + (e & 1)). dP^T
    // runs while P^T is computed.
    float s_acc[kBlockQ / 2], dp[kBlockQ / 2];
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) {
      s_acc[i] = dp[i] = 0.f;
      reg_fence(s_acc[i]);
      reg_fence(dp[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {  // q's d chunks 2ks and 2ks + 1
      wgmma3_tf32<kBlockQ>(
          s_acc, ka[ks],
          smem_desc(sm.qd_hi + 2 * ks * kCore, kCoreBytes, kDChunks<D> * kCoreBytes),
          smem_desc(sm.qd_lo + 2 * ks * kCore, kCoreBytes, kDChunks<D> * kCoreBytes));
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {  // c chunks 2i and 2i + 1
      const uint64_t v_hi = smem_desc(sm.v_hi + 2 * i * kCore, kCoreBytes, C / 4 * kCoreBytes);
      const uint64_t do_hi = smem_desc(sm.doc_hi + 2 * i * kCore, kCoreBytes, C / 4 * kCoreBytes);
      wgmma3_tf32_ss<kBlockQ>(
          dp, v_hi, smem_desc(sm.v_lo + 2 * i * kCore, kCoreBytes, C / 4 * kCoreBytes), do_hi,
          smem_desc(sm.doc_lo + 2 * i * kCore, kCoreBytes, C / 4 * kCoreBytes));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) reg_fence(s_acc[i]);

    // P^T = 2^(S^T - lse log2(e)), 0 for keys past N.
    float p[kBlockQ / 2];
#pragma unroll
    for (int j = 0; j < kQuerySteps; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.lse2[8 * j + 2 * t]);
      p[4 * j + 0] = ex2(s_acc[4 * j + 0] - ls.x);
      p[4 * j + 1] = ex2(s_acc[4 * j + 1] - ls.y);
      p[4 * j + 2] = ex2(s_acc[4 * j + 2] - ls.x);
      p[4 * j + 3] = ex2(s_acc[4 * j + 3] - ls.y);
    }
    if (key_base + kKeysPerBlock > n) {  // the ragged last key block
#pragma unroll
      for (int j = 0; j < kQuerySteps; ++j) {
        if (!key_ok0) p[4 * j + 0] = p[4 * j + 1] = 0.f;
        if (!key_ok1) p[4 * j + 2] = p[4 * j + 3] = 0.f;
      }
    }
    wgmma_wait<0>();  // dP^T is done
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) reg_fence(dp[i]);
    __syncthreads();  // every warp's dP^T is done: dS may overwrite the dO planes

    // Per k8 step j of the tile's queries: issue dV += P^T dO (m64nC, P^T
    // split into A by the key permutation), then, while it runs, dS^T = P^T
    // (dP^T - delta), dK += dS^T Q (FMAs over this thread's queries) and dS
    // into shared memory for dQ. dV's tile sum starts from zero.
    float dv_t[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      dv_t[i] = 0.f;
      reg_fence(dv_t[i]);
    }
    const int kc = warp * 16 + g;
    FragA8 pa[kQuerySteps];
#pragma unroll
    for (int j = 0; j < kQuerySteps; ++j) {
      const float* pj = p + 4 * j;
      pa[j] = split_a8(pj[0], pj[2], pj[1], pj[3]);
      wgmma_fence();
      const uint64_t doq_hi =
          smem_desc(sm.doq_hi + 2 * j * kCore, kCoreBytes, kBlockQ / 4 * kCoreBytes);
      wgmma3_tf32<C>(dv_t, pa[j], doq_hi,
                     smem_desc(sm.doq_lo + 2 * j * kCore, kCoreBytes, kBlockQ / 4 * kCoreBytes));
      wgmma_commit();

      const int qc = 8 * j + 2 * t;
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta_s[qc]);
      const float ds0 = pj[0] * (dp[4 * j + 0] - dl.x);
      const float ds1 = pj[1] * (dp[4 * j + 1] - dl.y);
      const float ds2 = pj[2] * (dp[4 * j + 2] - dl.x);
      const float ds3 = pj[3] * (dp[4 * j + 3] - dl.y);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float2 qv = *reinterpret_cast<const float2*>(&sm.q_s[d][qc]);
        dk0[d] = fmaf(ds0, qv.x, fmaf(ds1, qv.y, dk0[d]));
        dk1[d] = fmaf(ds2, qv.x, fmaf(ds3, qv.y, dk1[d]));
      }
      sm.ds[qc][kc] = ds0;
      sm.ds[qc + 1][kc] = ds1;
      sm.ds[qc][kc + 8] = ds2;
      sm.ds[qc + 1][kc + 8] = ds3;
      wgmma_wait<1>();  // step j - 1 is done: its P registers are free
      if (j > 0) reg_fence(pa[j - 1]);
    }
    wgmma_wait<0>();  // dV is done
    reg_fence(pa[kQuerySteps - 1]);
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      reg_fence(dv_t[i]);
      dv[i] += dv_t[i];
    }
    __syncthreads();  // the tile's dS is in shared memory

    // dQ: thread = (tile query qi, share h of the D columns), over the 64 keys.
    {
      constexpr int kHalf = D * kBlockQ / kThreads;
      const int qi = threadIdx.x % kBlockQ, h = threadIdx.x / kBlockQ;
      float acc[kHalf];
#pragma unroll
      for (int d = 0; d < kHalf; ++d) acc[d] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kKeysPerBlock; j += 4) {
        const float4 dsv = *reinterpret_cast<const float4*>(&sm.ds[qi][j]);
        const float w[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int d = 0; d < kHalf; ++d) acc[d] = fmaf(w[u], sm.k[j + u][h * kHalf + d], acc[d]);
        }
      }
      if (q0 + qi < n) {
#pragma unroll
        for (int d = 0; d < kHalf; ++d) {
          part[static_cast<size_t>(h * kHalf + d) * n + q0 + qi] = acc[d];
        }
      }
    }
  }

  // dK: add the quad's four shares (fixed order), then lane t = 0 stores.
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      dk0[d] += __shfl_xor_sync(0xffffffffu, dk0[d], mask);
      dk1[d] += __shfl_xor_sync(0xffffffffu, dk1[d], mask);
    }
  }
  float* dkb = dkt + bn * D;
  if (t == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (key_ok0) dkb[static_cast<size_t>(d) * n + key0] = dk0[d];
      if (key_ok1) dkb[static_cast<size_t>(d) * n + key0 + 8] = dk1[d];
    }
  }
  // dV (rows key0, key0 + 8; columns c = 8i + 2t, 8i + 2t + 1).
  float* dvb = dvt + bn * C;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const size_t c0 = static_cast<size_t>(8 * i + 2 * t) * n;
    if (key_ok0) {
      dvb[c0 + key0] = dv[4 * i + 0];
      dvb[c0 + n + key0] = dv[4 * i + 1];
    }
    if (key_ok1) {
      dvb[c0 + key0 + 8] = dv[4 * i + 2];
      dvb[c0 + n + key0 + 8] = dv[4 * i + 3];
    }
  }
}

// dqt[b, r] = sum over key blocks kb, in order, of dq_part[b, kb, r], where r
// runs over the D * N elements of one batch row.
__global__ void flash_bwd_dq_sum_kernel(const float* __restrict__ dq_part,
                                        float* __restrict__ dqt, int b_total, int nkb,
                                        int row) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(b_total) * row) return;
  const size_t b = idx / row, r = idx % row;
  const float* p = dq_part + b * nkb * row + r;
  float acc = 0.f;
  for (int kb = 0; kb < nkb; ++kb) acc += p[static_cast<size_t>(kb) * row];
  dqt[idx] = acc;
}

template <int D, int C, bool kVec>
cudaError_t launch_as(const void* qt, const void* kt, const void* vt, const void* dot,
                      const void* lse, const void* delta, void* dqt, void* dkt, void* dvt,
                      void* dq_part, int b, int n, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<D, C>);  // above 48 KB a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_kernel<D, C, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int nkb = (n + kKeysPerBlock - 1) / kKeysPerBlock;
  flash_bwd_tc_kernel<D, C, kVec><<<dim3(nkb, b), kThreads, kSmem, stream>>>(
      static_cast<const float*>(qt), static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const float*>(dot), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dkt), static_cast<float*>(dvt),
      static_cast<float*>(dq_part), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(b) * D * n;
  constexpr int kSumThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kSumThreads - 1) / kSumThreads);
  flash_bwd_dq_sum_kernel<<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<float*>(dqt), b, nkb, D * n);
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, const void* dot,
                   const void* lse, const void* delta, void* dqt, void* dkt, void* dvt,
                   void* dq_part, int b, int n, cudaStream_t stream) {
  if (n % 4 == 0 && aligned16(qt) && aligned16(dot) && aligned16(lse) && aligned16(delta)) {
    return launch_as<D, C, true>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n,
                                 stream);
  }
  return launch_as<D, C, false>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n,
                                stream);
}

}  // namespace

// Launches the backward (the pair kernel, then the dq sum) on `stream` and
// returns cudaGetLastError() (0 on success). dq_part is float32 scratch of
// b * key_blocks * d * n floats, where key_blocks must equal
// ceil(n / kKeysPerBlock), the kernel's keys per block. (d, c) must be one of
// the instantiated head widths below; anything else returns
// cudaErrorInvalidValue without launching. All tensors float32.
extern "C" int tdt_flash_bwd_f32(const void* qt, const void* kt, const void* vt,
                                 const void* dot, const void* lse, const void* delta,
                                 void* dqt, void* dkt, void* dvt, void* dq_part, int b, int n,
                                 int d, int c, int key_blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || b > 65535) return cudaErrorInvalidValue;
  if (key_blocks != (n + kKeysPerBlock - 1) / kKeysPerBlock) return cudaErrorInvalidValue;
  if (d == 4 && c == 32) {
    return launch<4, 32>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n, s);
  }
  if (d == 8 && c == 64) {
    return launch<8, 64>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n, s);
  }
  if (d == 16 && c == 128) {
    return launch<16, 128>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n, s);
  }
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of the pair kernel at (d, c), in bytes (-1 for a
// pair that is not instantiated), for reports.
extern "C" int tdt_flash_bwd_smem_bytes(int d, int c) {
  if (d == 4 && c == 32) return static_cast<int>(sizeof(Smem<4, 32>));
  if (d == 8 && c == 64) return static_cast<int>(sizeof(Smem<8, 64>));
  if (d == 16 && c == 128) return static_cast<int>(sizeof(Smem<16, 128>));
  return -1;
}
