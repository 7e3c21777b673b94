// Unscaled flash-attention backward for Hopper (sm_90a), bfloat16.
//
// Replaces the bf16 path (bf16_in) of the TPU kernel
// tinydiffusion_tpu/ops/attention.py::_bwd_fused_kernel (launched by _bwd).
// Given the forward's operands, its output's gradient dO, its row log-sum-exp
// lse and delta_i = sum_c dO_ic * O_ic (computed outside the kernel, as in
// JAX), it recomputes p_ij = exp(q_i . k_j - lse_i) and accumulates, with
// ds_ij = p_ij * (dO_i . v_j - delta_i):
//   dv_j = sum_i p_ij dO_i,   dk_j = sum_i ds_ij q_i,   dq_i = sum_j ds_ij k_j,
// without ever building the N x N matrices. No 1/sqrt(d) scaling.
//
// Layout: qt, kt (B, D, N), vt, dOt (B, C, N) bf16; lse and delta (B, 1, N)
// float32; outputs dqt, dkt (B, D, N), dvt (B, C, N) bf16; all contiguous. The
// dq scratch is float32.
//
// Design (one visit per (query, key) pair, as the TPU kernel; bf16 wgmma k16,
// fragments, tile layout and barriers in bf16_mma.cuh):
// - A block owns kKeysPerBlock = 128 keys: two consumer warpgroups of 64 keys
//   (the 64 rows of wgmma), each with its K and V as A fragments in registers
//   (loaded once), and a producer warpgroup whose four warps stream tiles of
//   64 queries (q and dO as bf16 tiles in the layout wgmma reads, lse and
//   delta) through a ring of kStages stages with mbarriers. setmaxnreg hands
//   the producer's registers to the consumers.
// - Per tile: S^T = K Q^T (m64n64k16, D padded to 16 with zeros; exact, JAX's
//   single bf16 pass, attention.py:210) and dP^T = V dO^T (m64n64k16 over C,
//   dO read MN-major) are issued together; P^T = 2^(S^T log2(e) - lse log2(e))
//   (one FFMA and an ex2 an element) runs while dP^T computes; dS^T = P^T
//   (dP^T - delta).
// - dV += P^T dO (m64nCk16) and dK += dS^T Q (m64n8k16, D padded to 8; m64n16
//   at D = 16) take
//   P^T and dS^T from registers as A, each as two bf16 planes (~2^-16 relative,
//   float32's accuracy for the outputs), the accumulator fragment repacked in
//   place; dO and q are the same staged tiles read K-major. dV accumulates in
//   its wgmma accumulators over the tiles, dK's tile sum is added in float32.
// - dQ = dS K: both consumers write their dS^T planes, bf16, into a shared
//   (key, query) tile; after a named barrier the consumer whose turn it is
//   (the tiles alternate) runs m64n8k16 (m64n16 at D = 16) over the block's
//   128 keys with dS read MN-major against the block's K (staged once), and
//   writes the block's
//   partial dq for the tile, float32, to scratch (B, N / 128, D, N). The dS
//   tile is double-buffered, so the other consumer runs on.
// - dq follows JAX's order of roundings (attention.py:225-229), which
//   accumulates dq in bf16 across its key blocks of kDqRunKeys = 1024: a
//   second kernel adds the partials of each run of 1024 keys (8 blocks) in
//   float32, in order, rounds that run's sum to bf16, and adds it to the bf16
//   running dq, rounding again. No atomics: two calls give the same bits.
// - Keys past N weigh 0 (p forced to 0). Queries past N are zero-filled (q, dO,
//   lse, delta), which makes their dv, ds and dk terms 0, and are not stored.
//
// Bound on an H100: 2*B*N^2*(3D + 2C) FLOPs of products (N=16384, D=4, C=32,
// B=4: 163 GFLOP, 0.165 ms at the 989 TFLOP/s bf16 tensor-core peak; N=4096,
// D=16, C=128: 40.8 GFLOP, 0.041 ms) and one exp per pair (0.257 ms at the
// MUFU rate). The partials add 2 * 4 * B * (N / 128) * D * N bytes (256 MiB
// moved at N=16384, D=4, B=4; 4 GiB at N=65536). At C = 128 a consumer thread
// holds V (32 registers) and dV (64) beside S^T, dP^T and the P and dS planes.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

using namespace tdt;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kKeysPerBlock = 128;  // the wrapper's FLASH_BWD_BF16_KEYS_PER_BLOCK
static_assert(kKeysPerBlock == 64 * kConsumers, "one wgmma row tile of keys a consumer");
constexpr int kBlockQ = kTileTokens;  // queries per tile
constexpr int kStages = 3;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kDsBarrier = 1;  // named barrier: both consumers' dS is written
// The n of dK's and dQ's products: D padded to 8.
template <int D>
constexpr int kDn = D < 8 ? 8 : D;

template <int D, int C>
struct Smem {
  alignas(128) unsigned char q[kStages][2 * kRowGroupBytes];  // 16 rows: D, then zeros to 16
  alignas(128) unsigned char dO[kStages][C / 8 * kRowGroupBytes];
  alignas(16) float lse[kStages][kBlockQ];
  alignas(16) float delta[kStages][kBlockQ];
  // dS of a tile, [buffer][plane hi, lo], keys as rows (MN-major A of dQ).
  alignas(128) unsigned char ds[2][2][kKeysPerBlock / 8 * kRowGroupBytes];
  // The block's K as B of dQ, read K-major: for each 8 values of d (zero from
  // D), the block's keys in core matrices of 8 keys.
  alignas(128) unsigned char k[kDn<D> / 8][kKeysPerBlock / 8 * kTokenGroupBytes];
  uint64_t full[kStages], empty[kStages];
};

template <int D, int C, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ kt,
                      const bf16* __restrict__ vt, const bf16* __restrict__ dot,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dkt, bf16* __restrict__ dvt,
                      float* __restrict__ dq_part, int n) {
  static_assert(D == 4 || D == 8 || D == 16, "K and q padded to one k16 step");
  static_assert(C == 32 || C == 64 || C == 128, "dV is one m64nC");
  constexpr int kN = kDn<D>;  // dK's and dQ's n
  constexpr uint32_t kKBytes = kKeysPerBlock / 8 * kTokenGroupBytes;  // a row group of sm.k
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D, C>& sm = *reinterpret_cast<Smem<D, C>*>(smem_raw);
  const int b = blockIdx.y, kb = blockIdx.x;
  const int key_base = kb * kKeysPerBlock;
  const size_t bn = static_cast<size_t>(b) * n;
  const bf16* kbp = kt + bn * D;
  const int ntiles = (n + kBlockQ - 1) / kBlockQ;

  // q's rows D..15 stay zero; the producer writes rows below D. The block's K
  // for dQ, zero past D and past N.
  if constexpr (D < 16) {
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(sm.q) / 16); i += kThreads) {
      reinterpret_cast<uint4*>(sm.q)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  for (int e = threadIdx.x; e < kKeysPerBlock * kN; e += kThreads) {
    const int key = e % kKeysPerBlock, d = e / kKeysPerBlock;
    const uint32_t v =
        bf16_bits(kbp + static_cast<size_t>(d) * n + key_base + key, d < D && key_base + key < n);
    *reinterpret_cast<unsigned short*>(sm.k[d / 8] + (key / 8) * kTokenGroupBytes +
                                       (d % 8) * 16 + (key % 8) * 2) =
        static_cast<unsigned short>(v);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], kProducerThreads);
      mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 0) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    {
      const int tid = threadIdx.x;
      const bf16* qb = qt + bn * D;
      const bf16* db = dot + bn * C;
      produce<kStages>(ntiles, sm.full, sm.empty, [&](int s, int it) {
        const int q0 = it * kBlockQ;
        copy_tile<D, kVec>(smem_addr(sm.q[s]), qb, q0, n, tid);
        copy_tile<C, kVec>(smem_addr(sm.dO[s]), db, q0, n, tid);
        copy_row<kVec>(smem_addr(sm.lse[s]), lse + bn, q0, n, tid);
        copy_row<kVec>(smem_addr(sm.delta[s]), delta + bn, q0, n, tid);
      });
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int cw = wg - 1;  // this consumer
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = cw * 64 + warp * 16 + g;  // this thread's rows: keys wkey, wkey + 8 of the block
  const int key0 = key_base + wkey;
  const bool key_ok0 = key0 < n, key_ok1 = key0 + 8 < n;
  const bf16* vb = vt + bn * C;

  // K as A of S^T (rows: keys; columns d = 2t, 2t + 1 and 2t + 8, 2t + 9,
  // zero from D) and V as A of dP^T (columns c, C / 16 k16 steps).
  auto bf16_pair = [&](const bf16* m, int row, int key, bool in) {
    const bf16* p = m + static_cast<size_t>(row) * n + key;
    return bf16_bits(p, in) | bf16_bits(p + n, in) << 16;
  };
  const uint32_t ka[4] = {bf16_pair(kbp, 2 * t, key0, 2 * t < D && key_ok0),
                          bf16_pair(kbp, 2 * t, key0 + 8, 2 * t < D && key_ok1),
                          bf16_pair(kbp, 2 * t + 8, key0, 2 * t + 8 < D && key_ok0),
                          bf16_pair(kbp, 2 * t + 8, key0 + 8, 2 * t + 8 < D && key_ok1)};
  uint32_t va[C / 16][4];
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    va[kk][0] = bf16_pair(vb, 16 * kk + 2 * t, key0, key_ok0);
    va[kk][1] = bf16_pair(vb, 16 * kk + 2 * t, key0 + 8, key_ok1);
    va[kk][2] = bf16_pair(vb, 16 * kk + 8 + 2 * t, key0, key_ok0);
    va[kk][3] = bf16_pair(vb, 16 * kk + 8 + 2 * t, key0 + 8, key_ok1);
  }

  float dv[C / 2];  // accumulator layout: element 4i + e of the n8 tile i of c
#pragma unroll
  for (int i = 0; i < C / 2; ++i) dv[i] = 0.f;
  // dK and dQ in accumulator layout: element 4i + e of the n8 tile i of d,
  // e.g. dk (key0, 8i + 2t), (key0, 8i + 2t + 1), (key0 + 8, ...).
  float dk[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk[i] = 0.f;
  float dk_t[kN / 2], dq[kN / 2];
  float s[kBlockQ / 2], dp[kBlockQ / 2];  // S^T, then P^T; dP^T, then dS^T
  FragPlanes pa, dsa;
  float* part = dq_part + (static_cast<size_t>(b) * gridDim.x + kb) * D * n;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages, buf = it & 1;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    wgmma_fence();
    Wgmma16<kBlockQ>::rs<1>(s, ka, desc_mn(sm.q[st]), 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      Wgmma16<kBlockQ>::rs<1>(dp, va[kk], desc_mn(sm.dO[st] + 2 * kk * kRowGroupBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done
    reg_fence(s);

    // P^T, 0 for keys past N; the tile query of column 8j + 2t (+1).
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + 2 * t]);
      const float lx = l2.x * kLog2e, ly = l2.y * kLog2e;
      s[4 * j + 0] = ex2(fmaf(s[4 * j + 0], kLog2e, -lx));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], kLog2e, -ly));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], kLog2e, -lx));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], kLog2e, -ly));
    }
    if (key_base + kKeysPerBlock > n) {  // the ragged last key block
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
        if (!key_ok0) s[4 * j + 0] = s[4 * j + 1] = 0.f;
        if (!key_ok1) s[4 * j + 2] = s[4 * j + 3] = 0.f;
      }
    }
    reg_fence(s);  // the exps run before the wait below, under dP^T
    wgmma_wait<0>();  // dP^T is done
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][8 * j + 2 * t]);
      dp[4 * j + 0] = s[4 * j + 0] * (dp[4 * j + 0] - dl.x);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dl.y);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dl.x);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dl.y);
    }
    to_planes(s, pa);
    to_planes(dp, dsa);

    // dV += P^T dO and dK's tile sum dS^T Q, from the planes.
    wgmma_fence();
    wgmma_planes<C>(dv, pa, sm.dO[st]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t qd = desc_k(sm.q[st] + 2 * j * kTokenGroupBytes);
      Wgmma16<kN>::template rs<0>(dk_t, dsa.lo[j], qd, j > 0);
      Wgmma16<kN>::template rs<0>(dk_t, dsa.hi[j], qd, 1);
    }
    wgmma_commit();

    // dS^T into the shared tile: register r of k16 step j holds key wkey
    // (+ 8 for odd r) and queries 16j + 2t, + 1 (+ 8 for r >= 2).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t off = tile_offset(wkey + 8 * (r & 1), 16 * j + 2 * t + 8 * (r >> 1));
        *reinterpret_cast<uint32_t*>(sm.ds[buf][0] + off) = dsa.hi[j][r];
        *reinterpret_cast<uint32_t*>(sm.ds[buf][1] + off) = dsa.lo[j][r];
      }
    }
    fence_proxy_async();
    bar_sync(kDsBarrier, 2 * 128);  // both consumers' dS is in the tile

    // dQ of the tile over the block's 128 keys, by the consumer whose turn it is.
    const bool mine = buf == cw;
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeysPerBlock / 16; ++j) {
        // K-major: the next 8 keys 128 bytes on, the next 8 values of d kKBytes.
        const uint64_t kd = smem_desc(sm.k[0] + 2 * j * kTokenGroupBytes, kTokenGroupBytes,
                                      kKBytes);
        Wgmma16<kN>::template ss<1, 0>(dq, desc_mn(sm.ds[buf][1] + 2 * j * kRowGroupBytes), kd,
                                       j > 0);
        Wgmma16<kN>::template ss<1, 0>(dq, desc_mn(sm.ds[buf][0] + 2 * j * kRowGroupBytes), kd,
                                       1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk_t);
    reg_fence(dq);
    reg_fence(pa);
    reg_fence(dsa);
    release(&sm.empty[st], lane);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) dk[i] += dk_t[i];
    if (mine) {  // rows: tile queries warp * 16 + g (+ 8); columns d = 8i + 2t, + 1
      const int q = it * kBlockQ + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        if (8 * i + 2 * t >= D) continue;
        float* p0 = part + static_cast<size_t>(8 * i + 2 * t) * n;
        if (q < n) {
          p0[q] = dq[4 * i + 0];
          p0[n + q] = dq[4 * i + 1];
        }
        if (q + 8 < n) {
          p0[q + 8] = dq[4 * i + 2];
          p0[n + q + 8] = dq[4 * i + 3];
        }
      }
    }
  }

  bf16* dkb = dkt + bn * D;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    if (8 * i + 2 * t >= D) continue;
    bf16* p0 = dkb + static_cast<size_t>(8 * i + 2 * t) * n;
    if (key_ok0) {
      p0[key0] = __float2bfloat16_rn(dk[4 * i + 0]);
      p0[n + key0] = __float2bfloat16_rn(dk[4 * i + 1]);
    }
    if (key_ok1) {
      p0[key0 + 8] = __float2bfloat16_rn(dk[4 * i + 2]);
      p0[n + key0 + 8] = __float2bfloat16_rn(dk[4 * i + 3]);
    }
  }
  bf16* dvb = dvt + bn * C;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const size_t c0 = static_cast<size_t>(8 * i + 2 * t) * n;
    if (key_ok0) {
      dvb[c0 + key0] = __float2bfloat16_rn(dv[4 * i + 0]);
      dvb[c0 + n + key0] = __float2bfloat16_rn(dv[4 * i + 1]);
    }
    if (key_ok1) {
      dvb[c0 + key0 + 8] = __float2bfloat16_rn(dv[4 * i + 2]);
      dvb[c0 + n + key0 + 8] = __float2bfloat16_rn(dv[4 * i + 3]);
    }
  }
}

// JAX's bf16 dq (attention.py:224-229): its kernel adds each 1024-key block's
// float32 dq, rounded to bf16, to a bf16 running dq.
constexpr int kDqRunKeys = 1024;
static_assert(kDqRunKeys % kKeysPerBlock == 0, "a run is whole key blocks");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dqt: the partials of each run of kDqRunKeys keys added in order in float32,
// and each run's sum, rounded to bf16, added to the running dq, which is
// rounded to bf16 after each add.
__global__ void flash_bwd_dq_sum_bf16_kernel(const float* __restrict__ dq_part,
                                             bf16* __restrict__ dqt, int b_total, int nkb,
                                             int row) {
  constexpr int kRunBlocks = kDqRunKeys / kKeysPerBlock;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(b_total) * row) return;
  const size_t b = idx / row, r = idx % row;
  const float* p = dq_part + b * nkb * row + r;
  float dq = 0.f;
  for (int kb0 = 0; kb0 < nkb; kb0 += kRunBlocks) {
    const int kb1 = min(kb0 + kRunBlocks, nkb);
    float acc = 0.f;
    for (int kb = kb0; kb < kb1; ++kb) acc += p[static_cast<size_t>(kb) * row];
    dq = round_bf16(dq + round_bf16(acc));
  }
  dqt[idx] = __float2bfloat16_rn(dq);
}

template <int D, int C, bool kVec>
cudaError_t launch_as(const void* qt, const void* kt, const void* vt, const void* dot,
                      const void* lse, const void* delta, void* dqt, void* dkt, void* dvt,
                      void* dq_part, int b, int n, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<D, C>);  // above 48 KB a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<D, C, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int nkb = (n + kKeysPerBlock - 1) / kKeysPerBlock;
  flash_bwd_bf16_kernel<D, C, kVec><<<dim3(nkb, b), kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(qt), static_cast<const bf16*>(kt), static_cast<const bf16*>(vt),
      static_cast<const bf16*>(dot), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dkt), static_cast<bf16*>(dvt),
      static_cast<float*>(dq_part), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(b) * D * n;
  constexpr int kSumThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kSumThreads - 1) / kSumThreads);
  flash_bwd_dq_sum_bf16_kernel<<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<bf16*>(dqt), b, nkb, D * n);
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, const void* dot,
                   const void* lse, const void* delta, void* dqt, void* dkt, void* dvt,
                   void* dq_part, int b, int n, cudaStream_t stream) {
  if (n % 8 == 0 && aligned16(qt) && aligned16(dot) && aligned16(lse) && aligned16(delta)) {
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
// cudaErrorInvalidValue without launching. qt, kt, vt, dot, dqt, dkt, dvt
// bfloat16; lse, delta float32.
extern "C" int tdt_flash_bwd_bf16(const void* qt, const void* kt, const void* vt,
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
extern "C" int tdt_flash_bwd_bf16_smem_bytes(int d, int c) {
  if (d == 4 && c == 32) return static_cast<int>(sizeof(Smem<4, 32>));
  if (d == 8 && c == 64) return static_cast<int>(sizeof(Smem<8, 64>));
  if (d == 16 && c == 128) return static_cast<int>(sizeof(Smem<16, 128>));
  return -1;
}
