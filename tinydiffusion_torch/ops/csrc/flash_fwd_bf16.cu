// Unscaled flash-attention forward for Hopper (sm_90a), bfloat16.
//
// Replaces the bf16 path (bf16_in) of the TPU kernel
// tinydiffusion_tpu/ops/attention.py::_fwd_kernel (launched by _fwd): out =
// softmax(Q K^T) V with NO 1/sqrt(d) scaling, rounded to bf16 once, plus the row
// log-sum-exp lse in float32, without ever building the N x N logits.
//
// Layout: qt, kt (B, D, N), vt (B, C, N) and out (B, C, N) bf16, lse (B, 1, N)
// float32 in natural-log units, all contiguous (the conv-VAE's SelfAttention2D
// keeps the token axis N minor).
//
// Design (bf16 wgmma k16; fragments, tile layout and barriers in bf16_mma.cuh):
// - A block owns 128 queries: two consumer warpgroups of 64 (the 64 rows of
//   wgmma) and a producer warpgroup that streams key tiles of kBlockK = 128
//   keys (two sub-tiles of 64) through a ring of kStages stages with
//   mbarriers (full: the copies landed; empty: both consumers are done with
//   it). There is no block-wide barrier in the key loop; setmaxnreg hands the
//   producer's registers to the consumers. All four producer warps copy: one
//   warp alone could not issue a tile's 16-byte copies as fast as the
//   consumers use them.
// - Loads: cp.async writes each 16 bytes of a K or V row straight into its
//   core matrix, the layout wgmma reads as staged (no widening pass). N not a
//   multiple of 8 (a bf16 row not 16-byte aligned) takes the same kernel with
//   one value a load.
// - S = Q K^T: m64n64k16 a sub-tile, Q from registers (D = 4 or 8 padded to 16
//   with zeros, loaded once), K read MN-major. Exact, as JAX's single bf16
//   pass (attention.py:129): each product has 16 significant bits.
// - Online softmax in base 2 on the accumulators: one FFMA an element for
//   s log2(e) - m log2(e), then ex2; a thread holds rows g and g + 8 of its
//   warp's 16, whose maxima are reduced over the quad with two shuffles.
// - P V: m64nCk16 with P from registers as A, the S fragment repacked in
//   place (bf16_mma.cuh), V read K-major. P goes as two bf16 planes,
//   P_hi V + P_lo V, which keeps ~2^-16 relative a weight, 2^8 below out's own
//   rounding, so P carries float32 accuracy as JAX's float32 value product
//   does (one plane, the TPU's DEFAULT precision, lands outside the card
//   checks' bounds: tests/test_torch_attention.py records it).
// - Per tile, a consumer issues S of tile j and P V of tile j - 1 together and
//   computes tile j's exps while P V runs (a register fence keeps the exps
//   ahead of the wait), then rescales O once P V is done. The two consumers
//   run free of each other: making them take turns to issue (a ping-pong on
//   named barriers) measured slower.
// - Keys past N get s = -inf (weight 0); queries past N are computed on zeros
//   and not stored. No atomics: two calls give the same bits.
//
// Bound on an H100: 2*B*N^2*(D+C) FLOPs of products (N=16384, D=4, C=32, B=4:
// 77 GFLOP, 0.078 ms at the 989 TFLOP/s bf16 tensor-core peak) and one exp per
// (query, key) pair (1.07e9 MUFU ops, 0.257 ms at 16 a clock per SM). The
// softmax's per-element work (an FFMA, an exp, a max, a sum and the two
// planes' conversions) on two consumer warps a scheduler is what bounds it.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

using namespace tdt;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);   // and the producer warpgroup
constexpr int kQueriesPerBlock = 64 * kConsumers;
constexpr int kSub = 2;                            // sub-tiles of 64 keys a key tile
constexpr int kBlockK = kSub * kTileTokens;        // keys per tile
constexpr int kStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int C>
struct Smem {
  alignas(128) unsigned char k[kStages][kSub][2 * kRowGroupBytes];  // 16 rows: D, then zeros
  alignas(128) unsigned char v[kStages][kSub][C / 8 * kRowGroupBytes];
  uint64_t full[kStages], empty[kStages];
};

template <int D, int C, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ kt,
                      const bf16* __restrict__ vt, bf16* __restrict__ out,
                      float* __restrict__ lse, int n) {
  static_assert(D == 4 || D == 8, "Q and K padded to one k16 step");
  static_assert(C == 32 || C == 64, "the value product is one m64n32 or m64n64");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(smem_raw);
  const int b = blockIdx.y;
  const size_t bn = static_cast<size_t>(b) * n;
  const int ntiles = (n + kBlockK - 1) / kBlockK;

  // K's rows D..15 stay zero; the producer writes rows below D.
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(sm.k) / 16); i += kThreads) {
    reinterpret_cast<uint4*>(sm.k)[i] = make_uint4(0, 0, 0, 0);
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
      const bf16* kb = kt + bn * D;
      const bf16* vb = vt + bn * C;
      produce<kStages>(ntiles, sm.full, sm.empty, [&](int s, int it) {
        for (int sub = 0; sub < kSub; ++sub) {
          const int k0 = it * kBlockK + sub * kTileTokens;
          copy_tile<D, kVec>(smem_addr(sm.k[s][sub]), kb, k0, n, tid);
          copy_tile<C, kVec>(smem_addr(sm.v[s][sub]), vb, k0, n, tid);
        }
      });
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int cw = wg - 1;  // this consumer
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQueriesPerBlock + cw * 64 + warp * 16 + g;  // and row0 + 8

  // Q as A (rows g, g + 8; columns d = 2t, 2t + 1; d >= D and 8..15 zero).
  const bf16* qb = qt + bn * D;
  auto q_pair = [&](int row) {
    const bool in = 2 * t < D && row < n;
    const bf16* p = qb + static_cast<size_t>(2 * t) * n + row;
    return bf16_bits(p, in) | bf16_bits(p + n, in) << 16;
  };
  const uint32_t qa[4] = {q_pair(row0), q_pair(row0 + 8), 0u, 0u};

  float o[C / 2];  // accumulator layout: element 4i + e of the n8 tile i of c
#pragma unroll
  for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8, times log2(e)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float s[kSub][32];                     // S of the tile by sub-tile, then P
  FragPlanes pa[kSub];                   // P of the previous tile, as A of P V

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages, prev = (it + kStages - 1) % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      Wgmma16<kTileTokens>::rs<1>(s[sub], qa, desc_mn(sm.k[st][sub]), 0);
    }
    wgmma_commit();
    if (it > 0) {
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) wgmma_planes<C>(o, pa[sub], sm.v[prev][sub]);
      wgmma_commit();
    }
    if (it > 0) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) reg_fence(s[sub]);

    const int k0 = it * kBlockK;
    if (k0 + kBlockK > n) {  // the ragged last tile: keys past N weigh 0
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
        for (int j = 0; j < kTileTokens / 8; ++j) {
          const int key = k0 + sub * kTileTokens + 8 * j + 2 * t;
          if (key >= n) s[sub][4 * j + 0] = s[sub][4 * j + 2] = -INFINITY;
          if (key + 1 >= n) s[sub][4 * j + 1] = s[sub][4 * j + 3] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
      for (int j = 0; j < kTileTokens / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[sub][4 * j + 0], s[sub][4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[sub][4 * j + 2], s[sub][4 * j + 3]));
      }
    }
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, mask));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, mask));
    }
    // Key k0 < N is in every tile, so the new maxima are finite, and on the
    // first tile 2^-inf = 0 zeroes only what is already zero.
    const float mn0 = fmaxf(m0, mx0 * kLog2e), mn1 = fmaxf(m1, mx1 * kLog2e);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      float* p = s[sub];
#pragma unroll
      for (int j = 0; j < kTileTokens / 8; ++j) {
        p[4 * j + 0] = ex2(fmaf(p[4 * j + 0], kLog2e, -mn0));
        p[4 * j + 1] = ex2(fmaf(p[4 * j + 1], kLog2e, -mn0));
        p[4 * j + 2] = ex2(fmaf(p[4 * j + 2], kLog2e, -mn1));
        p[4 * j + 3] = ex2(fmaf(p[4 * j + 3], kLog2e, -mn1));
        ls0 += p[4 * j + 0] + p[4 * j + 1];
        ls1 += p[4 * j + 2] + p[4 * j + 3];
      }
      reg_fence(s[sub]);  // the exps run before the wait below, under P V
    }
    reg_fence(ls0);
    reg_fence(ls1);

    wgmma_wait<0>();  // P V of the previous tile: its stage and P registers are free
    reg_fence(o);
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) reg_fence(pa[sub]);
    if (it > 0) release(&sm.empty[prev], lane);
    l0 = fmaf(l0, alpha0, ls0);
    l1 = fmaf(l1, alpha1, ls1);
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      o[4 * i + 0] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) to_planes(s[sub], pa[sub]);
  }
  const int last = (ntiles - 1) % kStages;
  wgmma_fence();
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub) wgmma_planes<C>(o, pa[sub], sm.v[last][sub]);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub) reg_fence(pa[sub]);
  release(&sm.empty[last], lane);

#pragma unroll
  for (int mask = 1; mask <= 2; mask <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, mask);
    l1 += __shfl_xor_sync(0xffffffffu, l1, mask);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* ob = out + bn * C;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const size_t c = 8 * i + 2 * t;
    if (row0 < n) {
      ob[c * n + row0] = __float2bfloat16_rn(o[4 * i + 0] * inv0);
      ob[(c + 1) * n + row0] = __float2bfloat16_rn(o[4 * i + 1] * inv0);
    }
    if (row0 + 8 < n) {
      ob[c * n + row0 + 8] = __float2bfloat16_rn(o[4 * i + 2] * inv1);
      ob[(c + 1) * n + row0 + 8] = __float2bfloat16_rn(o[4 * i + 3] * inv1);
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
  constexpr int kSmem = sizeof(Smem<C>);  // above 48 KB a kernel must opt in
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, C, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
  flash_fwd_bf16_kernel<D, C, kVec><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(qt), static_cast<const bf16*>(kt), static_cast<const bf16*>(vt),
      static_cast<bf16*>(out), static_cast<float*>(lse), n);
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, void* out, void* lse,
                   int b, int n, cudaStream_t stream) {
  if (n % 8 == 0 && aligned16(kt) && aligned16(vt)) {
    return launch_as<D, C, true>(qt, kt, vt, out, lse, b, n, stream);
  }
  return launch_as<D, C, false>(qt, kt, vt, out, lse, b, n, stream);
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). (d, c) must be one of the instantiated head widths below; any
// other pair returns cudaErrorInvalidValue without launching. qt, kt, vt, out
// bfloat16; lse float32.
extern "C" int tdt_flash_fwd_bf16(const void* qt, const void* kt, const void* vt, void* out,
                                  void* lse, int b, int n, int d, int c, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || b > 65535) return cudaErrorInvalidValue;
  if (d == 4 && c == 32) return launch<4, 32>(qt, kt, vt, out, lse, b, n, s);
  if (d == 8 && c == 64) return launch<8, 64>(qt, kt, vt, out, lse, b, n, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of the kernel at (d, c), in bytes (-1 for a pair
// that is not instantiated), for reports.
extern "C" int tdt_flash_fwd_bf16_smem_bytes(int d, int c) {
  if (d == 4 && c == 32) return static_cast<int>(sizeof(Smem<32>));
  if (d == 8 && c == 64) return static_cast<int>(sizeof(Smem<64>));
  return -1;
}
