// Unscaled flash-attention backward for Hopper (sm_90a), float32.
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
// (B, 1, N), all contiguous; outputs dqt, dkt (B, D, N), dvt (B, C, N).
//
// Design (one visit per (query, key) pair, as the TPU kernel; simple first):
// - One block per (batch, block of kThreads keys), one thread per key. Its
//   k_j, v_j and the accumulators dk_j, dv_j stay in float32 registers.
// - The block walks all queries in tiles of kThreads. A tile's q, dO, lse
//   (converted to base 2 once) and delta are staged in shared memory and
//   read as broadcasts, as flash_fwd.cu stages keys.
// - Each thread writes its ds_ij for the tile into a shared (query, key)
//   matrix. After a barrier the roles swap: thread t owns query t of the
//   tile and sums ds_tj * k_j over the block's keys, a (64 x 64) x (64 x D)
//   product read from shared memory without bank conflicts (padded rows).
// - That sum is the block's partial dq for the tile, written to a buffer
//   (B, N / kThreads, D, N). A second kernel adds the partials of the key
//   blocks in a fixed order. No atomics: two calls give the same bits.
//
// Bound on an H100: 2*B*N^2*(3D + 2C) float32 FLOPs (one fused multiply-add
// per pair and per D or C element: the logit, dv, dp, dk and dq products)
// against a few MB of operands, so the work is compute-bound (N=16384, D=4,
// C=32, B=4: 163 GFLOP, 2.44 ms at 67 TFLOP/s). The partials add
// 2 * 4 * B * (N / 64) * D * N bytes (512 MiB moved at N=16384, D=4, B=4).
// The tensor cores are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;  // keys per block (one per thread) = queries per tile
constexpr int kPad = 4;       // floats of row padding that keep rows 16-byte aligned
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                     const float* __restrict__ vt, const float* __restrict__ dot,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dkt, float* __restrict__ dvt,
                     float* __restrict__ dq_part, int n) {
  static_assert(D % 4 == 0 && C % 4 == 0, "float4 shared-memory reads");
  __shared__ __align__(16) float qs[kThreads][D + kPad];   // the tile's q, query-major
  __shared__ __align__(16) float dos[kThreads][C + kPad];  // the tile's dO
  __shared__ float lse2s[kThreads];                        // lse * log2(e)
  __shared__ float deltas[kThreads];
  __shared__ __align__(16) float ks[kThreads][D + kPad];   // the block's keys
  __shared__ float dss[kThreads][kThreads + 1];            // ds[query][key]

  const int b = blockIdx.y;
  const int kb = blockIdx.x;
  const int tid = threadIdx.x;
  const int key = kb * kThreads + tid;
  const bool key_active = key < n;
  const size_t bn = static_cast<size_t>(b) * n;
  const float* qb = qt + bn * D;
  const float* dob = dot + bn * C;

  float k[D], v[C], dk[D], dv[C];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    k[d] = key_active ? kt[(bn * D) + static_cast<size_t>(d) * n + key] : 0.f;
    ks[tid][d] = k[d];
    dk[d] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = key_active ? vt[(bn * C) + static_cast<size_t>(c) * n + key] : 0.f;
    dv[c] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kThreads) {
    const int qi = q0 + tid;
    const bool q_active = qi < n;
    __syncthreads();  // the previous tile's readers of qs, dos and dss are done
#pragma unroll
    for (int d = 0; d < D; ++d) qs[tid][d] = q_active ? qb[static_cast<size_t>(d) * n + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dos[tid][c] = q_active ? dob[static_cast<size_t>(c) * n + qi] : 0.f;
    }
    // A query past N gets lse = +inf, so p = exp2(-inf) = 0 and it adds nothing.
    lse2s[tid] = q_active ? lse[bn + qi] * kLog2e : INFINITY;
    deltas[tid] = q_active ? delta[bn + qi] : 0.f;
    __syncthreads();

    // Phase 1: thread = key j; every query i of the tile.
    for (int i = 0; i < kThreads; ++i) {
      const float4* qr = reinterpret_cast<const float4*>(qs[i]);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        s = fmaf(qv.x, k[4 * d4 + 0], s);
        s = fmaf(qv.y, k[4 * d4 + 1], s);
        s = fmaf(qv.z, k[4 * d4 + 2], s);
        s = fmaf(qv.w, k[4 * d4 + 3], s);
      }
      // A key past N weighs 0 (its k and v are 0, but exp(0 - lse) is not).
      const float p = key_active ? exp2f(fmaf(s, kLog2e, -lse2s[i])) : 0.f;
      const float4* gr = reinterpret_cast<const float4*>(dos[i]);
      float dp0 = 0.f, dp1 = 0.f;  // two chains for the dO . v dot
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 g = gr[c4];
        dv[4 * c4 + 0] = fmaf(p, g.x, dv[4 * c4 + 0]);
        dv[4 * c4 + 1] = fmaf(p, g.y, dv[4 * c4 + 1]);
        dv[4 * c4 + 2] = fmaf(p, g.z, dv[4 * c4 + 2]);
        dv[4 * c4 + 3] = fmaf(p, g.w, dv[4 * c4 + 3]);
        dp0 = fmaf(g.x, v[4 * c4 + 0], dp0);
        dp1 = fmaf(g.y, v[4 * c4 + 1], dp1);
        dp0 = fmaf(g.z, v[4 * c4 + 2], dp0);
        dp1 = fmaf(g.w, v[4 * c4 + 3], dp1);
      }
      const float ds = p * ((dp0 + dp1) - deltas[i]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        dk[4 * d4 + 0] = fmaf(ds, qv.x, dk[4 * d4 + 0]);
        dk[4 * d4 + 1] = fmaf(ds, qv.y, dk[4 * d4 + 1]);
        dk[4 * d4 + 2] = fmaf(ds, qv.z, dk[4 * d4 + 2]);
        dk[4 * d4 + 3] = fmaf(ds, qv.w, dk[4 * d4 + 3]);
      }
      dss[i][tid] = ds;
    }
    __syncthreads();

    // Phase 2: thread = query q0 + tid; its dq over this block's keys.
    if (q_active) {
      float dq[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = 0.f;
      for (int j = 0; j < kThreads; ++j) {
        const float ds = dss[tid][j];  // row stride kThreads + 1: no bank conflicts
        const float4* kr = reinterpret_cast<const float4*>(ks[j]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = kr[d4];
          dq[4 * d4 + 0] = fmaf(ds, kv.x, dq[4 * d4 + 0]);
          dq[4 * d4 + 1] = fmaf(ds, kv.y, dq[4 * d4 + 1]);
          dq[4 * d4 + 2] = fmaf(ds, kv.z, dq[4 * d4 + 2]);
          dq[4 * d4 + 3] = fmaf(ds, kv.w, dq[4 * d4 + 3]);
        }
      }
      float* part = dq_part + (static_cast<size_t>(b) * gridDim.x + kb) * D * n;
#pragma unroll
      for (int d = 0; d < D; ++d) part[static_cast<size_t>(d) * n + qi] = dq[d];
    }
  }

  if (key_active) {
#pragma unroll
    for (int d = 0; d < D; ++d) dkt[bn * D + static_cast<size_t>(d) * n + key] = dk[d];
#pragma unroll
    for (int c = 0; c < C; ++c) dvt[bn * C + static_cast<size_t>(c) * n + key] = dv[c];
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

template <int D, int C>
cudaError_t launch(const void* qt, const void* kt, const void* vt, const void* dot,
                   const void* lse, const void* delta, void* dqt, void* dkt, void* dvt,
                   void* dq_part, int b, int n, cudaStream_t stream) {
  const int nkb = (n + kThreads - 1) / kThreads;
  flash_bwd_f32_kernel<D, C><<<dim3(nkb, b), kThreads, 0, stream>>>(
      static_cast<const float*>(qt), static_cast<const float*>(kt),
      static_cast<const float*>(vt), static_cast<const float*>(dot),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dkt), static_cast<float*>(dvt), static_cast<float*>(dq_part), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(b) * D * n;
  constexpr int kSumThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kSumThreads - 1) / kSumThreads);
  flash_bwd_dq_sum_kernel<<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<float*>(dqt), b, nkb, D * n);
  return cudaGetLastError();
}

}  // namespace

// Launches the backward (the pair kernel, then the dq sum) on `stream` and
// returns cudaGetLastError() (0 on success). dq_part is scratch of
// b * key_blocks * d * n floats, where key_blocks must equal ceil(n / 64), the
// kernel's keys per block. (d, c) must be one of the instantiated head widths
// below; anything else returns cudaErrorInvalidValue without launching.
extern "C" int tdt_flash_bwd_f32(const void* qt, const void* kt, const void* vt,
                                 const void* dot, const void* lse, const void* delta,
                                 void* dqt, void* dkt, void* dvt, void* dq_part, int b, int n,
                                 int d, int c, int key_blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || b > 65535) return cudaErrorInvalidValue;
  if (key_blocks != (n + kThreads - 1) / kThreads) return cudaErrorInvalidValue;
  if (d == 4 && c == 32) {
    return launch<4, 32>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n, s);
  }
  if (d == 8 && c == 64) {
    return launch<8, 64>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, b, n, s);
  }
  return cudaErrorInvalidValue;
}
